// Observe's dense candidate scan and the movable-voxel scan for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernels _kernel (front_candidates) and _movable_kernel
// (movable_voxels) of semantic_dsp_map_tpu/ops/observe_pallas.py.  Oracles:
// front_candidates_plain / movable_voxels_plain in
// semantic_dsp_map_tpu_torch/ops/observe.py.
//
// Both are one pass over the particle store with a per-voxel ANY.  Slot k of
// voxel v lies at v*K + k.  A slot is alive when status != INVALID and its
// stamp is at least the voxel's scroll stamp (codecs.particle_alive); stamps
// are compared as integers, which is what the TPU kernel's f32 compare after
// a one-hot matmul computes for stamps below 2^24.
//
//   front:   has_alive[v] = any_k alive
//            has_cand[v]  = any_k alive & depth in [dmin, dmax] & pixel in
//                           the image
//   movable: movable[v]   = any_k alive & 0 <= track <= max_movable
//
// What bounds them: device memory.  The front reads the status of every
// slot, the stamp of those with a status set and the three coordinates of
// the live ones, 17 B per slot at most (about 1.0 GB per frame at VKITTI2
// scale) and little more than 1 B in a map that is mostly empty; the
// movable scan reads 9 B per slot at most.  A few flops per byte, so the work is to keep the
// load units streaming whole lines.
//
// Front (one thread per group of four neighbouring slots): with a thread per
// voxel, a warp's load of slot k touches addresses K * 4 bytes apart, K
// cache lines for 128 useful bytes, again for every k and every field: the
// bytes come from device memory once, but the load units handle K times the
// sectors.  Here a block owns FRONT_SPAN neighbouring voxels, hence one
// contiguous span of FRONT_SPAN * K slots, and
//   1. stages the span's voxel stamps in shared memory, and has every
//      thread ask for the status words of all its K groups before it waits
//      for any (in a map that is mostly empty that is nearly all it reads,
//      and what limits it is how many loads are in flight);
//   2. walks the slots four a thread, neighbouring threads on neighbouring
//      addresses: status as one 4-byte load, stamp as one 16-byte load only
//      where one of the four has a status set and, only where one of the
//      four is alive, each coordinate as one 16-byte load; the slot's voxel is its index divided by the constant K.  Each
//      slot's two flags go into one byte of a shared array;
//   3. ORs the flag bytes per voxel, four voxels a thread (K words of shared
//      memory at a stride of K words: K is odd, so no bank conflict), and
//      writes has_alive and has_cand as 4-byte stores.
// A span in which no slot has a status set, as most spans of a map, writes
// its zeros after step 1 and is done.
// The last block's span and the last group of the store may be ragged; both
// are masked.  The store's arrays must be 16-byte aligned (whole tensors
// are).  The TPU kernel's one-hot MXU reduction has no counterpart here.
//
// Movable: the first design, a thread per voxel looping over its K slots,
// read the scroll stamp of every voxel (4 B a voxel: a third of what it read
// at VKITTI2) and made K byte loads strided by K across a warp.  Here a block
// owns MOV_SPAN neighbouring voxels, one contiguous run of slots, and
//   1. loads the span's status as 16-byte pieces, neighbouring threads on
//      neighbouring addresses, all of a thread's at once;
//   2. only where a group of four slots has a status set, reads the group's
//      stamps (16 bytes) and its voxels' scroll stamps, all in flight
//      together (a thread without a status set, as most of a map, goes
//      straight to zero flags);
//   3. only where a slot is alive, reads the group's tracks, and puts a flag
//      byte a slot in shared memory;
//   4. after the one barrier (__syncthreads_or: a span without a status set
//      writes its zeros), ORs the flag bytes per voxel, four voxels a thread
//      (K words at a stride of K words: conflict-free), and writes them as
//      4-byte stores.
// Staging the span's voxel stamps in shared memory instead (a barrier after
// the status, another after the stamps) was as fast on a real VKITTI2 frame
// but a tenth slower on the dense ZED2 store; the scroll stamps of a group's
// voxels are two loads that L1 mostly serves.
// Its bound counts what the inputs need: the status of every slot, the
// output byte of every voxel, the stamp of the voxels and of the slots with
// a status set and the track of the live slots.  The last span and its last
// group may be ragged and are masked; status, stamp and track (and at K = 1
// the voxel stamps) must be 16-byte aligned (whole tensors are).

// Instances: K = 1, 3, 7, 15 and 31 of each scan, and one generic instance
// of each for every other K (front_generic_kernel, movable_generic_kernel,
// below): a span's K * SPAN flag bytes and a thread's K status words stop
// fitting past K = 31, so there a block walks its span in 16-slot pieces
// and ORs each slot's flag into its voxel's word in shared memory.
//
// Pixel truncation decides has_cand and is compared bit for bit with the
// plain version, so the projection keeps its expression order: camera
// coordinates r0*x + r1*y + r2*z + t added left to right, then
// u = fx * cx / zsafe + cx0 with IEEE division (the library is built with
// -fmad=false, so nothing is contracted), then C truncation toward zero.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr uint8_t STATUS_INVALID = 0;

struct Camera {
  float fx, fy, cx0, cy0, dmin, dmax;
  int h, w;
};

constexpr int FRONT_NT = 256;
constexpr int FRONT_SPAN = 4 * FRONT_NT;  // voxels a block; a multiple of 4

// Bit 0 of a slot's flag byte: alive; bit 1: candidate.
__device__ __forceinline__ unsigned slot_flags(
    bool alive, float x, float y, float z, const float* __restrict__ pose,
    const Camera& cam) {
  if (!alive) return 0u;
  const float cxc = pose[0] * x + pose[1] * y + pose[2] * z + pose[9];
  const float cyc = pose[3] * x + pose[4] * y + pose[5] * z + pose[10];
  const float czc = pose[6] * x + pose[7] * y + pose[8] * z + pose[11];
  const bool in_depth = czc >= cam.dmin && czc <= cam.dmax;
  const float zsafe = czc == 0.f ? 1e-6f : czc;
  const float u = cam.fx * cxc / zsafe + cam.cx0;
  const float vv = cam.fy * cyc / zsafe + cam.cy0;
  const int col = (int)u;
  const int row = (int)vv;
  const bool in_image = row >= 0 && row < cam.h && col >= 0 && col < cam.w;
  return (in_depth && in_image) ? 3u : 1u;
}

template <int K>
__global__ void __launch_bounds__(FRONT_NT) front_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const uint8_t* __restrict__ status,
    const int* __restrict__ stamp, const int* __restrict__ vax,
    const float* __restrict__ pose_g,  // r_cw row-major (9), t_cw (3)
    uint8_t* __restrict__ ha, uint8_t* __restrict__ hc, long long V,
    Camera cam) {
  __shared__ int s_vax[FRONT_SPAN];
  __shared__ unsigned s_flag[FRONT_SPAN * K / 4];  // a byte per slot
  const int tid = threadIdx.x;
  const long long v0 = (long long)blockIdx.x * FRONT_SPAN;
  const int nv = (int)(V - v0 < FRONT_SPAN ? V - v0 : FRONT_SPAN);
  // The span's slots, four a thread: FRONT_NT * K groups, K a thread.
  // v0 * K is a multiple of 4, so every whole group is 16-byte aligned in
  // the 4-byte arrays.
  const long long slot0 = v0 * K;
  const int nslots = nv * K;
  const int ngroups = (nslots + 3) / 4;

  // All of a thread's first loads at once, before anything waits for one:
  // its voxel stamps and the status words of its K groups (0 = INVALID in
  // every byte beyond the store).
  int va[FRONT_SPAN / FRONT_NT];
#pragma unroll
  for (int i = 0; i < FRONT_SPAN / FRONT_NT; ++i) {
    const int lv = tid + i * FRONT_NT;
    va[i] = lv < nv ? vax[v0 + lv] : 0;
  }
  unsigned st[K];
#pragma unroll
  for (int it = 0; it < K; ++it) {
    const int li = 4 * (tid + it * FRONT_NT);
    st[it] = 0u;
    if (li + 3 < nslots) {
      st[it] = *reinterpret_cast<const unsigned*>(status + slot0 + li);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (li + j < nslots) st[it] |= (unsigned)status[slot0 + li + j] << (8 * j);
    }
  }
  float pose[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) pose[i] = pose_g[i];
#pragma unroll
  for (int i = 0; i < FRONT_SPAN / FRONT_NT; ++i) s_vax[tid + i * FRONT_NT] = va[i];
  unsigned any_status = 0u;
#pragma unroll
  for (int it = 0; it < K; ++it) any_status |= st[it];
  const long long vq = v0 + 4 * tid;  // this thread's four voxels of the output
  if (!__syncthreads_or(any_status != 0u)) {
    // A span without a single slot in use, as most of a map is: all flags 0.
    if (4 * tid + 3 < nv) {
      *reinterpret_cast<unsigned*>(ha + vq) = 0u;
      *reinterpret_cast<unsigned*>(hc + vq) = 0u;
    } else {
      for (int u = 0; 4 * tid + u < nv; ++u) ha[vq + u] = hc[vq + u] = 0;
    }
    return;
  }

#pragma unroll
  for (int it = 0; it < K; ++it) {
    const int g = tid + it * FRONT_NT;
    if (g >= ngroups) break;
    // The stamps only where a status is set: a map is mostly empty slots,
    // and an empty slot's stamp decides nothing.
    if (st[it] == 0u) {
      s_flag[g] = 0u;
      continue;
    }
    const int li = 4 * g;
    const long long i0 = slot0 + li;
    const bool whole = li + 3 < nslots;
    int sp[4] = {0, 0, 0, 0};
    if (whole) {
      const int4 q = *reinterpret_cast<const int4*>(stamp + i0);
      sp[0] = q.x; sp[1] = q.y; sp[2] = q.z; sp[3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (li + j < nslots) sp[j] = stamp[i0 + j];
    }
    bool alive[4];
    bool any = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int lv = li + j < nslots ? (li + j) / K : 0;
      alive[j] = ((st[it] >> (8 * j)) & 0xffu) != STATUS_INVALID && sp[j] >= s_vax[lv];
      any = any || alive[j];
    }
    unsigned flags = 0u;
    if (any) {
      float x[4], y[4], z[4];
      if (whole) {
        const float4 a = *reinterpret_cast<const float4*>(px + i0);
        const float4 b = *reinterpret_cast<const float4*>(py + i0);
        const float4 c = *reinterpret_cast<const float4*>(pz + i0);
        x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
        y[0] = b.x; y[1] = b.y; y[2] = b.z; y[3] = b.w;
        z[0] = c.x; z[1] = c.y; z[2] = c.z; z[3] = c.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool in = li + j < nslots;
          x[j] = in ? px[i0 + j] : 0.f;
          y[j] = in ? py[i0 + j] : 0.f;
          z[j] = in ? pz[i0 + j] : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        flags |= slot_flags(alive[j], x[j], y[j], z[j], pose, cam) << (8 * j);
    }
    s_flag[g] = flags;
  }
  __syncthreads();

  // Four voxels a thread: their 4 * K flag bytes are K whole words.
  const int q = tid;
  if (4 * q < nv) {
    unsigned words[K];
    unsigned any_flag = 0u;
#pragma unroll
    for (int w = 0; w < K; ++w) {
      // words past the last group were never written: read them as 0
      words[w] = q * K + w < ngroups ? s_flag[q * K + w] : 0u;
      any_flag |= words[w];
    }
    unsigned f[4] = {0u, 0u, 0u, 0u};
    if (any_flag != 0u) {
#pragma unroll
      for (int w = 0; w < K; ++w) {
#pragma unroll
        for (int j = 0; j < 4; ++j) f[(4 * w + j) / K] |= (words[w] >> (8 * j)) & 0xffu;
      }
    }
    unsigned a4 = 0u, c4 = 0u;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a4 |= (f[u] & 1u) << (8 * u);
      c4 |= ((f[u] >> 1) & 1u) << (8 * u);
    }
    if (4 * q + 3 < nv) {
      *reinterpret_cast<unsigned*>(ha + vq) = a4;
      *reinterpret_cast<unsigned*>(hc + vq) = c4;
    } else {
      for (int u = 0; 4 * q + u < nv; ++u) {
        ha[vq + u] = (a4 >> (8 * u)) & 0xffu;
        hc[vq + u] = (c4 >> (8 * u)) & 0xffu;
      }
    }
  }
}

constexpr int MOV_NT = 256;
constexpr int MOV_SPAN = 4 * MOV_NT;  // voxels a block; four a thread at the end

// Steps 2 and 3 of the movable scan, for a thread whose status pieces `q`
// have a status set: where a group of four slots has one, its stamps (16
// bytes) and the scroll stamps of its voxels (at most two for K >= 3; four
// neighbouring ones, 16 bytes, for K = 1), all in flight together; then the
// tracks where a slot is alive; a flag byte a slot into `s_flag`.
template <int K, int ROUNDS>
__device__ __forceinline__ void movable_flags(
    const uint4 (&q)[ROUNDS], const int* __restrict__ track, const int* __restrict__ stamp,
    const int* __restrict__ vax, long long v0, int nv, long long slot0, int nslots,
    int max_movable, uint8_t* s_flag) {
  constexpr int CHUNKS = MOV_SPAN * K / 16;
  const int tid = threadIdx.x;
  int4 sp[ROUNDS][4], va[ROUNDS][4];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const unsigned word[4] = {q[r].x, q[r].y, q[r].z, q[r].w};
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int li = 16 * (tid + r * MOV_NT) + 4 * g;
      sp[r][g] = va[r][g] = make_int4(0, 0, 0, 0);
      if (word[g] == 0u) continue;
      if (li + 3 < nslots) {
        sp[r][g] = *reinterpret_cast<const int4*>(stamp + slot0 + li);
      } else {
        int t[4] = {0, 0, 0, 0};
        for (int j = 0; li + j < nslots; ++j) t[j] = stamp[slot0 + li + j];
        sp[r][g] = make_int4(t[0], t[1], t[2], t[3]);
      }
      if (K == 1) {
        if (li + 3 < nv) {
          va[r][g] = *reinterpret_cast<const int4*>(vax + v0 + li);
        } else {
          int t[4] = {0, 0, 0, 0};
          for (int j = 0; li + j < nv; ++j) t[j] = vax[v0 + li + j];
          va[r][g] = make_int4(t[0], t[1], t[2], t[3]);
        }
      } else {
        const int last = li + 3 < nslots ? li + 3 : nslots - 1;
        va[r][g].x = vax[v0 + li / K];
        va[r][g].y = vax[v0 + last / K];
      }
    }
  }
  unsigned alive[ROUNDS][4];  // a bit a slot of the group
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const unsigned word[4] = {q[r].x, q[r].y, q[r].z, q[r].w};
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int li = 16 * (tid + r * MOV_NT) + 4 * g;
      const int t[4] = {sp[r][g].x, sp[r][g].y, sp[r][g].z, sp[r][g].w};
      const int v4[4] = {va[r][g].x, va[r][g].y, va[r][g].z, va[r][g].w};
      alive[r][g] = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool set = ((word[g] >> (8 * j)) & 0xffu) != STATUS_INVALID;
        const int vs = K == 1 ? v4[j] : ((li + j) / K == li / K ? v4[0] : v4[1]);
        if (set && t[j] >= vs) alive[r][g] |= 1u << j;
      }
    }
  }
  // then the tracks where a slot is alive, and a flag byte a slot
  int4 tk[ROUNDS][4];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int li = 16 * (tid + r * MOV_NT) + 4 * g;
      tk[r][g] = make_int4(-1, -1, -1, -1);
      if (alive[r][g] == 0u) continue;
      if (li + 3 < nslots) {
        tk[r][g] = *reinterpret_cast<const int4*>(track + slot0 + li);
      } else {
        int t[4] = {-1, -1, -1, -1};
        for (int j = 0; li + j < nslots; ++j) t[j] = track[slot0 + li + j];
        tk[r][g] = make_int4(t[0], t[1], t[2], t[3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int c = tid + r * MOV_NT;
    if (c >= CHUNKS) break;
    unsigned f[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int t[4] = {tk[r][g].x, tk[r][g].y, tk[r][g].z, tk[r][g].w};
      f[g] = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool mov = (alive[r][g] >> j & 1u) && t[j] >= 0 && t[j] <= max_movable;
        f[g] |= (unsigned)mov << (8 * j);
      }
    }
    *reinterpret_cast<uint4*>(s_flag + 16 * c) = make_uint4(f[0], f[1], f[2], f[3]);
  }

}

// Blocks an SM the registers must leave room for: most of a map's spans
// only stream their status, and the more warps an SM holds the more of it
// is in flight.  At K = 7 the compiler's own choice (90 registers) left
// two blocks; three (85 at most) took a seventh off a real VKITTI2 frame's
// scan on an H100, while at K = 3 a cap of three let it grow to 71
// registers and lose, so five there (51 at most, the 48 it takes unasked).
template <int K>
__host__ __device__ constexpr int movable_min_blocks() {
  return K <= 3 ? 5 : (K <= 7 ? 3 : 1);
}

template <int K>
__global__ void __launch_bounds__(MOV_NT, movable_min_blocks<K>()) movable_kernel(
    const int* __restrict__ track, const uint8_t* __restrict__ status,
    const int* __restrict__ stamp, const int* __restrict__ vax,
    uint8_t* __restrict__ hm, long long V, int max_movable) {
  constexpr int CHUNKS = MOV_SPAN * K / 16;  // 16-byte pieces of a whole span's status
  constexpr int ROUNDS = (CHUNKS + MOV_NT - 1) / MOV_NT;
  __shared__ __align__(16) uint8_t s_flag[MOV_SPAN * K];  // a byte a slot
  const int tid = threadIdx.x;
  const long long v0 = (long long)blockIdx.x * MOV_SPAN;
  const int nv = (int)(V - v0 < MOV_SPAN ? V - v0 : MOV_SPAN);
  // v0 * K is a multiple of 16: every whole piece is 16-byte aligned.
  const long long slot0 = v0 * K;
  const int nslots = nv * K;

  // 1. The status, all of a thread's pieces at once (0 = INVALID beyond the
  // store).
  uint4 q[ROUNDS];
  unsigned any_status = 0u;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int li = 16 * (tid + r * MOV_NT);
    q[r] = make_uint4(0u, 0u, 0u, 0u);
    if (li + 15 < nslots) {
      q[r] = *reinterpret_cast<const uint4*>(status + slot0 + li);
    } else if (li < nslots) {
      unsigned w[4] = {0u, 0u, 0u, 0u};
      for (int j = 0; li + j < nslots; ++j) w[j / 4] |= (unsigned)status[slot0 + li + j] << (8 * (j % 4));
      q[r] = make_uint4(w[0], w[1], w[2], w[3]);
    }
    any_status |= q[r].x | q[r].y | q[r].z | q[r].w;
  }

  // 2-3. Where this thread has a status set: stamps and voxel stamps, then
  // tracks, and a flag byte a slot; else zero flags, as for most of a map.
  if (any_status != 0u) {
    movable_flags<K, ROUNDS>(q, track, stamp, vax, v0, nv, slot0, nslots, max_movable, s_flag);
  } else {
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int c = tid + r * MOV_NT;
      if (c < CHUNKS) *reinterpret_cast<uint4*>(s_flag + 16 * c) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // 4. Four voxels a thread: their 4 * K flag bytes are K whole words.  A
  // span without a single slot in use, as most of a map, writes its zeros.
  const long long vq = v0 + 4 * tid;
  const bool in_use = __syncthreads_or(any_status != 0u);
  if (4 * tid < nv) {
    unsigned m4 = 0u;
    if (in_use) {
      const unsigned* words = reinterpret_cast<const unsigned*>(s_flag) + tid * K;
      unsigned f[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int w = 0; w < K; ++w) {
        const unsigned word = words[w];
#pragma unroll
        for (int j = 0; j < 4; ++j) f[(4 * w + j) / K] |= (word >> (8 * j)) & 0xffu;
      }
      m4 = f[0] | f[1] << 8 | f[2] << 16 | f[3] << 24;
    }
    if (4 * tid + 3 < nv) {
      *reinterpret_cast<unsigned*>(hm + vq) = m4;
    } else {
      for (int u = 0; 4 * tid + u < nv; ++u) hm[vq + u] = (m4 >> (8 * u)) & 0xffu;
    }
  }
}

// The generic instances of both scans, for every K past 31.  The designs
// above keep a thread's K status words (front) or a span's K * MOV_SPAN flag
// bytes (movable) in registers and shared memory: at K = 31 the movable scan
// already takes 255 registers, and at K = 63 the front's shared array passes
// 48 KB.  Here a block owns GEN_SPAN neighbouring voxels, one contiguous run
// of GEN_SPAN * K slots (16-byte aligned: GEN_SPAN is a multiple of 16), and
// walks it in pieces of 16 slots, a piece a thread, neighbouring threads on
// neighbouring addresses, so nothing grows with K:
//   1. the span's voxel stamps go to shared memory, its flag words are
//      cleared (2 KB in all, whatever K);
//   2. a piece's status is one 16-byte load; only where a group of four of
//      its slots has a status set, the group's stamps (16 bytes), and only
//      where one of them is alive, its coordinates (front) or tracks
//      (movable), 16 bytes a field, as in the designs above;
//   3. each slot's flag is ORed into its voxel's word in shared memory
//      (atomicOr; the slot's voxel is its index divided by K).  An OR does
//      not depend on the order, and each slot's flag is computed as the
//      designs above compute it, so the result is the plain version's;
//   4. after the one barrier, a thread a voxel writes the flag bytes.
// Slot offsets are 64-bit: a full grid at K = 255 holds 2^31 slots.  Both
// stream the status as the designs above do: on an H100 at the full VKITTI2
// grid at K = 63, 0.27 (front) and 0.23 ms (movable) against bounds of 0.18
// and 0.16 ms.
constexpr int GEN_NT = 256;
constexpr int GEN_SPAN = 256;  // voxels a block

// A group's four stamps, or -1 past the store (never alive).
__device__ __forceinline__ int4 load_group_i32(const int* __restrict__ a, long long i0,
                                               long long n, long long li) {
  if (li + 3 < n) return *reinterpret_cast<const int4*>(a + i0);
  int t[4] = {0, 0, 0, 0};
  for (int j = 0; li + j < n; ++j) t[j] = a[i0 + j];
  return make_int4(t[0], t[1], t[2], t[3]);
}

__device__ __forceinline__ float4 load_group_f32(const float* __restrict__ a, long long i0,
                                                 long long n, long long li) {
  if (li + 3 < n) return *reinterpret_cast<const float4*>(a + i0);
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = 0; li + j < n; ++j) t[j] = a[i0 + j];
  return make_float4(t[0], t[1], t[2], t[3]);
}

// Steps 1-4 of the generic scans; ``Flags`` gives a group's four flag bytes
// from its alive bits (bit j: slot j of the group).
template <typename Flags>
__device__ __forceinline__ void generic_scan(
    const uint8_t* __restrict__ status, const int* __restrict__ stamp,
    const int* __restrict__ vax, long long V, int K, uint8_t* __restrict__ out0,
    uint8_t* __restrict__ out1, Flags flags) {
  __shared__ int s_vax[GEN_SPAN];
  __shared__ unsigned s_flag[GEN_SPAN];
  const int tid = threadIdx.x;
  const long long v0 = (long long)blockIdx.x * GEN_SPAN;
  const int nv = (int)(V - v0 < GEN_SPAN ? V - v0 : GEN_SPAN);
  const long long slot0 = v0 * K;
  const long long nslots = (long long)nv * K;
  for (int i = tid; i < GEN_SPAN; i += GEN_NT) {
    s_vax[i] = i < nv ? vax[v0 + i] : 0;
    s_flag[i] = 0u;
  }
  __syncthreads();
  for (long long li = 16LL * tid; li < nslots; li += 16LL * GEN_NT) {
    uint4 q;
    if (li + 15 < nslots) {
      q = *reinterpret_cast<const uint4*>(status + slot0 + li);
    } else {
      unsigned w[4] = {0u, 0u, 0u, 0u};
      for (int j = 0; li + j < nslots; ++j) w[j / 4] |= (unsigned)status[slot0 + li + j] << (8 * (j % 4));
      q = make_uint4(w[0], w[1], w[2], w[3]);
    }
    const unsigned word[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      if (word[g] == 0u) continue;
      const long long lg = li + 4 * g;  // the group's first slot in the span
      const int4 sp = load_group_i32(stamp, slot0 + lg, nslots, lg);
      const int t[4] = {sp.x, sp.y, sp.z, sp.w};
      int lv[4];
      unsigned alive = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lv[j] = lg + j < nslots ? (int)((lg + j) / K) : 0;
        const bool set = ((word[g] >> (8 * j)) & 0xffu) != STATUS_INVALID;
        if (set && t[j] >= s_vax[lv[j]]) alive |= 1u << j;
      }
      if (alive == 0u) continue;
      const unsigned f = flags(alive, slot0 + lg, nslots, lg);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned fj = (f >> (8 * j)) & 0xffu;
        if (fj != 0u) atomicOr(&s_flag[lv[j]], fj);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nv; i += GEN_NT) {
    const unsigned f = s_flag[i];
    out0[v0 + i] = (uint8_t)(f & 1u);
    if (out1 != nullptr) out1[v0 + i] = (uint8_t)((f >> 1) & 1u);
  }
}

__global__ void __launch_bounds__(GEN_NT) front_generic_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const uint8_t* __restrict__ status,
    const int* __restrict__ stamp, const int* __restrict__ vax,
    const float* __restrict__ pose_g, uint8_t* __restrict__ ha, uint8_t* __restrict__ hc,
    long long V, int K, Camera cam) {
  float pose[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) pose[i] = pose_g[i];
  generic_scan(status, stamp, vax, V, K, ha, hc,
               [&](unsigned alive, long long i0, long long n, long long lg) {
                 const float4 a = load_group_f32(px, i0, n, lg);
                 const float4 b = load_group_f32(py, i0, n, lg);
                 const float4 c = load_group_f32(pz, i0, n, lg);
                 const float x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
                 const float z[4] = {c.x, c.y, c.z, c.w};
                 unsigned f = 0u;
#pragma unroll
                 for (int j = 0; j < 4; ++j)
                   f |= slot_flags((alive >> j) & 1u, x[j], y[j], z[j], pose, cam) << (8 * j);
                 return f;
               });
}

__global__ void __launch_bounds__(GEN_NT) movable_generic_kernel(
    const int* __restrict__ track, const uint8_t* __restrict__ status,
    const int* __restrict__ stamp, const int* __restrict__ vax,
    uint8_t* __restrict__ hm, long long V, int K, int max_movable) {
  generic_scan(status, stamp, vax, V, K, hm, nullptr,
               [&](unsigned alive, long long i0, long long n, long long lg) {
                 const int4 q = load_group_i32(track, i0, n, lg);
                 const int t[4] = {q.x, q.y, q.z, q.w};
                 unsigned f = 0u;
#pragma unroll
                 for (int j = 0; j < 4; ++j) {
                   const bool mov = ((alive >> j) & 1u) && t[j] >= 0 && t[j] <= max_movable;
                   f |= (unsigned)mov << (8 * j);
                 }
                 return f;
               });
}

int launch_front_generic(const float* px, const float* py, const float* pz,
                         const uint8_t* status, const int* stamp, const int* vax,
                         const float* pose, uint8_t* ha, uint8_t* hc, long long V, int K,
                         Camera cam, cudaStream_t s) {
  const unsigned grid = (unsigned)((V + GEN_SPAN - 1) / GEN_SPAN);
  static CUfunction fn = nullptr;
  return dsp::launch(front_generic_kernel, fn, grid, GEN_NT, 0, s, px, py, pz, status, stamp,
                     vax, pose, ha, hc, V, K, cam);
}

int launch_movable_generic(const int* track, const uint8_t* status, const int* stamp,
                           const int* vax, uint8_t* hm, long long V, int K, int max_movable,
                           cudaStream_t s) {
  const unsigned grid = (unsigned)((V + GEN_SPAN - 1) / GEN_SPAN);
  static CUfunction fn = nullptr;
  return dsp::launch(movable_generic_kernel, fn, grid, GEN_NT, 0, s, track, status, stamp, vax,
                     hm, V, K, max_movable);
}

template <int K>
int launch_front(const float* px, const float* py, const float* pz,
                 const uint8_t* status, const int* stamp, const int* vax,
                 const float* pose, uint8_t* ha, uint8_t* hc, long long V,
                 Camera cam, cudaStream_t s) {
  const unsigned grid = (unsigned)((V + FRONT_SPAN - 1) / FRONT_SPAN);
  static CUfunction fn = nullptr;
  return dsp::launch(front_kernel<K>, fn, grid, FRONT_NT, 0, s, px, py, pz,
                     status, stamp, vax, pose, ha, hc, V, cam);
}

template <int K>
int launch_movable(const int* track, const uint8_t* status, const int* stamp,
                   const int* vax, uint8_t* hm, long long V, int max_movable,
                   cudaStream_t s) {
  const unsigned grid = (unsigned)((V + MOV_SPAN - 1) / MOV_SPAN);
  static CUfunction fn = nullptr;
  return dsp::launch(movable_kernel<K>, fn, grid, MOV_NT, 0, s, track,
                     status, stamp, vax, hm, V, max_movable);
}

}  // namespace

extern "C" int dsp_front_candidates(
    const float* px, const float* py, const float* pz, const uint8_t* status,
    const int* stamp, const int* vax, const float* pose, uint8_t* ha,
    uint8_t* hc, long long V, int K, float fx, float fy, float cx0, float cy0,
    int h, int w, float dmin, float dmax, void* stream) {
  if (V <= 0) return (int)cudaErrorInvalidValue;
  // the kernel loads four slots and stores four voxels at a time
  const uintptr_t wide = (uintptr_t)px | (uintptr_t)py | (uintptr_t)pz | (uintptr_t)stamp;
  const uintptr_t narrow = (uintptr_t)status | (uintptr_t)ha | (uintptr_t)hc;
  if (wide % 16 != 0 || narrow % 4 != 0) return (int)cudaErrorMisalignedAddress;
  const Camera cam{fx, fy, cx0, cy0, dmin, dmax, h, w};
  cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
    case 1: return launch_front<1>(px, py, pz, status, stamp, vax, pose, ha, hc, V, cam, s);
    case 3: return launch_front<3>(px, py, pz, status, stamp, vax, pose, ha, hc, V, cam, s);
    case 7: return launch_front<7>(px, py, pz, status, stamp, vax, pose, ha, hc, V, cam, s);
    case 15: return launch_front<15>(px, py, pz, status, stamp, vax, pose, ha, hc, V, cam, s);
    case 31: return launch_front<31>(px, py, pz, status, stamp, vax, pose, ha, hc, V, cam, s);
    default:
      // the generic instance loads the status 16 bytes at a time
      if (K <= 0) return (int)cudaErrorInvalidValue;
      if ((uintptr_t)status % 16 != 0) return (int)cudaErrorMisalignedAddress;
      return launch_front_generic(px, py, pz, status, stamp, vax, pose, ha, hc, V, K, cam, s);
  }
}

extern "C" int dsp_movable_voxels(
    const int* track, const uint8_t* status, const int* stamp, const int* vax,
    uint8_t* hm, long long V, int K, int max_movable, void* stream) {
  if (V <= 0) return (int)cudaErrorInvalidValue;
  // the kernel loads 16 bytes of each field and stores four voxels at a time
  if (((uintptr_t)track | (uintptr_t)status | (uintptr_t)stamp) % 16 != 0 || (uintptr_t)hm % 4 != 0 ||
      (K == 1 && (uintptr_t)vax % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
    case 1: return launch_movable<1>(track, status, stamp, vax, hm, V, max_movable, s);
    case 3: return launch_movable<3>(track, status, stamp, vax, hm, V, max_movable, s);
    case 7: return launch_movable<7>(track, status, stamp, vax, hm, V, max_movable, s);
    case 15: return launch_movable<15>(track, status, stamp, vax, hm, V, max_movable, s);
    case 31: return launch_movable<31>(track, status, stamp, vax, hm, V, max_movable, s);
    default:
      if (K <= 0) return (int)cudaErrorInvalidValue;
      return launch_movable_generic(track, status, stamp, vax, hm, V, K, max_movable, s);
  }
}
