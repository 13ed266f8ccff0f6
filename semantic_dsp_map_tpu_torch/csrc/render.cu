// Occupancy render reduction for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel _kernel of semantic_dsp_map_tpu/ops/render_pallas.py
// (render_core_pallas).  Oracle: render_core_plain in
// semantic_dsp_map_tpu_torch/ops/render.py.
//
// Per voxel of K slots it computes, in one pass: liveness against the
// scroll stamps, the pre-clamp weight sum, the clamped guessed-weight sum,
// the per-slot same-track sums, the argmax track with the lowest-track
// tie-break, the winning track's last-writer label and the occupancy code.
// It writes the clamped weight and the garbage-collected status back IN
// PLACE.
//
// What bounds it: device memory, and how little of it a map needs.  A slot
// holds 14 bytes that matter here (weight, stamp, track: 4 B each; status,
// label: 1 B each), but an empty slot's status says all there is to say, a
// stale slot's stamp too, and a map is mostly empty slots: a frame's store
// has a status set in about one slot of a hundred, in patches.  A thread per
// voxel that loads every field of its K slots before it looks at a status
// reads the whole store, about 1 GB a frame at VKITTI2 scale, where a
// quarter of that is needed.  Here a block owns a span of RENDER_NT * VPT
// neighbouring voxels, hence one contiguous run of the status array, and
// reads the store status first:
//   1. all status bytes of the span go to shared memory in 16-byte loads,
//      neighbouring threads on neighbouring addresses, and both voxel stamps
//      of each thread's VPT voxels to registers, all asked for before
//      anything waits;
//   2. the span is worked in sub-spans of RENDER_NT voxels, one a thread.  A
//      sub-span without a status set writes its results from the two voxel
//      stamps alone (free or unknown, no label, no track) and is done: most
//      of a map;
//   3. else a thread takes its voxel's K status bytes from shared memory and
//      loads the stamp only of the slots with a status set, then weight,
//      track and label only of the live ones, the K loads of a step in
//      flight together.  These loads are strided by K words across a warp;
//      that costs sectors only where slots are live, and on a store with
//      most slots alive it still reaches the memory rate, where staging the
//      three arrays through shared memory, a barrier after each, did not
//      (tried on an H100 at VKITTI2 scale with 58% of the slots alive: 0.64 and
//      0.84 ms against 0.42).
// Written back: a weight only where the clamp changes it (w > 1), a status
// only where the slot is collected; the same bytes in memory as writing every
// live slot, fewer sectors dirtied.  A voxel's slots are read and written by
// one thread only, the status after the block has copied it to shared memory,
// so the update in place is race-free.  The status array must be 16-byte
// aligned (whole tensors are; the others are held to the same); the last
// span and its last 16 bytes may be ragged and are masked.  No thread leaves
// before the two barriers.  80 registers at K = 7: three blocks an SM (with
// four the compiler spills and the full store takes a fifth longer).
//
// Every sum runs in slot order, and slot d's same-track sum starts from its
// own contribution and adds slots (d+1 .. d+K-1) mod K, the plain version's
// order, so the results match it bit for bit (ties in the argmax are
// decided by ==, so the order matters).
//
// Instances: K = 1, 3, 7, 15 and 31 (render_kernel<K>, the presets' and
// the main path's), and one generic instance for every other K
// (render_generic_kernel, below): a thread's K slots in registers stop
// scaling past K = 31, so there a warp shares a voxel, a slot a lane, in
// chunks of 32, with the same sums in the same order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr uint8_t STATUS_INVALID = 0;
constexpr uint8_t STATUS_UPDATED = 1;
constexpr uint8_t STATUS_GUESSED_BORN = 3;

constexpr int RENDER_NT = 256;

// Results of a voxel without a live slot: free or unknown from its stamps.
__device__ __forceinline__ void write_empty(
    long long v, int va, int vs, float thr, float init_w, int* __restrict__ occ_out,
    int* __restrict__ label_out, int* __restrict__ track_out, float* __restrict__ ws_out) {
  const bool vvalid = vs != 0 && vs >= va;
  const float ws = vvalid ? 0.f : -1.f;
  occ_out[v] = ws > thr ? 1 : (ws < 0.f ? -1 : (0.f >= init_w ? 2 : 0));
  label_out[v] = 0;
  track_out[v] = 0;
  ws_out[v] = ws;
}

template <int K>
__global__ void __launch_bounds__(RENDER_NT, K <= 7 ? 3 : 2) render_kernel(
    float* __restrict__ weight, const int* __restrict__ stamp,
    uint8_t* __restrict__ status, const int* __restrict__ track,
    const uint8_t* __restrict__ label, const int* __restrict__ vax,
    const int* __restrict__ vst,
    int* __restrict__ occ_out, int* __restrict__ label_out,
    int* __restrict__ track_out, float* __restrict__ ws_out,
    long long V, float thr, float init_w) {
  constexpr int VPT = K <= 7 ? 4 : 2;      // voxels a thread, sub-spans a block
  constexpr int SPAN = RENDER_NT * VPT;    // voxels a block; a multiple of 16
  constexpr int SUB = RENDER_NT * K;       // slots a sub-span; a multiple of 16
  constexpr int CHUNKS = SPAN * K / 16;    // 16-byte pieces of the span's status
  constexpr int ROUNDS = (CHUNKS + RENDER_NT - 1) / RENDER_NT;
  __shared__ __align__(16) uint8_t s_status[SPAN * K];
  __shared__ int s_any[VPT];               // a status set in the sub-span

  const int tid = threadIdx.x;
  const long long v0 = (long long)blockIdx.x * SPAN;
  const int nv = (int)(V - v0 < SPAN ? V - v0 : SPAN);
  // v0 * K is a multiple of 16: every whole group of 16 status bytes is
  // 16-byte aligned.
  const long long slot0 = v0 * K;
  const int nslots = nv * K;

  int va[VPT], vs[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int lv = i * RENDER_NT + tid;
    va[i] = lv < nv ? vax[v0 + lv] : 0;
    vs[i] = lv < nv ? vst[v0 + lv] : 0;
  }
  uint4 q[ROUNDS];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int li = 16 * (tid + r * RENDER_NT);
    q[r] = make_uint4(0u, 0u, 0u, 0u);  // 0 = INVALID beyond the store
    if (li + 15 < nslots) {
      q[r] = *reinterpret_cast<const uint4*>(status + slot0 + li);
    } else if (li < nslots) {
      unsigned w[4] = {0u, 0u, 0u, 0u};
      for (int j = 0; li + j < nslots; ++j) w[j / 4] |= (unsigned)status[slot0 + li + j] << (8 * (j % 4));
      q[r] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  if (tid < VPT) s_any[tid] = 0;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int c = tid + r * RENDER_NT;
    if (c < CHUNKS) {
      *reinterpret_cast<uint4*>(s_status + 16 * c) = q[r];
      if ((q[r].x | q[r].y | q[r].z | q[r].w) != 0u) s_any[16 * c / SUB] = 1;
    }
  }
  __syncthreads();

#pragma unroll 1
  for (int i = 0; i < VPT; ++i) {
    const int lv = i * RENDER_NT + tid;
    const long long v = v0 + lv;
    const bool mine = lv < nv;
    if (s_any[i] == 0) {  // uniform over the block
      if (mine) write_empty(v, va[i], vs[i], thr, init_w, occ_out, label_out, track_out, ws_out);
      continue;
    }
    if (!mine) continue;
    const uint8_t* my_status = s_status + i * SUB + tid * K;
    const long long base = v * K;
    // The voxel's own slots from here on: the stamp only of the slots with a
    // status set, weight, track and label only of the live ones, every load
    // of a step asked for before one is waited for.
    int st[K], sp[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      st[k] = my_status[k];
      sp[k] = 0;
      if (st[k] != STATUS_INVALID) sp[k] = stamp[base + k];
    }
    unsigned alive_bits = 0u;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (st[k] != STATUS_INVALID && sp[k] >= va[i]) alive_bits |= 1u << k;
    if (alive_bits == 0u) {
      write_empty(v, va[i], vs[i], thr, init_w, occ_out, label_out, track_out, ws_out);
    } else {
      const bool vvalid = vs[i] != 0 && vs[i] >= va[i];
      float w[K], wc[K], contrib[K];
      int tk[K], lb[K];
      bool alive[K], cmask[K], gc[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        alive[k] = (alive_bits >> k) & 1u;
        // a slot that is not alive adds nothing below, whatever it holds
        w[k] = 0.f;
        tk[k] = 0;
        lb[k] = 0;
        if (alive[k]) {
          w[k] = weight[base + k];
          tk[k] = track[base + k];
          lb[k] = label[base + k];
        }
      }
      float wsum = 0.f, gsum = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        wc[k] = w[k] > 1.f ? 1.f : w[k];
        const bool guessed = alive[k] && st[k] == STATUS_GUESSED_BORN;
        gc[k] = alive[k] && st[k] == STATUS_UPDATED && wc[k] < init_w;
        cmask[k] = alive[k] && !gc[k];
        contrib[k] = cmask[k] ? wc[k] : 0.f;
        wsum = wsum + (alive[k] ? w[k] : 0.f);
        gsum = gsum + (guessed ? wc[k] : 0.f);
      }

      float best_w = -1.f;
      float ts[K];
#pragma unroll
      for (int d = 0; d < K; ++d) {
        float acc = contrib[d];
#pragma unroll
        for (int s = 1; s < K; ++s) {
          const int nbr = (d + s) % K;
          acc = acc + (tk[d] == tk[nbr] ? contrib[nbr] : 0.f);
        }
        ts[d] = acc;
        if (cmask[d] && acc > 0.f && acc > best_w) best_w = acc;
      }
      const bool found = best_w > 0.f;
      int best_track = 1 << 30;
#pragma unroll
      for (int d = 0; d < K; ++d) {
        if (cmask[d] && ts[d] > 0.f && ts[d] == best_w && tk[d] < best_track) best_track = tk[d];
      }
      int pick = -1;
#pragma unroll
      for (int d = 0; d < K; ++d) {
        if (cmask[d] && tk[d] == best_track) {
          const int code = (d << 8) | (lb[d] & 0xFF);
          if (code > pick) pick = code;
        }
      }
      int best_label = pick >= 0 ? (pick & 0xFF) : 0;
      if (!(found && vvalid)) {
        best_track = 0;
        best_label = 0;
      }
      const float ws = vvalid ? wsum : -1.f;
      const float gw = vvalid ? gsum : 0.f;
      const int occ = ws > thr ? 1 : (ws < 0.f ? -1 : (gw >= init_w ? 2 : 0));

      occ_out[v] = occ;
      label_out[v] = best_label;
      track_out[v] = best_track;
      ws_out[v] = ws;
      if (vvalid) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (alive[k] && w[k] > 1.f) weight[base + k] = wc[k];
          if (gc[k]) status[base + k] = STATUS_INVALID;
        }
      }
    }
  }
}

// The generic instance, for every K past 31 (63 slots a voxel and more; the
// config allows up to 2^31 slots in all).  The design above holds a voxel's
// K slots in one thread's registers and a span's status in shared memory,
// SPAN * K bytes: at K = 31 that already takes 128 registers and spills,
// and at K = 127 the static array passes 48 KB.  Here the lanes of a warp
// share a voxel instead, a slot a lane, and walk its slots in chunks of 32,
// so no array grows with K, in registers or in shared memory (none is
// used):
//   1. a warp owns GEN_SPAN neighbouring voxels, one contiguous run of
//      GEN_SPAN * K status bytes that starts on a 16-byte boundary, and
//      reads it in 16-byte loads, neighbouring lanes on neighbouring
//      addresses; a span without a status set writes its voxels' results
//      from their stamps, as most of a map;
//   2. else the warp takes the span's voxels one after another, each in
//      three passes over its chunks, a slot a lane, neighbouring lanes on
//      neighbouring words (a voxel's run is not 16-byte aligned for odd K):
//        a. liveness, the pre-clamp and guessed-weight sums, accumulated
//           in slot order: every lane adds the chunk's 32 terms one after
//           another, each broadcast by a shuffle, so every lane holds the
//           same sums, with the plain version's bits;
//        b. the same-track sums: the lane that owns slot d adds slots
//           d+1 .. d+K-1 mod K in that order, the rest of its own chunk
//           (by shuffle), then the other chunks in turn from d's on,
//           wrapping (each read again, a slot a lane, and broadcast), then
//           the head of its own chunk; then the argmax with the
//           lowest-track tie-break, kept as a running (sum, track) pair a
//           lane and reduced across the warp: the order it decides by is
//           total, so any reduction order gives the same pair;
//        c. the last-writer label (the highest slot index of the winning
//           track, a max over the warp) and the write-back in place of what
//           changes, each slot by the lane that read it.
// The K^2 work of (b) is spread over the lanes without moving a bit.  Slot
// offsets are 64-bit (v * K passes 2^31 on a full grid at K = 255).  What
// bounds it is the same as above, device memory: on an H100 at the full
// VKITTI2 grid at K = 63 (a real store, 0.2% of its slots with a status)
// it took 0.49 ms against a bound of 0.22 ms.
constexpr int GEN_NT = 256;
constexpr int GEN_SPAN = 16;  // voxels a warp; GEN_SPAN * K is a multiple of 16

// One slot's view for the render: what (a) to (c) compute from it.
struct Slot {
  bool in, alive, gc, cmask;
  uint8_t st;
  float w, wc, contrib;
  int tk;
};

__device__ __forceinline__ Slot load_slot(
    const float* __restrict__ weight, const int* __restrict__ stamp,
    const uint8_t* __restrict__ status, const int* __restrict__ track, long long base, int k,
    int K, int va, float init_w) {
  Slot s;
  s.in = k < K;
  s.st = s.in ? status[base + k] : STATUS_INVALID;
  s.alive = s.st != STATUS_INVALID && stamp[base + k] >= va;
  s.w = s.alive ? weight[base + k] : 0.f;
  s.tk = s.alive ? track[base + k] : 0;
  s.wc = s.w > 1.f ? 1.f : s.w;
  s.gc = s.alive && s.st == STATUS_UPDATED && s.wc < init_w;
  s.cmask = s.alive && !s.gc;
  s.contrib = s.cmask ? s.wc : 0.f;
  return s;
}

__global__ void __launch_bounds__(GEN_NT) render_generic_kernel(
    float* __restrict__ weight, const int* __restrict__ stamp,
    uint8_t* __restrict__ status, const int* __restrict__ track,
    const uint8_t* __restrict__ label, const int* __restrict__ vax,
    const int* __restrict__ vst,
    int* __restrict__ occ_out, int* __restrict__ label_out,
    int* __restrict__ track_out, float* __restrict__ ws_out,
    long long V, int K, float thr, float init_w) {
  constexpr unsigned ALL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long v0 = ((long long)blockIdx.x * (GEN_NT / 32) + threadIdx.x / 32) * GEN_SPAN;
  if (v0 >= V) return;  // a whole warp
  const int nv = (int)(V - v0 < GEN_SPAN ? V - v0 : GEN_SPAN);
  const int C = (K + 31) / 32;  // chunks of a voxel

  // 1. the span's status, 16 bytes a lane (v0 * K is a multiple of 16)
  const long long slot0 = v0 * K;
  const long long nslots = (long long)nv * K;
  unsigned any = 0u;
  for (long long li = 16LL * lane; li < nslots; li += 16 * 32) {
    if (li + 15 < nslots) {
      const uint4 q = *reinterpret_cast<const uint4*>(status + slot0 + li);
      any |= q.x | q.y | q.z | q.w;
    } else {
      for (long long j = li; j < nslots; ++j) any |= status[slot0 + j];
    }
  }
  const int va_l = lane < nv ? vax[v0 + lane] : 0;
  const int vs_l = lane < nv ? vst[v0 + lane] : 0;
  if (!__any_sync(ALL, any != 0u)) {
    if (lane < nv) write_empty(v0 + lane, va_l, vs_l, thr, init_w, occ_out, label_out, track_out, ws_out);
    return;
  }

  // 2. the span's voxels in turn, the warp on one voxel
  for (int i = 0; i < nv; ++i) {
    const long long v = v0 + i;
    const int va = __shfl_sync(ALL, va_l, i);
    const int vs = __shfl_sync(ALL, vs_l, i);
    const long long base = v * K;
    // a. liveness and the two sums in slot order
    float wsum = 0.f, gsum = 0.f;
    bool any_alive = false;
    for (int c0 = 0; c0 < K; c0 += 32) {
      const Slot s = load_slot(weight, stamp, status, track, base, c0 + lane, K, va, init_w);
      const float wt = s.alive ? s.w : 0.f;
      const float gt = s.alive && s.st == STATUS_GUESSED_BORN ? s.wc : 0.f;
      const int n = K - c0 < 32 ? K - c0 : 32;
      for (int j = 0; j < n; ++j) {
        wsum = wsum + __shfl_sync(ALL, wt, j);
        gsum = gsum + __shfl_sync(ALL, gt, j);
      }
      any_alive = __any_sync(ALL, s.alive) || any_alive;
    }
    if (!any_alive) {
      if (lane == 0) write_empty(v, va, vs, thr, init_w, occ_out, label_out, track_out, ws_out);
      continue;
    }
    const bool vvalid = vs != 0 && vs >= va;

    // b. per-slot same-track sums and the running argmax
    float best_w = -1.f;
    int best_tk = 1 << 30;
    for (int c = 0; c < C; ++c) {
      const int c0 = 32 * c;
      const Slot own = load_slot(weight, stamp, status, track, base, c0 + lane, K, va, init_w);
      const int n_own = K - c0 < 32 ? K - c0 : 32;
      float acc = own.contrib;
      for (int j = 0; j < n_own; ++j) {  // the rest of the own chunk: d+1 ..
        const int t = __shfl_sync(ALL, own.tk, j);
        const float cj = __shfl_sync(ALL, own.contrib, j);
        if (j > lane) acc = acc + (own.tk == t ? cj : 0.f);
      }
      for (int m = 1; m < C; ++m) {  // the other chunks, from the own one's next on
        const int o0 = 32 * ((c + m) % C);
        const Slot o = load_slot(weight, stamp, status, track, base, o0 + lane, K, va, init_w);
        const int n = K - o0 < 32 ? K - o0 : 32;
        for (int j = 0; j < n; ++j) {
          const int t = __shfl_sync(ALL, o.tk, j);
          const float cj = __shfl_sync(ALL, o.contrib, j);
          acc = acc + (own.tk == t ? cj : 0.f);
        }
      }
      for (int j = 0; j < n_own; ++j) {  // the head of the own chunk: .. d-1
        const int t = __shfl_sync(ALL, own.tk, j);
        const float cj = __shfl_sync(ALL, own.contrib, j);
        if (j < lane) acc = acc + (own.tk == t ? cj : 0.f);
      }
      if (own.in && own.cmask && acc > 0.f) {
        if (acc > best_w) {
          best_w = acc;
          best_tk = own.tk;
        } else if (acc == best_w && own.tk < best_tk) {
          best_tk = own.tk;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ow = __shfl_xor_sync(ALL, best_w, off);
      const int ot = __shfl_xor_sync(ALL, best_tk, off);
      if (ow > best_w || (ow == best_w && ot < best_tk)) {
        best_w = ow;
        best_tk = ot;
      }
    }
    const bool found = best_w > 0.f;

    // c. the winning track's last writer, and the write-back
    int pick = -1;
    for (int c0 = 0; c0 < K; c0 += 32) {
      const int k = c0 + lane;
      const Slot s = load_slot(weight, stamp, status, track, base, k, K, va, init_w);
      if (s.in && s.cmask && s.tk == best_tk) {
        const int code = (k << 8) | label[base + k];
        if (code > pick) pick = code;
      }
      if (vvalid) {
        if (s.alive && s.w > 1.f) weight[base + k] = s.wc;
        if (s.gc) status[base + k] = STATUS_INVALID;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) pick = max(pick, __shfl_xor_sync(ALL, pick, off));
    if (lane == 0) {
      int best_track = best_tk;
      int best_label = pick >= 0 ? (pick & 0xFF) : 0;
      if (!(found && vvalid)) {
        best_track = 0;
        best_label = 0;
      }
      const float ws = vvalid ? wsum : -1.f;
      const float gw = vvalid ? gsum : 0.f;
      occ_out[v] = ws > thr ? 1 : (ws < 0.f ? -1 : (gw >= init_w ? 2 : 0));
      label_out[v] = best_label;
      track_out[v] = best_track;
      ws_out[v] = ws;
    }
  }
}

int launch_generic(float* weight, const int* stamp, uint8_t* status, const int* track,
                   const uint8_t* label, const int* vax, const int* vst, int* occ, int* lab,
                   int* trk, float* ws, long long V, int K, float thr, float init_w,
                   cudaStream_t stream) {
  constexpr long long VOX = (GEN_NT / 32) * GEN_SPAN;  // voxels a block
  const long long grid = (V + VOX - 1) / VOX;
  static CUfunction fn = nullptr;
  return dsp::launch(render_generic_kernel, fn, (unsigned)grid, GEN_NT, 0, stream, weight, stamp,
                     status, track, label, vax, vst, occ, lab, trk, ws, V, K, thr, init_w);
}

template <int K>
int launch(float* weight, const int* stamp, uint8_t* status, const int* track,
           const uint8_t* label, const int* vax, const int* vst, int* occ,
           int* lab, int* trk, float* ws, long long V, float thr, float init_w,
           cudaStream_t stream) {
  constexpr int SPAN = RENDER_NT * (K <= 7 ? 4 : 2);
  const long long grid = (V + SPAN - 1) / SPAN;
  static CUfunction fn = nullptr;
  return dsp::launch(render_kernel<K>, fn, (unsigned)grid, RENDER_NT, 0, stream,
                     weight, stamp, status, track, label, vax, vst, occ, lab,
                     trk, ws, V, thr, init_w);
}

}  // namespace

extern "C" int dsp_render(
    float* weight, const int* stamp, uint8_t* status, const int* track,
    const uint8_t* label, const int* vax, const int* vst, int* occ, int* lab,
    int* trk, float* ws, long long V, int K, float thr, float init_w,
    void* stream) {
  if (V <= 0) return (int)cudaErrorInvalidValue;
  // the kernel loads the status 16 bytes at a time; one rule for the store
  const uintptr_t store = (uintptr_t)weight | (uintptr_t)stamp | (uintptr_t)status |
                          (uintptr_t)track | (uintptr_t)label;
  if (store % 16 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
    case 1: return launch<1>(weight, stamp, status, track, label, vax, vst, occ, lab, trk, ws, V, thr, init_w, s);
    case 3: return launch<3>(weight, stamp, status, track, label, vax, vst, occ, lab, trk, ws, V, thr, init_w, s);
    case 7: return launch<7>(weight, stamp, status, track, label, vax, vst, occ, lab, trk, ws, V, thr, init_w, s);
    case 15: return launch<15>(weight, stamp, status, track, label, vax, vst, occ, lab, trk, ws, V, thr, init_w, s);
    case 31: return launch<31>(weight, stamp, status, track, label, vax, vst, occ, lab, trk, ws, V, thr, init_w, s);
    default:
      if (K <= 0) return (int)cudaErrorInvalidValue;
      return launch_generic(weight, stamp, status, track, label, vax, vst, occ, lab, trk, ws, V, K, thr, init_w, s);
  }
}

extern "C" const char* dsp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
