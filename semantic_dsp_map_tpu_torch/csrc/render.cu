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
// scaling past K = 31, so there a block streams a span's status and its
// warps share the voxels that have one, a warp a voxel and a slot a lane,
// with the same sums over the slots that add to them.

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
// SPAN * K bytes: at K = 31 that already takes 128 registers and spills, and
// at K = 127 the static array passes 48 KB.  Here nothing grows with K:
//   a. a block of GEN_NT threads owns a span of GEN_SPAN neighbouring
//      voxels, one contiguous run of GEN_SPAN * K status bytes that starts
//      on a 16-byte boundary.  Each thread asks for its voxel's two stamps,
//      then the span's status is streamed in 16-byte pieces, GEN_PIECES a
//      thread in flight before any is tested (as the generic scans of
//      observe.cu stream the same array).  A non-zero piece, rare on a real
//      store, sets the bits of the voxels whose bytes are set in a bitmap
//      of the span in shared memory (atomicOr);
//   b. a voxel without a status, or whose stamps make it invalid, is
//      written from its two stamps alone, a thread a voxel, each result
//      array in one coalesced store a block: most of a map.  An invalid
//      voxel's results are its stamps' whatever its slots hold, and the
//      plain version changes none of its slots;
//   c. the other voxels, those with a status, are listed in shared memory
//      (a ballot a warp, a popcount) and the block's warps take them in
//      turn, so a patch of them does not hold one warp while the others
//      idle;
//   d. a warp reads its voxel once, two chunks of 32 slots a step, a slot a
//      lane, every load of a kind asked for before one is waited on: the
//      status, the stamp only where a status is set, weight, track and
//      label only where the slot is alive.  The sums run over the alive
//      slots in slot order (each broadcast by a shuffle, the set bits of a
//      ballot, so every lane holds them), the clamped weights and the
//      collected statuses are written back by the lane that owns the slot,
//      and the contributing slots (alive and not collected) go to the
//      warp's buffer in shared memory in slot order (ballot + popcount):
//      track, clamped weight and (slot << 8 | label).  Then each lane takes
//      entries d of the buffer and adds, to d's own weight, the entries of
//      d's track after d in slot order and then those before it: the plain
//      version's cyclic order d+1 .. K-1, 0 .. d-1 with the other slots
//      left out, L^2 work for L contributing slots instead of K^2.  Then
//      the running (sum, lowest track) argmax, reduced over the warp (the
//      order it decides by is total, so any reduction order gives the same
//      pair), and the last writer: the largest (slot << 8 | label) of the
//      winning track.
// The buffer holds GEN_CAP entries a warp.  A voxel with more contributing
// slots works in rounds of GEN_CAP: its entries are read again from the
// store for each round they are needed in (the own entries, those after
// them, those before them), in the same order, so the sums keep their bits.
// At K <= 127 no voxel needs a second round; GEN_CAP = 128 keeps the
// buffers at 12 KB a block, so four blocks of 256 threads fit an SM and
// keep enough of the status stream in flight (ptxas, sm_90a: 64 registers,
// no spill, 17,984 bytes of shared memory).
//
// Left out and still the plain version's bits: the plain version adds
// +0.0 for every slot that is not alive (to the weight and guessed sums)
// and for every slot of another track or outside the contributing mask (to
// a same-track sum).  x + (+0.0) has the bits of x unless x is -0.0.  The
// weight and guessed sums start at +0.0, and a sum that starts at +0.0
// never becomes -0.0 under round-to-nearest, so they keep every bit; a NaN
// stays a NaN either way.  A same-track sum may start at -0.0 (a
// contributing slot of weight -0.0), so left without the +0.0 terms it may
// differ in the sign of a zero; but it is only compared (> 0, >, ==), where
// -0.0 == +0.0.  A contributing slot of weight zero stays in the buffer: it
// takes part in the argmax's test and in the last-writer pick.
// Slot offsets are 64-bit (v * K passes 2^31 on a full grid at K = 255).
constexpr int GEN_NT = 256;               // threads a block
constexpr int GEN_SPAN = GEN_NT;          // voxels a block, a thread each
constexpr int GEN_WARPS = GEN_NT / 32;
constexpr int GEN_PIECES = 4;             // 16-byte status pieces a thread in flight
constexpr int GEN_J = 4;                  // a lane's own entries of a round
constexpr int GEN_CAP = 32 * GEN_J;       // entries of a warp's buffer

// A warp's buffer of contributing slots, in slot order.
struct Entries {
  int* track;
  float* contrib;
  int* code;  // slot << 8 | label
};

// Sets the bits of the voxels whose status bytes are set in the piece `q`
// of the span's status, slots li .. li + 15 of the span.
__device__ __forceinline__ void mark_set(uint4 q, long long li, int K, unsigned* s_set) {
  const unsigned word[4] = {q.x, q.y, q.z, q.w};
  int lv = (int)(li / K), r = (int)(li % K), last = -1;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (((word[j >> 2] >> (8 * (j & 3))) & 0xffu) != 0u && lv != last) {
      atomicOr(&s_set[lv >> 5], 1u << (lv & 31));
      last = lv;
    }
    if (++r == K) {
      r = 0;
      ++lv;
    }
  }
}

// One pass over the K slots at `base`, two chunks of 32 a step, a slot a
// lane.  The contributing slots of rank r0 .. r0 + GEN_CAP - 1 go to the
// warp's buffer (index rank - r0); returns how many contributing slots the
// voxel has (with FIRST), or at least r0 + GEN_CAP (a refill stops there).
// FIRST: also the weight and guessed sums in slot order, and the write-back
// of the clamped weights and the collected statuses (the voxel is valid).
// A refill reads the written-back store: the collected slots are then no
// longer alive and the clamped weights clamp to the same bits, so it finds
// the same entries.
template <bool FIRST>
__device__ __forceinline__ int render_scan(
    float* __restrict__ weight, const int* __restrict__ stamp, uint8_t* __restrict__ status,
    const int* __restrict__ track, const uint8_t* __restrict__ label, long long base, int K,
    int va, float init_w, int r0, Entries buf, float& wsum, float& gsum) {
  constexpr unsigned ALL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  int n = 0;  // contributing slots so far, the same in every lane
  for (int c0 = 0; c0 < K; c0 += 64) {
    if (!FIRST && n >= r0 + GEN_CAP) break;
    int st[2], tk[2], lb[2];
    bool alive[2];
    float w[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = c0 + 32 * h + lane;
      st[h] = k < K ? status[base + k] : STATUS_INVALID;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      alive[h] = st[h] != STATUS_INVALID && stamp[base + c0 + 32 * h + lane] >= va;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long i = base + c0 + 32 * h + lane;
      w[h] = alive[h] ? weight[i] : 0.f;
      tk[h] = alive[h] ? track[i] : 0;
      lb[h] = alive[h] ? label[i] : 0;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = c0 + 32 * h + lane;
      const float wc = w[h] > 1.f ? 1.f : w[h];
      const bool guessed = alive[h] && st[h] == STATUS_GUESSED_BORN;
      const bool gc = alive[h] && st[h] == STATUS_UPDATED && wc < init_w;
      const bool cmask = alive[h] && !gc;
      if (FIRST) {
        for (unsigned m = __ballot_sync(ALL, alive[h]); m != 0u; m &= m - 1u)
          wsum = wsum + __shfl_sync(ALL, w[h], __ffs(m) - 1);
        for (unsigned m = __ballot_sync(ALL, guessed); m != 0u; m &= m - 1u)
          gsum = gsum + __shfl_sync(ALL, wc, __ffs(m) - 1);
        if (alive[h] && w[h] > 1.f) weight[base + k] = wc;
        if (gc) status[base + k] = STATUS_INVALID;
      }
      const unsigned cm = __ballot_sync(ALL, cmask);
      const int e = n + __popc(cm & lt) - r0;
      if (cmask && e >= 0 && e < GEN_CAP) {
        buf.track[e] = tk[h];
        buf.contrib[e] = wc;
        buf.code[e] = (k << 8) | lb[h];
      }
      n += __popc(cm);
    }
  }
  return n;
}

// Adds the buffer's n entries (ranks g0 .. g0 + n - 1) to the same-track
// sums of the lane's own entries (ranks d0 + 32 j + lane, j < nj): those
// after an own entry (AFTER) or before it, in slot order.
template <bool AFTER>
__device__ __forceinline__ void add_entries(const Entries& buf, int n, int g0, int d0, int nj,
                                            const int (&t)[GEN_J], float (&acc)[GEN_J]) {
  const int lane = threadIdx.x & 31;
  for (int e = 0; e < n; ++e) {
    const int te = buf.track[e];
    const float ce = buf.contrib[e];
    const int g = g0 + e;
#pragma unroll
    for (int j = 0; j < GEN_J; ++j) {
      const int d = d0 + 32 * j + lane;
      if (j < nj && (AFTER ? g > d : g < d) && te == t[j]) acc[j] = acc[j] + ce;
    }
  }
}

// Steps c-d for one valid voxel with a status, by one warp; the results go
// to lane 0's references.
__device__ __forceinline__ void render_voxel(
    float* __restrict__ weight, const int* __restrict__ stamp, uint8_t* __restrict__ status,
    const int* __restrict__ track, const uint8_t* __restrict__ label, long long base, int K,
    int va, float thr, float init_w, Entries buf, int& occ, int& lab, int& trk, float& ws) {
  constexpr unsigned ALL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  float wsum = 0.f, gsum = 0.f;
  const int L = render_scan<true>(weight, stamp, status, track, label, base, K, va, init_w, 0,
                                  buf, wsum, gsum);
  __syncwarp();
  const int rounds = (L + GEN_CAP - 1) / GEN_CAP;
  int held = 0;  // the round the buffer holds
  auto hold = [&](int r) {
    if (held == r) return;
    __syncwarp();
    float unused = 0.f;
    render_scan<false>(weight, stamp, status, track, label, base, K, va, init_w, r * GEN_CAP, buf,
                       unused, unused);
    __syncwarp();
    held = r;
  };
  auto size = [&](int r) { return L - r * GEN_CAP < GEN_CAP ? L - r * GEN_CAP : GEN_CAP; };

  // the same-track sums of each round's entries, and the running argmax
  float best_w = -1.f;
  int best_tk = 1 << 30;
  for (int ro = 0; ro < rounds; ++ro) {
    hold(ro);
    const int n_own = size(ro), nj = (n_own + 31) / 32, d0 = ro * GEN_CAP;
    int t[GEN_J];
    float acc[GEN_J];
#pragma unroll
    for (int j = 0; j < GEN_J; ++j) {
      const int e = 32 * j + lane;
      t[j] = e < n_own ? buf.track[e] : 0;
      acc[j] = e < n_own ? buf.contrib[e] : 0.f;
    }
    for (int r = ro; r < rounds; ++r) {  // the entries after an own one
      hold(r);
      add_entries<true>(buf, size(r), r * GEN_CAP, d0, nj, t, acc);
    }
    for (int r = 0; r <= ro; ++r) {  // then those before it
      hold(r);
      add_entries<false>(buf, size(r), r * GEN_CAP, d0, nj, t, acc);
    }
#pragma unroll
    for (int j = 0; j < GEN_J; ++j) {
      if (32 * j + lane < n_own && acc[j] > 0.f) {
        if (acc[j] > best_w) {
          best_w = acc[j];
          best_tk = t[j];
        } else if (acc[j] == best_w && t[j] < best_tk) {
          best_tk = t[j];
        }
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

  // the winning track's last writer
  int pick = -1;
  if (found) {
    for (int r = rounds - 1; r >= 0; --r) {
      hold(r);
      for (int e = lane; e < size(r); e += 32)
        if (buf.track[e] == best_tk && buf.code[e] > pick) pick = buf.code[e];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) pick = max(pick, __shfl_xor_sync(ALL, pick, off));
  }
  __syncwarp();  // the buffer is read until here
  ws = wsum;
  occ = wsum > thr ? 1 : (wsum < 0.f ? -1 : (gsum >= init_w ? 2 : 0));
  trk = found ? best_tk : 0;
  lab = found && pick >= 0 ? (pick & 0xFF) : 0;
}

__global__ void __launch_bounds__(GEN_NT, 4) render_generic_kernel(
    float* __restrict__ weight, const int* __restrict__ stamp,
    uint8_t* __restrict__ status, const int* __restrict__ track,
    const uint8_t* __restrict__ label, const int* __restrict__ vax,
    const int* __restrict__ vst,
    int* __restrict__ occ_out, int* __restrict__ label_out,
    int* __restrict__ track_out, float* __restrict__ ws_out,
    long long V, int K, float thr, float init_w) {
  constexpr unsigned ALL = 0xffffffffu;
  __shared__ unsigned s_set[GEN_WARPS];  // a bit a voxel with a status byte set
  __shared__ int s_count[GEN_WARPS];     // the live voxels of a warp's 32
  __shared__ short s_list[GEN_SPAN];     // the live voxels, in order
  __shared__ int s_va[GEN_SPAN];
  __shared__ int s_occ[GEN_SPAN], s_lab[GEN_SPAN], s_trk[GEN_SPAN];
  __shared__ float s_ws[GEN_SPAN];
  __shared__ int s_etrack[GEN_WARPS][GEN_CAP], s_ecode[GEN_WARPS][GEN_CAP];
  __shared__ float s_econtrib[GEN_WARPS][GEN_CAP];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long v0 = (long long)blockIdx.x * GEN_SPAN;
  const int nv = (int)(V - v0 < GEN_SPAN ? V - v0 : GEN_SPAN);
  // v0 * K is a multiple of 16: every whole piece is 16-byte aligned.
  const long long slot0 = v0 * K, nslots = (long long)nv * K;
  const int va = tid < nv ? vax[v0 + tid] : 0;
  const int vs = tid < nv ? vst[v0 + tid] : 0;
  if (tid < GEN_WARPS) s_set[tid] = 0u;
  __syncthreads();

  // a. the span's status, GEN_PIECES pieces a thread at once (0 = INVALID
  // beyond the store)
  const long long pieces = (nslots + 15) / 16;
  for (long long p0 = tid; p0 < pieces; p0 += (long long)GEN_NT * GEN_PIECES) {
    uint4 q[GEN_PIECES];
#pragma unroll
    for (int u = 0; u < GEN_PIECES; ++u) {
      const long long li = 16 * (p0 + (long long)u * GEN_NT);
      q[u] = make_uint4(0u, 0u, 0u, 0u);
      if (li + 15 < nslots) {
        q[u] = *reinterpret_cast<const uint4*>(status + slot0 + li);
      } else if (li < nslots) {
        unsigned w[4] = {0u, 0u, 0u, 0u};
        for (int j = 0; li + j < nslots; ++j) w[j / 4] |= (unsigned)status[slot0 + li + j] << (8 * (j % 4));
        q[u] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < GEN_PIECES; ++u)
      if ((q[u].x | q[u].y | q[u].z | q[u].w) != 0u)
        mark_set(q[u], 16 * (p0 + (long long)u * GEN_NT), K, s_set);
  }
  __syncthreads();

  // b-c. the valid voxels with a status, listed in order
  const bool vvalid = vs != 0 && vs >= va;
  const bool live = tid < nv && vvalid && ((s_set[warp] >> lane) & 1u);
  const unsigned lw = __ballot_sync(ALL, live);
  if (lane == 0) s_count[warp] = __popc(lw);
  s_va[tid] = va;
  __syncthreads();
  int off = 0, total = 0;
#pragma unroll
  for (int w = 0; w < GEN_WARPS; ++w) {
    off += w < warp ? s_count[w] : 0;
    total += s_count[w];
  }
  if (live) s_list[off + __popc(lw & ((1u << lane) - 1u))] = (short)tid;
  __syncthreads();

  // d. a warp a listed voxel, the warps in turn
  const Entries buf{s_etrack[warp], s_econtrib[warp], s_ecode[warp]};
  for (int i = warp; i < total; i += GEN_WARPS) {
    const int lv = s_list[i];
    int occ, lab, trk;
    float ws;
    render_voxel(weight, stamp, status, track, label, (v0 + lv) * K, K, s_va[lv], thr, init_w,
                 buf, occ, lab, trk, ws);
    if (lane == 0) {
      s_occ[lv] = occ;
      s_lab[lv] = lab;
      s_trk[lv] = trk;
      s_ws[lv] = ws;
    }
  }
  __syncthreads();

  // the results, a thread a voxel
  if (tid < nv) {
    const long long v = v0 + tid;
    if (live) {
      occ_out[v] = s_occ[tid];
      label_out[v] = s_lab[tid];
      track_out[v] = s_trk[tid];
      ws_out[v] = s_ws[tid];
    } else {
      write_empty(v, va, vs, thr, init_w, occ_out, label_out, track_out, ws_out);
    }
  }
}

int launch_generic(float* weight, const int* stamp, uint8_t* status, const int* track,
                   const uint8_t* label, const int* vax, const int* vst, int* occ, int* lab,
                   int* trk, float* ws, long long V, int K, float thr, float init_w,
                   cudaStream_t stream) {
  const long long grid = (V + GEN_SPAN - 1) / GEN_SPAN;
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
