// Birth's block merge for Hopper (sm_90a), plain C interface: the merge
// stage of _insert_core, which every path that inserts particles runs
// (birth, the moving-object cleanup, the template stages, the sharded step).
//
// Replaces the merge that XLA fuses out of semantic_dsp_map_tpu/ops/birth.py
// (_insert_core, lines 279-402: lane shifts on the [A, spb] layout), which
// has no pl.pallas_call of its own.  Oracle: merge_blocks_plain in
// semantic_dsp_map_tpu_torch/ops/birth.py, some 400 small PyTorch launches
// a call on the card (row gathers, the stale prune, the resample walk, a
// cumsum along K, gathers, selects, row scatters); this is one launch.
//
// One thread per (block row a, voxel j of the block), A x bv threads.  The
// thread works on its voxel's K slots in registers:
//   1. a padding row (ids[a] >= nb) is skipped: the plain version's scatter
//      sends padding rows to a real row with that row's own bytes (or, with
//      no real row, to the last row with its current bytes), the same store;
//   2. it reads what the merge decides on: the K slots' status and stamp,
//      the voxel's scroll stamp and the K staged candidates' meta;
//   3. the stale prune: a slot with a status set and a stamp below the
//      voxel's scroll stamp becomes INVALID, BEFORE the resample reads the
//      status (the plain version prunes first, so the walk never sees a
//      stale UPDATED particle);
//   4. with resample on and at least one staged candidate, it reads the K
//      weights and runs the resample walk of resample_slots (below);
//   5. the first-vacant merge: the vacant slot with vacant-rank c takes
//      staged candidate c where its meta >= 0; meta unpacks as the plain
//      version's (& 0xFFFF track, >> 16 & 0xFF label, >> 24 & 0x7 status,
//      >> 27 & 0x7 forget);
//   6. it writes in place what changed: the nine fields of a slot that took
//      a candidate, else the status where the prune or the walk changed it
//      and the weight where the walk set it.  The plain version writes every
//      field of every slot back, the unchanged ones with their own bytes:
//      the same store.  It adds its accepted count (staged candidates r with
//      r < the voxel's vacancy count) to a 64-bit device counter: one atomic
//      a warp.  The count is an integer, so the order of the atomics changes
//      nothing.
// Real block ids are unique (listed ascending from a sorted stream), so
// each slot has one writer and the in-place writes do not race.
//
// Bit-equality hazards, each kept as the plain version computes it (the
// library is built with -fmad=false, so nothing is contracted):
//   - the walk's sums are sequential f32 additions in slot order, a
//     not-UPDATED slot adding +0.0 as torch.where does;
//   - wpp = min(wsum / trigger, 1): PyTorch's CUDA division of a tensor by
//     a Python scalar multiplies by the scalar's f32 reciprocal, and this
//     does the same (trigger is a power of two: both forms are exact);
//     torch.clamp passes a NaN through, and so does this;
//   - the threshold advances through at most K + 8 additions of wpp
//     (semantic_dsp_map.h:1505-1510): the plain version's bounded loop of
//     selects.  Its condition cannot turn true again once false (nothing
//     changes then), so leaving the bounded loop at the first false one
//     gives the same bits;
//   - the wipe applies when wsum < 0.01f (PyTorch compares an f32 tensor
//     with a Python scalar in f32).
//
// What bounds it: device memory.  A real row's slots' status, stamp and
// staged meta are read (9 B a slot), the weights of a resampled voxel
// (4 B a slot), and each accepted candidate's staged position, weight and
// stamp (20 B); what changes is written: a status byte, a resampled weight,
// the 27 B of a slot that took a candidate.  At VKITTI2's birth (1536 rows
// of 448 slots) that is about 10 MB, 0.003 ms at 3.35 TB/s.  A warp's 32
// voxels are 32 * K neighbouring slots, so its strided loads of one slot
// index touch the same lines as its loads of the next; L1 keeps them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int STATUS_INVALID = 0;  // state.py
constexpr int STATUS_UPDATED = 1;  // state.py
constexpr int BLOCK = 256;

struct Store {
  float* px;
  float* py;
  float* pz;
  float* weight;
  uint8_t* label;
  int* track;
  uint8_t* status;
  uint8_t* forget;
  int* stamp;
};

struct Staged {
  const float* px;
  const float* py;
  const float* pz;
  const float* w;
  const int* stamp;
  const int* meta;
};

// resampleParticlesInVoxel (semantic_dsp_map.h:1448-1519) on one voxel's
// K slots, as ops/birth.py's resample_slots computes it for a targeted
// voxel: only UPDATED slots take part; the voxel resamples iff more than
// `trigger` of them are UPDATED, wiped if their weight sum is below 0.01,
// else the keep/delete walk in slot order.
// Returns the slots whose weight the walk set, a bit a slot.
template <int K>
__device__ __forceinline__ unsigned resample(int (&st)[K], float (&w)[K], int trigger,
                                             float inv_trigger) {
  bool upd[K];
  float wsum = 0.f;
  int count = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    upd[k] = st[k] == STATUS_UPDATED;
    wsum = wsum + (upd[k] ? w[k] : 0.f);
    count += upd[k];
  }
  if (!(count > trigger)) return 0u;
  if (wsum < 0.01f) {  // wipe
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (upd[k]) st[k] = STATUS_INVALID;
    return 0u;
  }
  const float q = wsum * inv_trigger;
  const float wpp = q != q ? q : fminf(q, 1.f);
  float csum = 0.f;
  float thresh = wpp;
  unsigned kept = 0u;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (!upd[k]) continue;  // neither the sums nor the threshold move
    const float csum_k = csum + w[k];
    if (csum_k < thresh) {
      st[k] = STATUS_INVALID;
    } else {
      float next = thresh + wpp;
      for (int i = 0; i < K + 8; ++i) {
        if (!(csum_k > next)) break;
        next = next + wpp;
      }
      w[k] = wpp;
      kept |= 1u << k;
      thresh = next;
    }
    csum = csum_k;
  }
  return kept;
}

template <int K>
__global__ void __launch_bounds__(BLOCK) merge_kernel(
    Store s, Staged in, const int* __restrict__ vax, const long long* __restrict__ ids,
    unsigned long long* __restrict__ accepted, long long rows, int bv_log2, long long nb,
    int do_resample, int trigger, float inv_trigger) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  unsigned acc = 0;
  const long long id = i < (rows << bv_log2) ? ids[i >> bv_log2] : nb;
  if (id < nb) {
    const long long vox = (id << bv_log2) + (i & ((1LL << bv_log2) - 1));
    const long long base = vox * K;
    const long long sbase = i * K;  // the staged [A, bv, K] buffers
    const int va = vax[vox];
    int st[K], old[K], meta[K];
    float w[K];
    bool any_staged = false;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      st[k] = old[k] = s.status[base + k];
      meta[k] = in.meta[sbase + k];
      any_staged = any_staged || meta[k] >= 0;
      // Stale slots count as vacant and are pruned (operations.h:810-816).
      if (st[k] != STATUS_INVALID && s.stamp[base + k] < va) st[k] = STATUS_INVALID;
    }
    unsigned kept = 0u;  // the slots whose weight the walk set
    if (do_resample && any_staged) {
#pragma unroll
      for (int k = 0; k < K; ++k) w[k] = s.weight[base + k];
      kept = resample<K>(st, w, trigger, inv_trigger);
    }
    int c = 0;  // vacant slots so far: the next vacant slot's vacant-rank
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool vacant = st[k] == STATUS_INVALID;
      int m = -1;
#pragma unroll
      for (int r = 0; r < K; ++r) m = vacant && r == c ? meta[r] : m;
      if (m >= 0) {  // the slot takes staged candidate c
        s.px[base + k] = in.px[sbase + c];
        s.py[base + k] = in.py[sbase + c];
        s.pz[base + k] = in.pz[sbase + c];
        s.weight[base + k] = in.w[sbase + c];
        s.stamp[base + k] = in.stamp[sbase + c];
        s.track[base + k] = m & 0xFFFF;
        s.label[base + k] = (uint8_t)((m >> 16) & 0xFF);
        s.status[base + k] = (uint8_t)((m >> 24) & 0x7);
        s.forget[base + k] = (uint8_t)((m >> 27) & 0x7);
      } else {
        if (st[k] != old[k]) s.status[base + k] = (uint8_t)st[k];
        if (kept >> k & 1u) s.weight[base + k] = w[k];
      }
      c += vacant;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) acc += (k < c && meta[k] >= 0);
  }
  acc = __reduce_add_sync(0xffffffffu, acc);
  if ((threadIdx.x & 31) == 0 && acc != 0) atomicAdd(accepted, (unsigned long long)acc);
}

template <int K>
int launch_merge(const Store& s, const Staged& in, const int* vax, const long long* ids,
                 unsigned long long* accepted, long long rows, int bv_log2, long long nb,
                 int do_resample, int trigger, cudaStream_t stream) {
  const long long threads = rows << bv_log2;
  const unsigned grid = (unsigned)((threads + BLOCK - 1) / BLOCK);
  static CUfunction fn = nullptr;
  return dsp::launch(merge_kernel<K>, fn, grid, BLOCK, 0, stream, s, in, vax, ids, accepted,
                     rows, bv_log2, nb, do_resample, trigger, 1.0f / (float)trigger);
}

}  // namespace

// The nine fields of the store (updated in place), the voxels' scroll
// stamps, the rows' block ids (A, int64), the six staged buffers
// ([A, bv, K]), the accepted count (one int64, zeroed by the caller);
// A, bv (a power of two), K, the number of blocks of the store, whether to
// resample, the resample trigger; the stream.
extern "C" int dsp_merge_blocks(
    float* px, float* py, float* pz, float* weight, uint8_t* label, int* track,
    uint8_t* status, uint8_t* forget, int* stamp, const int* vax, const long long* ids,
    const float* in_px, const float* in_py, const float* in_pz, const float* in_w,
    const int* in_stamp, const int* in_meta, long long* accepted, long long rows, int bv,
    int K, long long nb, int do_resample, int trigger, void* stream) {
  if (rows <= 0 || bv <= 0 || (bv & (bv - 1)) != 0 || nb <= 0 || trigger <= 0)
    return (int)cudaErrorInvalidValue;
  const int bv_log2 = __builtin_ctz((unsigned)bv);
  const Store s{px, py, pz, weight, label, track, status, forget, stamp};
  const Staged in{in_px, in_py, in_pz, in_w, in_stamp, in_meta};
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(accepted);
  cudaStream_t st = (cudaStream_t)stream;
  switch (K) {
    case 1: return launch_merge<1>(s, in, vax, ids, acc, rows, bv_log2, nb, do_resample, trigger, st);
    case 3: return launch_merge<3>(s, in, vax, ids, acc, rows, bv_log2, nb, do_resample, trigger, st);
    case 7: return launch_merge<7>(s, in, vax, ids, acc, rows, bv_log2, nb, do_resample, trigger, st);
    case 15: return launch_merge<15>(s, in, vax, ids, acc, rows, bv_log2, nb, do_resample, trigger, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
