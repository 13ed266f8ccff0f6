// Birth's block merge for Hopper (sm_90a), plain C interface: the merge
// stage of _insert_core, which every path that inserts particles runs
// (birth, the moving-object cleanup, the template stages, the sharded step).
//
// Replaces no TPU kernel: the JAX package has no pl.pallas_call here, XLA
// fuses the merge out of semantic_dsp_map_tpu/ops/birth.py (_insert_core,
// lines 279-402: lane shifts on the [A, spb] layout).  Oracle:
// merge_blocks_plain in semantic_dsp_map_tpu_torch/ops/birth.py, some 400
// small PyTorch launches a call on the card; this is one launch.
//
// What the merge computes, per voxel of a target block row (A rows of bv
// voxels of K slots; a row's slots are one contiguous run of the store):
//   1. a padding row (ids[a] >= nb) is skipped: the plain version's scatter
//      sends padding rows to a real row with that row's own bytes (or, with
//      no real row, to the last row with its current bytes), the same store;
//   2. the stale prune: a slot with a status set and a stamp below the
//      voxel's scroll stamp becomes INVALID, BEFORE the resample reads the
//      status (the plain version prunes first, so the walk never sees a
//      stale UPDATED particle);
//   3. with resample on and at least one staged candidate, the resample walk
//      of resample_slots (below) on the K weights;
//   4. the first-vacant merge: the vacant slot with vacant-rank c takes
//      staged candidate c where its meta >= 0; meta unpacks as the plain
//      version's (& 0xFFFF track, >> 16 & 0xFF label, >> 24 & 0x7 status,
//      >> 27 & 0x7 forget);
//   5. the write-back in place of what changed: the nine fields of a slot
//      that took a candidate, else the status where the prune or the walk
//      changed it and the weight where the walk set it.  The plain version
//      writes every field of every slot back, the unchanged ones with their
//      own bytes: the same store.  The accepted count (staged candidates r
//      with r < the voxel's vacancy count) goes to a 64-bit device counter.
//      It is an integer, so the order of the atomics changes nothing.
// Real block ids are unique (listed ascending from a sorted stream), so
// each slot has one writer and the in-place writes do not race.
//
// What bounds it: device memory.  A real row's slots' status, stamp and
// staged meta are read (9 B a slot), the weights of a resampled voxel
// (4 B a slot), and each accepted candidate's staged position, weight and
// stamp (20 B); what changes is written: a status byte, a resampled weight,
// the 27 B of a slot that took a candidate.  At VKITTI2's birth (1536 rows
// of 448 slots) that is about 17 MB, 0.005 ms at 3.35 TB/s.
//
// What held the first design (a thread per voxel, K slots in registers) at
// a tenth of that: latency.  Each thread walked a chain of dependent loads
// (ids -> scroll stamp -> K statuses -> K stamps -> K metas -> K weights ->
// the staged fields of each taken slot, one taken slot after another), each
// load strided by K across the warp, and at the moving-object cleanup (256
// rows) only 64 blocks had work.  Here a CUDA block owns a tile of
// merge_vox<K>() voxels, whole block rows, a thread a voxel:
//   a. the tile's block ids go to shared memory (the one load everything
//      else waits for), and each thread asks for its voxel's scroll stamp;
//   b. the tile's real rows' status, stamp and staged meta runs (and, with
//      resample on, the weights) are copied into shared memory with
//      cp.async, 16 bytes a thread, neighbouring threads on neighbouring
//      addresses, every copy of the tile asked for before any is waited on
//      (a row run is 16-byte aligned when bv * K is a multiple of 16, as on
//      every grid of 32 voxels or more; a smaller grid's rows are copied an
//      element at a time).  With resample on nearly every real row holds a
//      candidate (the rows are the blocks that received them), so the
//      weights come with the rest instead of one round trip later;
//   c. each thread runs its voxel's prune, walk and vacancy ranks out of
//      shared memory (a stride of K words: conflict-free for odd K);
//   d. the staged position, weight and stamp of the taken slots are the
//      only loads that depend on data: a voxel's are asked for together,
//      eight slots at a time, before any of its stores, which go straight
//      to the store, only where something changed;
//   e. the accepted count: a shared-memory sum, one global atomic a tile.
// Tiles of 128 voxels (64 at K = 31, 512 at K = 1): 2 rows a block at
// VKITTI2, so its 256-row cleanup has 128 blocks on 132 SMs (64 before).
// On an H100 this halves the cleanup and shortens a real frame's two
// merges, but leaves a synthetic birth in which a quarter of the slots take
// a candidate where it was (0.047 ms against a bound of 0.005 ms): there
// the scattered stores of the taken slots' nine fields fill 32-byte sectors
// a few bytes at a time.  Staging all nine fields and writing whole rows
// back (by cp.async, or one TMA bulk copy a row and field) took that
// birth to 0.036 / 0.035 ms, but real frames change few slots a row, and
// there moving whole rows lost to this design in every scene measured
// (PERF.md, section 6).
//
// Two instances of the kernel for each K: the count-only one, which every
// path of the frame runs (dsp_merge_blocks), and one that also writes each
// staged slot's acceptance, a byte a slot of the staged [A, bv, K] layout
// (dsp_merge_blocks_accepted): the per-candidate mask of the JAX package's
// insert_particles (semantic_dsp_map_tpu/ops/birth.py:404), which reads
// _insert_core's accepted_staged.  Staged candidate k of a voxel is
// accepted iff k < the voxel's vacancy count, the value the count sums.
// The mask adds A * bv * K bytes written (688 KB at VKITTI2's birth, about
// 0.0002 ms at 3.35 TB/s); each thread stores its voxel's K bytes, padding
// rows zeros, so the caller need not clear the buffer.
//
// Both variants have instances for K = 1, 3, 7, 15 and 31 and a generic
// instance for every other K (merge_generic_kernel, below): past K = 31 a
// voxel's slots no longer fit a thread's registers, so a warp shares a
// voxel and walks it two chunks of 32 a step, the resample walk still
// sequential in slot order.
//
// Bit-equality hazards, each kept as the plain version computes it (the
// library is built with -fmad=false, so nothing is contracted):
//   - the walk's sums are sequential f32 additions in slot order, a
//     not-UPDATED slot adding +0.0 as torch.where does (the generic
//     instance leaves those terms out: a sum that starts at +0.0 never
//     becomes -0.0 under round-to-nearest, x + (+0.0) has the bits of
//     any other number x, and a NaN stays a NaN);
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

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int STATUS_INVALID = 0;  // state.py
constexpr int STATUS_UPDATED = 1;  // state.py

// Voxels (and threads) a block: whole block rows, since a row has at most
// 512 slots (ops/blocks.py block_layout), hence bv <= the largest power of
// two <= 512 / K.  At K = 31 a tile of 128 voxels would take 51.6 KB of
// shared memory, past the 48 KB of a static allocation, so 64 there.
template <int K>
__host__ __device__ constexpr int merge_vox() {
  return K == 1 ? 512 : (K == 31 ? 64 : 128);
}

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

// Which row runs may be copied 16 bytes at a time (bit 0: the status
// bytes; bit 1: the 4-byte fields), from dsp_merge_blocks.
constexpr int WIDE_BYTES = 1;
constexpr int WIDE_WORDS = 2;

// Copies the tile's real rows of one field into shared memory: row r of the
// tile comes from row src_row(r) of `src` (a block id of the store, or the
// staged buffer's own row), `row_len` elements a row.  `wide`: rows and
// bases are 16-byte aligned, so the copy goes by cp.async, 16 bytes a
// thread; else an element at a time.
template <int K, typename T, typename Row>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int tile_len, int row_len,
                                           int bv_log2, bool wide, const long long* s_id,
                                           long long nb, Row src_row) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (wide) {
    constexpr int E = 16 / sizeof(T);
    for (int e = tid * E; e < tile_len; e += nt * E) {
      const int r = (e / K) >> bv_log2;
      if (s_id[r] >= nb) continue;
      __pipeline_memcpy_async(dst + e, src + src_row(r) * row_len + (e - r * row_len), 16);
    }
  } else {
    for (int e = tid; e < tile_len; e += nt) {
      const int r = (e / K) >> bv_log2;
      if (s_id[r] >= nb) continue;
      dst[e] = src[src_row(r) * row_len + (e - r * row_len)];
    }
  }
}

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

// ACC: the instance that also writes each staged slot's acceptance, a byte
// a slot of the [A, bv, K] staged layout, into `lanes` (insert_particles'
// per-candidate mask); the count-only instance (ACC false, `lanes` unused)
// is the one every path of the frame runs.
template <int K, bool ACC>
__global__ void __launch_bounds__(merge_vox<K>()) merge_kernel(
    Store s, const float* __restrict__ in_px, const float* __restrict__ in_py,
    const float* __restrict__ in_pz, const float* __restrict__ in_w,
    const int* __restrict__ in_stamp, const int* __restrict__ in_meta,
    const int* __restrict__ vax, const long long* __restrict__ ids,
    unsigned long long* __restrict__ accepted, uint8_t* __restrict__ lanes, long long rows,
    int bv_log2, long long nb, int do_resample, int trigger, float inv_trigger, int wide) {
  constexpr int VOX = merge_vox<K>();
  constexpr int SLOTS = VOX * K;
  constexpr int CH = K < 8 ? K : 8;  // taken slots whose staged loads fly together
  __shared__ __align__(16) uint8_t s_status[SLOTS];
  __shared__ __align__(16) int s_stamp[SLOTS];
  __shared__ __align__(16) int s_meta[SLOTS];
  __shared__ __align__(16) float s_w[SLOTS];
  __shared__ long long s_id[VOX];
  __shared__ unsigned s_acc;

  const int tid = threadIdx.x;
  const int bv = 1 << bv_log2;
  const int rpb = VOX >> bv_log2;  // block rows a tile
  const long long a0 = (long long)blockIdx.x * rpb;
  const int row_len = K << bv_log2;
  const int tile_rows = (int)(rows - a0 < rpb ? rows - a0 : rpb);
  const int tile_len = tile_rows * row_len;  // slots of the tile's rows

  // a. the tile's block ids (rows past the end as padding), then the one
  // load of this thread's own that waits on nothing else.
  if (tid < rpb) s_id[tid] = tid < tile_rows ? ids[a0 + tid] : nb;
  if (tid == 0) s_acc = 0u;
  __syncthreads();
  const int r = tid >> bv_log2;
  const long long id = s_id[r];
  const bool mine = id < nb;  // a voxel of a real row
  const long long vox = (id << bv_log2) + (tid & (bv - 1));
  const int va = mine ? vax[vox] : 0;

  // b. the tile's runs, all asked for before any is waited on.
  const bool wide_b = wide & WIDE_BYTES, wide_w = wide & WIDE_WORDS;
  auto by_id = [&](int rr) { return s_id[rr]; };
  auto by_row = [&](int rr) { return a0 + rr; };
  stage_rows<K>(s_status, s.status, tile_len, row_len, bv_log2, wide_b, s_id, nb, by_id);
  stage_rows<K>(s_stamp, s.stamp, tile_len, row_len, bv_log2, wide_w, s_id, nb, by_id);
  stage_rows<K>(s_meta, in_meta, tile_len, row_len, bv_log2, wide_w, s_id, nb, by_row);
  if (do_resample)
    stage_rows<K>(s_w, s.weight, tile_len, row_len, bv_log2, wide_w, s_id, nb, by_id);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  unsigned acc = 0u;
  if (mine) {
    // c. prune, walk and vacancy ranks out of shared memory.
    const int l0 = tid * K;  // this voxel's slots in the tile
    const long long base = vox * K;
    const long long sbase = ((a0 << bv_log2) + tid) * K;  // the staged [A, bv, K] buffers
    int st[K], old[K];
    float w[K];
    bool any_staged = false;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      st[k] = old[k] = s_status[l0 + k];
      any_staged = any_staged || s_meta[l0 + k] >= 0;
      // Stale slots count as vacant and are pruned (operations.h:810-816).
      if (st[k] != STATUS_INVALID && s_stamp[l0 + k] < va) st[k] = STATUS_INVALID;
    }
    unsigned kept = 0u;  // the slots whose weight the walk set
    if (do_resample && any_staged) {
#pragma unroll
      for (int k = 0; k < K; ++k) w[k] = s_w[l0 + k];
      kept = resample<K>(st, w, trigger, inv_trigger);
    }
    int src[K];  // the staged candidate slot k takes, or -1
    int c = 0;   // vacant slots so far: the next vacant slot's vacant-rank
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool vacant = st[k] == STATUS_INVALID;
      src[k] = vacant && s_meta[l0 + c] >= 0 ? c : -1;
      c += vacant;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) acc += (k < c && s_meta[l0 + k] >= 0);
    if constexpr (ACC) {
      // staged candidate k is accepted iff k < the voxel's vacancy count
#pragma unroll
      for (int k = 0; k < K; ++k) lanes[sbase + k] = (uint8_t)(k < c && s_meta[l0 + k] >= 0);
    }

    // d. the taken slots' staged fields, CH slots' loads in flight together,
    // then the writes.
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += CH) {
      float x[CH], y[CH], z[CH], ww[CH];
      int sp[CH];
#pragma unroll
      for (int j = 0; j < CH && k0 + j < K; ++j) {
        const int c_k = src[k0 + j];
        if (c_k >= 0) {
          x[j] = in_px[sbase + c_k];
          y[j] = in_py[sbase + c_k];
          z[j] = in_pz[sbase + c_k];
          ww[j] = in_w[sbase + c_k];
          sp[j] = in_stamp[sbase + c_k];
        }
      }
#pragma unroll
      for (int j = 0; j < CH && k0 + j < K; ++j) {
        const int k = k0 + j;
        const int c_k = src[k];
        if (c_k >= 0) {  // the slot takes staged candidate c_k
          const int m = s_meta[l0 + c_k];
          s.px[base + k] = x[j];
          s.py[base + k] = y[j];
          s.pz[base + k] = z[j];
          s.weight[base + k] = ww[j];
          s.stamp[base + k] = sp[j];
          s.track[base + k] = m & 0xFFFF;
          s.label[base + k] = (uint8_t)((m >> 16) & 0xFF);
          s.status[base + k] = (uint8_t)((m >> 24) & 0x7);
          s.forget[base + k] = (uint8_t)((m >> 27) & 0x7);
        } else {
          if (st[k] != old[k]) s.status[base + k] = (uint8_t)st[k];
          if (kept >> k & 1u) s.weight[base + k] = w[k];
        }
      }
    }
  }
  if constexpr (ACC) {
    // a padding row of the staged buffers accepts nothing
    if (!mine && r < tile_rows) {
      const long long sbase = ((a0 << bv_log2) + tid) * K;
#pragma unroll
      for (int k = 0; k < K; ++k) lanes[sbase + k] = 0;
    }
  }
  // e. the accepted count, one global atomic a tile.
  if (acc != 0u) atomicAdd(&s_acc, acc);
  __syncthreads();
  if (tid == 0 && s_acc != 0u) atomicAdd(accepted, (unsigned long long)s_acc);
}

// The generic instance, for every K past 31, in both variants (count-only
// and ACC).  The design above holds a voxel's K slots in one thread:
// st[K], w[K], src[K] and a 32-bit kept mask in registers (220 registers at
// K = 31).  Here a warp owns a voxel and walks its slots two chunks of 32 a
// step, a slot a lane, so nothing grows with K.  What holds the merge back
// is latency, not bytes (a real VKITTI2 birth at K = 63 moves about 12 MB,
// 0.0035 ms at the memory rate): the time is the chain of dependent round
// trips each warp waits on, times the waves of warps the card holds at
// once.  So every load of a step is asked for at once, and each pass runs
// only where its result is needed:
//   1. with resample on: the prune, the staged flag, the UPDATED slots'
//      count (ballot) and weight sum in slot order (the set bits of each
//      chunk's ballot, each weight broadcast by a shuffle, so every lane
//      adds the same terms in the same order).  Without resample nothing
//      here is needed and the pass is skipped;
//   2. the step's slots again (the L1 cache's), then the prune, the walk
//      over the UPDATED slots alone in slot order (each lane runs the same
//      walk on the broadcast values and keeps the result of its own slot,
//      so it is the one walk of resample_slots), the vacancy ranks (ballot
//      + popcount).  A vacant slot of vacant-rank r takes staged candidate
//      r: its meta comes from the step's lane that loaded it, by shuffle,
//      where r is in the step (r <= the slot's index), else from device
//      memory; then the taken slots' five staged fields, all asked for
//      before any store, and the stores of what changed, each slot by the
//      lane that owns it;
//   3. the accepted count (staged candidates k below the vacancy count)
//      and, in the ACC variant, each staged slot's acceptance byte.
// Round trips at K <= 64: the block id -> (the scroll stamp, the step's
// slots) -> the taken slots' staged fields -> stores, besides the re-reads
// of passes 2 and 3.  Measured on an H100 against it (PERF.md, section 6):
// a tile of whole rows staged in shared memory by cp.async, as the design
// above does, lost (it adds a block barrier, and at K = 63 a second voxel
// a warp, to the chain, and saves no round trip), and so did handing each
// step's staged fields to the taking lanes by shuffle (74 registers: fewer
// warps at once).  ptxas, sm_90a: 60 registers in both variants, no spill,
// 4 bytes of shared memory.
// Offsets are 64-bit: a full grid at K = 255 holds 2^31 slots.
constexpr int GEN_NT = 256;
constexpr int GEN_WARPS = GEN_NT / 32;

// Passes 1-3 for one voxel of a real row, by one warp; returns the
// voxel's accepted count (in every lane).  base: the voxel's first slot in
// the store, sbase: in the staged [A, bv, K] buffers.
template <bool ACC>
__device__ __forceinline__ unsigned merge_voxel(
    const Store& s, const float* __restrict__ in_px, const float* __restrict__ in_py,
    const float* __restrict__ in_pz, const float* __restrict__ in_w,
    const int* __restrict__ in_stamp, const int* __restrict__ in_meta, uint8_t* __restrict__ lanes,
    long long base, long long sbase, int K, int va, int do_resample, int trigger,
    float inv_trigger) {
  constexpr unsigned ALL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;  // the lanes below this one

  // 1. prune, staged flag, the UPDATED slots' count and weight sum
  bool any_staged = false;
  int count = 0;
  float wsum = 0.f;
  if (do_resample) {  // its results decide the resample only
    for (int c0 = 0; c0 < K; c0 += 64) {
      int raw[2], sp[2], mk[2];
      float w[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = c0 + 32 * h + lane;
        raw[h] = k < K ? s.status[base + k] : STATUS_INVALID;
        sp[h] = k < K ? s.stamp[base + k] : 0;
        mk[h] = k < K ? in_meta[sbase + k] : -1;
        w[h] = k < K ? s.weight[base + k] : 0.f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int st = raw[h] != STATUS_INVALID && sp[h] < va ? STATUS_INVALID : raw[h];
        const unsigned um = __ballot_sync(ALL, st == STATUS_UPDATED);
        any_staged = __any_sync(ALL, mk[h] >= 0) || any_staged;
        count += __popc(um);
        for (unsigned m = um; m != 0u; m &= m - 1u)
          wsum = wsum + __shfl_sync(ALL, w[h], __ffs(m) - 1);
      }
    }
  }
  const bool resample = do_resample && any_staged && count > trigger;
  const bool wipe = resample && wsum < 0.01f;
  const bool walk = resample && !wipe;
  const float q = wsum * inv_trigger;
  const float wpp = q != q ? q : fminf(q, 1.f);

  // 2. the walk, the vacancy ranks and the merge, two chunks a step
  float csum = 0.f, thresh = wpp;
  int vac = 0;  // vacant slots before the chunk
  for (int c0 = 0; c0 < K; c0 += 64) {
    int raw[2], sp[2], mk[2], st[2], src[2], meta[2];
    float w[2];
    bool kept[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = c0 + 32 * h + lane;
      raw[h] = k < K ? s.status[base + k] : STATUS_INVALID;
      sp[h] = k < K ? s.stamp[base + k] : 0;
      mk[h] = k < K ? in_meta[sbase + k] : -1;
      w[h] = k < K && walk ? s.weight[base + k] : 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = c0 + 32 * h + lane;
      st[h] = raw[h] != STATUS_INVALID && sp[h] < va ? STATUS_INVALID : raw[h];
      const bool upd = st[h] == STATUS_UPDATED;
      kept[h] = false;
      if (wipe && upd) st[h] = STATUS_INVALID;
      if (walk) {
        for (unsigned m = __ballot_sync(ALL, upd); m != 0u; m &= m - 1u) {
          const int j = __ffs(m) - 1;  // neither the sums nor the threshold move elsewhere
          const float csum_k = csum + __shfl_sync(ALL, w[h], j);
          if (csum_k < thresh) {
            if (lane == j) st[h] = STATUS_INVALID;
          } else {
            float next = thresh + wpp;
            for (int i = 0; i < K + 8; ++i) {
              if (!(csum_k > next)) break;
              next = next + wpp;
            }
            if (lane == j) {
              w[h] = wpp;
              kept[h] = true;
            }
            thresh = next;
          }
          csum = csum_k;
        }
      }
      const bool vacant = k < K && st[h] == STATUS_INVALID;
      const unsigned vb = __ballot_sync(ALL, vacant);
      const int r = vac + __popc(vb & lt);  // the slot's vacant-rank, <= k
      vac += __popc(vb);
      // staged candidate r's meta: lane r % 32 of this step's chunk
      // (r - c0) / 32 holds it where r >= c0, else device memory does
      const int m0 = __shfl_sync(ALL, mk[0], r & 31), m1 = __shfl_sync(ALL, mk[1], r & 31);
      meta[h] = !vacant ? -1 : (r >= c0 ? (r - c0 >= 32 ? m1 : m0) : in_meta[sbase + r]);
      src[h] = meta[h] >= 0 ? r : -1;  // the staged candidate the slot takes
    }
    float x[2], y[2], z[2], ww[2];
    int ts[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (src[h] >= 0) {
        const long long c = sbase + src[h];
        x[h] = in_px[c];
        y[h] = in_py[c];
        z[h] = in_pz[c];
        ww[h] = in_w[c];
        ts[h] = in_stamp[c];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = c0 + 32 * h + lane;
      const long long i = base + k;
      if (src[h] >= 0) {
        const int m = meta[h];
        s.px[i] = x[h];
        s.py[i] = y[h];
        s.pz[i] = z[h];
        s.weight[i] = ww[h];
        s.stamp[i] = ts[h];
        s.track[i] = m & 0xFFFF;
        s.label[i] = (uint8_t)((m >> 16) & 0xFF);
        s.status[i] = (uint8_t)((m >> 24) & 0x7);
        s.forget[i] = (uint8_t)((m >> 27) & 0x7);
      } else if (k < K) {
        if (st[h] != raw[h]) s.status[i] = (uint8_t)st[h];
        if (kept[h]) s.weight[i] = w[h];
      }
    }
  }

  // 3. the accepted count and each staged slot's acceptance
  unsigned acc = 0u;
  for (int c0 = 0; c0 < K; c0 += 32) {
    const int k = c0 + lane;
    const bool ok = k < K && k < vac && in_meta[sbase + k] >= 0;
    acc += __popc(__ballot_sync(ALL, ok));
    if constexpr (ACC) {
      if (k < K) lanes[sbase + k] = (uint8_t)ok;
    }
  }
  return acc;
}

template <bool ACC>
__global__ void __launch_bounds__(GEN_NT) merge_generic_kernel(
    Store s, const float* __restrict__ in_px, const float* __restrict__ in_py,
    const float* __restrict__ in_pz, const float* __restrict__ in_w,
    const int* __restrict__ in_stamp, const int* __restrict__ in_meta,
    const int* __restrict__ vax, const long long* __restrict__ ids,
    unsigned long long* __restrict__ accepted, uint8_t* __restrict__ lanes, long long rows,
    int bv_log2, int K, long long nb, int do_resample, int trigger, float inv_trigger) {
  __shared__ unsigned s_acc;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) s_acc = 0u;
  __syncthreads();
  // this warp's voxel: row a of the staged [A, bv, K] buffers, voxel vi of it
  const long long wv = (long long)blockIdx.x * GEN_WARPS + threadIdx.x / 32;
  const long long a = wv >> bv_log2;
  const long long sbase = wv * K;  // (a * bv + vi) * K
  unsigned acc = 0u;
  if (a < rows) {
    const long long id = ids[a];
    if (id < nb) {
      const long long vox = (id << bv_log2) + (wv & ((1LL << bv_log2) - 1));
      acc = merge_voxel<ACC>(s, in_px, in_py, in_pz, in_w, in_stamp, in_meta, lanes, vox * K,
                             sbase, K, vax[vox], do_resample, trigger, inv_trigger);
    } else if constexpr (ACC) {
      // a padding row of the staged buffers accepts nothing
      for (int k = lane; k < K; k += 32) lanes[sbase + k] = 0;
    }
  }
  // the accepted count, one global atomic a block
  if (lane == 0 && acc != 0u) atomicAdd(&s_acc, acc);
  __syncthreads();
  if (threadIdx.x == 0 && s_acc != 0u) atomicAdd(accepted, (unsigned long long)s_acc);
}

template <bool ACC>
int launch_merge_generic(const Store& s, const Staged& in, const int* vax, const long long* ids,
                         unsigned long long* accepted, uint8_t* lanes, long long rows,
                         int bv_log2, int K, long long nb, int do_resample, int trigger,
                         cudaStream_t stream) {
  const unsigned grid = (unsigned)(((rows << bv_log2) + GEN_WARPS - 1) / GEN_WARPS);
  static CUfunction fn = nullptr;
  return dsp::launch(merge_generic_kernel<ACC>, fn, grid, GEN_NT, 0, stream, s, in.px, in.py,
                     in.pz, in.w, in.stamp, in.meta, vax, ids, accepted, lanes, rows, bv_log2, K,
                     nb, do_resample, trigger, 1.0f / (float)trigger);
}

template <int K, bool ACC>
int launch_merge(const Store& s, const Staged& in, const int* vax, const long long* ids,
                 unsigned long long* accepted, uint8_t* lanes, long long rows, int bv_log2,
                 long long nb, int do_resample, int trigger, int wide, cudaStream_t stream) {
  constexpr int VOX = merge_vox<K>();
  if ((VOX >> bv_log2) < 1) return (int)cudaErrorInvalidValue;  // a row wider than a tile
  const long long rpb = VOX >> bv_log2;
  const unsigned grid = (unsigned)((rows + rpb - 1) / rpb);
  static CUfunction fn = nullptr;
  return dsp::launch(merge_kernel<K, ACC>, fn, grid, VOX, 0, stream, s, in.px, in.py, in.pz,
                     in.w, in.stamp, in.meta, vax, ids, accepted, lanes, rows, bv_log2, nb,
                     do_resample, trigger, 1.0f / (float)trigger, wide);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// What the two C entry points share: the checks, the copy widths and the
// dispatch on K.
template <bool ACC>
int merge_blocks(float* px, float* py, float* pz, float* weight, uint8_t* label, int* track,
                 uint8_t* status, uint8_t* forget, int* stamp, const int* vax,
                 const long long* ids, const float* in_px, const float* in_py,
                 const float* in_pz, const float* in_w, const int* in_stamp, const int* in_meta,
                 long long* accepted, uint8_t* lanes, long long rows, int bv, int K, long long nb,
                 int do_resample, int trigger, void* stream) {
  if (rows <= 0 || bv <= 0 || (bv & (bv - 1)) != 0 || nb <= 0 || trigger <= 0)
    return (int)cudaErrorInvalidValue;
  const int bv_log2 = __builtin_ctz((unsigned)bv);
  const long long row_len = (long long)bv * K;
  int wide = 0;
  if (row_len % 16 == 0 && aligned16(status)) wide |= WIDE_BYTES;
  if (row_len % 4 == 0 && aligned16(stamp) && aligned16(weight) && aligned16(in_meta))
    wide |= WIDE_WORDS;
  const Store s{px, py, pz, weight, label, track, status, forget, stamp};
  const Staged in{in_px, in_py, in_pz, in_w, in_stamp, in_meta};
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(accepted);
  cudaStream_t st = (cudaStream_t)stream;
  switch (K) {
    case 1: return launch_merge<1, ACC>(s, in, vax, ids, acc, lanes, rows, bv_log2, nb, do_resample, trigger, wide, st);
    case 3: return launch_merge<3, ACC>(s, in, vax, ids, acc, lanes, rows, bv_log2, nb, do_resample, trigger, wide, st);
    case 7: return launch_merge<7, ACC>(s, in, vax, ids, acc, lanes, rows, bv_log2, nb, do_resample, trigger, wide, st);
    case 15: return launch_merge<15, ACC>(s, in, vax, ids, acc, lanes, rows, bv_log2, nb, do_resample, trigger, wide, st);
    case 31: return launch_merge<31, ACC>(s, in, vax, ids, acc, lanes, rows, bv_log2, nb, do_resample, trigger, wide, st);
    default:
      if (K <= 0) return (int)cudaErrorInvalidValue;
      return launch_merge_generic<ACC>(s, in, vax, ids, acc, lanes, rows, bv_log2, K, nb, do_resample, trigger, st);
  }
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
  return merge_blocks<false>(px, py, pz, weight, label, track, status, forget, stamp, vax, ids,
                             in_px, in_py, in_pz, in_w, in_stamp, in_meta, accepted, nullptr,
                             rows, bv, K, nb, do_resample, trigger, stream);
}

// dsp_merge_blocks, and after the count the acceptance of each staged slot
// (uint8 [A, bv, K], every byte written: 1 where that staged candidate was
// accepted): insert_particles' instance.
extern "C" int dsp_merge_blocks_accepted(
    float* px, float* py, float* pz, float* weight, uint8_t* label, int* track,
    uint8_t* status, uint8_t* forget, int* stamp, const int* vax, const long long* ids,
    const float* in_px, const float* in_py, const float* in_pz, const float* in_w,
    const int* in_stamp, const int* in_meta, long long* accepted, uint8_t* lanes,
    long long rows, int bv, int K, long long nb, int do_resample, int trigger, void* stream) {
  return merge_blocks<true>(px, py, pz, weight, label, track, status, forget, stamp, vax, ids,
                            in_px, in_py, in_pz, in_w, in_stamp, in_meta, accepted, lanes, rows,
                            bv, K, nb, do_resample, trigger, stream);
}
