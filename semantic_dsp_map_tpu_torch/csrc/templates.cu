// Template mode's two every-frame passes for Hopper (sm_90a), plain C
// interface: the template gate and rematch's delete pass.
//
// Replaces no TPU kernel: XLA fuses the JAX package's template_gate loop and
// masked delete (semantic_dsp_map_tpu/template_engine.py).  Oracles:
// template_gate and delete_matched_plain in
// semantic_dsp_map_tpu_torch/template_engine.py.
//
// Gate: the i32[O, 8] eligibility array [valid, rematch_ok, birth_ok,
// track_id, label, cloud_point_count, bbox_extent_x_mm, bbox_extent_y_mm].
// Its last three columns reduce over the image: for each object row, the
// valid pixels whose track is the row's id, counted, with the min and max of
// their x and y.  The plain gate builds that as masks over [O, H*W] (64 x
// 465,750 at VKITTI2): an equality, an AND, a sum and four where + amax/amin
// pairs, about 1.2 GB of traffic for 2 KB of result.
// What bounds it: device memory.  The inputs it needs are each pixel's track
// (4 B) and validity (1 B), 2.3 MB at VKITTI2 shapes, and x and y of each
// pixel some valid row takes: the 32-byte sectors of the interleaved
// positions that hold them, each counted once (a car's pixels are
// contiguous, about 12 B a pixel).  Counting every pixel's position too, as
// a pass that read them all would, 7.9 MB, 2.4 us at 3.35 TB/s.
//   1. gate_accumulate_kernel: a grid over the pixels (GATE_PIXELS a thread,
//      neighbouring threads on neighbouring pixels) by chunks of GATE_ROWS
//      object rows.  A block lists its chunk's valid rows (track id, row) in
//      shared memory; an invalid row's three columns are masked to 0, so it
//      takes no pixel, and two valid rows of one id both take it.  For each
//      pixel a thread holds and each listed row, the warp asks which lanes'
//      pixels are valid with the row's id; where some are, their count, the
//      max of x and of y and the min of both (as max of the complement) are
//      reduced across the warp and lane 0 adds them into the block's
//      accumulators in shared memory.  x and y are read only where a pixel
//      matched.  Then each listed row with a point merges into the per-row
//      accumulators in device memory by atomics.  Floats are compared
//      through `ordered`, an unsigned that orders as the float does; every
//      float but NaN maps above 0, so the zeroed accumulator is empty.  A NaN
//      x or y sets a flag bit instead.
//   2. gate_finish_kernel: a thread a row writes the eight columns as the
//      plain code does.  The plain max takes every pixel, those the row does
//      not take filled with -BIG (min: +BIG): where the row does not take
//      every pixel of the image the fill joins the max (min), which is what
//      gives the plain bits for infinite positions.  A NaN flag gives NaN
//      (amax and amin propagate it), and the cast of the extent * 1000 to
//      int32 is the cast PyTorch's kernel makes on the card (NaN to 0,
//      saturated past the int32 range).
// The scratch, u32[GATE_COLUMNS, O], is the wrapper's; the entry point zeroes
// it on the stream before the first kernel.
//
// Delete: status = INVALID at every slot whose track is the id of a rematch
// slot whose match was good (deleteParticlesInSet, operations.h:125-146).
// The plain pass builds a bool mask over the store (58,720,256 slots at
// VKITTI2), an int32 equality and two ORs a rematch slot, then a masked
// fill: about 1.4 GB of traffic every frame, and it deletes nothing unless a
// match was good, which is the common frame.
// What bounds it: with no good slot, the flags (a few bytes): its time is
// the launch.  With one, the store's track (235 MB) and a byte of status a
// matching slot, about 70 us at 3.35 TB/s.
// delete_matched_kernel: every block first lists the good slots' ids in
// shared memory and returns when there is none.  Otherwise a grid-stride
// loop over the store, a resident grid, reads track as 16-byte pieces
// (streaming loads) and writes INVALID only at a matching slot: the bytes
// of status it writes are those the plain masked fill changes or rewrites
// with the same value, so the store's bits equal the plain pass's.  The
// last n % 4 slots take scalar code; track must be 16-byte aligned (whole
// tensors are), and the store at most INT_MAX slots.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int GATE_THREADS = 256;
constexpr int GATE_PIXELS = 4;     // pixels a thread, GATE_THREADS apart
constexpr int GATE_ROWS = 256;     // object rows a block lists (grid.y walks O by these)
constexpr int FINISH_THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = 3.4e38f;     // template_engine._BIG as float32

// Columns of the gate's accumulators, u32[GATE_COLUMNS, O] in device memory.
enum { CNT, MAX_X, MIN_X, MAX_Y, MIN_Y, NANS, GATE_COLUMNS };

constexpr int DEL_THREADS = 256;
constexpr int DEL_SLOTS = 32;      // most rematch slots a launch takes
constexpr uint8_t STATUS_INVALID = 0;  // state.STATUS_INVALID

// A float's bits as an unsigned that orders as the float does (NaN aside);
// every float but NaN maps above 0.
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__global__ void __launch_bounds__(GATE_THREADS) gate_accumulate_kernel(
    const int* __restrict__ trk, const uint8_t* __restrict__ ok, const float* __restrict__ pos,
    const uint8_t* __restrict__ valid, const int* __restrict__ tid, unsigned* __restrict__ acc,
    int n_pix, int n_rows) {
  __shared__ int s_tid[GATE_ROWS];
  __shared__ int s_row[GATE_ROWS];
  __shared__ unsigned s_acc[GATE_COLUMNS][GATE_ROWS];
  __shared__ int s_listed;
  const int row0 = blockIdx.y * GATE_ROWS;
  const int rows = min(GATE_ROWS, n_rows - row0);
  if (threadIdx.x == 0) s_listed = 0;
  for (int k = threadIdx.x; k < GATE_ROWS; k += GATE_THREADS) {
    for (int c = 0; c < GATE_COLUMNS; ++c) s_acc[c][k] = 0u;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += GATE_THREADS) {
    if (valid[row0 + r]) {
      const int k = atomicAdd(&s_listed, 1);
      s_tid[k] = tid[row0 + r];
      s_row[k] = row0 + r;
    }
  }
  __syncthreads();
  const int listed = s_listed;
  if (listed == 0) return;  // no valid row in the chunk: its columns are masked
  const bool lead = (threadIdx.x & 31) == 0;
  const int first = blockIdx.x * GATE_THREADS * GATE_PIXELS + threadIdx.x;
  for (int i = 0; i < GATE_PIXELS; ++i) {
    const int p = first + i * GATE_THREADS;
    const bool in = p < n_pix && ok[p];
    const int t = in ? trk[p] : 0;
    float x = 0.0f, y = 0.0f;
    bool loaded = false;
    for (int k = 0; k < listed; ++k) {
      const bool hit = in && t == s_tid[k];
      const unsigned hits = __ballot_sync(FULL, hit);
      if (hits == 0u) continue;  // the whole warp skips the row
      if (hit && !loaded) {
        x = pos[3 * (long long)p];
        y = pos[3 * (long long)p + 1];
        loaded = true;
      }
      const bool nan_x = hit && x != x, nan_y = hit && y != y;  // NaN
      const bool in_x = hit && !nan_x, in_y = hit && !nan_y;
      const unsigned hi_x = __reduce_max_sync(FULL, in_x ? ordered(x) : 0u);
      const unsigned lo_x = __reduce_max_sync(FULL, in_x ? ~ordered(x) : 0u);
      const unsigned hi_y = __reduce_max_sync(FULL, in_y ? ordered(y) : 0u);
      const unsigned lo_y = __reduce_max_sync(FULL, in_y ? ~ordered(y) : 0u);
      const unsigned nans = __reduce_or_sync(FULL, (nan_x ? 1u : 0u) | (nan_y ? 2u : 0u));
      if (lead) {
        atomicAdd(&s_acc[CNT][k], (unsigned)__popc(hits));
        atomicMax(&s_acc[MAX_X][k], hi_x);
        atomicMax(&s_acc[MIN_X][k], lo_x);
        atomicMax(&s_acc[MAX_Y][k], hi_y);
        atomicMax(&s_acc[MIN_Y][k], lo_y);
        if (nans) atomicOr(&s_acc[NANS][k], nans);
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < listed; k += GATE_THREADS) {
    if (s_acc[CNT][k] == 0u) continue;
    const int r = s_row[k];
    atomicAdd(&acc[CNT * n_rows + r], s_acc[CNT][k]);
    for (int c = MAX_X; c <= MIN_Y; ++c) atomicMax(&acc[c * n_rows + r], s_acc[c][k]);
    if (s_acc[NANS][k]) atomicOr(&acc[NANS * n_rows + r], s_acc[NANS][k]);
  }
}

// max - min of a row's coordinate as the plain gate computes it, for a row
// with a point: `nan` that one was NaN, `filled` that the row does not take
// every pixel (so the -BIG / +BIG fill joins the max / min).
__device__ float row_extent(unsigned hi_bits, unsigned lo_bits, bool nan, bool filled) {
  if (nan) return __uint_as_float(0x7fc00000u);
  float hi = unordered(hi_bits), lo = unordered(~lo_bits);
  if (filled) {
    hi = hi > -BIG ? hi : -BIG;
    lo = lo < BIG ? lo : BIG;
  }
  return hi - lo;
}

__global__ void __launch_bounds__(FINISH_THREADS) gate_finish_kernel(
    const unsigned* __restrict__ acc, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ to_match_previous, const uint8_t* __restrict__ moving,
    const uint8_t* __restrict__ has_moved_record, const uint8_t* __restrict__ to_match_templates,
    const int* __restrict__ tid, const int* __restrict__ label, int* __restrict__ gate,
    int n_pix, int n_rows, int car_label) {
  const int r = blockIdx.x * FINISH_THREADS + threadIdx.x;
  if (r >= n_rows) return;
  const bool v = valid[r] != 0;
  const unsigned n = acc[CNT * n_rows + r];
  const unsigned nans = acc[NANS * n_rows + r];
  const bool ok = v && n > 0u, filled = n < (unsigned)n_pix;
  const float ext_x =
      ok ? row_extent(acc[MAX_X * n_rows + r], acc[MIN_X * n_rows + r], nans & 1u, filled) : 0.0f;
  const float ext_y =
      ok ? row_extent(acc[MAX_Y * n_rows + r], acc[MIN_Y * n_rows + r], nans & 2u, filled) : 0.0f;
  int* out = gate + 8 * (long long)r;
  out[0] = v;
  out[1] = v && to_match_previous[r] && moving[r] && has_moved_record[r];
  out[2] = v && to_match_templates[r] && label[r] == car_label;
  out[3] = tid[r];
  out[4] = label[r];
  out[5] = v ? (int)n : 0;
  out[6] = (int)(ext_x * 1000.0f);
  out[7] = (int)(ext_y * 1000.0f);
}

__device__ __forceinline__ bool deleted(int t, const int* ids, int n) {
  bool hit = false;
  for (int i = 0; i < n; ++i) hit |= t == ids[i];
  return hit;
}

// Eight blocks an SM: 32 registers a thread, so the grid-stride loop keeps
// every warp slot of an SM streaming track.
__global__ void __launch_bounds__(DEL_THREADS, 8) delete_matched_kernel(
    const int* __restrict__ track, uint8_t* __restrict__ status,
    const uint8_t* __restrict__ good, const int* __restrict__ tid, int n_slots, long long n) {
  __shared__ int s_ids[DEL_SLOTS];
  __shared__ int s_good;
  if (threadIdx.x == 0) {
    int m = 0;
    for (int i = 0; i < n_slots; ++i) {
      if (good[i]) s_ids[m++] = tid[i];
    }
    s_good = m;
  }
  __syncthreads();
  const int m = s_good;
  if (m == 0) return;  // no match was good: nothing to delete
  // 32-bit indices (the entry takes at most INT_MAX slots): with 64-bit ones
  // the loop needs 34 registers and spills at the bound's 32.
  const unsigned quads = (unsigned)(n / 4);
  const int4* track4 = reinterpret_cast<const int4*>(track);
  const unsigned step = gridDim.x * DEL_THREADS;
  for (unsigned q = blockIdx.x * DEL_THREADS + threadIdx.x; q < quads; q += step) {
    const int4 t = __ldcs(track4 + q);
    uint8_t* s = status + 4 * q;
    if (deleted(t.x, s_ids, m)) s[0] = STATUS_INVALID;
    if (deleted(t.y, s_ids, m)) s[1] = STATUS_INVALID;
    if (deleted(t.z, s_ids, m)) s[2] = STATUS_INVALID;
    if (deleted(t.w, s_ids, m)) s[3] = STATUS_INVALID;
  }
  const unsigned tail = 4 * quads + threadIdx.x;
  if (blockIdx.x == 0 && tail < n && deleted(track[tail], s_ids, m)) status[tail] = STATUS_INVALID;
}

// Blocks of the delete kernel that fit on the card at once, asked of the
// runtime once a process.
cudaError_t resident_delete_blocks(long long* blocks) {
  static long long cached = 0;
  if (cached == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, delete_matched_kernel,
                                                        DEL_THREADS, 0);
    if (e != cudaSuccess) return e;
    cached = (long long)sms * per_sm;
  }
  *blocks = cached;
  return cudaSuccess;
}

}  // namespace

// trk, ok: the cloud's track (i32) and validity (bool) of n_pix pixels; pos
// its positions (f32[n_pix, 3]); the object table's valid,
// to_match_previous, moving, has_moved_record, to_match_templates (bool),
// track_id and label (i32) of n_rows rows; acc the scratch (u32[6, n_rows]);
// gate the output (i32[n_rows, 8]).
extern "C" int dsp_template_gate(const int* trk, const uint8_t* ok, const float* pos,
                                 const uint8_t* valid, const uint8_t* to_match_previous,
                                 const uint8_t* moving, const uint8_t* has_moved_record,
                                 const uint8_t* to_match_templates, const int* tid,
                                 const int* label, unsigned* acc, int* gate, int n_pix,
                                 int n_rows, int car_label, void* stream) {
  if (n_pix <= 0 || n_rows <= 0 || n_rows > 65535 * GATE_ROWS) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      cudaMemsetAsync(acc, 0, sizeof(unsigned) * GATE_COLUMNS * (size_t)n_rows, s);
  if (e != cudaSuccess) return (int)e;
  const int per_block = GATE_THREADS * GATE_PIXELS;
  const dim3 grid((unsigned)((n_pix + (long long)per_block - 1) / per_block),
                  (unsigned)((n_rows + GATE_ROWS - 1) / GATE_ROWS));
  static CUfunction accumulate_fn = nullptr;
  const int err = dsp::launch(gate_accumulate_kernel, accumulate_fn, grid, dim3(GATE_THREADS), 0,
                              s, trk, ok, pos, valid, tid, acc, n_pix, n_rows);
  if (err) return err;
  static CUfunction finish_fn = nullptr;
  return dsp::launch(gate_finish_kernel, finish_fn,
                     dim3((unsigned)((n_rows + FINISH_THREADS - 1) / FINISH_THREADS)),
                     dim3(FINISH_THREADS), 0, s, acc, valid, to_match_previous, moving,
                     has_moved_record, to_match_templates, tid, label, gate, n_pix, n_rows,
                     car_label);
}

// track (i32) and status (u8, written in place) of n slots; good (bool) and
// tid (i32) of n_slots rematch slots.
extern "C" int dsp_delete_matched(const int* track, uint8_t* status, const uint8_t* good,
                                  const int* tid, int n_slots, long long n, void* stream) {
  if (n <= 0 || n > INT_MAX || n_slots <= 0 || n_slots > DEL_SLOTS)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)track % 16 != 0) return (int)cudaErrorMisalignedAddress;
  long long blocks = 0;
  const cudaError_t e = resident_delete_blocks(&blocks);
  if (e != cudaSuccess) return (int)e;
  const long long needed = (n / 4 + DEL_THREADS - 1) / DEL_THREADS;
  if (blocks > needed) blocks = needed;
  if (blocks < 1) blocks = 1;  // the tail alone
  static CUfunction fn = nullptr;
  return dsp::launch(delete_matched_kernel, fn, dim3((unsigned)blocks), dim3(DEL_THREADS), 0,
                     (cudaStream_t)stream, track, status, good, tid, n_slots, n);
}
