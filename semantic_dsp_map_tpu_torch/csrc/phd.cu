// PHD stencil passes A and B for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels _pass_a_kernel / _pass_b_kernel of
// semantic_dsp_map_tpu/ops/phd_pallas.py.  Oracles: pass_a_raw /
// pass_b_raw in semantic_dsp_map_tpu_torch/ops/phd.py.
//
// Both passes are (2R+1)^2-offset stencils over an image-sized grid.  The
// plain version re-reads every operand from device memory once per offset
// (121 times at R = 5); what bounds a kernel here is that re-streaming, so
// each block stages the halo tile it needs in shared memory once and runs
// all offsets from there, and each thread keeps its own pixel's operands
// in registers.  After staging, the work is expf plus ~15 flops per
// (pixel, offset, live slot): bound by the f32 pipes.
//
// Pass A (one term per lane-iteration): what bounds it on this card is the
// rate of the SMs' warp schedulers, as for pass B, not bytes.  The table is
// front-filled and mostly empty, so a thread per pixel that walks all
// (2R+1)^2 offsets of every slot plane and skips the empty neighbours keeps
// a third of its lanes busy: a warp runs a term when any of its 32
// neighbours has one.  Here a block owns an A_TW x A_TH tile and, for each
// group of up to 32 slot planes,
//   1. reads w_eff of every entry of its (A_TW+2R) x (A_TH+2R) halo once and
//      keeps one bit per entry (w_eff != 0; outside the image no bit), a word
//      per halo pixel;
//   2. turns the words' bit counts into list positions with a block prefix
//      scan (no atomics: a position depends on the data alone, not on which
//      warp came first);
//   3. packs the live entries into a list in shared memory, ordered by (halo
//      row, halo column, slot): (px, py, pz, w_eff) as one float4 and the
//      track beside it, so a term is one 16-byte and one 4-byte shared load;
//      positions and track are read only of live entries, one entry per
//      thread, every lane busy;
//   4. gives each pixel its 2R+1 halo rows in turn: the entries of columns
//      x-R .. x+R of one halo row are one contiguous range of the list, so
//      every step of a lane is a term.  Neighbouring lanes' ranges share 2R
//      of their 2R+1 columns, so their lengths are close and the lanes of a
//      warp stay together.
// A tile whose halo has no live entry writes its zeros after step 2.  The
// list holds A_CAP entries; a group of planes with more (a table with every
// slot full) is run in sub-groups of A_CAP / halo-pixels planes, which always
// fit.  Summation order: plane groups in ascending order, inside a group halo
// row, halo column, slot, one add at a time into one accumulator; it depends
// on the data alone, so two launches on one input give the same bits.  The
// plain version sums the slots of one offset first: the two agree at rtol
// 2e-5, not bit for bit.  Terms with w_eff == 0 are dropped (they are exactly
// zero), and so is the plain version's 10-sigma clip: it only ever zeroes
// terms below COEF^3 * e^-49.
//
// Pass B (work compacted inside the block): what bounds it on this card is
// the rate of the SMs' warp schedulers (one operation a cycle each), not
// bytes.  A term costs about 50 machine operations (precise
// expf, a division with the IEEE bits, no contracted FMA: all three are
// needed for the bits), and only the occupied entries have terms: the table
// is front-filled and mostly empty, so a thread per pixel looping over its S
// slots leaves most lanes of a warp masked off while one lane walks a
// window.  Here a block owns a B_TW x B_TH tile and
//   1. stages the observation halo once, packed: (ox, oy, oz, ck_kappa) as
//      one float4 per halo pixel and the track beside it, so a term is one
//      16-byte and one 4-byte shared load; invalid and out-of-image pixels
//      carry track -1, which never equals a particle track and is skipped;
//   2. scans trk_eff of its B_TW x B_TH x S entries with coalesced loads,
//      writes acc = 0 and right = 0 for the empty ones at once, and pushes
//      the occupied ones onto a work list in shared memory (one ballot and
//      one shared atomic per warp; the list holds a whole tile, so nothing
//      is dropped when every entry is occupied);
//   3. hands the list out one entry per thread, so every lane of every warp
//      but the last of a tile walks a full window.
// An entry is never split across lanes: its terms are evaluated in the plain
// version's expression order, its offsets visited in the plain version's
// order and summed sequentially, so with -fmad=false and precise expf the
// result matches bit for bit (except for the clipped terms above).  The
// "rightly updated" flag keeps the exact comparison COEF^3 * exp(...) > 0.1,
// and an occupied slot with a zero forgetting factor still computes it.
// The tile is small and the block has twice as many threads as pixels: the
// halo costs a few dozen operations per pixel against thousands for the
// terms, a frame's particles lie in patches, and the block scheduler evens
// out tiles with many and few of them only if no tile is long; a tile with
// several entries per pixel still takes few rounds.  The division: see
// div_term.
//
// Every R and S runs: pass A's kernel where one plane of the halo fits its
// list (R <= 13) and a pixel's window holds at most 8,192 entries, pass B's
// where its halo and a tile's list fit the card's shared memory; past
// those, a streaming pass finds each pixel's live planes once
// (live_planes_kernel) and the wide instances (pass_a_wide_kernel,
// pass_b_wide_kernel, below) work from its bits: pass B's terms still in
// the plain version's order, pass A's sum a partial a window row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

// Pass A tile, block and list: 256 pixels, one thread each, A_CAP entries.
constexpr int A_TW = 32;
constexpr int A_TH = 8;
constexpr int A_NT = A_TW * A_TH;
constexpr int A_CAP = 2048;  // holds one plane of the halo up to R = 13 (pass_a_wide_kernel past it)

// Exclusive prefix sums of popc(s_mask[i] & sel), i < n, into s_start[0..n];
// returns the total.  Every thread of the block calls it.
__device__ __forceinline__ int scan_live(
    const unsigned* s_mask, unsigned sel, int* s_start, int* s_warp, int n, int tid) {
  const int per = (n + A_NT - 1) / A_NT;
  const int lo = min(tid * per, n), hi = min(lo + per, n);
  int local = 0;
  for (int i = lo; i < hi; ++i) local += __popc(s_mask[i] & sel);
  int incl = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if ((tid & 31) >= d) incl += v;
  }
  if ((tid & 31) == 31) s_warp[tid >> 5] = incl;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < A_NT / 32; ++w) {
    const int v = s_warp[w];
    if (w < (tid >> 5)) before += v;
    total += v;
  }
  int pos = before + incl - local;
  for (int i = lo; i < hi; ++i) {
    s_start[i] = pos;
    pos += __popc(s_mask[i] & sel);
  }
  if (tid == 0) s_start[n] = total;
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(A_NT, 4) pass_a_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ weff,
    const int* __restrict__ trk,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ isg,
    const int* __restrict__ otrk,
    float* __restrict__ ck,
    int S, int H, int W, int R, float coef3, float id_p, int independent) {
  extern __shared__ float4 smem_a[];
  __shared__ int s_warp[A_NT / 32];
  const int sw = A_TW + 2 * R;
  const int n = sw * (A_TH + 2 * R);
  float4* s_ent = smem_a;                                     // px, py, pz, w_eff
  int* s_trk = reinterpret_cast<int*>(s_ent + A_CAP);         // track (first: entry code)
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_trk + A_CAP);  // live bits per halo pixel
  int* s_start = reinterpret_cast<int*>(s_mask + n);          // n + 1 list positions

  const int tid = threadIdx.x;
  const int tx = tid & (A_TW - 1), ty = tid / A_TW;
  const int x0 = blockIdx.x * A_TW, y0 = blockIdx.y * A_TH;
  const int x = x0 + tx, y = y0 + ty;
  const bool inside = x < W && y < H;
  const long long HW = (long long)H * W;
  const int side = 2 * R + 1;

  float qx = 0.f, qy = 0.f, qz = 0.f, qs = 0.f;
  int qt = -1;
  if (inside) {
    const long long q = (long long)y * W + x;
    qx = ox[q]; qy = oy[q]; qz = oz[q]; qs = isg[q]; qt = otrk[q];
  }
  float acc = 0.f;

  // The planes of ``sel`` (bits relative to plane s_lo), ``total`` > 0 live
  // entries: list them and add every pixel's terms.  Uniform over the block.
  auto run = [&](int s_lo, unsigned sel, int total) {
    // entry codes in list order; the order of a pixel's slots is ascending
    for (int i = tid; i < n; i += A_NT) {
      unsigned m = s_mask[i] & sel;
      int pos = s_start[i];
      while (m != 0u) {
        const int b = __ffs(m) - 1;
        m &= m - 1u;
        s_trk[pos++] = (b << 16) | i;
      }
    }
    __syncthreads();
    // one live entry per thread: its position, weight and track
    for (int k = tid; k < total; k += A_NT) {
      const int code = s_trk[k];
      const int i = code & 0xffff, b = code >> 16;
      const int iy = i / sw, ix = i - iy * sw;
      const long long g = (long long)(s_lo + b) * HW + (long long)(y0 + iy - R) * W + (x0 + ix - R);
      s_ent[k] = make_float4(px[g], py[g], pz[g], weff[g]);
      s_trk[k] = trk[g];
    }
    __syncthreads();
    if (inside) {
      for (int dm = 0; dm < side; ++dm) {
        const int first = (ty + dm) * sw + tx;
        const int end = s_start[first + side];
        for (int k = s_start[first]; k < end; ++k) {
          const float4 e = s_ent[k];
          const int t = s_trk[k];
          const float zx = (e.x - qx) * qs;
          const float zy = (e.y - qy) * qs;
          const float zz = (e.z - qz) * qs;
          const float s2 = zx * zx + zy * zy + zz * zz;
          float gk = coef3 * expf(-0.5f * s2);
          if (independent) {
            if (t == qt) acc += e.w * gk;
          } else {
            if (t != qt) gk = gk * id_p;
            acc += e.w * gk;
          }
        }
      }
    }
    __syncthreads();  // the list and the positions are reused
  };

  for (int s_lo = 0; s_lo < S; s_lo += 32) {
    const int planes = min(32, S - s_lo);
    // w_eff is read here and nowhere else decides what is listed
    for (int i = tid; i < n; i += A_NT) {
      const int iy = i / sw, ix = i - iy * sw;
      const int gy = y0 + iy - R, gx = x0 + ix - R;
      unsigned m = 0u;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const float* p = weff + s_lo * HW + (long long)gy * W + gx;
#pragma unroll 4
        for (int b = 0; b < planes; ++b)
          if (p[b * HW] != 0.f) m |= 1u << b;
      }
      s_mask[i] = m;
    }
    __syncthreads();
    const unsigned all = planes == 32 ? 0xffffffffu : (1u << planes) - 1u;
    const int total = scan_live(s_mask, all, s_start, s_warp, n, tid);
    if (total == 0) continue;
    if (total <= A_CAP) {
      run(s_lo, all, total);
    } else {
      const int step = A_CAP / n;  // planes whose entries always fit the list
      for (int b0 = 0; b0 < planes; b0 += step) {
        const int b1 = min(b0 + step, planes);
        const unsigned sel = (b1 == 32 ? 0xffffffffu : (1u << b1) - 1u) & ~((1u << b0) - 1u);
        const int part = scan_live(s_mask, sel, s_start, s_warp, n, tid);
        if (part != 0) run(s_lo, sel, part);
      }
    }
  }
  if (inside) ck[(long long)y * W + x] = acc;
}

// Pass B tile and block: 128 pixels, up to 128 * S list entries, 256 threads.
constexpr int B_TW = 32;
constexpr int B_TH = 4;
constexpr int B_PIX = B_TW * B_TH;
constexpr int B_NT = 256;
constexpr int B_SCAN = 8;  // trk_eff loads in flight per thread in the scan
static_assert(B_NT % 32 == 0, "the scan's ballots need whole warps");

// y / c with the bits of the IEEE division.  The hardware's division takes
// a slow path of about a hundred operations whenever the numerator is
// zero or so small that it or the quotient is denormal, and a warp pays it
// when one lane needs it; observation pixels far from a particle give such
// terms (a quarter of them are exact zeros in a table of random positions).
// For 0 <= y < 2^-40 and 2^-20 <= c <= 2^20 the same bits come without it.
// A zero stays zero.  Else y is scaled by 2^64 (exact) and divided, operands
// and quotient now mid-range: qs is the true scaled quotient rounded to 24
// bits.  Scaled back it is the answer while that is normal (qs >= 2^-62).
// A denormal answer is the true quotient rounded to a multiple of 2^-149:
// w = qs * 2^85 counts in those units (exact, below 2^23).  Rounding to 24
// bits is monotone and keeps every k + 0.5 below 2^23, so w lies on the same
// side of each tie as the true quotient and rintf(w) is right, unless w is
// a tie itself: then the sign of the exact remainder ys - qs * c (an FMA,
// scaled by 2^60 twice over to stay clear of underflow) says on which side
// the true quotient lies, and a zero remainder is a true tie, which rintf
// rounds to even as the division does.
__device__ __forceinline__ float div_term(float y, float c) {
  if (!(y >= 0.f && y < 0x1p-40f && c >= 0x1p-20f && c <= 0x1p+20f)) return y / c;
  if (y == 0.f) return 0.f;
  const float ys = y * 0x1p+64f;
  const float qs = ys / c;
  if (qs >= 0x1p-62f) return qs * 0x1p-64f;
  const float w = qs * 0x1p+85f;
  float n = rintf(w);
  if (fabsf(w - n) == 0.5f) {
    const float r = fmaf(-(qs * 0x1p+60f), c, ys * 0x1p+60f);
    if (r != 0.f) n = r > 0.f ? ceilf(w) : floorf(w);
  }
  return n * 0x1p-149f;
}

__global__ void __launch_bounds__(B_NT, 6) pass_b_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const int* __restrict__ trk_eff,
    const float* __restrict__ ff_eff, const float* __restrict__ isg_p,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const uint8_t* __restrict__ ovalid,
    const int* __restrict__ otrk, const float* __restrict__ ck_kappa,
    float* __restrict__ acc_out, uint8_t* __restrict__ right_out,
    int S, int H, int W, int R, float coef3, float id_p, float thr_right,
    int independent) {
  extern __shared__ float4 smem_b[];
  __shared__ int s_count;
  const int sw = B_TW + 2 * R;
  const int n = sw * (B_TH + 2 * R);
  float4* s_obs = smem_b;                             // ox, oy, oz, ck_kappa
  int* s_ot = reinterpret_cast<int*>(s_obs + n);      // track, -1 = skip
  int* s_list = s_ot + n;                             // occupied entries

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int x0 = blockIdx.x * B_TW, y0 = blockIdx.y * B_TH;
  const long long HW = (long long)H * W;
  const int side = 2 * R + 1;

  if (tid == 0) s_count = 0;
  for (int i = tid; i < n; i += B_NT) {
    const int iy = i / sw, ix = i - iy * sw;
    const int gy = y0 + iy - R, gx = x0 + ix - R;
    float4 o = make_float4(0.f, 0.f, 0.f, 1.f);
    int t = -1;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      // all six loads at once: a load that waits for ovalid doubles the latency
      const long long q = (long long)gy * W + gx;
      const bool valid = ovalid[q] != 0;
      const float4 v = make_float4(ox[q], oy[q], oz[q], ck_kappa[q]);
      const int vt = otrk[q];
      if (valid) {
        o = v;
        t = vt;
      }
    }
    s_obs[i] = o;
    s_ot[i] = t;
  }
  __syncthreads();

  // Scan: entry e of the tile is slot e / B_PIX of tile pixel e % B_PIX.
  // Every thread runs every round (the ballots need whole warps).
  const int total = B_PIX * S;
  for (int e0 = 0; e0 < total; e0 += B_NT * B_SCAN) {
    int trk[B_SCAN];
    long long gs[B_SCAN];
#pragma unroll
    for (int u = 0; u < B_SCAN; ++u) {
      const int e = e0 + u * B_NT + tid;
      const int s = e / B_PIX, p = e - s * B_PIX;
      const int x = x0 + p % B_TW, y = y0 + p / B_TW;
      gs[u] = -1;
      trk[u] = -2;
      if (e < total && x < W && y < H) {
        gs[u] = s * HW + (long long)y * W + x;
        trk[u] = trk_eff[gs[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < B_SCAN; ++u) {
      const bool occupied = trk[u] != -2;
      if (!occupied && gs[u] >= 0) {
        acc_out[gs[u]] = 0.f;
        right_out[gs[u]] = 0;
      }
      const unsigned m = __ballot_sync(0xffffffffu, occupied);
      int base = 0;
      if (lane == 0 && m != 0u) base = atomicAdd(&s_count, __popc(m));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (occupied) s_list[base + __popc(m & ((1u << lane) - 1u))] = e0 + u * B_NT + tid;
    }
  }
  __syncthreads();

  // One list entry per thread; the whole window in the plain version's order.
  const int n_work = s_count;
  for (int k = tid; k < n_work; k += B_NT) {
    const int e = s_list[k];
    const int s = e / B_PIX, p = e - s * B_PIX;
    const int tx = p % B_TW, ty = p / B_TW;
    const long long q = (long long)(y0 + ty) * W + (x0 + tx);
    const long long g = s * HW + q;
    const int t = trk_eff[g];
    const float ppx = px[g], ppy = py[g], ppz = pz[g], ff = ff_eff[g];
    const float sg = isg_p[q];
    float acc = 0.f;
    bool right = false;
    for (int dm = 0; dm < side; ++dm) {
      const int row = (ty + dm) * sw + tx;
      for (int dn = 0; dn < side; ++dn) {
        const int i = row + dn;
        const int ot = s_ot[i];
        if (ot == -1) continue;
        const float4 o = s_obs[i];
        const float zx = (ppx - o.x) * sg;
        const float zy = (ppy - o.y) * sg;
        const float zz = (ppz - o.z) * sg;
        const float s2 = zx * zx + zy * zy + zz * zz;
        const float g_raw = coef3 * expf(-0.5f * s2);
        const bool same = ot == t;
        float gk;
        if (independent) {
          gk = same ? g_raw : 0.f;
        } else {
          if (same && g_raw > thr_right) right = true;
          gk = same ? g_raw : g_raw * id_p;
          gk = gk * ff;
        }
        acc = acc + div_term(gk, o.w);
      }
    }
    acc_out[g] = acc;
    right_out[g] = right ? 1 : 0;
  }
}

// The wide instances: every R and S the config takes.  pass_a_kernel lists
// one plane group of the whole halo at a time, so one plane of the halo must
// fit its list ((A_TW + 2R) * (A_TH + 2R) <= A_CAP: R <= 13), and
// pass_b_kernel holds the whole halo and a whole tile's work list in shared
// memory (20 B a halo pixel and 4 * B_PIX * S bytes: at R = 5 no more than
// about S = 430 fit the card's 227 KB).  Past those the wrappers run two
// launches: first live_planes_kernel, then the wide instance.
//
// What bounds them.  A wide table is deep and almost empty: a real store
// never fills a pixel past slot 12, so at S = 512 some 500 of the 512 planes
// hold nothing.  Pass B's least time is a stream (trk_eff read, acc and right
// written: 2.15 GB at S = 512, 0.64 ms at 3.35 TB/s) and pass A's is w_eff
// read once (0.95 GB); the terms of the few occupied entries come after.  So
// the deciding plane of each table is read once, by a pass built to stream:
//
// live_planes_kernel: the words, u32 [ceil(S / 32), H, W] (29.8 MB at
// S = 512 and 1242 x 375, which stays in the 50 MB L2 for the wide instance
// that reads them), hold bit b of word (g, pixel) where plane 32g + b of
// the pixel is live (pass A: w_eff != 0; pass B: trk_eff != -2).  They are
// cleared, then the table is streamed as one flat array: a thread has four
// 16-byte loads in flight and sets the bits of its live entries by atomic OR
// (a few in a hundred; neighbouring lanes hit neighbouring words).  For pass
// B it also writes acc = 0 and right = 0 at every empty entry, 16 and 4
// bytes a vector where all four entries are empty, so every output is still
// written exactly once.  Not a thread per pixel and plane group: its 4-byte
// accesses along the planes (whose bases are off 16-byte bounds at VKITTI2,
// H * W * 4 = 1,863,000 B) ran pass B's stream at 56% of its bound.
//
// Pass A wide: the halo is cut into chunks of at most A_CAP pixels (whole
// halo rows, or pieces of one row where a row is longer).  For each chunk
// the block reads the live words of every plane group at once and ORs them
// into the set of groups with a live entry there; a group without one costs
// nothing more, and a tile with none writes its zeros.  Each live group runs
// as the whole halo runs in pass_a_kernel, its bits now read from the words
// instead of from w_eff: the block's prefix scan, the list in plane
// sub-groups, and every pixel's terms from the rows and columns of its
// window that lie in the chunk, each such row's entries one contiguous range
// of the list.  A chunk wholly outside the image is skipped.  The sum: each
// window row's range into a partial of its own, the partial added to the
// pixel's total (chunk by chunk, group by group, sub-group by sub-group,
// row by row).  One accumulator added to term by term drifts from the plain
// version by about the square root of its term count in ulps, and a pixel of
// a full table at S = 512 and R = 5 has 61,952 terms (5.1e-5 relative on an
// H100 with one accumulator, past the rtol 2e-5 of the check); with a
// partial a row the total takes a few thousand additions and each partial a
// few dozen (tests/test_torch_phd_wide_sum.py replays this order on the
// CPU).  pass_a_kernel runs where a pixel's window holds at most
// A_MAX_TERMS = 8,192 entries (S (2R+1)^2: the presets' 1,452 at R = 5,
// S = 12); every other shape runs here.  The order depends on the data
// alone, so two launches give the same bits; it agrees with the plain
// version at rtol 2e-5.
//
// Pass B wide: the tile's live words, up to BW_WORDS at a time (16 plane
// groups of its 128 pixels), are turned into list positions by the block's
// prefix scan of their bit counts, and the occupied entries are handed out
// in rounds of BW_LIST: no round visits an empty plane.  Where the halo fits
// one piece of BW_PIECE pixels (R <= 23) it is staged once and each entry,
// one a thread, walks its whole window as in pass_b_kernel
// (pass_b_wide_kernel<true>).  Past that the halo is staged in pieces (bands
// of whole halo rows, or pieces of one row) and each thread holds BW_EPT
// entries' sums across them (<false>).  Either way each entry adds its
// terms in the plain version's order (offset rows ascending, columns
// ascending within a row), so the sequence of additions, and with it every
// bit, is pass_b_kernel's.
constexpr long long A_MAX_TERMS = 8192;   // a pixel's window entries for pass_a_kernel
constexpr int L_NT = 256;                 // live_planes_kernel: threads a block
constexpr int L_VEC = 4;                  // and 4-entry vectors a thread
constexpr int BW_EPT = 4;                 // list entries a thread holds (pieces)
constexpr int BW_LIST = B_NT * BW_EPT;    // list entries a round
constexpr int BW_PIECE = 4096;            // halo pixels a piece
constexpr int BW_WORDS = 2048;            // live words a block scans at once
static_assert(BW_WORDS % B_PIX == 0 && BW_WORDS / B_PIX <= 32, "whole plane groups");
static_assert(B_NT == A_NT, "pass B wide scans with scan_live");

// The halo in chunks of at most `cap` pixels: `*cw` columns by `*ch` rows,
// whole rows where a row fits, else one row.
void halo_chunks(int hw, int hh, int cap, int* cw, int* ch) {
  *cw = hw < cap ? hw : cap;
  *ch = cap / *cw < hh ? cap / *cw : hh;
}

template <bool TRACKS>
__global__ void __launch_bounds__(L_NT) live_planes_kernel(
    const int* __restrict__ plane, unsigned* __restrict__ live, float* __restrict__ acc_out,
    uint8_t* __restrict__ right_out, long long n, long long HW, double inv_hw, int aligned) {
  // entry bits: a weight is live unless it is +0 or -0, a track unless it is -2
  auto is_live = [](int v) { return TRACKS ? v != -2 : (v & 0x7fffffff) != 0; };
  // entry e is plane s = e / HW of pixel e - s * HW; the quotient by the
  // reciprocal (off by at most one, then set right) keeps the 64-bit
  // division's subroutine call, and the registers it saves, out of the kernel
  auto mark = [&](long long e) {
    long long s = (long long)((double)e * inv_hw);
    if (s * HW > e) {
      --s;
    } else if ((s + 1) * HW <= e) {
      ++s;
    }
    atomicOr(&live[(s >> 5) * HW + (e - s * HW)], 1u << (s & 31));
  };
  const long long first = (long long)blockIdx.x * (L_NT * L_VEC) + threadIdx.x;  // a 4-entry vector
  int4 v[L_VEC];
#pragma unroll
  for (int k = 0; k < L_VEC; ++k) {
    const long long j = first + k * L_NT;
    v[k] = aligned && 4 * j + 3 < n ? reinterpret_cast<const int4*>(plane)[j]
                                    : make_int4(0, 0, 0, 0);
  }
#pragma unroll
  for (int k = 0; k < L_VEC; ++k) {
    const long long j = first + k * L_NT;
    if (!aligned || 4 * j + 3 >= n) {
      // one entry at a time: past the last whole vector, or off 16-byte bounds
      for (long long e = 4 * j; e < n && e < 4 * j + 4; ++e) {
        if (is_live(plane[e])) {
          mark(e);
        } else if (TRACKS) {
          acc_out[e] = 0.f;
          right_out[e] = 0;
        }
      }
      continue;
    }
    const int w[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
    bool any = false;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (is_live(w[i])) {
        any = true;
        mark(4 * j + i);
      }
    }
    if (!TRACKS) continue;
    if (!any) {
      reinterpret_cast<float4*>(acc_out)[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<unsigned*>(right_out)[j] = 0u;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!is_live(w[i])) {
          acc_out[4 * j + i] = 0.f;
          right_out[4 * j + i] = 0;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(A_NT, 4) pass_a_wide_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ weff,
    const int* __restrict__ trk,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ isg,
    const int* __restrict__ otrk, const unsigned* __restrict__ live,
    float* __restrict__ ck,
    int S, int H, int W, int R, float coef3, float id_p, int independent, int cw, int ch) {
  extern __shared__ float4 smem_aw[];
  __shared__ int s_warp[A_NT / 32];
  __shared__ unsigned s_groups;
  float4* s_ent = smem_aw;                                         // px, py, pz, w_eff
  int* s_trk = reinterpret_cast<int*>(s_ent + A_CAP);              // track (first: entry code)
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_trk + A_CAP);   // live bits per chunk pixel
  int* s_start = reinterpret_cast<int*>(s_mask + cw * ch);         // list positions

  const int tid = threadIdx.x;
  const int tx = tid & (A_TW - 1), ty = tid / A_TW;
  const int x0 = blockIdx.x * A_TW, y0 = blockIdx.y * A_TH;
  const int x = x0 + tx, y = y0 + ty;
  const bool inside = x < W && y < H;
  const long long HW = (long long)H * W;
  const int hw = A_TW + 2 * R, hh = A_TH + 2 * R;
  const int G = (S + 31) >> 5;

  float qx = 0.f, qy = 0.f, qz = 0.f, qs = 0.f;
  int qt = -1;
  if (inside) {
    const long long q = (long long)y * W + x;
    qx = ox[q]; qy = oy[q]; qz = oz[q]; qs = isg[q]; qt = otrk[q];
  }
  float acc = 0.f;

  for (int r0 = 0; r0 < hh; r0 += ch) {
    const int rh = min(ch, hh - r0);
    if (y0 + r0 + rh - 1 - R < 0 || y0 + r0 - R >= H) continue;  // uniform
    for (int c0 = 0; c0 < hw; c0 += cw) {
      const int rw = min(cw, hw - c0);
      if (x0 + c0 + rw - 1 - R < 0 || x0 + c0 - R >= W) continue;
      const int n = rw * rh;
      // this pixel's window in the chunk: halo rows ra..rb, columns lo..hi
      const int ra = max(ty, r0), rb = min(ty + 2 * R, r0 + rh - 1);
      const int lo = max(tx, c0), hi = min(tx + 2 * R, c0 + rw - 1);
      // The chunk pixel i in the image: the offset of its (row, column) in a
      // plane, else -1.
      auto pixel = [&](int i) -> long long {
        const int iy = i / rw, ix = i - iy * rw;
        const int gy = y0 + r0 + iy - R, gx = x0 + c0 + ix - R;
        return gy >= 0 && gy < H && gx >= 0 && gx < W ? (long long)gy * W + gx : -1;
      };

      // The planes of ``sel`` (bits relative to plane s_lo), ``total`` > 0
      // live entries: list them and add every pixel's terms.
      auto run = [&](int s_lo, unsigned sel, int total) {
        for (int i = tid; i < n; i += A_NT) {
          unsigned m = s_mask[i] & sel;
          int pos = s_start[i];
          while (m != 0u) {
            const int b = __ffs(m) - 1;
            m &= m - 1u;
            s_trk[pos++] = (b << 16) | i;
          }
        }
        __syncthreads();
        for (int k = tid; k < total; k += A_NT) {
          const int code = s_trk[k];
          const int i = code & 0xffff, b = code >> 16;
          const long long g = (long long)(s_lo + b) * HW + pixel(i);
          s_ent[k] = make_float4(px[g], py[g], pz[g], weff[g]);
          s_trk[k] = trk[g];
        }
        __syncthreads();
        if (inside && lo <= hi) {
          for (int row = ra; row <= rb; ++row) {
            const int first = (row - r0) * rw + (lo - c0);
            const int end = s_start[first + (hi - lo) + 1];
            float part = 0.f;  // this window row's terms
            for (int k = s_start[first]; k < end; ++k) {
              const float4 e = s_ent[k];
              const int t = s_trk[k];
              const float zx = (e.x - qx) * qs;
              const float zy = (e.y - qy) * qs;
              const float zz = (e.z - qz) * qs;
              const float s2 = zx * zx + zy * zy + zz * zz;
              float gk = coef3 * expf(-0.5f * s2);
              if (independent) {
                if (t == qt) part += e.w * gk;
              } else {
                if (t != qt) gk = gk * id_p;
                part += e.w * gk;
              }
            }
            acc += part;
          }
        }
        __syncthreads();  // the list and the positions are reused
      };

      for (int g0 = 0; g0 < G; g0 += 32) {
        // the groups g0 .. g0 + 31 with a live entry in the chunk, read at once
        const int ng = min(32, G - g0);
        unsigned seen = 0u;
        for (int i = tid; i < n; i += A_NT) {
          const long long q = pixel(i);
          if (q < 0) continue;
          const unsigned* w = live + (long long)g0 * HW + q;
          for (int k = 0; k < ng; ++k)
            if (w[k * HW] != 0u) seen |= 1u << k;
        }
        seen = __reduce_or_sync(0xffffffffu, seen);
        __syncthreads();  // the last readers of s_groups are done
        if (tid == 0) s_groups = 0u;
        __syncthreads();
        if ((tid & 31) == 0 && seen != 0u) atomicOr(&s_groups, seen);
        __syncthreads();
        for (unsigned groups = s_groups; groups != 0u; groups &= groups - 1u) {
          const int g = g0 + __ffs(groups) - 1;
          const int planes = min(32, S - 32 * g);
          for (int i = tid; i < n; i += A_NT) {
            const long long q = pixel(i);
            s_mask[i] = q < 0 ? 0u : live[(long long)g * HW + q];
          }
          __syncthreads();
          const unsigned all = planes == 32 ? 0xffffffffu : (1u << planes) - 1u;
          const int total = scan_live(s_mask, all, s_start, s_warp, n, tid);
          if (total <= A_CAP) {
            run(32 * g, all, total);
          } else {
            const int step = A_CAP / n;  // n <= A_CAP: at least one plane
            for (int b0 = 0; b0 < planes; b0 += step) {
              const int b1 = min(b0 + step, planes);
              const unsigned sel = (b1 == 32 ? 0xffffffffu : (1u << b1) - 1u) & ~((1u << b0) - 1u);
              const int part = scan_live(s_mask, sel, s_start, s_warp, n, tid);
              if (part != 0) run(32 * g, sel, part);
            }
          }
        }
      }
    }
  }
  if (inside) ck[(long long)y * W + x] = acc;
}

template <bool ONE_PIECE>
__global__ void __launch_bounds__(B_NT, ONE_PIECE ? 4 : 2) pass_b_wide_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const int* __restrict__ trk_eff,
    const float* __restrict__ ff_eff, const float* __restrict__ isg_p,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const uint8_t* __restrict__ ovalid,
    const int* __restrict__ otrk, const float* __restrict__ ck_kappa,
    const unsigned* __restrict__ live,
    float* __restrict__ acc_out, uint8_t* __restrict__ right_out,
    int S, int H, int W, int R, float coef3, float id_p, float thr_right,
    int independent, int pw, int pr) {
  extern __shared__ float4 smem_bw[];
  __shared__ int s_warp[B_NT / 32];
  float4* s_obs = smem_bw;                                      // ox, oy, oz, ck_kappa
  int* s_ot = reinterpret_cast<int*>(s_obs + pw * pr);          // track, -1 = skip
  int* s_list = s_ot + pw * pr;                                 // occupied entries of a round
  unsigned* s_word = reinterpret_cast<unsigned*>(s_list + BW_LIST);  // the tile's live words
  int* s_start = reinterpret_cast<int*>(s_word + BW_WORDS);     // their list positions

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * B_TW, y0 = blockIdx.y * B_TH;
  const long long HW = (long long)H * W;
  const int sw = B_TW + 2 * R, hh = B_TH + 2 * R;
  const int G = (S + 31) >> 5;
  constexpr int GPW = BW_WORDS / B_PIX;  // plane groups a scan

  // Stages the piece of halo rows r0.. and columns c0.. (rh x rw pixels).
  auto stage = [&](int r0, int c0, int rh, int rw) {
    for (int i = tid; i < rh * rw; i += B_NT) {
      const int iy = i / rw, ix = i - iy * rw;
      const int gy = y0 + r0 + iy - R, gx = x0 + c0 + ix - R;
      float4 o = make_float4(0.f, 0.f, 0.f, 1.f);
      int t = -1;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const long long q = (long long)gy * W + gx;
        const bool valid = ovalid[q] != 0;
        const float4 v = make_float4(ox[q], oy[q], oz[q], ck_kappa[q]);
        const int vt = otrk[q];
        if (valid) {
          o = v;
          t = vt;
        }
      }
      s_obs[i] = o;
      s_ot[i] = t;
    }
  };
  if (ONE_PIECE) stage(0, 0, hh, sw);  // read by every round below

  for (int g0 = 0; g0 < G; g0 += GPW) {
    // word i = k * B_PIX + p: plane group g0 + k of tile pixel p
    const int nw = min(GPW, G - g0) * B_PIX;
    for (int i = tid; i < nw; i += B_NT) {
      const int k = i / B_PIX, p = i - k * B_PIX;
      const int x = x0 + p % B_TW, y = y0 + p / B_TW;
      s_word[i] = x < W && y < H ? live[(long long)(g0 + k) * HW + (long long)y * W + x] : 0u;
    }
    __syncthreads();
    const int total = scan_live(s_word, 0xffffffffu, s_start, s_warp, nw, tid);
    for (int base = 0; base < total; base += BW_LIST) {
      // the round's list: the occupied entries at positions base .. base + BW_LIST - 1
      for (int i = tid; i < nw; i += B_NT) {
        int pos = s_start[i];
        if (s_start[i + 1] <= base || pos >= base + BW_LIST) continue;
        for (unsigned m = s_word[i]; m != 0u; m &= m - 1u, ++pos)
          if (pos >= base && pos < base + BW_LIST) s_list[pos - base] = (i << 5) | (__ffs(m) - 1);
      }
      __syncthreads();
      const int n_work = min(BW_LIST, total - base);
      // list entry -> (slot, tile pixel)
      auto entry = [&](int k, int* s, int* p) {
        const int e = s_list[k], i = e >> 5;
        *s = 32 * (g0 + i / B_PIX) + (e & 31);
        *p = i % B_PIX;
      };
      if (ONE_PIECE) {
        // One entry per thread; the whole window in the plain version's order.
        for (int k = tid; k < n_work; k += B_NT) {
          int s, p;
          entry(k, &s, &p);
          const int tx = p % B_TW, ty = p / B_TW;
          const long long q = (long long)(y0 + ty) * W + (x0 + tx);
          const long long g = s * HW + q;
          const int t = trk_eff[g];
          const float ppx = px[g], ppy = py[g], ppz = pz[g], ff = ff_eff[g];
          const float sg = isg_p[q];
          float acc = 0.f;
          bool right = false;
          for (int dm = 0; dm <= 2 * R; ++dm) {
            const int row = (ty + dm) * sw + tx;
            for (int dn = 0; dn <= 2 * R; ++dn) {
              const int i = row + dn;
              const int ot = s_ot[i];
              if (ot == -1) continue;
              const float4 o = s_obs[i];
              const float zx = (ppx - o.x) * sg;
              const float zy = (ppy - o.y) * sg;
              const float zz = (ppz - o.z) * sg;
              const float s2 = zx * zx + zy * zy + zz * zz;
              const float g_raw = coef3 * expf(-0.5f * s2);
              const bool same = ot == t;
              float gk;
              if (independent) {
                gk = same ? g_raw : 0.f;
              } else {
                if (same && g_raw > thr_right) right = true;
                gk = same ? g_raw : g_raw * id_p;
                gk = gk * ff;
              }
              acc = acc + div_term(gk, o.w);
            }
          }
          acc_out[g] = acc;
          right_out[g] = right ? 1 : 0;
        }
      } else {
        // This thread's entries: their particle, their window's place, their sums.
        int et[BW_EPT], etx[BW_EPT], ety[BW_EPT];
        long long eg[BW_EPT];
        float ex[BW_EPT], ey[BW_EPT], ez[BW_EPT], eff[BW_EPT], esg[BW_EPT], eacc[BW_EPT];
        bool eright[BW_EPT];
#pragma unroll
        for (int i = 0; i < BW_EPT; ++i) {
          const int k = tid + i * B_NT;
          eacc[i] = 0.f;
          eright[i] = false;
          eg[i] = -1;
          et[i] = etx[i] = ety[i] = 0;
          ex[i] = ey[i] = ez[i] = eff[i] = esg[i] = 0.f;
          if (k < n_work) {
            int s, p;
            entry(k, &s, &p);
            etx[i] = p % B_TW;
            ety[i] = p / B_TW;
            const long long q = (long long)(y0 + ety[i]) * W + (x0 + etx[i]);
            eg[i] = s * HW + q;
            et[i] = trk_eff[eg[i]];
            ex[i] = px[eg[i]]; ey[i] = py[eg[i]]; ez[i] = pz[eg[i]]; eff[i] = ff_eff[eg[i]];
            esg[i] = isg_p[q];
          }
        }
        for (int r0 = 0; r0 < hh; r0 += pr) {
          const int rh = min(pr, hh - r0);
          if (y0 + r0 + rh - 1 - R < 0 || y0 + r0 - R >= H) continue;  // uniform
          for (int c0 = 0; c0 < sw; c0 += pw) {
            const int rw = min(pw, sw - c0);
            if (x0 + c0 + rw - 1 - R < 0 || x0 + c0 - R >= W) continue;
            __syncthreads();  // the last piece's readers are done
            stage(r0, c0, rh, rw);
            __syncthreads();
#pragma unroll
            for (int i = 0; i < BW_EPT; ++i) {
              if (eg[i] < 0) continue;
              const int ra = max(ety[i], r0), rb = min(ety[i] + 2 * R, r0 + rh - 1);
              const int lo = max(etx[i], c0), hi = min(etx[i] + 2 * R, c0 + rw - 1);
              float acc = eacc[i];
              bool right = eright[i];
              for (int row = ra; row <= rb; ++row) {
                for (int col = lo; col <= hi; ++col) {
                  const int j = (row - r0) * rw + (col - c0);
                  const int ot = s_ot[j];
                  if (ot == -1) continue;
                  const float4 o = s_obs[j];
                  const float zx = (ex[i] - o.x) * esg[i];
                  const float zy = (ey[i] - o.y) * esg[i];
                  const float zz = (ez[i] - o.z) * esg[i];
                  const float s2 = zx * zx + zy * zy + zz * zz;
                  const float g_raw = coef3 * expf(-0.5f * s2);
                  const bool same = ot == et[i];
                  float gk;
                  if (independent) {
                    gk = same ? g_raw : 0.f;
                  } else {
                    if (same && g_raw > thr_right) right = true;
                    gk = same ? g_raw : g_raw * id_p;
                    gk = gk * eff[i];
                  }
                  acc = acc + div_term(gk, o.w);
                }
              }
              eacc[i] = acc;
              eright[i] = right;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < BW_EPT; ++i) {
          if (eg[i] < 0) continue;
          acc_out[eg[i]] = eacc[i];
          right_out[eg[i]] = eright[i] ? 1 : 0;
        }
      }
      __syncthreads();  // the list is reused
    }
  }
}

// Pass A: the list (20 bytes an entry), a word of live bits and a list
// position per halo pixel (per chunk pixel in the wide instance).
size_t pass_a_smem_bytes(int n) {
  return size_t(20) * A_CAP + sizeof(int) * (2 * size_t(n) + 1);
}

// Pass B: the packed halo (20 bytes a pixel) and a list of a whole tile.
size_t pass_b_smem_bytes(int R, int S) {
  return size_t(20) * (B_TW + 2 * R) * (B_TH + 2 * R) + sizeof(int) * B_PIX * S;
}

// Pass B wide: a piece of the halo, a round's list, the live words and
// their list positions.
size_t pass_b_wide_smem_bytes(int pixels) {
  return size_t(20) * pixels + sizeof(int) * (BW_LIST + 2 * BW_WORDS + 1);
}

// The most shared memory a block of the current device may ask for.
int max_block_smem() {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&cached, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess)
      cached = 48 * 1024;
  }
  return cached;
}

// Launches `kernel` with `smem` bytes of dynamic shared memory, asked for
// first where it passes 48 KB (a request beyond what the card has fails
// there).
template <typename... P, typename... A>
int launch_smem(void (*kernel)(P...), CUfunction& fn, dim3 grid, int threads, size_t smem,
                void* stream, A... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return dsp::launch(kernel, fn, grid, threads, (unsigned)smem, (cudaStream_t)stream, args...);
}

// Where each pass runs its main instance: pass A where one plane of the halo
// fits the list and a pixel's sum is short, pass B where the whole halo and
// a tile's list fit the card's shared memory.
bool pass_a_main(int S, int R) {
  const long long side = 2 * R + 1;
  return (long long)(A_TW + 2 * R) * (A_TH + 2 * R) <= A_CAP && S * side * side <= A_MAX_TERMS;
}

bool pass_b_main(int S, int R) { return pass_b_smem_bytes(R, S) <= (size_t)max_block_smem(); }

}  // namespace

// Every shape runs: dsp_pass_a / dsp_pass_b launch the main instances, and
// where dsp_pass_a_is_wide / dsp_pass_b_is_wide say 1 the wrapper runs
// dsp_live_planes, then dsp_pass_a_wide / dsp_pass_b_wide on its words
// (the entry points of the main instances refuse those shapes).
extern "C" int dsp_pass_a_is_wide(int S, int H, int W, int R) {
  (void)H, (void)W;
  return R >= 0 && !pass_a_main(S, R);
}

extern "C" int dsp_pass_b_is_wide(int S, int H, int W, int R) {
  (void)H, (void)W;
  return R >= 0 && !pass_b_main(S, R);
}

// The live words of a table (live_planes_kernel): `plane` is w_eff (f32) or,
// with `tracks`, trk_eff (i32), whose empty entries get acc = 0, right = 0.
// The words are cleared first.  The entries are read and written 16 bytes
// at a time where the table and acc start on 16-byte bounds and right on
// 4-byte ones (PyTorch's allocations do), else one at a time.
extern "C" int dsp_live_planes(const void* plane, unsigned* live, float* acc, uint8_t* right,
                               int S, int H, int W, int tracks, void* stream) {
  if (S <= 0) return (int)cudaErrorInvalidValue;
  const long long HW = (long long)H * W, n = S * HW;
  const cudaError_t e =
      cudaMemsetAsync(live, 0, sizeof(unsigned) * ((S + 31) / 32) * HW, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  const long long vectors = (n + 3) / 4;
  const unsigned grid = (unsigned)((vectors + L_NT * L_VEC - 1) / (L_NT * L_VEC));
  if (grid == 0) return 0;
  const auto at = [](const void* p, unsigned bytes) { return (uintptr_t)p % bytes == 0; };
  if (tracks) {
    static CUfunction fn = nullptr;
    return dsp::launch(live_planes_kernel<true>, fn, grid, L_NT, 0, (cudaStream_t)stream,
                       static_cast<const int*>(plane), live, acc, right, n, HW, 1.0 / HW,
                       (int)(at(plane, 16) && at(acc, 16) && at(right, 4)));
  }
  static CUfunction fn = nullptr;
  return dsp::launch(live_planes_kernel<false>, fn, grid, L_NT, 0, (cudaStream_t)stream,
                     static_cast<const int*>(plane), live, nullptr, nullptr, n, HW, 1.0 / HW,
                     (int)at(plane, 16));
}

extern "C" int dsp_pass_a(
    const float* px, const float* py, const float* pz, const float* weff,
    const int* trk, const float* ox, const float* oy, const float* oz,
    const float* isg, const int* otrk, float* ck,
    int S, int H, int W, int R, float coef3, float id_p, int independent,
    void* stream) {
  if (R < 0 || !pass_a_main(S, R)) return (int)cudaErrorInvalidValue;
  dim3 grid((W + A_TW - 1) / A_TW, (H + A_TH - 1) / A_TH);
  static CUfunction fn = nullptr;
  return launch_smem(pass_a_kernel, fn, grid, A_NT,
                     pass_a_smem_bytes((A_TW + 2 * R) * (A_TH + 2 * R)), stream, px, py, pz, weff,
                     trk, ox, oy, oz, isg, otrk, ck, S, H, W, R, coef3, id_p, independent);
}

extern "C" int dsp_pass_a_wide(
    const float* px, const float* py, const float* pz, const float* weff,
    const int* trk, const float* ox, const float* oy, const float* oz,
    const float* isg, const int* otrk, const unsigned* live, float* ck,
    int S, int H, int W, int R, float coef3, float id_p, int independent,
    void* stream) {
  if (R < 0) return (int)cudaErrorInvalidValue;
  dim3 grid((W + A_TW - 1) / A_TW, (H + A_TH - 1) / A_TH);
  int cw = 0, ch = 0;
  halo_chunks(A_TW + 2 * R, A_TH + 2 * R, A_CAP, &cw, &ch);
  static CUfunction fn = nullptr;
  return launch_smem(pass_a_wide_kernel, fn, grid, A_NT, pass_a_smem_bytes(cw * ch), stream, px,
                     py, pz, weff, trk, ox, oy, oz, isg, otrk, live, ck, S, H, W, R, coef3, id_p,
                     independent, cw, ch);
}

extern "C" int dsp_pass_b(
    const float* px, const float* py, const float* pz, const int* trk_eff,
    const float* ff_eff, const float* isg_p, const float* ox, const float* oy,
    const float* oz, const uint8_t* ovalid, const int* otrk,
    const float* ck_kappa, float* acc, uint8_t* right,
    int S, int H, int W, int R, float coef3, float id_p, float thr_right,
    int independent, void* stream) {
  if (R < 0 || !pass_b_main(S, R)) return (int)cudaErrorInvalidValue;
  dim3 grid((W + B_TW - 1) / B_TW, (H + B_TH - 1) / B_TH);
  static CUfunction fn = nullptr;
  return launch_smem(pass_b_kernel, fn, grid, B_NT, pass_b_smem_bytes(R, S), stream, px, py, pz,
                     trk_eff, ff_eff, isg_p, ox, oy, oz, ovalid, otrk, ck_kappa, acc, right, S, H,
                     W, R, coef3, id_p, thr_right, independent);
}

extern "C" int dsp_pass_b_wide(
    const float* px, const float* py, const float* pz, const int* trk_eff,
    const float* ff_eff, const float* isg_p, const float* ox, const float* oy,
    const float* oz, const uint8_t* ovalid, const int* otrk,
    const float* ck_kappa, const unsigned* live, float* acc, uint8_t* right,
    int S, int H, int W, int R, float coef3, float id_p, float thr_right,
    int independent, void* stream) {
  if (R < 0) return (int)cudaErrorInvalidValue;
  dim3 grid((W + B_TW - 1) / B_TW, (H + B_TH - 1) / B_TH);
  const int sw = B_TW + 2 * R, hh = B_TH + 2 * R;
  int pw = 0, pr = 0;
  halo_chunks(sw, hh, BW_PIECE, &pw, &pr);
  const size_t smem = pass_b_wide_smem_bytes(pw * pr);
  if (pw >= sw && pr >= hh) {
    static CUfunction fn = nullptr;
    return launch_smem(pass_b_wide_kernel<true>, fn, grid, B_NT, smem, stream, px, py, pz,
                       trk_eff, ff_eff, isg_p, ox, oy, oz, ovalid, otrk, ck_kappa, live, acc,
                       right, S, H, W, R, coef3, id_p, thr_right, independent, pw, pr);
  }
  static CUfunction fn_pieces = nullptr;
  return launch_smem(pass_b_wide_kernel<false>, fn_pieces, grid, B_NT, smem, stream, px, py, pz,
                     trk_eff, ff_eff, isg_p, ox, oy, oz, ovalid, otrk, ck_kappa, live, acc, right,
                     S, H, W, R, coef3, id_p, thr_right, independent, pw, pr);
}
