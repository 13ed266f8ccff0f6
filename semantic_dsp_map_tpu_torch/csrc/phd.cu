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
// Pass A (one thread per pixel, slot loop outside): for each slot plane s
// the block stages the five planes (px, py, pz, w_eff, track) of its
// (TH+2R) x (TW+2R) halo tile; outside the image w_eff is 0, which kills
// the term, as the TPU wrapper's zero padding does.  A tile whose staged
// w_eff is all zero is skipped (the table is front-filled, so most high
// slot planes are empty); a zero-weight neighbour is skipped too.  Both
// skips drop terms that are exactly zero.  The 10-sigma clip of the plain
// version is dropped: it only ever zeroes terms below COEF^3 * e^-49.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 32;  // tile width = threads in x
constexpr int TH = 16;  // tile height = threads in y
constexpr int NT = TW * TH;

__global__ void pass_a_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ weff,
    const int* __restrict__ trk,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ isg,
    const int* __restrict__ otrk,
    float* __restrict__ ck,
    int S, int H, int W, int R, float coef3, float id_p, int independent) {
  extern __shared__ float smem[];
  const int sw = TW + 2 * R;
  const int n = sw * (TH + 2 * R);
  float* s_px = smem;
  float* s_py = smem + n;
  float* s_pz = smem + 2 * n;
  float* s_w = smem + 3 * n;
  int* s_trk = reinterpret_cast<int*>(smem + 4 * n);

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TW + tx;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
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
  for (int s = 0; s < S; ++s) {
    int live = 0;
    for (int i = tid; i < n; i += NT) {
      const int iy = i / sw, ix = i - iy * sw;
      const int gy = y0 + iy - R, gx = x0 + ix - R;
      float w = 0.f, a = 0.f, b = 0.f, c = 0.f;
      int t = -1;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const long long g = s * HW + (long long)gy * W + gx;
        w = weff[g];
        if (w != 0.f) {
          a = px[g]; b = py[g]; c = pz[g]; t = trk[g];
          live = 1;
        }
      }
      s_px[i] = a; s_py[i] = b; s_pz[i] = c; s_w[i] = w; s_trk[i] = t;
    }
    if (!__syncthreads_or(live)) continue;
    if (inside) {
      for (int dm = 0; dm < side; ++dm) {
        const int row = (ty + dm) * sw + tx;
        for (int dn = 0; dn < side; ++dn) {
          const int i = row + dn;
          const float w = s_w[i];
          if (w == 0.f) continue;
          const float zx = (s_px[i] - qx) * qs;
          const float zy = (s_py[i] - qy) * qs;
          const float zz = (s_pz[i] - qz) * qs;
          const float s2 = zx * zx + zy * zy + zz * zz;
          float gk = coef3 * expf(-0.5f * s2);
          const int t = s_trk[i];
          if (independent) {
            if (t == qt) acc += w * gk;
          } else {
            if (t != qt) gk = gk * id_p;
            acc += w * gk;
          }
        }
      }
    }
    __syncthreads();
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

size_t tile_smem_bytes(int R) {
  return size_t(5) * (TW + 2 * R) * (TH + 2 * R) * sizeof(float);
}

// Pass B: the packed halo (20 bytes a pixel) and a list of a whole tile.
size_t pass_b_smem_bytes(int R, int S) {
  return size_t(20) * (B_TW + 2 * R) * (B_TH + 2 * R) + sizeof(int) * B_PIX * S;
}

}  // namespace

extern "C" int dsp_pass_a(
    const float* px, const float* py, const float* pz, const float* weff,
    const int* trk, const float* ox, const float* oy, const float* oz,
    const float* isg, const int* otrk, float* ck,
    int S, int H, int W, int R, float coef3, float id_p, int independent,
    void* stream) {
  dim3 block(TW, TH);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  pass_a_kernel<<<grid, block, tile_smem_bytes(R), (cudaStream_t)stream>>>(
      px, py, pz, weff, trk, ox, oy, oz, isg, otrk, ck,
      S, H, W, R, coef3, id_p, independent);
  return (int)cudaGetLastError();
}

extern "C" int dsp_pass_b(
    const float* px, const float* py, const float* pz, const int* trk_eff,
    const float* ff_eff, const float* isg_p, const float* ox, const float* oy,
    const float* oz, const uint8_t* ovalid, const int* otrk,
    const float* ck_kappa, float* acc, uint8_t* right,
    int S, int H, int W, int R, float coef3, float id_p, float thr_right,
    int independent, void* stream) {
  const size_t smem = pass_b_smem_bytes(R, S);
  if (smem > 48 * 1024) {
    // Above 48 KB a block's shared memory has to be asked for; a request
    // beyond what the card has fails here.
    const cudaError_t e = cudaFuncSetAttribute(
        pass_b_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((W + B_TW - 1) / B_TW, (H + B_TH - 1) / B_TH);
  pass_b_kernel<<<grid, B_NT, smem, (cudaStream_t)stream>>>(
      px, py, pz, trk_eff, ff_eff, isg_p, ox, oy, oz, ovalid, otrk, ck_kappa,
      acc, right, S, H, W, R, coef3, id_p, thr_right, independent);
  return (int)cudaGetLastError();
}
