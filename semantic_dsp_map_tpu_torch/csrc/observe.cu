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
// What bounds them: device memory.  The front reads status and stamp of
// every slot and the three coordinates of the live ones, 17 B per slot at
// most (about 1.0 GB per frame at VKITTI2 scale); the movable scan reads
// 9 B per slot at most.  A few flops per byte.  The design is the simple
// one: one thread per voxel loops over its K slots in registers (K is a
// template parameter) and writes two or one bytes; neighbouring threads
// take neighbouring voxels, so a warp's loads cover one contiguous span of
// each array.  No cross-thread reduction is needed, and the TPU kernel's
// one-hot MXU reduction has no counterpart here.
//
// Pixel truncation decides has_cand and is compared bit for bit with the
// plain version, so the projection keeps its expression order: camera
// coordinates r0*x + r1*y + r2*z + t added left to right, then
// u = fx * cx / zsafe + cx0 with IEEE division (the library is built with
// -fmad=false, so nothing is contracted), then C truncation toward zero.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint8_t STATUS_INVALID = 0;

struct Camera {
  float fx, fy, cx0, cy0, dmin, dmax;
  int h, w;
};

template <int K>
__global__ void front_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const uint8_t* __restrict__ status,
    const int* __restrict__ stamp, const int* __restrict__ vax,
    const float* __restrict__ pose,  // r_cw row-major (9), t_cw (3)
    uint8_t* __restrict__ ha, uint8_t* __restrict__ hc, long long V,
    Camera cam) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  const float r00 = pose[0], r01 = pose[1], r02 = pose[2];
  const float r10 = pose[3], r11 = pose[4], r12 = pose[5];
  const float r20 = pose[6], r21 = pose[7], r22 = pose[8];
  const float t0 = pose[9], t1 = pose[10], t2 = pose[11];
  const long long base = v * K;
  const int va = vax[v];
  bool any_alive = false, any_cand = false;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long i = base + k;
    const bool alive = status[i] != STATUS_INVALID && stamp[i] >= va;
    if (!alive) continue;
    any_alive = true;
    const float x = px[i], y = py[i], z = pz[i];
    const float cxc = r00 * x + r01 * y + r02 * z + t0;
    const float cyc = r10 * x + r11 * y + r12 * z + t1;
    const float czc = r20 * x + r21 * y + r22 * z + t2;
    const bool in_depth = czc >= cam.dmin && czc <= cam.dmax;
    const float zsafe = czc == 0.f ? 1e-6f : czc;
    const float u = cam.fx * cxc / zsafe + cam.cx0;
    const float vv = cam.fy * cyc / zsafe + cam.cy0;
    const int col = (int)u;
    const int row = (int)vv;
    const bool in_image = row >= 0 && row < cam.h && col >= 0 && col < cam.w;
    any_cand = any_cand || (in_depth && in_image);
  }
  ha[v] = any_alive;
  hc[v] = any_cand;
}

template <int K>
__global__ void movable_kernel(
    const int* __restrict__ track, const uint8_t* __restrict__ status,
    const int* __restrict__ stamp, const int* __restrict__ vax,
    uint8_t* __restrict__ hm, long long V, int max_movable) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  const long long base = v * K;
  const int va = vax[v];
  bool any = false;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long i = base + k;
    if (status[i] == STATUS_INVALID || stamp[i] < va) continue;
    const int t = track[i];
    any = any || (t >= 0 && t <= max_movable);
  }
  hm[v] = any;
}

constexpr int BLOCK = 256;

unsigned grid_for(long long V) { return (unsigned)((V + BLOCK - 1) / BLOCK); }

template <int K>
int launch_front(const float* px, const float* py, const float* pz,
                 const uint8_t* status, const int* stamp, const int* vax,
                 const float* pose, uint8_t* ha, uint8_t* hc, long long V,
                 Camera cam, cudaStream_t s) {
  front_kernel<K><<<grid_for(V), BLOCK, 0, s>>>(px, py, pz, status, stamp, vax,
                                                pose, ha, hc, V, cam);
  return (int)cudaGetLastError();
}

template <int K>
int launch_movable(const int* track, const uint8_t* status, const int* stamp,
                   const int* vax, uint8_t* hm, long long V, int max_movable,
                   cudaStream_t s) {
  movable_kernel<K><<<grid_for(V), BLOCK, 0, s>>>(track, status, stamp, vax,
                                                  hm, V, max_movable);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dsp_front_candidates(
    const float* px, const float* py, const float* pz, const uint8_t* status,
    const int* stamp, const int* vax, const float* pose, uint8_t* ha,
    uint8_t* hc, long long V, int K, float fx, float fy, float cx0, float cy0,
    int h, int w, float dmin, float dmax, void* stream) {
  if (V <= 0) return (int)cudaErrorInvalidValue;
  const Camera cam{fx, fy, cx0, cy0, dmin, dmax, h, w};
  cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
    case 1: return launch_front<1>(px, py, pz, status, stamp, vax, pose, ha, hc, V, cam, s);
    case 3: return launch_front<3>(px, py, pz, status, stamp, vax, pose, ha, hc, V, cam, s);
    case 7: return launch_front<7>(px, py, pz, status, stamp, vax, pose, ha, hc, V, cam, s);
    case 15: return launch_front<15>(px, py, pz, status, stamp, vax, pose, ha, hc, V, cam, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int dsp_movable_voxels(
    const int* track, const uint8_t* status, const int* stamp, const int* vax,
    uint8_t* hm, long long V, int K, int max_movable, void* stream) {
  if (V <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
    case 1: return launch_movable<1>(track, status, stamp, vax, hm, V, max_movable, s);
    case 3: return launch_movable<3>(track, status, stamp, vax, hm, V, max_movable, s);
    case 7: return launch_movable<7>(track, status, stamp, vax, hm, V, max_movable, s);
    case 15: return launch_movable<15>(track, status, stamp, vax, hm, V, max_movable, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
