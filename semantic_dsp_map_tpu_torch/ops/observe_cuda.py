"""Wrappers of the hand-written CUDA observe kernels (csrc/observe.cu).

``front_candidates_cuda`` replaces ``front_candidates`` and
``movable_voxels_cuda`` replaces ``movable_voxels`` of
``semantic_dsp_map_tpu/ops/observe_pallas.py`` (the TPU kernels ``_kernel``
and ``_movable_kernel``).  On CUDA tensors they launch the kernel; on CPU
tensors they run the plain scans of ops/observe.py, their oracles, which
take the same arguments.  Bound and design: see the note at the top of
csrc/observe.cu.

``front_candidates_cuda.launches`` / ``movable_voxels_cuda.launches``
count kernel launches.
"""

from __future__ import annotations

import torch

from ..config import MapConfig
from . import cuda_lib
from .observe import front_candidates_plain, movable_voxels_plain


def _slots(cfg: MapConfig, vox_axis: torch.Tensor):
    V = vox_axis.shape[0]
    return V, cfg.slots_per_voxel, (V * cfg.slots_per_voxel,)


@cuda_lib.counted
def front_candidates_cuda(cfg: MapConfig, px, py, pz, status, stamp, vox_axis, r_cw, t_cw):
    """(has_alive u8[V], has_cand u8[V]); see
    ops.observe.front_candidates_plain.  The kernel loads 16 bytes a thread:
    the store's arrays must start on a 16-byte boundary (whole tensors do),
    and a store that does not raises."""
    index = px.get_device()
    if index < 0:  # the CPU: the plain version
        return front_candidates_plain(cfg, px, py, pz, status, stamp, vox_axis, r_cw, t_cw)
    V, K, n = _slots(cfg, vox_axis)
    f32 = torch.float32
    pose = torch.cat([r_cw.reshape(-1), t_cw.reshape(-1)])
    ptrs = cuda_lib.pointers(index, f32, n, (px, py, pz), ("px", "py", "pz"))
    ptrs += cuda_lib.pointers(index, torch.uint8, n, (status,), ("status",))
    ptrs += cuda_lib.pointers(index, torch.int32, n, (stamp,), ("stamp",))
    ptrs += cuda_lib.pointers(index, torch.int32, (V,), (vox_axis,), ("vox_axis",))
    ptrs += cuda_lib.pointers(index, f32, (12,), (pose,), ("pose",))
    ha = torch.empty(V, dtype=torch.uint8, device=px.device)
    hc = torch.empty(V, dtype=torch.uint8, device=px.device)
    err = cuda_lib.entry.dsp_front_candidates(
        *ptrs, ha.data_ptr(), hc.data_ptr(), V, K, cfg.fx, cfg.fy, cfg.cx, cfg.cy,
        cfg.height, cfg.width, cfg.depth_range_min, cfg.depth_range_max,
        cuda_lib.stream_ptr(index),
    )
    if err:
        raise cuda_lib.error(err, "dsp_front_candidates")
    front_candidates_cuda.launches += 1
    return ha, hc


@cuda_lib.counted
def movable_voxels_cuda(cfg: MapConfig, track, status, stamp, vox_axis, max_movable: int):
    """u8[V]; see ops.observe.movable_voxels_plain.  The kernel loads 16
    bytes of track, status and stamp (and at K = 1 of vox_axis) at a time: a
    store whose arrays do not start on a 16-byte boundary raises (whole
    tensors do)."""
    index = track.get_device()
    if index < 0:  # the CPU: the plain version
        return movable_voxels_plain(cfg, track, status, stamp, vox_axis, max_movable)
    V, K, n = _slots(cfg, vox_axis)
    track_p, stamp_p = cuda_lib.pointers(index, torch.int32, n, (track, stamp), ("track", "stamp"))
    (status_p,) = cuda_lib.pointers(index, torch.uint8, n, (status,), ("status",))
    (vax,) = cuda_lib.pointers(index, torch.int32, (V,), (vox_axis,), ("vox_axis",))
    hm = torch.empty(V, dtype=torch.uint8, device=track.device)
    err = cuda_lib.entry.dsp_movable_voxels(
        track_p, status_p, stamp_p, vax, hm.data_ptr(), V, K, int(max_movable),
        cuda_lib.stream_ptr(index),
    )
    if err:
        raise cuda_lib.error(err, "dsp_movable_voxels")
    movable_voxels_cuda.launches += 1
    return hm
