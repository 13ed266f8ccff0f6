"""Wrapper of the hand-written CUDA render kernel (csrc/render.cu).

It replaces ``render_core_pallas`` of
``semantic_dsp_map_tpu/ops/render_pallas.py`` (the TPU kernel ``_kernel``)
and takes the same arguments.  On CUDA tensors it launches the kernel,
which writes the new weight and status IN PLACE into ``p.weight`` and
``p.status``; on CPU tensors it runs the plain reduction of ops/render.py,
its oracle, and copies the new weight and status in, so both paths have
the same effect.  Bound and design: see the note at the top of
csrc/render.cu.

``render_core_cuda.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from ..config import MapConfig, PARTICLE_OCC_INIT_WEIGHT
from . import cuda_lib
from .render import RenderResult, render_core_plain


@cuda_lib.counted
def render_core_cuda(cfg: MapConfig, p, voxel_stamp, vax, occupancy_threshold: float):
    """Returns (p, RenderResult); ``p.weight`` and ``p.status`` are updated
    in place."""
    K = cfg.slots_per_voxel
    V = voxel_stamp.shape[0]
    index = p.weight.get_device()
    if index < 0:  # the CPU: the plain version
        new, res = render_core_plain(cfg, p, voxel_stamp, vax, occupancy_threshold)
        p.weight.copy_(new.weight)
        p.status.copy_(new.status)
        return p, res
    n = (V * K,)
    (weight_p,) = cuda_lib.pointers(index, torch.float32, n, (p.weight,), ("weight",))
    stamp_p, track_p = cuda_lib.pointers(index, torch.int32, n, (p.stamp, p.track),
                                         ("stamp", "track"))
    status_p, label_p = cuda_lib.pointers(index, torch.uint8, n, (p.status, p.label),
                                          ("status", "label"))
    voxel_p = cuda_lib.pointers(index, torch.int32, (V,), (vax, voxel_stamp),
                                ("vax", "voxel_stamp"))
    dev = p.weight.device
    occ = torch.empty(V, dtype=torch.int32, device=dev)
    label = torch.empty(V, dtype=torch.int32, device=dev)
    track = torch.empty(V, dtype=torch.int32, device=dev)
    weight_sum = torch.empty(V, dtype=torch.float32, device=dev)
    err = cuda_lib.entry.dsp_render(
        weight_p, stamp_p, status_p, track_p, label_p, *voxel_p,
        occ.data_ptr(), label.data_ptr(), track.data_ptr(), weight_sum.data_ptr(), V, K,
        occupancy_threshold, PARTICLE_OCC_INIT_WEIGHT, cuda_lib.stream_ptr(index),
    )
    if err:
        raise cuda_lib.error(err, "dsp_render")
    render_core_cuda.launches += 1
    return p, RenderResult(occ=occ, label=label, track=track, weight_sum=weight_sum)
