"""Depth back-projection into the labeled point cloud (counterpart of
``semantic_dsp_map_tpu/ops/projection.py``; generateLabeledPointCloud,
pointcloud_tools.h:217-307), with the ZED2-mode sky cull and bbox gate."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import FilterParams, MapConfig
from ..labels import BACKGROUND_INSTANCE_ID
from ..state import constant


class LabeledCloud(NamedTuple):
    """Dense per-pixel observation grid (data_base.h:78-92)."""

    pos: torch.Tensor     # f32[H, W, 3] global-frame point
    sigma: torch.Tensor   # f32[H, W] noise stddev
    label: torch.Tensor   # i32[H, W]
    track: torch.Tensor   # i32[H, W]
    valid: torch.Tensor   # bool[H, W]


def generate_labeled_cloud(
    cfg: MapConfig,
    params: FilterParams,
    depth: torch.Tensor,              # f32[H, W]
    track_raster: torch.Tensor,       # i32[H, W]
    track_label_table: torch.Tensor,  # i32[65536]
    r_wc: torch.Tensor,
    t_wc: torch.Tensor,
    max_movable_instance_id: int,
    sky_instance_id: int = -1,
    inst_bbox_min: torch.Tensor | None = None,  # f32[65536, 3]
    inst_bbox_max: torch.Tensor | None = None,
    row_offset: int = 0,
) -> LabeledCloud:
    """K^-1 back-projection, camera -> world, per-pixel label lookup and the
    depth-noise model.

    ZED2-mode extras, enabled by the optional arguments: sky pixels are
    culled (pointcloud_tools.h:234-241), and a movable-track pixel whose
    point lies outside its track's box (dense tables indexed by track id,
    margin included) is demoted to Background before the label lookup
    (pointcloud_tools.h:254-273).

    Shapes come from ``depth``: an image-row slab (halo included, row-slab
    sharding in parallel/shard_step.py) passes its rows and their global
    ``row_offset``."""
    H, W = depth.shape
    dev = depth.device
    # Integer-valued f32 rows: exact, as the JAX package's iota + row_offset.
    rows = torch.arange(row_offset, row_offset + H, dtype=torch.float32, device=dev)
    rows = rows[:, None].expand(H, W)
    cols = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)

    valid = (
        torch.isfinite(depth)
        & (depth >= cfg.depth_range_min)
        & (depth <= cfg.depth_range_max)
    )
    track = track_raster.to(torch.int32)
    if sky_instance_id >= 0:
        valid &= track != sky_instance_id

    # A float32 reciprocal held on the cloud's device, not a division by the
    # Python scalar: the CPU divides where CUDA (and the JAX package under
    # jit) multiplies by the reciprocal, 1 ulp apart in a share of the
    # columns, and these positions are truncated to pixels and voxels.
    inv_fx = constant(1.0 / cfg.fx, torch.float32, dev)
    inv_fy = constant(1.0 / cfg.fy, torch.float32, dev)
    x_cam = (cols - cfg.cx) * inv_fx * depth
    y_cam = (rows - cfg.cy) * inv_fy * depth
    cam = torch.stack([x_cam, y_cam, depth], dim=-1)
    pos = cam @ r_wc.T + t_wc

    if inst_bbox_min is not None:
        tid = torch.clamp(track, 0, inst_bbox_min.shape[0] - 1).long()
        outside = ((pos < inst_bbox_min[tid]) | (pos > inst_bbox_max[tid])).any(dim=-1)
        demote = (track <= max_movable_instance_id) & outside
        track = torch.where(demote, BACKGROUND_INSTANCE_ID, track)

    label = track_label_table[torch.clamp(track, 0, track_label_table.shape[0] - 1).long()]

    if params.if_consider_depth_noise:
        sigma = (
            params.depth_noise_model_zero_order
            + params.depth_noise_model_first_order * depth
        )
    else:
        sigma = torch.full((H, W), 0.1, dtype=torch.float32, device=dev)
    sigma = torch.where(
        torch.isfinite(sigma), sigma,
        torch.full_like(sigma, params.depth_noise_model_zero_order),
    )
    return LabeledCloud(
        pos=pos.to(torch.float32),
        sigma=sigma.to(torch.float32),
        label=label,
        track=track,
        valid=valid,
    )
