"""Index codecs and ego-centric ring-buffer scroll (counterpart of
``semantic_dsp_map_tpu/ops/codecs.py``; reference
include/mc_ring/operations.h).

Index spaces: map index (position relative to the map center), ring index
(map index shifted by the scroll offset, modulo the axis length) and the
flat voxel index ``(((zi << Ny_n) | yi) << Nx_n) | xi``.  Float->int
conversions truncate toward zero like C ``static_cast<int>``; voxel positions
are voxel corners; the scroll offsets use C-style truncated modulo.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import MapConfig
from ..state import STATUS_INVALID, ScrollState, constant

INVALID_VOXEL = -1


def ring_to_voxel(cfg: MapConfig, xi, yi, zi):
    """operations.h:899-901."""
    return (((zi << cfg.voxel_num_axis_y_n) | yi) << cfg.voxel_num_axis_x_n) | xi


def voxel_to_ring(cfg: MapConfig, v):
    """operations.h:961-965."""
    xi = v & (cfg.nx - 1)
    yi = (v >> cfg.voxel_num_axis_x_n) & (cfg.ny - 1)
    zi = v >> (cfg.voxel_num_axis_x_n + cfg.voxel_num_axis_y_n)
    return xi, yi, zi


def map_to_ring(cfg: MapConfig, equiv_steps, mx, my, mz):
    xi = torch.remainder(mx + equiv_steps[0], cfg.nx)
    yi = torch.remainder(my + equiv_steps[1], cfg.ny)
    zi = torch.remainder(mz + equiv_steps[2], cfg.nz)
    return xi, yi, zi


def ring_to_map(cfg: MapConfig, equiv_steps, xi, yi, zi):
    mx = torch.remainder(xi - equiv_steps[0], cfg.nx)
    my = torch.remainder(yi - equiv_steps[1], cfg.ny)
    mz = torch.remainder(zi - equiv_steps[2], cfg.nz)
    return mx, my, mz


def _axis_sizes(cfg: MapConfig, device):
    return constant((cfg.nx, cfg.ny, cfg.nz), torch.int32, device)


def global_pos_to_voxel(cfg: MapConfig, scroll: ScrollState, pos):
    """Global position [..., 3] -> (voxel index, xi, yi, zi, valid)
    (operations.h:848-883); out-of-map positions get INVALID_VOXEL."""
    half = constant(tuple(cfg.map_half_extent), torch.float32, pos.device)
    recip = constant(1.0 / cfg.voxel_size, torch.float32, pos.device)
    f = (pos - scroll.map_center + half) * recip
    midx = f.to(torch.int32)  # truncation toward zero (operations.h:867-869)
    valid = ((f >= 0) & (midx < _axis_sizes(cfg, pos.device))).all(dim=-1)
    xi, yi, zi = map_to_ring(
        cfg, scroll.equiv_steps, midx[..., 0], midx[..., 1], midx[..., 2]
    )
    v = torch.where(valid, ring_to_voxel(cfg, xi, yi, zi), INVALID_VOXEL)
    return v, xi, yi, zi, valid


def voxel_to_map_pos(cfg: MapConfig, equiv_steps, v):
    """Voxel index -> map-frame corner position (operations.h:969-983)."""
    xi, yi, zi = voxel_to_ring(cfg, v)
    mx, my, mz = ring_to_map(cfg, equiv_steps, xi, yi, zi)
    half = cfg.map_half_extent
    x = mx.to(torch.float32) * cfg.voxel_size - half[0]
    y = my.to(torch.float32) * cfg.voxel_size - half[1]
    z = mz.to(torch.float32) * cfg.voxel_size - half[2]
    return torch.stack([x, y, z], dim=-1)


def voxel_to_global_pos(cfg: MapConfig, scroll: ScrollState, v):
    """operations.h:939-944."""
    return voxel_to_map_pos(cfg, scroll.equiv_steps, v) + scroll.map_center


def axis_stamps_per_voxel(cfg: MapConfig, scroll: ScrollState):
    """max(stamp_x[xi], stamp_y[yi], stamp_z[zi]) for every voxel -> i32[V]
    (operations.h:810-837): a broadcast over the [nz, ny, nx] view."""
    sx = scroll.axis_stamp_x[None, None, :]
    sy = scroll.axis_stamp_y[None, :, None]
    sz = scroll.axis_stamp_z[:, None, None]
    out = torch.maximum(torch.maximum(sx, sy), sz)
    return out.expand(cfg.nz, cfg.ny, cfg.nx).reshape(-1)


def particle_alive(status, stamp, voxel_axis_stamp):
    """isParticleVacant negation (operations.h:810-816) on [V, K] slots."""
    return (status != STATUS_INVALID) & (stamp >= voxel_axis_stamp[:, None])


def voxel_valid(voxel_stamp, voxel_axis_stamp):
    """isVoxelValid (operations.h:824-837)."""
    return (voxel_stamp != 0) & (voxel_stamp >= voxel_axis_stamp)


def _c_mod(steps, n):
    """C-style truncated modulo (operations.h:1196-1230)."""
    return torch.where(steps >= 0, torch.remainder(steps, n), -torch.remainder(-steps, n))


def _stamp_axis(n_axis: int, axis_stamp, equiv_old, delta, global_time):
    """Stamp the ring columns that wrapped out on one axis
    (operations.h:1132-1181); |delta| >= N clamps to stamping every column,
    which equals the reference's multi-sub-step union."""
    idx = torch.arange(n_axis, dtype=torch.int32, device=axis_stamp.device)
    rel = torch.remainder(idx - equiv_old, n_axis)
    d = torch.clamp(delta, -n_axis, n_axis)
    stamped = torch.where(d >= 0, rel < d, rel >= n_axis + d)
    return torch.where(stamped, global_time, axis_stamp).to(torch.int32)


def update_ego_center(cfg: MapConfig, scroll: ScrollState, new_pos, global_time) -> ScrollState:
    """updateEgoCenterPos + updateRingbufferIndexParams
    (operations.h:68-96, 1111-1191): quantize the ego position to voxel
    steps, stamp the wrapped-out columns, update the scroll offsets.  No
    particle data moves."""
    recip = constant(1.0 / cfg.voxel_size, torch.float32, new_pos.device)
    center_steps = (new_pos * recip).to(torch.int32)  # trunc toward zero
    map_center = center_steps.to(torch.float32) * cfg.voxel_size
    delta = center_steps - scroll.moved_steps
    stamps = [
        _stamp_axis(n, s, scroll.equiv_steps[i], delta[i], global_time)
        for i, (n, s) in enumerate(
            [(cfg.nx, scroll.axis_stamp_x), (cfg.ny, scroll.axis_stamp_y),
             (cfg.nz, scroll.axis_stamp_z)]
        )
    ]
    equiv = _c_mod(center_steps, _axis_sizes(cfg, new_pos.device)).to(torch.int32)
    return dataclasses.replace(
        scroll,
        ego_pos=new_pos.to(torch.float32),
        map_center=map_center,
        moved_steps=center_steps,
        equiv_steps=equiv,
        axis_stamp_x=stamps[0],
        axis_stamp_y=stamps[1],
        axis_stamp_z=stamps[2],
    )
