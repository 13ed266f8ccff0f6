"""Host-side rendering of the occupancy result into colored point clouds
(counterpart of ``semantic_dsp_map_tpu/viz.py``; tensors on any device are
brought to the host first).

Mirrors the colorization of getOccupancyResult (semantic_dsp_map.h:1258-1376):
jet-by-height background, per-label colors for static classes, hashed colors
for instances, evaluation-format RGB encoding, HSV dimming outside the FOV,
and the optional green freespace cloud.  This is visualization only, so it
runs in numpy on host.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import FilterParams, KEYPOINTS_BBOX3D, MapConfig
from .labels import LabelRegistry
from .ops.render import RenderResult


def _np(x) -> np.ndarray:
    """A host numpy view of a tensor (any device) or array-like."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def voxel_positions(cfg: MapConfig, scroll) -> np.ndarray:
    """Global-frame corner position of every voxel, f32[V, 3] — the host
    mirror of codecs.voxel_to_global_pos (operations.h:939-983); pure index
    arithmetic on the (tiny) scroll state."""
    equiv = _np(scroll.equiv_steps).astype(np.int64)
    center = _np(scroll.map_center).astype(np.float32)
    n = np.array([cfg.nx, cfg.ny, cfg.nz], np.int64)
    v = np.arange(cfg.num_voxels, dtype=np.int64)
    xi = v & (cfg.nx - 1)
    yi = (v >> cfg.voxel_num_axis_x_n) & (cfg.ny - 1)
    zi = v >> (cfg.voxel_num_axis_x_n + cfg.voxel_num_axis_y_n)
    m = (np.stack([xi, yi, zi], -1) - equiv) % n
    half = np.array(cfg.map_half_extent, np.float32)
    return (m.astype(np.float32) * np.float32(cfg.voxel_size) - half + center)


def _jet_table():
    """The constructor's hand-rolled jet colormap (semantic_dsp_map.h:51-63)."""
    t = np.zeros((256, 3), np.int32)
    i = np.arange(256)
    t[i < 64] = np.stack([0 * i[i < 64], 0 * i[i < 64], i[i < 64] * 4], 1)
    m = (i >= 64) & (i < 128)
    t[m] = np.stack([0 * i[m], (i[m] - 64) * 4, 255 + 0 * i[m]], 1)
    m = (i >= 128) & (i < 192)
    t[m] = np.stack([(i[m] - 128) * 4, 255 + 0 * i[m], 255 - (i[m] - 128) * 4], 1)
    m = i >= 192
    t[m] = np.stack([255 + 0 * i[m], 255 - (i[m] - 192) * 4, 0 * i[m]], 1)
    return np.clip(t, 0, 255).astype(np.uint8)


def _shuffled_256(seed: int = 1234):
    """color_map_int_256_ (semantic_dsp_map.h:44-48): a shuffled 0..255.  The
    reference uses an unseeded RNG; we fix the seed for reproducibility."""
    rng = np.random.RandomState(seed)
    v = np.arange(256)
    rng.shuffle(v)
    return v


_JET = _jet_table()
_SHUF = _shuffled_256()


def in_fov_mask(
    cfg: MapConfig,
    voxel_pos: np.ndarray,
    cam_pos: np.ndarray,
    cam_quat: np.ndarray,
) -> np.ndarray:
    """Per-voxel in-frustum mask for render dimming.

    The reference dims occupied voxels outside the camera frustum
    (semantic_dsp_map.h:1333-1351 via checkIfPointInFrustum ->
    isPointInFrustum, operations.h:1240-1258: depth-range plus symmetric
    half-FOV tangent test).  Host-side numpy mirror over all voxel positions.
    """
    w, x, y, z = [float(v) for v in _np(cam_quat).reshape(4)]
    r_wc = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )
    pos = _np(voxel_pos).astype(np.float32)
    cam = (pos - _np(cam_pos).astype(np.float32).reshape(1, 3)) @ r_wc
    cx, cy, cz = cam[:, 0], cam[:, 1], cam[:, 2]
    ok = (cz >= cfg.depth_range_min) & (cz <= cfg.depth_range_max)
    ok &= np.abs(cx) <= cz * cfg.tan_half_fov_x
    ok &= np.abs(cy) <= cz * cfg.tan_half_fov_y
    return ok


def _rgb_dim(rgb: np.ndarray, factor: float) -> np.ndarray:
    """HSV value-channel dimming (semantic_dsp_map.h:1333-1351): V *= factor
    preserves hue/saturation, which equals scaling RGB uniformly."""
    return (rgb.astype(np.float32) * factor).astype(np.uint8)


def colorize(
    cfg: MapConfig,
    params: FilterParams,
    registry: LabelRegistry,
    result: RenderResult,
    cam_pos: np.ndarray,
    voxel_pos: np.ndarray,
    in_fov_mask: np.ndarray | None = None,
):
    """Returns dict with occupied/freespace xyz+rgb arrays.

    ``voxel_pos`` comes from :func:`voxel_positions` (host-side)."""
    occ = _np(result.occ)
    label = _np(result.label)
    track = _np(result.track)
    pos = _np(voxel_pos)

    occupied = occ == 1
    guessed = occ == 2
    sel = occupied | guessed

    xyz = pos[sel]
    lab = label[sel]
    trk = track[sel]
    is_guessed = guessed[sel]

    rgb = np.zeros((xyz.shape[0], 3), np.uint8)

    bg_id = registry.label_to_id.get("Background", registry.label_to_id.get("background", 0))
    max_movable = registry.max_movable_instance_id
    color_tab = registry.label_color_table()  # BGR

    is_bg = lab == bg_id
    # Jet by height (axis differs for ZED2, semantic_dsp_map.h:1279-1284).
    if cfg.keypoint_mode == KEYPOINTS_BBOX3D:
        hval = xyz[:, 1] + 2.0
    else:
        hval = -xyz[:, 2] + 2.0
    ci = np.clip((hval * 51.2).astype(np.int32), 0, 255)
    rgb[is_bg] = _JET[ci[is_bg]]
    if params.if_out_evaluation_format:
        rgb[is_bg] = 0

    is_static = ~is_bg & (trk > max_movable)
    bgr = color_tab[np.clip(lab[is_static], 0, 255)]
    rgb[is_static] = bgr[:, ::-1]  # BGR -> RGB (semantic_dsp_map.h:1299-1309)

    is_inst = ~is_bg & ~is_static
    if params.if_out_evaluation_format:
        # r=label, g=track>>8, b=track&0xFF (semantic_dsp_map.h:1311-1315).
        rgb[is_inst, 0] = np.clip(lab[is_inst], 0, 255)
        rgb[is_inst, 1] = (trk[is_inst] >> 8) & 0xFF
        rgb[is_inst, 2] = trk[is_inst] & 0xFF
    else:
        rgb[is_inst, 0] = 160
        rgb[is_inst, 1] = _SHUF[np.clip(trk[is_inst], 0, 65535) % 256]
        rgb[is_inst, 2] = _SHUF[np.clip(lab[is_inst], 0, 255)]

    rgb[is_guessed] = 255  # white (semantic_dsp_map.h:1325-1330)

    if not params.if_out_evaluation_format and in_fov_mask is not None:
        out = ~_np(in_fov_mask)[sel]
        rgb[out] = _rgb_dim(rgb[out], 0.7)

    if params.visualize_with_zero_center:
        xyz = xyz - _np(cam_pos).reshape(1, 3)

    out = {"occupied_xyz": xyz.astype(np.float32), "occupied_rgb": rgb}

    free = occ == 0
    fxyz = pos[free]
    if params.visualize_with_zero_center:
        fxyz = fxyz - _np(cam_pos).reshape(1, 3)
    frgb = np.zeros((fxyz.shape[0], 3), np.uint8)
    frgb[:, 1] = 255
    out["freespace_xyz"] = fxyz.astype(np.float32)
    out["freespace_rgb"] = frgb
    return out
