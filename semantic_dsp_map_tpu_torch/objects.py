"""Object-level update: tracking table, Bayesian moving/static filter,
transform windows and constant-velocity prediction (counterpart of
``semantic_dsp_map_tpu/objects.py``; semantic_dsp_map.h:306-566,
object_layer.h:57-648).

Both keypoint modes are ported: superpoint (matched keypoint pairs) and
ZED2/bbox3d (4 box corners against the stored last-frame corners).  The
reference quirks listed in the JAX module's docstring are kept: pre-clamp
threshold compare, the default dt of 0.15 s, the divide-by-(window-1)
velocity, translation-only prediction, the last-keypoint-only out-of-FOV
test of the bbox3d mode and the Chebyshev range gate for new objects.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .config import (
    FilterParams,
    KEYPOINTS_BBOX3D,
    MapConfig,
    MOVEMENT_ALWAYS,
    MOVEMENT_NEVER,
)
from .ops.transforms import ransac_transform
from .state import ObjectTable, constant

WINDOW_MAX_AGE = 10
DEFAULT_TIME_INTERVAL = 0.15
DEFAULT_PREDICT_DT = 0.2

#: RANSAC hypotheses per instance in superpoint mode (semantic_dsp_map.h:381).
RANSAC_ITERS = 100

#: RANSAC hypotheses per instance in bbox3d mode, over the 4 box corners,
#: without refit (as ``semantic_dsp_map_tpu/objects.py`` runs them).
RANSAC_ITERS_BBOX3D = 2


def ransac_draw_shape(cfg: MapConfig):
    """Shape of the Gumbel draws object_level_update takes: [I, iterations,
    points] (the points are the Kp keypoints, or the 4 box corners)."""
    if cfg.keypoint_mode == KEYPOINTS_BBOX3D:
        return (cfg.max_instances_per_frame, RANSAC_ITERS_BBOX3D, 4)
    return (cfg.max_instances_per_frame, RANSAC_ITERS, cfg.max_keypoints)


class ObservedInstances(NamedTuple):
    """Fixed-shape batch of this frame's observed movable instances."""

    valid: torch.Tensor       # bool[I]
    track: torch.Tensor       # i32[I]
    label: torch.Tensor       # i32[I]; -1 if the label is unknown
    kpts_curr: torch.Tensor   # f32[I, Kp, 3]
    kpts_prev: torch.Tensor   # f32[I, Kp, 3]
    kpts_count: torch.Tensor  # i32[I]


def _scatter(arr: torch.Tensor, tgt: torch.Tensor, vals, add: bool = False) -> torch.Tensor:
    """``arr.at[tgt].set(vals, mode="drop")`` where ``tgt == len(arr)`` is
    the drop sentinel: writes go to a spare trailing row."""
    out = torch.cat([arr, arr[:1]])
    shape = (tgt.shape[0],) + arr.shape[1:]
    if isinstance(vals, torch.Tensor):
        vals = vals.to(arr.dtype).expand(shape)
    else:  # a Python number, filled on the device (no copy from the host)
        vals = torch.full(shape, vals, dtype=arr.dtype, device=arr.device)
    if add:
        out.index_add_(0, tgt, vals)
    else:
        out[tgt] = vals
    return out[:-1]


def _match_objects(objects: ObjectTable, track):
    """For each instance, the object-table row with the same track id."""
    eq = (track[:, None] == objects.track_id[None, :]) & objects.valid[None, :]
    has = eq.any(dim=1)
    idx = torch.argmax(eq.to(torch.int32), dim=1)
    return has, torch.where(has, idx, 0)


def _translation_matrix(v):
    T = torch.eye(4, dtype=torch.float32, device=v.device).expand(
        v.shape[:-1] + (4, 4)
    ).clone()
    T[..., :3, 3] = v
    return T


def _window_push_and_estimate(objects, push_mask, T_new, dt_new, ref_new, global_time):
    """ObjectTransformations::update (object_layer.h:218-259) for every
    object in ``push_mask``, then MotionEstimation::estimate
    (object_layer.h:137-160)."""
    O, W = objects.win_dt.shape
    dev = push_mask.device
    stamps = torch.cat(
        [objects.win_stamp, global_time.expand(O, 1).to(torch.int32)], dim=1
    )
    pos = torch.arange(W + 1, device=dev)[None, :]
    occupied = (pos < objects.win_count[:, None]) | (pos == W)
    aged = occupied & ((global_time - stamps) > WINDOW_MAX_AGE)
    n_aged_front = aged.sum(dim=1)

    count1 = objects.win_count + 1
    drop = torch.maximum(n_aged_front, count1 - W)
    new_count = (count1 - drop).to(torch.int32)

    dst = torch.arange(W, device=dev)[None, :]
    src = dst + drop[:, None]
    from_new = src == objects.win_count[:, None]
    src_old = torch.clamp(src, 0, W - 1)

    def compact(old, new):
        extra = old.dim() - 2
        idx = src_old.reshape(src_old.shape + (1,) * extra).expand(old.shape)
        gathered = torch.gather(old, 1, idx)
        sel = from_new.reshape(from_new.shape + (1,) * extra)
        return torch.where(sel, new[:, None], gathered)

    win_t = compact(objects.win_tmatrix, T_new)
    win_dt = compact(objects.win_dt, dt_new)
    win_stamp = torch.where(
        from_new, global_time.to(torch.int32), torch.gather(objects.win_stamp, 1, src_old)
    )
    win_ref = compact(objects.win_ref, ref_new)

    pm = push_mask
    win_t = torch.where(pm[:, None, None, None], win_t, objects.win_tmatrix)
    win_dt = torch.where(pm[:, None], win_dt, objects.win_dt)
    win_stamp = torch.where(pm[:, None], win_stamp, objects.win_stamp)
    win_ref = torch.where(pm[:, None, None], win_ref, objects.win_ref)
    win_count = torch.where(pm, new_count, objects.win_count)

    # Centroid of {ref, ref+x_hat, ref+y_hat} is ref + (1/3, 1/3, 0); its
    # displacement under T is (R - I) @ centroid + t.
    entry_valid = torch.arange(W, device=dev)[None, :] < win_count[:, None]
    centroid = win_ref + constant((1.0 / 3.0, 1.0 / 3.0, 0.0), torch.float32, dev)
    R = win_t[..., :3, :3]
    t = win_t[..., :3, 3]
    disp = torch.einsum("owij,owj->owi", R, centroid) - centroid + t
    dt_safe = torch.where(win_dt == 0, 1e-9, win_dt)
    per_entry_v = disp / dt_safe[..., None]
    vsum = torch.where(entry_valid[..., None], per_entry_v, 0.0).sum(dim=1)
    denom = torch.clamp(win_count - 1, min=1).to(torch.float32)
    velocity = vsum / denom[:, None]

    can_estimate = pm & (win_count >= 2)
    velocity = torch.where(can_estimate[:, None], velocity, objects.velocity)
    vel_valid = torch.where(pm, win_count >= 2, objects.vel_valid)

    return dataclasses.replace(
        objects, win_tmatrix=win_t, win_dt=win_dt, win_stamp=win_stamp,
        win_ref=win_ref, win_count=win_count, velocity=velocity, vel_valid=vel_valid,
    )


def object_level_update(
    cfg: MapConfig,
    params: FilterParams,
    objects: ObjectTable,
    obs: ObservedInstances,
    cam_pos,
    r_cw,
    t_cw,
    time_now,
    prev_frame_time,
    global_time,
    gumbel: torch.Tensor,
) -> ObjectTable:
    """One frame of objectLevelUpdate (semantic_dsp_map.h:306-566).
    ``gumbel`` (shape :func:`ransac_draw_shape`) holds the RANSAC triple
    draws (see ops.transforms.ransac_transform)."""
    bbox3d = cfg.keypoint_mode == KEYPOINTS_BBOX3D
    I = obs.valid.shape[0]
    Kp = obs.kpts_curr.shape[1]
    O = objects.valid.shape[0]
    dev = obs.valid.device
    gt = global_time.to(torch.int32)

    relevant = obs.valid & (obs.label >= 0)
    has, oidx = _match_objects(objects, obs.track)

    # ---------------- Case 1: new objects ------------------------------
    kmask = torch.arange(Kp, device=dev)[None, :] < obs.kpts_count[:, None]
    cheb = (obs.kpts_curr - cam_pos[None, None, :]).abs().amax(dim=-1)
    cheb = torch.where(kmask, cheb, float("inf"))
    closest = cheb.amin(dim=1)
    map_half_scaled = cfg.voxel_size * (1 << (cfg.biggest_axis_n - 1)) * 1.2
    new_mask = relevant & ~has & (closest <= map_half_scaled)

    free = ~objects.valid
    free_rank = torch.cumsum(free.to(torch.int32), 0) - 1
    n_free = free.sum()
    new_rank = torch.cumsum(new_mask.to(torch.int32), 0) - 1
    slot_match = free[None, :] & (free_rank[None, :] == new_rank[:, None])
    new_slot = torch.argmax(slot_match.to(torch.int32), dim=1)
    placeable = new_mask & (new_rank < n_free) & slot_match.any(dim=1)
    tgt = torch.where(placeable, new_slot, O)

    put = lambda arr, vals: _scatter(arr, tgt, vals)
    k4 = obs.kpts_curr[:, :4]
    objects = dataclasses.replace(
        objects,
        valid=put(objects.valid, True),
        track_id=put(objects.track_id, obs.track),
        label=put(objects.label, obs.label),
        last_obs_step=put(objects.last_obs_step, gt),
        obs_count=put(objects.obs_count, 1),
        moved_probability=put(objects.moved_probability, 0.5),
        moving=put(objects.moving, False),
        has_moved_record=put(objects.has_moved_record, False),
        has_tmatrix=put(objects.has_tmatrix, False),
        to_match_templates=put(objects.to_match_templates, True),
        to_match_previous=put(objects.to_match_previous, False),
        win_count=put(objects.win_count, 0),
        vel_valid=put(objects.vel_valid, False),
        last_kpts=put(objects.last_kpts, k4),
        last_kpts_time=put(objects.last_kpts_time, time_now),
        has_last_kpts=put(objects.has_last_kpts, True),
        key_kpts=put(objects.key_kpts, k4),
        key_kpts_time=put(objects.key_kpts_time, time_now),
    )
    has, oidx = _match_objects(objects, obs.track)

    # ---------------- Case 2: keypoint transform update ----------------
    exist_obs = relevant & has & ~new_mask & (obs.kpts_count >= (4 if bbox3d else 5))
    if bbox3d:
        # ZED2: transform from the stored last-frame corners to the current
        # ones (semantic_dsp_map.h:408-481).
        last_k = objects.last_kpts[oidx]
        has_last = objects.has_last_kpts[oidx]
        key_k = objects.key_kpts[oidx]
        last_idx = torch.clamp(obs.kpts_count - 1, min=0)
        last_pt = obs.kpts_curr[torch.arange(I, device=dev), last_idx]
        out_fov = _point_out_of_fov(cfg, r_cw, t_cw, last_pt, margin=5)
        T2 = ransac_transform(
            gumbel, last_k, k4, torch.ones((I, 4), dtype=torch.bool, device=dev), 0.5, False
        )[0]

        width = torch.linalg.vector_norm(k4[:, 1] - k4[:, 0], dim=-1)
        key_thr = torch.clamp(width, min=params.bayesian_movement_distance_threshold)
        drift = torch.linalg.vector_norm(k4[:, 0] - key_k[:, 0], dim=-1)
        moved_obs = (drift > key_thr).to(torch.int32)
        success2 = exist_obs & ~out_fov & has_last
        ref_pt = last_k[:, 0]
        dt_window = time_now - objects.last_kpts_time[oidx]

        # Corner caches: the last corners of every stored observation, and
        # the key corners when missing or older than 2 s
        # (semantic_dsp_map.h:431-478).
        store = exist_obs & ~out_fov
        set_key = store & (~has_last | ((time_now - objects.key_kpts_time[oidx]) > 2.0))
        tgt2 = torch.where(store, oidx, O)
        tgt_key = torch.where(set_key, oidx, O)
        objects = dataclasses.replace(
            objects,
            last_kpts=_scatter(objects.last_kpts, tgt2, k4),
            last_kpts_time=_scatter(objects.last_kpts_time, tgt2, time_now),
            has_last_kpts=_scatter(objects.has_last_kpts, tgt2, True),
            key_kpts=_scatter(objects.key_kpts, tgt_key, k4),
            key_kpts_time=_scatter(objects.key_kpts_time, tgt_key, time_now),
        )
    else:
        # Superpoint: matched keypoint pairs, RANSAC with refit and the
        # mse/inlier gate (semantic_dsp_map.h:381-407).
        T2, _inl, n_inl, mse, first_inl = ransac_transform(
            gumbel, obs.kpts_prev, obs.kpts_curr, kmask, 0.5, True
        )
        ratio = n_inl.to(torch.float32) / torch.clamp(obs.kpts_count, min=1)
        tf_ok = (mse <= 0.2) & (n_inl >= 5) & (ratio >= 0.5)
        success2 = exist_obs & tf_ok
        ref_pt = obs.kpts_prev[torch.arange(I, device=dev), first_inl]
        moved_obs = torch.full((I,), -1, dtype=torch.int32, device=dev)
        dt_window = torch.full((I,), DEFAULT_TIME_INTERVAL, dtype=torch.float32, device=dev)

    # ---------------- updateObject (object_layer.h:470-539) ------------
    disp = torch.einsum("iab,ib->ia", T2[:, :3, :3], ref_pt) + T2[:, :3, 3] - ref_pt
    disp_norm = torch.linalg.vector_norm(disp, dim=-1)
    if cfg.movement_mode == MOVEMENT_NEVER:
        moving_now = torch.zeros(I, dtype=torch.bool, device=dev)
        prob_new = objects.moved_probability[oidx]
    elif cfg.movement_mode == MOVEMENT_ALWAYS:
        moving_now = torch.ones(I, dtype=torch.bool, device=dev)
        prob_new = objects.moved_probability[oidx]
    else:
        evidence = torch.where(
            moved_obs == -1,
            disp_norm > params.bayesian_movement_distance_threshold,
            moved_obs == 1,
        )
        prob_old = objects.moved_probability[oidx]
        prob_raw = torch.where(
            evidence,
            prob_old + params.bayesian_movement_increment,
            prob_old - params.bayesian_movement_decrement,
        )
        # Threshold compare happens before the clamp (object_layer.h:506-514).
        moving_now = prob_raw > params.bayesian_movement_probability_threshold
        prob_new = torch.clamp(prob_raw, 0.0, 1.0)

    tgt3 = torch.where(success2, oidx, O)
    put3 = lambda arr, vals: _scatter(arr, tgt3, vals)
    objects = dataclasses.replace(
        objects,
        label=put3(objects.label, obs.label),
        tmatrix=put3(objects.tmatrix, T2),
        has_tmatrix=put3(objects.has_tmatrix, True),
        last_obs_step=put3(objects.last_obs_step, gt),
        obs_count=_scatter(objects.obs_count, tgt3, 1, add=True),
        to_match_previous=put3(objects.to_match_previous, False),
        moved_probability=put3(objects.moved_probability, prob_new),
        moving=put3(objects.moving, moving_now),
        has_moved_record=put3(objects.has_moved_record, True),
        reference_point=put3(objects.reference_point, ref_pt),
    )

    # Window push for moving objects (object_layer.h:535-537).
    tgt4 = torch.where(success2 & moving_now, oidx, O)
    push_mask = _scatter(torch.zeros(O, dtype=torch.bool, device=dev), tgt4, True)
    eye = torch.eye(4, dtype=torch.float32, device=dev).expand(O, 4, 4)
    T_o = _scatter(eye, tgt4, T2)
    dt_o = _scatter(torch.ones(O, dtype=torch.float32, device=dev), tgt4, dt_window)
    ref_o = _scatter(torch.zeros(O, 3, dtype=torch.float32, device=dev), tgt4, ref_pt)
    objects = _window_push_and_estimate(objects, push_mask, T_o, dt_o, ref_o, gt)

    # ---------------- Case 3 (superpoint): rematch / coast -------------
    if not bbox3d:
        fail = relevant & has & ~new_mask & ~success2
        fail &= objects.has_moved_record[oidx] & objects.moving[oidx]
        can_predict = objects.vel_valid[oidx]

        coast = fail & can_predict
        T_pred = _translation_matrix(objects.velocity[oidx] * DEFAULT_PREDICT_DT)
        tgt5 = torch.where(coast, oidx, O)
        objects = dataclasses.replace(
            objects,
            tmatrix=_scatter(objects.tmatrix, tgt5, T_pred),
            has_tmatrix=_scatter(objects.has_tmatrix, tgt5, True),
            to_match_previous=_scatter(objects.to_match_previous, tgt5, False),
        )
        tgt6 = torch.where(fail & ~can_predict, oidx, O)
        objects = dataclasses.replace(
            objects,
            last_obs_step=_scatter(objects.last_obs_step, tgt6, gt),
            to_match_previous=_scatter(objects.to_match_previous, tgt6, True),
            to_match_templates=_scatter(objects.to_match_templates, tgt6, False),
        )

    # ---------------- Unobserved objects: coasting prediction ----------
    observed = _scatter(
        torch.zeros(O, dtype=torch.bool, device=dev), torch.where(relevant, oidx, O), True
    )
    unobs = objects.valid & ~observed & objects.has_moved_record & objects.moving
    td = time_now - prev_frame_time
    td = torch.where(td.abs() > 1.0, 1.0, td)
    T_pred_u = _translation_matrix(objects.velocity * td)
    upd_T = unobs & objects.vel_valid
    return dataclasses.replace(
        objects,
        tmatrix=torch.where(upd_T[:, None, None], T_pred_u, objects.tmatrix),
        has_tmatrix=objects.has_tmatrix | upd_T,
        to_match_previous=torch.where(unobs, False, objects.to_match_previous),
    )


def _point_out_of_fov(cfg: MapConfig, r_cw, t_cw, pts, margin: int):
    """isPointOutOfFOV (semantic_dsp_map.h:1421-1442) for points [..., 3]."""
    cam = pts @ r_cw.T + t_cw
    z = cam[..., 2]
    zs = torch.where(z == 0, 1e-9, z)
    u = cfg.fx * cam[..., 0] / zs + cfg.cx
    v = cfg.fy * cam[..., 1] / zs + cfg.cy
    outside = (u < margin) | (u >= cfg.width - margin) | (v < margin) | (v >= cfg.height - margin)
    return (z <= 0) | outside


def expire_objects(params: FilterParams, objects: ObjectTable, global_time):
    """Expiry of moving objects unseen for too long
    (semantic_dsp_map.h:600-606): returns (objects', expired bool[O])."""
    expired = (
        objects.valid
        & objects.has_moved_record
        & objects.moving
        & ((global_time - objects.last_obs_step) >= params.max_observation_lost_time)
    )
    objects = dataclasses.replace(
        objects,
        valid=objects.valid & ~expired,
        has_last_kpts=objects.has_last_kpts & ~expired,
    )
    return objects, expired
