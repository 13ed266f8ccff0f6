"""The frame step, frozen: a plain copy of the port's eager step
(``map.build_frame_step`` of the PyTorch package, its oracle) with every
hand-written kernel replaced by its plain PyTorch version.

One frame runs the reference's frame kernel stage for stage
(semantic_dsp_map.h:170-251): object-level update, labeled point cloud,
prediction (ego scroll, object expiry, floating-particle cleanup, rigid
moves), visibility + PHD weight update, birth + resampling, occupancy
render.  Template matching is not part of this copy.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .config import FilterParams, KEYPOINTS_BBOX3D, MapConfig
from .frontend import FrameInput
from .labels import LabelRegistry
from .objects import ObservedInstances, expire_objects, object_level_update, ransac_draw_shape
from .ops import codecs
from .ops.birth import Candidates, _insert_core, birth_and_resample
from .ops.blocks import (
    block_layout,
    gather_rows_flat,
    row_valid,
    scatter_rows_flat,
    select_blocks,
)
from .ops.geometry import camera_matrices
from .ops.observe import movable_voxels_plain, observe_and_update
from .ops.projection import generate_labeled_cloud
from .ops.render import render_occupancy, render_occupancy_smoothed
from .state import MapState, Particles, STATUS_INVALID


class StepDiagnostics(NamedTuple):
    """Per-frame counters; nonzero *_overflow means a capacity cap bound."""

    visible_count: torch.Tensor    # particles in the pixel table this frame
    born_count: torch.Tensor       # accepted newborn particles
    moved_count: torch.Tensor      # rigid-moved particles re-inserted
    block_overflow: torch.Tensor   # observe: active blocks beyond capacity
    entry_overflow: torch.Tensor   # observe: entries beyond max_table_entries
    table_dropped: torch.Tensor    # observe: visible entries past S per pixel
    corner_overflow: torch.Tensor  # observe: empty-voxel blocks beyond capacity
    move_overflow: torch.Tensor    # move: blocks beyond max_moving_blocks
    birth_overflow: torch.Tensor   # birth: target blocks beyond capacity


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel draws (the RANSAC triple sampler)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device).clamp_(min=tiny)
    return -torch.log(-torch.log(u))


def rigid_move(params: FilterParams, objects, btrk, bst, bmovable, bpx, bpy, bpz,
               generator: torch.Generator):
    """The floating cleanup and the rigid moves of a working set
    (semantic_dsp_map.h:672-737): a movable slot whose track has no valid
    object is invalidated; a slot of a moving object is transformed by the
    object's transform, plus Gaussian jitter from ``generator``.  Returns
    (status after the cleanup, the moved slots, their new x, y, z)."""
    mv_obj = objects.valid & objects.has_moved_record & objects.moving & objects.has_tmatrix
    if params.if_use_template_matching:
        # Objects flagged for cloud re-matching skip the rigid move; the
        # rematch stage re-seeds their particles (semantic_dsp_map.h:616-669).
        mv_obj = mv_obj & ~objects.to_match_previous

    # Owner and moving-owner per slot.  Valid objects have unique track ids
    # (a new object is placed only when no valid row has its id), so at most
    # one row matches a slot.
    eq = btrk[:, :, None] == objects.track_id[None, None, :]
    owned = (eq & objects.valid).any(dim=-1)
    eq_mv = eq & mv_obj
    moving_mask = eq_mv.any(dim=-1)
    owner = torch.argmax(eq_mv.to(torch.int32), dim=-1)

    floating = bmovable & ~owned
    bst = torch.where(floating, STATUS_INVALID, bst)
    bmove = bmovable & moving_mask & ~floating

    T = objects.tmatrix[owner]  # [A, spb, 4, 4]
    rows = [T[..., r, 0] * bpx + T[..., r, 1] * bpy + T[..., r, 2] * bpz + T[..., r, 3]
            for r in range(3)]
    nx, ny, nz = (torch.where(bmove, t, b) for t, b in zip(rows, (bpx, bpy, bpz)))
    if params.prediction_stddev != 0.0:
        noise = torch.randn((3,) + bpx.shape, generator=generator, device=bpx.device)
        noise = noise * params.prediction_stddev
        nx, ny, nz = nx + noise[0], ny + noise[1], nz + noise[2]
    return bst, bmove, nx, ny, nz


def _move_and_cleanup(
    cfg: MapConfig,
    params: FilterParams,
    particles: Particles,
    scroll,
    objects,
    generator: torch.Generator,
    max_movable: int,
):
    """Prediction-phase particle maintenance (semantic_dsp_map.h:587-737):
    particles whose movable track id has no live object are invalidated
    (:712-737); particles of moving objects are rigidly transformed by their
    object's transform plus Gaussian jitter and re-inserted in one batch
    (:672-693; operations.h:321-362).  All work runs on the working set of
    blocks holding movable particles; ``particles`` is updated in place.
    Returns (particles, moved_count, overflow)."""
    K = cfg.slots_per_voxel
    bv, nb, spb = block_layout(cfg)
    A = min(cfg.max_moving_blocks, nb)
    flat = particles

    vox_axis = codecs.axis_stamps_per_voxel(cfg, scroll)
    hm = movable_voxels_plain(cfg, flat.track, flat.status, flat.stamp, vox_axis, max_movable)
    blocks = select_blocks((hm.view(nb, bv) != 0).any(dim=1), A)
    del hm
    rv = row_valid(blocks)

    g = lambda f: gather_rows_flat(f, blocks, spb)
    btrk = g(flat.track)
    bst = g(flat.status).to(torch.int32)
    bstamp = g(flat.stamp)
    baxis = torch.repeat_interleave(gather_rows_flat(vox_axis, blocks, bv), K, dim=1)
    balive = (bst != STATUS_INVALID) & (bstamp >= baxis)
    bmovable = balive & (btrk >= 0) & (btrk <= max_movable) & rv[:, None]
    bpx, bpy, bpz = g(flat.px), g(flat.py), g(flat.pz)
    bst, bmove, nx, ny, nz = rigid_move(params, objects, btrk, bst, bmovable, bpx, bpy, bpz,
                                        generator)

    # Delete the sources first (batched copy-delete-readd,
    # operations.h:321-362), then re-insert them as candidates.
    scatter_rows_flat(flat.status, blocks, spb, torch.where(bmove, STATUS_INVALID, bst))

    n = A * spb
    cand = Candidates(
        pos=torch.stack([nx.reshape(-1), ny.reshape(-1), nz.reshape(-1)], dim=-1),
        weight=g(flat.weight).reshape(-1),
        label=g(flat.label).to(torch.int32).reshape(-1),
        track=btrk.reshape(-1),
        status=bst.reshape(-1),
        stamp=bstamp.reshape(-1),
        forget=g(flat.forget).to(torch.int32).reshape(-1),
        priority=torch.arange(n, dtype=torch.int32, device=bpx.device),
        valid=bmove.reshape(-1),
    )
    res = _insert_core(
        cfg, flat, scroll, cand, resample_targets=False, max_target_blocks=2 * A,
    )
    return res.particles, res.accepted_count, blocks.overflow + res.block_overflow


def _packed_views(cfg: MapConfig, buf: torch.Tensor) -> dict:
    """pack_frame's fields as int32 views of ``buf``, by name (no kernel
    runs)."""
    HW = cfg.height * cfg.width
    I, Kp = cfg.max_instances_per_frame, cfg.max_keypoints
    sizes = (("head", 8), ("depth", HW), ("raster", (HW + 1) // 2), ("inst_track", I),
             ("inst_label", I), ("kpts_count", I), ("has_bbox", I), ("bbox_min", 3 * I),
             ("bbox_max", 3 * I), ("kpts_curr", 3 * I * Kp), ("kpts_prev", 3 * I * Kp))
    views, o = {}, 0
    for name, n in sizes:
        views[name] = buf[o : o + n]
        o += n
    return views


def _object_inputs(cfg: MapConfig, v: dict) -> FrameInput:
    I, Kp = cfg.max_instances_per_frame, cfg.max_keypoints
    head = v["head"].view(torch.float32)
    return FrameInput(
        depth=None,
        track_raster=None,
        track_label_table=None,
        inst_valid=v["inst_track"] >= 0,
        inst_track=torch.clamp(v["inst_track"], min=0),
        inst_label=v["inst_label"],
        kpts_curr=v["kpts_curr"].view(torch.float32).view(I, Kp, 3),
        kpts_prev=v["kpts_prev"].view(torch.float32).view(I, Kp, 3),
        kpts_count=v["kpts_count"],
        inst_bbox_min=None,
        inst_bbox_max=None,
        cam_pos=head[0:3],
        cam_quat=head[3:7],
        time=head[7],
    )


def unpack_frame(cfg: MapConfig, static_table: torch.Tensor, buf: torch.Tensor) -> FrameInput:
    """Device-side decode of the packed frame buffer (frontend.pack_frame),
    rebuilding the dense track -> label and track -> bbox tables from the
    per-instance arrays.  ``buf`` is int32 on the target device."""
    H, W = cfg.height, cfg.width
    I = cfg.max_instances_per_frame
    v = _packed_views(cfg, buf)
    f = _object_inputs(cfg, v)
    rp = v["raster"]
    raster = torch.stack([rp & 0xFFFF, (rp >> 16) & 0xFFFF], dim=-1).reshape(-1)[:H * W].view(H, W)

    inst_track, inst_label, valid = v["inst_track"], v["inst_label"], f.inst_valid
    # Overlays: valid instances with a known label write the label table,
    # those with a box the bbox tables; row 65536 is the drop row.
    tid = torch.where(valid & (inst_label >= 0) & (inst_track < 65536), inst_track, 65536)
    table = torch.cat([static_table, static_table[:1]])
    table[tid.long()] = torch.clamp(inst_label, min=0)
    tid_b = torch.where(valid & (v["has_bbox"] == 1) & (inst_track < 65536), inst_track,
                        65536).long()
    dev = buf.device
    bbox_min = torch.full((65537, 3), float("-inf"), dtype=torch.float32, device=dev)
    bbox_max = torch.full((65537, 3), float("inf"), dtype=torch.float32, device=dev)
    bbox_min[tid_b] = v["bbox_min"].view(torch.float32).view(I, 3)
    bbox_max[tid_b] = v["bbox_max"].view(torch.float32).view(I, 3)
    return f._replace(
        depth=v["depth"].view(torch.float32).view(H, W),
        track_raster=raster,
        track_label_table=table[:65536],
        inst_bbox_min=bbox_min[:65536],
        inst_bbox_max=bbox_max[:65536],
    )


def build_frame_step(cfg: MapConfig, params: FilterParams, registry: LabelRegistry):
    """The per-frame update: (MapState, FrameInput of device tensors) ->
    (MapState, RenderResult, StepDiagnostics), the port's eager
    ``map.build_frame_step`` without template stages.  The state's particle
    store and voxel stamps are updated in place."""
    max_movable = registry.max_movable_instance_id
    bbox3d = cfg.keypoint_mode == KEYPOINTS_BBOX3D
    # ZED2 only: sky cull (pointcloud_tools.h:234-241) and bbox gate.
    sky_instance = registry.static_label_to_instance.get(
        "Sky", registry.static_label_to_instance.get("sky", -1)
    ) if bbox3d else -1
    render_fn = (render_occupancy_smoothed if params.if_use_neighbor_smoothed_occupancy
                 else render_occupancy)

    def object_stage(state: MapState, f: FrameInput):
        # 1. Object layer (only with instances, semantic_dsp_map.h:189-191).
        if not cfg.consider_instance:
            return state.objects
        _r_wc, _t_wc, r_cw, t_cw = camera_matrices(f.cam_pos, f.cam_quat)
        draws = gumbel(ransac_draw_shape(cfg), state.rng, f.cam_pos.device)
        observed = ObservedInstances(
            valid=f.inst_valid, track=f.inst_track, label=f.inst_label,
            kpts_curr=f.kpts_curr, kpts_prev=f.kpts_prev, kpts_count=f.kpts_count,
        )
        return object_level_update(
            cfg, params, state.objects, observed, f.cam_pos, r_cw, t_cw, f.time,
            state.prev_frame_time, state.global_time + 1, draws,
        )

    def step(state: MapState, f: FrameInput):
        objects = object_stage(state, f)
        gt = state.global_time + 1
        r_wc, t_wc, r_cw, t_cw = camera_matrices(f.cam_pos, f.cam_quat)

        # 2. Labeled point cloud.
        cloud = generate_labeled_cloud(
            cfg, params, f.depth, f.track_raster, f.track_label_table, r_wc, t_wc,
            max_movable, sky_instance_id=sky_instance,
            inst_bbox_min=f.inst_bbox_min if bbox3d else None,
            inst_bbox_max=f.inst_bbox_max if bbox3d else None,
        )

        # 3. Prediction: scroll, expiry, cleanup, rigid moves.
        scroll = codecs.update_ego_center(cfg, state.scroll, f.cam_pos, gt)
        objects, _expired = expire_objects(params, objects, gt)
        particles = state.particles
        particles, moved, move_overflow = _move_and_cleanup(
            cfg, params, particles, scroll, objects, state.rng, max_movable
        )
        state = dataclasses.replace(
            state, particles=particles, scroll=scroll, objects=objects, global_time=gt,
        )

        # 4+5. Visibility + PHD weight update.
        particles, voxel_stamp, odiag = observe_and_update(
            cfg, params, particles, scroll, state.voxel_stamp, cloud, f.depth, r_cw, t_cw, gt,
        )
        state = dataclasses.replace(state, particles=particles, voxel_stamp=voxel_stamp)

        # 6. Birth + resampling.
        particles, born, birth_overflow, _cand = birth_and_resample(
            cfg, params, particles, scroll, cloud, gt, state.rng
        )
        state = dataclasses.replace(
            state, particles=particles, objects=objects, prev_frame_time=f.time,
        )

        # 7. Occupancy render (with its in-reduction GC side effects).
        particles, result = render_fn(cfg, state, params.occupancy_threshold)
        state = dataclasses.replace(state, particles=particles)

        diag = StepDiagnostics(
            visible_count=odiag.visible_count,
            born_count=born,
            moved_count=moved,
            block_overflow=odiag.block_overflow,
            entry_overflow=odiag.entry_overflow,
            table_dropped=odiag.table_dropped,
            corner_overflow=odiag.corner_overflow,
            move_overflow=move_overflow,
            birth_overflow=birth_overflow,
        )
        return state, result, diag

    return step
