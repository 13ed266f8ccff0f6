"""The frame step with the template stages: the frozen step's stages
(``dspbench.reference.step``) in its order, with template rematch in the
prediction, after the ego scroll and the object expiry and before the
rigid moves (which skip the objects it rematches), and template birth
after birth, before the render (semantic_dsp_map.h:616-669, :806-894)."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

from ..reference.config import FilterParams, KEYPOINTS_BBOX3D, MapConfig
from ..reference.frontend import FrameInput
from ..reference.labels import LabelRegistry
from ..reference.objects import (ObservedInstances, expire_objects, object_level_update,
                                 ransac_draw_shape)
from ..reference.ops import codecs
from ..reference.ops.birth import birth_and_resample
from ..reference.ops.geometry import camera_matrices
from ..reference.ops.observe import observe_and_update
from ..reference.ops.projection import generate_labeled_cloud
from ..reference.ops.render import render_occupancy, render_occupancy_smoothed
from ..reference.state import MapState
from ..reference.step import StepDiagnostics, _move_and_cleanup, gumbel
from . import templates


class TemplateCounts(NamedTuple):
    """What the template stages did in a frame."""

    rematch_sweeps: int
    template_birth_sweeps: int
    guessed_born_count: int


def build_frame_step(cfg: MapConfig, params: FilterParams, registry: LabelRegistry, bank: list):
    """(MapState, FrameInput of device tensors) -> (MapState, RenderResult,
    StepDiagnostics), as the frozen step; ``bank`` holds the Car templates
    (``templates.load_bank``).  The particle store and voxel stamps are
    updated in place; the step's ``counts`` attribute holds the last
    frame's TemplateCounts."""
    max_movable = registry.max_movable_instance_id
    car_label = registry.label_to_id.get("Car", -1)
    bbox3d = cfg.keypoint_mode == KEYPOINTS_BBOX3D
    sky_instance = registry.static_label_to_instance.get(
        "Sky", registry.static_label_to_instance.get("sky", -1)
    ) if bbox3d else -1
    render_fn = (render_occupancy_smoothed if params.if_use_neighbor_smoothed_occupancy
                 else render_occupancy)

    def step(state: MapState, f: FrameInput):
        gt = state.global_time + 1
        r_wc, t_wc, r_cw, t_cw = camera_matrices(f.cam_pos, f.cam_quat)

        # 1. Object layer.
        objects = state.objects
        if cfg.consider_instance:
            draws = gumbel(ransac_draw_shape(cfg), state.rng, f.cam_pos.device)
            observed = ObservedInstances(
                valid=f.inst_valid, track=f.inst_track, label=f.inst_label,
                kpts_curr=f.kpts_curr, kpts_prev=f.kpts_prev, kpts_count=f.kpts_count,
            )
            objects = object_level_update(
                cfg, params, state.objects, observed, f.cam_pos, r_cw, t_cw, f.time,
                state.prev_frame_time, gt, draws,
            )

        # 2. Labeled point cloud.
        cloud = generate_labeled_cloud(
            cfg, params, f.depth, f.track_raster, f.track_label_table, r_wc, t_wc,
            max_movable, sky_instance_id=sky_instance,
            inst_bbox_min=f.inst_bbox_min if bbox3d else None,
            inst_bbox_max=f.inst_bbox_max if bbox3d else None,
        )

        # 3. Prediction: scroll, expiry, template rematch, cleanup, rigid moves.
        scroll = codecs.update_ego_center(cfg, state.scroll, f.cam_pos, gt)
        objects, _expired = expire_objects(params, objects, gt)
        particles, rematch_sweeps = templates.rematch(cfg, params, state.particles, scroll,
                                                      objects, cloud, f.cam_pos, gt)
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

        # 6. Birth + resampling, then template birth.
        particles, born, birth_overflow, _cand = birth_and_resample(
            cfg, params, particles, scroll, cloud, gt, state.rng
        )
        particles, flags, birth_sweeps, guessed = templates.template_birth(
            cfg, params, particles, scroll, objects, cloud, f.cam_pos, gt, bank, car_label,
            state.rng)
        objects = dataclasses.replace(objects, to_match_templates=flags)
        state = dataclasses.replace(
            state, particles=particles, objects=objects, prev_frame_time=f.time,
        )

        # 7. Occupancy render.
        particles, result = render_fn(cfg, state, params.occupancy_threshold)
        state = dataclasses.replace(state, particles=particles)

        diag = StepDiagnostics(
            visible_count=odiag.visible_count, born_count=born, moved_count=moved,
            block_overflow=odiag.block_overflow, entry_overflow=odiag.entry_overflow,
            table_dropped=odiag.table_dropped, corner_overflow=odiag.corner_overflow,
            move_overflow=move_overflow, birth_overflow=birth_overflow,
        )
        step.counts = TemplateCounts(rematch_sweeps, birth_sweeps, guessed)
        return state, result, diag

    step.counts = None
    return step
