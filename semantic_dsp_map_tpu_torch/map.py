"""The map engine: SemanticDSPMap (counterpart of
``semantic_dsp_map_tpu/map.py``; reference include/semantic_dsp_map.h:21).

One frame runs the reference's frame kernel stage for stage
(semantic_dsp_map.h:170-251): object-level update, labeled point cloud,
prediction (ego scroll, object expiry, floating-particle cleanup, rigid
moves), visibility + PHD weight update, birth + resampling, occupancy
render.  Every capacity cap is counted in :class:`StepDiagnostics`; the step
has fixed shapes and makes no data-dependent host sync.

Both keypoint modes run: superpoint (the VKITTI2 preset) and ZED2/bbox3d,
with its sky cull and bbox gate; so do template matching
(``template_engine``, after ``set_template_path``: its gate and its slots'
branches stay on the device) and the neighbour-smoothed render.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .config import FilterParams, KEYPOINTS_BBOX3D, MapConfig
from .frontend import FrameInput, PackedFrame, static_label_table
from .labels import LabelRegistry
from .objects import (
    ObservedInstances,
    expire_objects,
    object_finish,
    object_fit,
    object_level_update,
    ransac_draw_shape,
)
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
from .ops.observe import movable_voxels_plain, observe_and_update, use_observe_kernels
from .ops.projection import generate_labeled_cloud
from .ops.render import render_occupancy, render_occupancy_smoothed
from .state import (
    MapState,
    Particles,
    STATUS_INVALID,
    clear_map_state,
    init_map_state,
    resolve_device,
)
from .step_graph import StaticStep, split_at_refit
from .template_engine import TemplateEngine
from .timing import NO_SPAN, Tracer


#: The stages of the frame step, in order (the reference's VERBOSE_MODE
#: chrono spans, semantic_dsp_map.h:916-952).  ``build_frame_step``'s
#: ``stop_after`` indexes this tuple.
STAGES = (
    "objects",
    "labeled_cloud",
    "prediction",
    "observe_phd",
    "birth_resample",
    "render",
)


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
    scan = movable_voxels_plain
    if use_observe_kernels(cfg, flat.track):
        from .ops.observe_cuda import movable_voxels_cuda as scan
    hm = scan(cfg, flat.track, flat.status, flat.stamp, vox_axis, max_movable)
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


def unpack_objects(cfg: MapConfig, buf: torch.Tensor) -> FrameInput:
    """The part of :func:`unpack_frame` that the object layer reads: the
    camera, the time and the per-instance arrays, the same tensors.  The
    image and the dense track tables (``depth``, ``track_raster``,
    ``track_label_table``, ``inst_bbox_min``, ``inst_bbox_max``) are None."""
    return _object_inputs(cfg, _packed_views(cfg, buf))


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


class FrameStages(NamedTuple):
    """The frame step in parts: ``objects(state, f)`` is the object layer
    (stage 0) and returns the updated ObjectTable; ``rest(state, f, objects)``
    runs stages 1-5 from it and returns (MapState, RenderResult,
    StepDiagnostics).  Where the superpoint refit runs
    (``step_graph.split_at_refit``), ``objects`` is ``objects_fit(state, f)``
    (an ``objects.ObjectFit``), ``objects.refit_svd`` of it (U, Vt), then
    ``objects_finish(fit, U, Vt)``, and ``step_graph`` captures the parts on
    either side of the SVD; elsewhere those two are None.  The object parts
    read only the fields of ``f`` that :func:`unpack_objects` fills.
    ``rank_rng`` is None for the map; the sharded stages
    (``parallel.shard_step.build_shard_stages``) also draw from a generator
    of the rank's own, and there it is that generator's keeper
    (``shard_step.RankGenerator``: called with the state it returns the
    generator, ``reseed(state)`` seeds it anew).  ``tracer`` is the
    ``timing.Tracer`` the parts stamp (None: no stamps); ``step_graph``
    stamps the graphs' starts and the frame's last stamp with it."""

    objects: Callable
    rest: Callable
    objects_fit: Optional[Callable]
    objects_finish: Optional[Callable]
    rank_rng: Optional[Callable] = None
    tracer: Optional[Tracer] = None


def build_frame_stages(cfg: MapConfig, params: FilterParams, registry: LabelRegistry,
                       template_stages=None, stop_after: Optional[int] = None,
                       tracer: Optional[Tracer] = None) -> FrameStages:
    """The two parts of :func:`build_frame_step`'s step (same arguments).
    With ``tracer`` each stage ends with its stamp (``timing.STAMPS``: the
    object layer, the labeled cloud, the prediction, observe and update,
    birth), the template stages (with ``template_stages``) have a start and
    an end stamp each, and template birth's end copies their counts
    (``TemplateStages.counts``); without it the parts are the eager
    step's."""
    last = len(STAGES) - 1
    stop_after = last if stop_after is None else stop_after
    if not 0 <= stop_after <= last:
        raise ValueError(f"stop_after must be in [0, {last}], got {stop_after}")
    max_movable = registry.max_movable_instance_id
    bbox3d = cfg.keypoint_mode == KEYPOINTS_BBOX3D
    # ZED2 only: sky cull (pointcloud_tools.h:234-241) and bbox gate.
    sky_instance = registry.static_label_to_instance.get(
        "Sky", registry.static_label_to_instance.get("sky", -1)
    ) if bbox3d else -1
    render_fn = (render_occupancy_smoothed if params.if_use_neighbor_smoothed_occupancy
                 else render_occupancy)

    def observed(f: FrameInput):
        return ObservedInstances(
            valid=f.inst_valid, track=f.inst_track, label=f.inst_label,
            kpts_curr=f.kpts_curr, kpts_prev=f.kpts_prev, kpts_count=f.kpts_count,
        )

    def object_stage(state: MapState, f: FrameInput):
        # 1. Object layer (only with instances, semantic_dsp_map.h:189-191).
        objects = state.objects
        if cfg.consider_instance:
            _r_wc, _t_wc, r_cw, t_cw = camera_matrices(f.cam_pos, f.cam_quat)
            draws = gumbel(ransac_draw_shape(cfg), state.rng, f.cam_pos.device)
            objects = object_level_update(
                cfg, params, state.objects, observed(f), f.cam_pos, r_cw, t_cw, f.time,
                state.prev_frame_time, state.global_time + 1, draws,
            )
        if tracer is not None:
            tracer.stamp("objects")
        return objects

    def objects_fit(state: MapState, f: FrameInput):
        draws = gumbel(ransac_draw_shape(cfg), state.rng, f.cam_pos.device)
        return object_fit(cfg, state.objects, observed(f), f.cam_pos, f.time,
                          state.prev_frame_time, state.global_time + 1, draws)

    def objects_finish(fit, U, Vt):
        objects = object_finish(cfg, params, fit, U, Vt)
        if tracer is not None:
            tracer.stamp("objects")
        return objects

    def rest(state: MapState, f: FrameInput, objects):
        if stop_after == 0:
            return dataclasses.replace(state, objects=objects), None, None
        gt = state.global_time + 1
        r_wc, t_wc, r_cw, t_cw = camera_matrices(f.cam_pos, f.cam_quat)

        # 2. Labeled point cloud.
        cloud = generate_labeled_cloud(
            cfg, params, f.depth, f.track_raster, f.track_label_table, r_wc, t_wc,
            max_movable, sky_instance_id=sky_instance,
            inst_bbox_min=f.inst_bbox_min if bbox3d else None,
            inst_bbox_max=f.inst_bbox_max if bbox3d else None,
        )
        if tracer is not None:
            tracer.stamp("cloud")
        if stop_after == 1:
            return dataclasses.replace(state, objects=objects), None, None

        # 3. Prediction: scroll, expiry, template rematch, cleanup, rigid moves.
        scroll = codecs.update_ego_center(cfg, state.scroll, f.cam_pos, gt)
        objects, _expired = expire_objects(params, objects, gt)
        particles = state.particles
        tmpl_overflow = 0
        if template_stages is not None:
            if tracer is not None:
                tracer.stamp("rematch_start")
            # Which rows have work, on the device (the slots' branches read it).
            gate = template_stages.gate(objects, cloud)
            particles, rm_ov = template_stages.rematch(particles, scroll, cloud, f.cam_pos, gate, gt)
            tmpl_overflow = tmpl_overflow + rm_ov
            if tracer is not None:
                tracer.stamp("rematch_end")
        particles, moved, move_overflow = _move_and_cleanup(
            cfg, params, particles, scroll, objects, state.rng, max_movable
        )
        state = dataclasses.replace(
            state, particles=particles, scroll=scroll, objects=objects, global_time=gt,
        )
        if tracer is not None:
            tracer.stamp("predict")
        if stop_after == 2:
            return state, None, None

        # 4+5. Visibility + PHD weight update.
        particles, voxel_stamp, odiag = observe_and_update(
            cfg, params, particles, scroll, state.voxel_stamp, cloud, f.depth, r_cw, t_cw, gt,
        )
        state = dataclasses.replace(state, particles=particles, voxel_stamp=voxel_stamp)
        if tracer is not None:
            tracer.stamp("observe")
        if stop_after == 3:
            return state, None, None

        # 6. Birth + resampling, then template birth.
        particles, born, birth_overflow, _cand = birth_and_resample(
            cfg, params, particles, scroll, cloud, gt, state.rng
        )
        if template_stages is not None:
            if tracer is not None:
                tracer.stamp("template_birth_start")
            particles, objects, tb_ov = template_stages.birth(
                particles, scroll, objects, cloud, f.cam_pos, gate, gt, state.rng
            )
            tmpl_overflow = tmpl_overflow + tb_ov
            if tracer is not None:
                tracer.stamp("template_birth_end", counts=template_stages.counts())
        state = dataclasses.replace(
            state, particles=particles, objects=objects, prev_frame_time=f.time,
        )
        if tracer is not None:
            tracer.stamp("birth")
        if stop_after == 4:
            return state, None, None

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
            birth_overflow=birth_overflow + tmpl_overflow,
        )
        return state, result, diag

    if split_at_refit(cfg):
        return FrameStages(object_stage, rest, objects_fit, objects_finish, tracer=tracer)
    return FrameStages(object_stage, rest, None, None, tracer=tracer)


def build_frame_step(cfg: MapConfig, params: FilterParams, registry: LabelRegistry,
                     template_stages=None, stop_after: Optional[int] = None):
    """The per-frame update: (MapState, FrameInput of device tensors) ->
    (MapState, RenderResult, StepDiagnostics).  The state's particle store
    and voxel stamps are updated in place.  This is the eager step, the
    oracle of the captured one (``step_graph``).

    ``template_stages`` (a template_engine.TemplateStages) runs template
    matching where the JAX step does: the gate and the rematch after object
    expiry, before the rigid moves (semantic_dsp_map.h:616-669); the
    template birth after regular birth, before the render (:806-894).  Their
    insert overflow is added to ``birth_overflow``.

    ``stop_after`` (an index into :data:`STAGES`) truncates the step after
    that stage, for the per-stage timing of ``profiling``: the step then
    returns (the state as far as it got, None, None).  ``None`` and the last
    index run the whole step."""
    stages = build_frame_stages(cfg, params, registry, template_stages, stop_after)

    def step(state: MapState, f: FrameInput):
        return stages.rest(state, f, stages.objects(state, f))

    return step


class SemanticDSPMap:
    """User-facing map engine (reference: class SemanticDSPMap,
    semantic_dsp_map.h:21).

    Typical use::

        dsp = SemanticDSPMap(virtual_kitti2_config(), FilterParams(...))
        for frame in frames:
            result, diag = dsp.update(depth, masks, cam_pos, cam_quat, t)

    ``device=None`` means the card; without a CUDA device it raises, and
    ``device="cpu"`` asks for the CPU by name (state.resolve_device).  The
    card's kernels take every K the config accepts (a store the card's
    memory cannot hold fails in the allocator).  On the
    card the step is captured into CUDA graphs from the second frame on and
    replayed after (``step_graph``), template mode included (each template
    slot is a conditional node of graph "finish").
    ``state`` names tensors that keep their addresses; assigning another
    state (a restored checkpoint) is taken over on the next frame.  Every
    frame overwrites them in place: a part of ``state`` held across
    ``update()`` holds the new values, so clone what must stay as it was.

    ``tracer`` (a ``timing.Tracer``, None: off) records each frame's host
    spans, its stages' device times and its counters in memory, with no
    host synchronization; ``tracer.collect()`` reads them.
    """

    def __init__(
        self,
        cfg: MapConfig,
        params: Optional[FilterParams] = None,
        registry: Optional[LabelRegistry] = None,
        seed: int = 0,
        device=None,
        log_diagnostics: bool = False,
        tracer: Optional[Tracer] = None,
    ):
        self.cfg = cfg
        self.params = params or FilterParams()
        self.registry = registry or LabelRegistry.default()
        self.device = resolve_device(device)
        self.state = init_map_state(cfg, seed, self.device)
        self.log_diagnostics = log_diagnostics
        self.tracer = tracer
        if tracer is not None:
            tracer.bind(self.device)
        self._static_table = torch.from_numpy(static_label_table(self.registry)).to(self.device)
        self._time_origin: Optional[float] = None
        # The buffer update() packs each frame into (frontend.PackedFrame),
        # made on the first frame and again only if the frame's shape
        # changes; the frames packed into the one held and those that made
        # one.
        self._packed: Optional[PackedFrame] = None
        self.packs_in_place = 0
        self.pack_allocations = 0
        self._templates = None
        # The step (step_graph.StaticStep), built on first use: in template
        # mode the stages close over the bank, which set_template_path loads
        # after construction.
        self._static = None
        if self.params.if_use_template_matching:
            self._templates = TemplateEngine(cfg, self.params, self.registry)

    def set_template_path(self, folder: str) -> int:
        """setTemplatePath (semantic_dsp_map.h:163-166): load the CAD
        template bank (.pcd files grouped by label-id directory); returns
        the number of templates."""
        if self._templates is None:
            raise ValueError(
                "set_template_path requires FilterParams(if_use_template_matching=True)"
            )
        n = self._templates.set_template_path(folder)
        self._static = None
        return n

    def clear(self):
        """semantic_dsp_map.h:74-81."""
        self.state = clear_map_state(self.state, self.cfg)

    def _run(self, kind: str, host):
        """One frame: ``kind`` "packed" is pack_frame's int32 array, "frame"
        a FrameInput."""
        if self._static is None:
            templates = self._templates.stages(self.device) if self._templates else None
            self._static = StaticStep(
                build_frame_stages(self.cfg, self.params, self.registry, templates,
                                   tracer=self.tracer),
                functools.partial(unpack_frame, self.cfg, self._static_table),
                functools.partial(unpack_objects, self.cfg), self.state,
                capture=self.device.type == "cuda",
            )
        self.state, result, diag = self._static(kind, host, self.state)
        if self.log_diagnostics:
            d = {k: int(v) for k, v in diag._asdict().items()}
            print(f"[dsp] t={int(self.state.global_time)} {d}", flush=True)
        return result, diag

    def update_from_frame(self, frame: FrameInput):
        """Run one frame from a FrameInput (frontend.build_frame_input) of
        host arrays or of tensors on the device; returns (RenderResult,
        StepDiagnostics)."""
        with NO_SPAN if self.tracer is None else self.tracer.span("dsp.update"):
            return self._run("frame", frame)

    def update(self, depth: np.ndarray, masks, cam_pos, cam_quat, time: float = 0.0):
        """Reference-parity entry (semantic_dsp_map.h:170): depth image,
        MaskKpts list and camera pose -> (RenderResult, StepDiagnostics).
        The frame travels to the device as one packed buffer, which the map
        keeps and packs again on the next frame (the step copies it to the
        device before it returns)."""
        tracer = self.tracer
        with NO_SPAN if tracer is None else tracer.span("dsp.update"):
            with NO_SPAN if tracer is None else tracer.span("dsp.pack"):
                if self._time_origin is None:
                    self._time_origin = float(time)
                t = float(time) - self._time_origin
                fresh = self._packed is None or not self._packed.fits(self.cfg)
                if fresh:
                    self._packed = PackedFrame(self.cfg)
                self.pack_allocations += fresh
                self.packs_in_place += not fresh
                if tracer is not None:
                    tracer.count("pack_allocated" if fresh else "pack_in_place")
                buf = self._packed.pack(self.cfg, self.registry, depth, masks, cam_pos,
                                        cam_quat, t)
            return self._run("packed", buf)
