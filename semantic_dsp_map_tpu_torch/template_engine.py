"""Template-matching frame stages, flag ``if_use_template_matching``
(counterpart of ``semantic_dsp_map_tpu/template_engine.py``).

The two template paths of the reference frame kernel:

  1. **Rematch** (semantic_dsp_map.h:616-669): objects flagged
     ``to_match_previous`` get their particles re-aligned to the observed
     object cloud (center + non-FS sweep); on a good match the old particles
     are deleted and the aligned cloud re-added at weight 0.2
     (operations.h:125-146).  Runs in the prediction phase, before the
     rigid moves (which skip those objects).
  2. **Template birth** (semantic_dsp_map.h:806-894): newly observed Cars with
     1500..8000 observed points and a >= 1 m bbox are matched against the CAD
     template bank (FS sweep, best template wins); on a good match, 3
     jittered GUESSED_BORN particles are added per template point.  Runs
     after regular birth and before the render.

Both stages run on the device with no host read, structure for structure
as the JAX package's (its round-5 design), so that the captured step
(``step_graph``) holds them:

  - the i32[O, 8] gate (``template_gate``; on the card one pass of a kernel
    over the image, ``ops/templates_cuda.py``) says which objects have work,
    and ``_top_rows`` picks the slots' rows from it on the device; track ids
    and labels are tensors read from it;
  - each slot is one ``step_graph.slot_cond`` (the JAX package's
    ``lax.cond``): a conditional node of the graph that runs the slot's sweep
    only where its row has work, and returns small outputs only (the aligned
    cloud, its validity, a flag or the score); the particle store never
    passes through a branch;
  - then, every frame, whatever the slots did: rematch's delete pass
    (``delete_matched_plain``, on the card a kernel that returns at once
    where no match was good) and one fixed-capacity ``_insert_core`` per
    stage, every slot's candidates concatenated (an insert with no valid
    candidate leaves the store as it was);
  - the guessed-birth normals are drawn every frame, outside the branch, so
    that a replay advances the generator as the eager step does.

Each stage's sweeps are counted on the device (:class:`SweepRecord`), and
so are the rematch slots whose match was good; ``TemplateStages.counts()``
hands the frame tracer those totals and the guessed particles that template
birth's last insert accepted.  As in the JAX package, at most ``RM_MAX``
rematches and ``TB_MAX`` template births run per frame, in ascending object
row; eligibility beyond the cap is deferred (the ``to_match_*`` flags stay
set).  Guessed-birth jitter comes from the map's ``torch.Generator`` unless
the caller passes the standard-normal draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import torch

from .config import FilterParams, MapConfig, PARTICLE_OCC_INIT_WEIGHT
from .labels import LabelRegistry
from .ops import codecs, templates_cuda
from .ops.birth import Candidates, _insert_core
from .ops.blocks import block_layout, gather_rows_flat, row_valid, select_blocks
from .ops.templates import (
    GUESSED_BIRTH_COPIES,
    GUESSED_BIRTH_NOISE,
    MATCHED_WEIGHT,
    MatchGridConfig,
    REMATCH_MIN_POINTS,
    TM_MAX_POINTS,
    TM_MIN_BBOX_XY,
    TM_MIN_POINTS,
    TemplateBank,
    sweep_tables,
    take,
    template_match,
    template_match_bank,
)
from .state import STATUS_GUESSED_BORN, STATUS_INVALID, constant, resolve_device
from .step_graph import slot_cond

#: Per-frame slot capacities (see module docstring).
RM_MAX = 2
TB_MAX = 1

#: Target-block capacity of each stage's insert: an aligned car at 0.15 m
#: voxels covers ~60-120 storage blocks; overflow rides birth_overflow.
TM_INSERT_BLOCKS = 256

_BIG = 3.4e38


def template_gate(car_label: int, objects, cloud) -> torch.Tensor:
    """The i32[O, 8] eligibility array, one masked reduction over
    [O, H*W].

    Columns: [valid, rematch_ok, birth_ok, track_id, label,
    cloud_point_count, bbox_extent_x_mm, bbox_extent_y_mm].  The count is the
    uncapped per-track cloud count (semantic_dsp_map.h:815); the mm columns
    are the getBoundingBox x/y extents (semantic_dsp_map.h:1388-1412)."""
    flat_trk = cloud.track.reshape(-1)
    flat_ok = cloud.valid.reshape(-1)
    fx = cloud.pos[..., 0].reshape(-1)
    fy = cloud.pos[..., 1].reshape(-1)
    big = constant(_BIG, torch.float32, fx.device)

    m = (flat_trk[None, :] == objects.track_id[:, None]) & flat_ok[None, :]
    n = m.sum(dim=1, dtype=torch.int32)

    def extent(v):
        return torch.where(m, v, -big).amax(dim=1) - torch.where(m, v, big).amin(dim=1)

    ok = objects.valid & (n > 0)
    cnt = torch.where(objects.valid, n, 0)
    ext_x = torch.where(ok, extent(fx), 0.0)
    ext_y = torch.where(ok, extent(fy), 0.0)
    rem = objects.valid & objects.to_match_previous & objects.moving & objects.has_moved_record
    tb = objects.valid & objects.to_match_templates & (objects.label == car_label)
    return torch.stack(
        [
            objects.valid.to(torch.int32),
            rem.to(torch.int32),
            tb.to(torch.int32),
            objects.track_id.to(torch.int32),
            objects.label.to(torch.int32),
            cnt,
            (ext_x * 1000.0).to(torch.int32),
            (ext_y * 1000.0).to(torch.int32),
        ],
        dim=1,
    )


def delete_matched_plain(track, status, good, tid) -> None:
    """deleteParticlesInSet (operations.h:125-146) for the rematch slots
    whose match was good: ``status`` set to STATUS_INVALID, in place,
    wherever ``track`` is ``tid[i]`` for a slot ``i`` with ``good[i]``
    (bool[S], i32[S]); one masked pass over the store.  The CPU path and
    the oracle of ``ops.templates_cuda.delete_matched_cuda``."""
    del_mask = torch.zeros_like(status, dtype=torch.bool)
    for i in range(good.shape[0]):
        del_mask |= good[i] & (track == tid[i])
    status.masked_fill_(del_mask, STATUS_INVALID)


def _top_rows(mask: torch.Tensor, cap: int):
    """Indices of the first ``cap`` True rows (ascending object index, the
    reference's iteration order), i64[cap] with 0 where there is none, and
    their validity, bool[cap]: one sort on the device."""
    O = mask.shape[0]
    iota = torch.arange(O, device=mask.device)
    srt = torch.sort(torch.where(mask, iota, O + iota)).values[:cap]
    valid = srt < O
    return torch.where(valid, srt, 0), valid


def _compact_by_sort(mask_flat, xs, ys, zs, n_max: int):
    """Stable compaction of masked points into a buffer of at most n_max
    rows (a stable sort on the key); selected points keep ascending source
    order."""
    key = (~mask_flat).to(torch.int32)
    srt = torch.sort(key, stable=True)
    ks, order = srt.values[:n_max], srt.indices[:n_max]
    ok = ks == 0
    pts = torch.stack([xs[order], ys[order], zs[order]], dim=-1)
    return torch.where(ok[:, None], pts, 0.0), ok


def _extract_track_points(n_max: int, cloud, tid):
    """Compact the valid labeled-cloud points of track id ``tid`` (a number
    or a 0-d tensor; the reference takes every mask pixel,
    semantic_dsp_map.h:625-638; only valid points are kept here)."""
    m = ((cloud.track == tid) & cloud.valid).reshape(-1)
    return _compact_by_sort(
        m,
        cloud.pos[..., 0].reshape(-1),
        cloud.pos[..., 1].reshape(-1),
        cloud.pos[..., 2].reshape(-1),
        n_max,
    )


def _extract_particle_points(cfg: MapConfig, n_max: int, particles, scroll, tid,
                             weight_threshold: float):
    """getParticlesAsPointCloud (operations.h:242-255) for track id ``tid``
    (a 0-d tensor): alive particles with weight > threshold, compacted from
    the block working set that holds them.  Returns (pts f32[n_max, 3], ok,
    count)."""
    K = cfg.slots_per_voxel
    V = cfg.num_voxels
    bv, nb, spb = block_layout(cfg)
    A = min(cfg.max_moving_blocks, nb)
    vox_axis = codecs.axis_stamps_per_voxel(cfg, scroll)
    alive = codecs.particle_alive(particles.status.view(V, K), particles.stamp.view(V, K), vox_axis)
    thr = constant(weight_threshold, torch.float32, vox_axis.device)
    m = (alive & (particles.track.view(V, K) == tid) & (particles.weight.view(V, K) > thr)).reshape(-1)

    blocks = select_blocks(m.view(nb, spb).any(dim=1), A)
    rv = row_valid(blocks)
    g = lambda f: gather_rows_flat(f, blocks, spb)
    bm = (g(m) & rv[:, None]).reshape(-1)
    pts, ok = _compact_by_sort(
        bm, g(particles.px).reshape(-1), g(particles.py).reshape(-1),
        g(particles.pz).reshape(-1), min(n_max, A * spb),
    )
    pad = n_max - pts.shape[0]
    if pad > 0:
        pts = torch.nn.functional.pad(pts, (0, 0, 0, pad))
        ok = torch.nn.functional.pad(ok, (0, pad))
    return pts, ok, m.sum()


def _masked_center(ppts, pok):
    """alignPointCloudToXYZCenter (pointcloud_tools.h:365-380) under a mask."""
    big = constant(_BIG, torch.float32, ppts.device)
    lo = torch.where(pok[:, None], ppts, big).amin(dim=0)
    hi = torch.where(pok[:, None], ppts, -big).amax(dim=0)
    c = (lo + hi) * 0.5
    return torch.where(pok[:, None], ppts - c, 0.0)


def _candidates(pos, valid, track, label, weight: float, gt) -> Candidates:
    n = pos.shape[0]
    dev = pos.device
    full = lambda v, dtype: torch.full((n,), v, dtype=dtype, device=dev)
    return Candidates(
        pos=pos,
        weight=full(weight, torch.float32),
        label=label,
        track=track,
        status=full(STATUS_GUESSED_BORN, torch.int32),
        stamp=gt.to(torch.int32).expand(n),
        forget=full(0, torch.int32),
        priority=torch.arange(n, dtype=torch.int32, device=dev),
        valid=valid,
    )


class SweepRecord(NamedTuple):
    """The sweeps one stage ran, on the device: each branch that runs a
    sweep writes it, inside the captured step as outside it (a replay calls
    no Python).  ``count`` sweeps so far; ``gate_row`` and ``score`` those
    of the last."""

    count: torch.Tensor     # i64
    gate_row: torch.Tensor  # i32[8], the object's row of the gate
    score: torch.Tensor     # f32, the best score of its sweep


def _sweep_cond(pred, record: SweepRecord, gate_row, do: Callable, no: Callable) -> tuple:
    """``step_graph.slot_cond(pred, do, no)`` for a slot whose branch
    sweeps: ``do()``'s last output is the sweep's best score.  ``record``
    counts the sweep and takes ``gate_row`` and that score where the branch
    runs, and keeps what it held elsewhere."""

    def do_recorded():
        out = do()
        return (*out, record.count + 1, gate_row, out[-1])

    def no_recorded():
        return (*no(), record.count, record.gate_row, record.score)

    *out, count, row, score = slot_cond(pred, do_recorded, no_recorded)
    for dst, src in zip(record, (count, row, score)):
        dst.copy_(src)
    return tuple(out)


class TemplateStages(NamedTuple):
    """The stage closures built once per (config, params, bank, device),
    and the records of the sweeps they ran."""

    gate: object     # (objects, cloud) -> i32[O, 8] on the device
    rematch: object  # (particles, scroll, cloud, cam_pos, gate, gt) -> (particles, overflow)
    birth: object    # (particles, scroll, objects, cloud, cam_pos, gate, gt,
                     #  generator=None, draws=None) -> (particles, objects, overflow)
    records: Dict[str, SweepRecord]  # "rematch", "birth"
    counts: Callable  # () -> {counter name: 0-d int64 device tensor} for timing.Tracer


def build_template_stages(
    cfg: MapConfig,
    params: FilterParams,
    registry: LabelRegistry,
    grid: MatchGridConfig,
    bank: Optional[TemplateBank],
    device=None,
) -> TemplateStages:
    """Build the per-frame template stages (see module docstring).  The
    stages take the gate as the device tensor ``gate(...)`` gives, make no
    host read, and update the particle store in place."""
    car_label = registry.label_to_id.get("Car", -1)
    Pt = grid.max_template_points
    n_copies = Pt * GUESSED_BIRTH_COPIES
    min_mm = int(TM_MIN_BBOX_XY * 1000)
    dev = resolve_device(device)
    thr = constant(params.match_score_threshold, torch.float32, dev)
    tables = sweep_tables(grid, dev)
    records = {
        stage: SweepRecord(torch.zeros((), dtype=torch.int64, device=dev),
                           torch.zeros(8, dtype=torch.int32, device=dev),
                           torch.zeros((), dtype=torch.float32, device=dev))
        for stage in ("rematch", "birth")
    }
    # The rematch slots whose match was good, a running total.
    matched = torch.zeros((), dtype=torch.int64, device=dev)

    have_bank = False
    if bank is not None:
        tpls_np, tvalids_np = bank.of_label(car_label)
        have_bank = tpls_np.shape[0] > 0
    if have_bank:
        tpls = torch.from_numpy(tpls_np).to(dev)
        tvalids = torch.from_numpy(tvalids_np).to(dev)

    def gate_fn(objects, cloud):
        return templates_cuda.template_gate_cuda(car_label, objects, cloud)

    def no_sweep():
        return (torch.zeros((Pt, 3), dtype=torch.float32, device=dev),
                torch.zeros(Pt, dtype=torch.bool, device=dev))

    def per_slot(v, n: int):
        return torch.cat([x.to(torch.int32).expand(n) for x in v])

    # ------------------------------------------------------------------
    def rematch(particles, scroll, cloud, cam_pos, gate, gt):
        rows, rvalid = _top_rows(gate[:, 1] == 1, RM_MAX)
        slots = []
        for i in range(RM_MAX):
            row = take(gate, rows[i])
            tid = row[3]
            eligible = rvalid[i] & (row[5] >= REMATCH_MIN_POINTS)

            def do_match():
                pts, ok = _extract_track_points(grid.max_source_points, cloud, tid)
                ppts, pok, pcount = _extract_particle_points(cfg, Pt, particles, scroll, tid, 0.1)
                res = template_match(grid, False, pts, ok, cam_pos, _masked_center(ppts, pok), pok,
                                     tables)
                return res.aligned, pok, (res.score > thr) & (pcount > 0), res.score

            def no_match():
                return (*no_sweep(), torch.zeros((), dtype=torch.bool, device=dev),
                        constant(-1.0, torch.float32, dev))

            aligned, pok, good, _score = _sweep_cond(eligible, records["rematch"], row, do_match,
                                                     no_match)
            slots.append((aligned, pok, good, tid, row[4]))

        # deleteParticlesInSet for matched objects: one pass over the store.
        good = torch.stack([s[2] for s in slots])
        templates_cuda.delete_matched_cuda(particles.track, particles.status, good,
                                           torch.stack([s[3] for s in slots]))
        matched.add_(good.sum())

        # One fixed-capacity insert of every slot's aligned cloud.
        cand = _candidates(
            pos=torch.cat([s[0] for s in slots]),
            valid=torch.cat([s[1] & s[2] for s in slots]),
            track=per_slot([s[3] for s in slots], Pt),
            label=per_slot([s[4] for s in slots], Pt),
            weight=MATCHED_WEIGHT, gt=gt,
        )
        res = _insert_core(cfg, particles, scroll, cand, resample_targets=False,
                           max_target_blocks=TM_INSERT_BLOCKS)
        return res.particles, res.block_overflow

    # ------------------------------------------------------------------
    def birth(particles, scroll, objects, cloud, cam_pos, gate, gt,
              generator: Optional[torch.Generator] = None, draws: Optional[torch.Tensor] = None):
        """``draws``: standard-normal f32[TB_MAX * Pt * 3, 3], drawn from
        ``generator`` when None, on every frame: a replay of a CUDA graph
        advances the generator's offset by the same amount whether a birth
        runs or not, and so does the eager step."""
        if not have_bank:
            none = torch.zeros((), dtype=torch.int64, device=dev)
            last["guessed_born"] = none
            return particles, objects, none
        if draws is None:
            draws = torch.randn((TB_MAX * n_copies, 3), generator=generator, device=dev)
        rows, rvalid = _top_rows(gate[:, 2] == 1, TB_MAX)
        flags = objects.to_match_templates.clone()
        slots = []
        for i in range(TB_MAX):
            row = take(gate, rows[i])
            n_pts = row[5]
            attempted = (rvalid[i] & (n_pts > TM_MIN_POINTS) & (n_pts < TM_MAX_POINTS)
                         & (row[6] >= min_mm) & (row[7] >= min_mm))

            def do_match():
                pts, ok = _extract_track_points(grid.max_source_points, cloud, row[3])
                best_idx, score, aligned = template_match_bank(grid, True, pts, ok, cam_pos, tpls,
                                                               tvalids, tables)
                return aligned, take(tvalids, best_idx), score

            def no_match():
                return (*no_sweep(), constant(-1.0, torch.float32, dev))

            aligned, best_ok, score = _sweep_cond(attempted, records["birth"], row, do_match,
                                                  no_match)
            # Flag bookkeeping (semantic_dsp_map.h:842, :873-875): an
            # attempted row matches once; a below-threshold score retries.
            flags.index_copy_(0, rows[i:i + 1],
                              torch.where(attempted, score < thr, take(flags, rows[i]))[None])
            slots.append((aligned, best_ok & attempted & (score >= thr), row[3], row[4]))

        # 3 jittered GUESSED_BORN copies per template point
        # (semantic_dsp_map.h:878-891).
        sigma = constant(GUESSED_BIRTH_NOISE, torch.float32, dev)
        pos = torch.cat([
            torch.repeat_interleave(s[0], GUESSED_BIRTH_COPIES, dim=0)
            + draws[i * n_copies:(i + 1) * n_copies] * sigma
            for i, s in enumerate(slots)
        ])
        cand = _candidates(
            pos=pos,
            valid=torch.cat([torch.repeat_interleave(s[1], GUESSED_BIRTH_COPIES) for s in slots]),
            track=per_slot([s[2] for s in slots], n_copies),
            label=per_slot([s[3] for s in slots], n_copies),
            weight=PARTICLE_OCC_INIT_WEIGHT, gt=gt,
        )
        res = _insert_core(cfg, particles, scroll, cand, resample_targets=False,
                           max_target_blocks=TM_INSERT_BLOCKS)
        last["guessed_born"] = res.accepted_count
        return res.particles, dataclasses.replace(objects, to_match_templates=flags), res.block_overflow

    # The tensors of the last frame built (under capture: the graph's own,
    # which each replay rewrites in place); none born before the first.
    last: Dict[str, torch.Tensor] = {
        "guessed_born": torch.zeros((), dtype=torch.int64, device=dev)}

    def counts():
        """The tracer's template counters: each stage's running total of
        sweeps, the guessed particles of the last ``birth``'s insert and the
        running total of rematch slots whose match was good."""
        return {"rematch_sweeps": records["rematch"].count,
                "template_birth_sweeps": records["birth"].count,
                "guessed_born_count": last["guessed_born"],
                "rematch_matched": matched}

    return TemplateStages(gate=gate_fn, rematch=rematch, birth=birth, records=records,
                          counts=counts)


class TemplateEngine:
    """Template-bank holder behind ``SemanticDSPMap.set_template_path``;
    builds the stages on demand.  ``records`` are the sweep records
    (:class:`SweepRecord`, by stage) and ``counts`` the tracer's counts
    (``TemplateStages.counts``) of the stages built last."""

    def __init__(
        self,
        cfg: MapConfig,
        params: FilterParams,
        registry: LabelRegistry,
        bank: Optional[TemplateBank] = None,
        grid: Optional[MatchGridConfig] = None,
    ):
        self.cfg = cfg
        self.params = params
        self.registry = registry
        self.grid = grid or MatchGridConfig()
        self.bank = bank
        self.records: Optional[Dict[str, SweepRecord]] = None
        self.counts: Optional[Callable] = None

    def set_template_path(self, folder: str) -> int:
        """setTemplatePath (semantic_dsp_map.h:163-166)."""
        self.bank = TemplateBank.from_folder(folder, self.grid)
        return int(self.bank.label.size)

    def stages(self, device=None) -> TemplateStages:
        stages = build_template_stages(self.cfg, self.params, self.registry, self.grid, self.bank,
                                       device)
        self.records, self.counts = stages.records, stages.counts
        return stages
