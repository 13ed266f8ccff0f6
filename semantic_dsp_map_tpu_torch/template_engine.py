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

Which objects have work is read on the host once per frame, in template
mode only: the i32[O, 8] gate (``template_gate``).  A sweep runs only for
eligible rows, so a frame without one costs the gate and nothing else.
(The JAX package runs both stages as per-slot conditionals inside the
jitted step, because a device-to-host read cost ~25 ms over its TPU link.)

As in the JAX package, at most ``RM_MAX`` rematches and ``TB_MAX`` template
births run per frame, in ascending object row; eligibility beyond the cap
is deferred (the ``to_match_*`` flags stay set).  Guessed-birth jitter
comes from the map's ``torch.Generator`` unless the caller passes the
standard-normal draws.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .config import FilterParams, MapConfig, PARTICLE_OCC_INIT_WEIGHT
from .labels import LabelRegistry
from .ops import codecs
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
    template_match,
    template_match_bank,
)
from .state import STATUS_GUESSED_BORN, STATUS_INVALID, resolve_device

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
    big = torch.tensor(_BIG, dtype=torch.float32, device=fx.device)

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


def _top_rows(mask: np.ndarray, cap: int) -> np.ndarray:
    """The first ``cap`` True rows, in ascending object index (the
    reference's iteration order)."""
    return np.nonzero(mask)[0][:cap]


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


def _extract_track_points(n_max: int, cloud, tid: int):
    """Compact the valid labeled-cloud points of one track id (the
    reference takes every mask pixel, semantic_dsp_map.h:625-638; only
    valid points are kept here)."""
    m = ((cloud.track == tid) & cloud.valid).reshape(-1)
    return _compact_by_sort(
        m,
        cloud.pos[..., 0].reshape(-1),
        cloud.pos[..., 1].reshape(-1),
        cloud.pos[..., 2].reshape(-1),
        n_max,
    )


def _extract_particle_points(cfg: MapConfig, n_max: int, particles, scroll, tid: int,
                             weight_threshold: float):
    """getParticlesAsPointCloud (operations.h:242-255) for one track id:
    alive particles with weight > threshold, compacted from the block
    working set that holds them.  Returns (pts f32[n_max, 3], ok, count)."""
    K = cfg.slots_per_voxel
    V = cfg.num_voxels
    bv, nb, spb = block_layout(cfg)
    A = min(cfg.max_moving_blocks, nb)
    vox_axis = codecs.axis_stamps_per_voxel(cfg, scroll)
    alive = codecs.particle_alive(particles.status.view(V, K), particles.stamp.view(V, K), vox_axis)
    thr = torch.tensor(weight_threshold, dtype=torch.float32, device=vox_axis.device)
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
    big = torch.tensor(_BIG, dtype=torch.float32, device=ppts.device)
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


class TemplateSweep(NamedTuple):
    """One sweep a stage ran: its stage name, the object's gate row and the
    best score (a device tensor)."""

    stage: str
    gate_row: np.ndarray
    score: torch.Tensor


class TemplateStages(NamedTuple):
    """The stage closures built once per (config, params, bank, device)."""

    gate: object     # (objects, cloud) -> i32[O, 8] on the device
    rematch: object  # (particles, scroll, cloud, cam_pos, gate_np, gt) -> (particles, overflow)
    birth: object    # (particles, scroll, objects, cloud, cam_pos, gate_np, gt,
                     #  generator=None, draws=None) -> (particles, objects, overflow)


def build_template_stages(
    cfg: MapConfig,
    params: FilterParams,
    registry: LabelRegistry,
    grid: MatchGridConfig,
    bank: Optional[TemplateBank],
    device=None,
    record: Optional[Callable[[TemplateSweep], None]] = None,
) -> TemplateStages:
    """Build the per-frame template stages (see module docstring).  The
    stages take the gate as a host numpy array (``gate(...).cpu().numpy()``)
    and update the particle store in place; ``record`` receives every sweep
    they run."""
    car_label = registry.label_to_id.get("Car", -1)
    Pt = grid.max_template_points
    dev = resolve_device(device)
    thr = torch.tensor(params.match_score_threshold, dtype=torch.float32, device=dev)

    have_bank = False
    if bank is not None:
        tpls_np, tvalids_np = bank.of_label(car_label)
        have_bank = tpls_np.shape[0] > 0
    if have_bank:
        tpls = torch.from_numpy(tpls_np).to(dev)
        tvalids = torch.from_numpy(tvalids_np).to(dev)

    def gate_fn(objects, cloud):
        return template_gate(car_label, objects, cloud)

    def zero():
        return torch.zeros((), dtype=torch.int64, device=dev)

    # ------------------------------------------------------------------
    def rematch(particles, scroll, cloud, cam_pos, gate: np.ndarray, gt):
        outs = []
        for row in _top_rows(gate[:, 1] == 1, RM_MAX):
            if gate[row, 5] < REMATCH_MIN_POINTS:
                continue
            tid, label = int(gate[row, 3]), int(gate[row, 4])
            pts, ok = _extract_track_points(grid.max_source_points, cloud, tid)
            ppts, pok, pcount = _extract_particle_points(cfg, Pt, particles, scroll, tid, 0.1)
            res = template_match(grid, False, pts, ok, cam_pos, _masked_center(ppts, pok), pok)
            good = (res.score > thr) & (pcount > 0)
            outs.append((res.aligned, pok, good, tid, label))
            if record is not None:
                record(TemplateSweep("rematch", gate[row].copy(), res.score))
        if not outs:
            return particles, zero()

        # deleteParticlesInSet for matched objects (one masked pass).
        del_mask = torch.zeros_like(particles.status, dtype=torch.bool)
        for _aligned, _pok, good, tid, _label in outs:
            del_mask |= good & (particles.track == tid)
        particles.status.masked_fill_(del_mask, STATUS_INVALID)

        # One insert of every slot's aligned cloud.
        full = lambda v: torch.full((Pt,), v, dtype=torch.int32, device=dev)
        cand = _candidates(
            pos=torch.cat([o[0] for o in outs]),
            valid=torch.cat([o[1] & o[2] for o in outs]),
            track=torch.cat([full(o[3]) for o in outs]),
            label=torch.cat([full(o[4]) for o in outs]),
            weight=MATCHED_WEIGHT, gt=gt,
        )
        res = _insert_core(cfg, particles, scroll, cand, resample_targets=False,
                           max_target_blocks=TM_INSERT_BLOCKS)
        return res.particles, res.block_overflow

    # ------------------------------------------------------------------
    def birth(particles, scroll, objects, cloud, cam_pos, gate: np.ndarray, gt,
              generator: Optional[torch.Generator] = None, draws: Optional[torch.Tensor] = None):
        """``draws``: standard-normal f32[TB_MAX * Pt * 3, 3] (drawn from
        ``generator`` when None, only if a birth is attempted)."""
        if not have_bank:
            return particles, objects, zero()
        n_copies = Pt * GUESSED_BIRTH_COPIES
        min_mm = int(TM_MIN_BBOX_XY * 1000)
        outs = []
        flags = objects.to_match_templates
        for i, row in enumerate(_top_rows(gate[:, 2] == 1, TB_MAX)):
            if not (TM_MIN_POINTS < gate[row, 5] < TM_MAX_POINTS
                    and gate[row, 6] >= min_mm and gate[row, 7] >= min_mm):
                continue
            tid, label = int(gate[row, 3]), int(gate[row, 4])
            pts, ok = _extract_track_points(grid.max_source_points, cloud, tid)
            best_idx, score, aligned = template_match_bank(grid, True, pts, ok, cam_pos, tpls, tvalids)
            # Flag bookkeeping (semantic_dsp_map.h:842, :873-875): an
            # attempted row matches once; a below-threshold score retries.
            flags = flags.clone()
            flags[row] = score < thr
            outs.append((i, aligned, tvalids[best_idx] & (score >= thr), tid, label))
            if record is not None:
                record(TemplateSweep("birth", gate[row].copy(), score))
        if not outs:
            return particles, objects, zero()

        if draws is None:
            draws = torch.randn((TB_MAX * n_copies, 3), generator=generator, device=dev)
        sigma = torch.tensor(GUESSED_BIRTH_NOISE, dtype=torch.float32, device=dev)
        # 3 jittered GUESSED_BORN copies per template point
        # (semantic_dsp_map.h:878-891).
        pos = torch.cat([
            torch.repeat_interleave(o[1], GUESSED_BIRTH_COPIES, dim=0)
            + draws[o[0] * n_copies:(o[0] + 1) * n_copies] * sigma
            for o in outs
        ])
        full = lambda v: torch.full((n_copies,), v, dtype=torch.int32, device=dev)
        cand = _candidates(
            pos=pos,
            valid=torch.cat([torch.repeat_interleave(o[2], GUESSED_BIRTH_COPIES) for o in outs]),
            track=torch.cat([full(o[3]) for o in outs]),
            label=torch.cat([full(o[4]) for o in outs]),
            weight=PARTICLE_OCC_INIT_WEIGHT, gt=gt,
        )
        res = _insert_core(cfg, particles, scroll, cand, resample_targets=False,
                           max_target_blocks=TM_INSERT_BLOCKS)
        return res.particles, dataclasses.replace(objects, to_match_templates=flags), res.block_overflow

    return TemplateStages(gate=gate_fn, rematch=rematch, birth=birth)


class TemplateEngine:
    """Template-bank holder behind ``SemanticDSPMap.set_template_path``;
    builds the stages on demand.  ``sweeps`` keeps the last sweeps the
    stages ran and ``n_sweeps`` counts them all."""

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
        self.sweeps = collections.deque(maxlen=16)
        self.n_sweeps = 0

    def _record(self, sweep: TemplateSweep):
        self.sweeps.append(sweep)
        self.n_sweeps += 1

    def set_template_path(self, folder: str) -> int:
        """setTemplatePath (semantic_dsp_map.h:163-166)."""
        self.bank = TemplateBank.from_folder(folder, self.grid)
        return int(self.bank.label.size)

    def stages(self, device=None) -> TemplateStages:
        return build_template_stages(
            self.cfg, self.params, self.registry, self.grid, self.bank, device, self._record
        )
