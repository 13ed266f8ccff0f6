"""Particle birth, slot-constrained insertion and per-voxel resampling
(counterpart of ``semantic_dsp_map_tpu/ops/birth.py``;
semantic_dsp_map.h:1148-1230, 1448-1519; operations.h:782-803).

The reference's serial insert-into-first-vacant-slot loop becomes:
resample every voxel targeted by a candidate this frame (the decision only
involves UPDATED particles, so it can run first), then rank the candidates
per voxel by the reference's sweep order and place the top ones into the
voxel's vacant slots in first-vacant order.  Stale slots count as vacant.
The same insertion core serves newborn and rigid-moved particles.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import FilterParams, MapConfig, PARTICLE_OCC_INIT_WEIGHT
from ..state import (
    Particles,
    ScrollState,
    STATUS_INVALID,
    STATUS_REGULAR_BORN,
    STATUS_UPDATED,
)
from . import codecs
from .blocks import (
    ActiveBlocks,
    block_layout,
    gather_rows_flat,
    group_rank,
    scatter_rows_flat,
    stable_lexsort,
)
from .projection import LabeledCloud


class Candidates(NamedTuple):
    """A batch of particles to insert (padding rows have valid=False)."""

    pos: torch.Tensor       # f32[N, 3] global frame
    weight: torch.Tensor    # f32[N]
    label: torch.Tensor     # i32[N]
    track: torch.Tensor     # i32[N]
    status: torch.Tensor    # i32[N]
    stamp: torch.Tensor     # i32[N]
    forget: torch.Tensor    # i32[N]
    priority: torch.Tensor  # i32[N] smaller = inserted earlier
    valid: torch.Tensor     # bool[N]


def resample_slots(cfg: MapConfig, status, weight, target):
    """resampleParticlesInVoxel (semantic_dsp_map.h:1448-1519) on [..., K]
    slots with a target mask [...].  Only UPDATED particles take part; a
    voxel resamples iff more than 2^n >> 1 of them are UPDATED: wiped if
    their weight sum < 0.01, else the serial keep/delete walk with
    threshold steps of weight_sum/trigger, in f32 and in slot order."""
    K = cfg.slots_per_voxel
    trigger = (1 << cfg.max_particle_num_per_voxel_n) >> 1

    updated = status == STATUS_UPDATED
    wsum = torch.zeros(status.shape[:-1], dtype=torch.float32, device=status.device)
    for k in range(K):
        wsum = wsum + torch.where(updated[..., k], weight[..., k], 0.0)
    count = updated.sum(dim=-1)

    do_resample = target & (count > trigger)
    wipe = do_resample & (wsum < 0.01)
    walk = do_resample & ~wipe
    wpp = torch.clamp(wsum / trigger, max=1.0)

    new_status, new_weight = [], []
    csum = torch.zeros_like(wsum)
    thresh = wpp
    for k in range(K):
        upd_k = updated[..., k]
        w_k = weight[..., k]
        csum_k = csum + torch.where(upd_k, w_k, 0.0)
        delete = csum_k < thresh
        # The threshold advances by repeated f32 additions of wpp until it
        # is >= csum (semantic_dsp_map.h:1505-1510).
        thresh_kept = thresh + wpp
        for _ in range(K + 8):
            thresh_kept = torch.where(csum_k > thresh_kept, thresh_kept + wpp, thresh_kept)
        active = walk & upd_k
        new_status.append(
            torch.where((wipe & upd_k) | (active & delete), STATUS_INVALID, status[..., k])
        )
        new_weight.append(torch.where(active & ~delete, wpp, w_k))
        csum = torch.where(walk & upd_k, csum_k, csum)
        thresh = torch.where(active & ~delete, thresh_kept, thresh)

    return torch.stack(new_status, dim=-1), torch.stack(new_weight, dim=-1)


class InsertResult(NamedTuple):
    particles: Particles
    accepted_count: torch.Tensor   # scalar
    block_overflow: torch.Tensor   # scalar
    #: bool[A, bv, K]: which staged candidates were accepted; None unless
    #: ``need_src``
    accepted_staged: Optional[torch.Tensor] = None
    #: i32[A, bv, K]: each staged candidate's index in the batch, N where
    #: nothing is staged; None unless ``need_src``
    staged_src: Optional[torch.Tensor] = None


class Staged(NamedTuple):
    """The first K candidates of each voxel of the target blocks, staged at
    (block row, voxel within the block, rank); each ``[A, bv, K]``.  A slot
    without a candidate holds ``meta`` -1 and zeros."""

    px: torch.Tensor     # f32
    py: torch.Tensor     # f32
    pz: torch.Tensor     # f32
    w: torch.Tensor      # f32
    stamp: torch.Tensor  # i32
    meta: torch.Tensor   # i32: forget << 27 | status << 24 | label << 16 | track


def _insert_core(
    cfg: MapConfig,
    particles: Particles,
    scroll: ScrollState,
    cand: Candidates,
    resample_targets: bool,
    uniform_weight: Optional[float] = None,
    uniform_stamp=None,
    max_target_blocks: Optional[int] = None,
    vox: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
    vox_axis: Optional[torch.Tensor] = None,
    need_src: bool = False,
) -> InsertResult:
    """Sort candidates by (voxel, priority), stage the first K per voxel
    into the target blocks, optionally resample the targeted voxels, merge
    staged candidates into first-vacant slots and write the rows back IN
    PLACE into ``particles``.

    Works on a voxel slab as on the whole grid: sizes come from the particle
    store, and a caller may pass each candidate's voxel id (``vox``, with
    ``valid``) and the store's per-voxel scroll stamps (``vox_axis``) in
    slab-local ids (parallel/shard_step.py does); left None they are
    derived from ``scroll`` for the whole grid.  With ``need_src`` the
    result also says which staged candidate was accepted and where each
    came from (the frame's callers do not ask)."""
    K = cfg.slots_per_voxel
    V = particles.px.shape[0] // K
    bv, _nb_full, spb = block_layout(cfg)
    nb = V // bv
    A = min(max_target_blocks or cfg.max_birth_blocks, nb)
    bv_n = bv.bit_length() - 1
    dev = cand.pos.device
    flat = particles

    if vox is None:
        vox, _, _, _, in_map = codecs.global_pos_to_voxel(cfg, scroll, cand.pos)
        valid = cand.valid & in_map
    if vox_axis is None:
        vox_axis = codecs.axis_stamps_per_voxel(cfg, scroll)
    vox = torch.where(valid, vox, V).to(torch.int64)

    meta = (
        (torch.clamp(cand.forget.to(torch.int32), 0, 7) << 27)
        | (torch.clamp(cand.status.to(torch.int32), 0, 7) << 24)
        | ((cand.label.to(torch.int32) & 0xFF) << 16)
        | (cand.track.to(torch.int32) & 0xFFFF)
    )

    order = stable_lexsort(vox, cand.priority)
    sv = vox[order]
    spx, spy, spz = (cand.pos[:, i][order] for i in range(3))
    smeta = meta[order]
    rank = group_rank(sv)
    stage_ok = (sv < V) & (rank < K)

    # Active target blocks, listed from the sorted stream (ascending, unique).
    sblock = sv >> bv_n
    new_block = torch.ones_like(stage_ok)
    new_block[1:] = sblock[1:] != sblock[:-1]
    new_block &= sv < V
    block_rank = torch.cumsum(new_block.to(torch.int64), 0) - 1
    n_blocks = torch.clamp(block_rank[-1] + 1, min=0)
    ids = torch.cat([nb + torch.arange(A, device=dev), torch.zeros(1, dtype=torch.int64, device=dev)])
    ids.index_copy_(
        0,
        torch.where(new_block & (block_rank < A), block_rank, A),
        torch.clamp(sblock, max=nb - 1),
    )
    blocks = ActiveBlocks(
        ids=ids[:A],
        count=torch.clamp(n_blocks, max=A),
        overflow=torch.clamp(n_blocks - A, min=0),
    )

    # Stage the first K candidates of each voxel at
    # (block_rank, voxel-within-block, rank).
    dest_ok = stage_ok & (block_rank < A)
    dest = torch.where(dest_ok, block_rank * spb + (sv & (bv - 1)) * K + rank, A * spb)

    def stage(fill, vals, dtype):
        buf = torch.full((A * spb + 1,), fill, dtype=dtype, device=dev)
        buf.index_copy_(0, dest, vals.to(dtype))
        return buf[: A * spb].view(A, bv, K)

    in_px = stage(0.0, spx, torch.float32)
    in_py = stage(0.0, spy, torch.float32)
    in_pz = stage(0.0, spz, torch.float32)
    in_meta = stage(-1, smeta, torch.int32)
    occupied_stage = in_meta >= 0
    if uniform_weight is None:
        in_w = stage(0.0, cand.weight[order], torch.float32)
    else:
        in_w = torch.where(occupied_stage, uniform_weight, 0.0).to(torch.float32)
    if uniform_stamp is None:
        in_stamp = stage(0, cand.stamp[order], torch.int32)
    else:
        in_stamp = torch.where(occupied_stage, uniform_stamp, 0).to(torch.int32)

    staged = Staged(in_px, in_py, in_pz, in_w, in_stamp, in_meta)
    if not need_src:
        flat, accepted_count = merge_blocks(cfg, flat, blocks, vox_axis, staged, resample_targets)
        return InsertResult(flat, accepted_count, blocks.overflow)
    staged_src = stage(cand.pos.shape[0], order, torch.int32)
    flat, accepted_count, accepted_staged = merge_blocks(
        cfg, flat, blocks, vox_axis, staged, resample_targets, want_accepted=True)
    return InsertResult(flat, accepted_count, blocks.overflow, accepted_staged, staged_src)


def merge_blocks(cfg: MapConfig, flat: Particles, blocks: ActiveBlocks, vox_axis: torch.Tensor,
                 staged: Staged, resample_targets: bool, want_accepted: bool = False):
    """The merge stage of ``_insert_core``: ``merge_blocks_plain``."""
    return merge_blocks_plain(cfg, flat, blocks, vox_axis, staged, resample_targets,
                              want_accepted)


def merge_blocks_plain(cfg: MapConfig, flat: Particles, blocks: ActiveBlocks,
                       vox_axis: torch.Tensor, staged: Staged, resample_targets: bool,
                       want_accepted: bool = False):
    """Gather the target blocks' rows of ``flat``, prune their stale slots,
    optionally resample the voxels with a staged candidate, merge the
    staged candidates into first-vacant slots and write the rows back IN
    PLACE.  Returns (flat, accepted count as a 0-d int64 tensor), and with
    ``want_accepted`` also which staged candidates were accepted (bool
    ``[A, bv, K]``).  The oracle of ops.birth_cuda.merge_blocks_cuda."""
    K = cfg.slots_per_voxel
    A = blocks.ids.shape[0]
    bv, _nb_full, spb = block_layout(cfg)
    in_px, in_py, in_pz, in_w, in_stamp, in_meta = staged
    occupied_stage = in_meta >= 0

    # ---- working set of the target blocks ----
    g = lambda f: gather_rows_flat(f, blocks, spb).view(A, bv, K)
    bpx, bpy, bpz = g(flat.px), g(flat.py), g(flat.pz)
    bw = g(flat.weight)
    blab = g(flat.label).to(torch.int32)
    btrk = g(flat.track)
    bst = g(flat.status).to(torch.int32)
    bstamp = g(flat.stamp)
    bfg = g(flat.forget).to(torch.int32)
    baxis = gather_rows_flat(vox_axis, blocks, bv)[:, :, None]

    # Stale slots count as vacant and are pruned (operations.h:810-816).
    stale = (bst != STATUS_INVALID) & (bstamp < baxis)
    bst = torch.where(stale, STATUS_INVALID, bst)

    if resample_targets:
        bst, bw = resample_slots(cfg, bst, bw, occupied_stage.any(dim=2))

    # ---- first-vacant merge: the vacant slot with vacant-rank c takes the
    # voxel's staged candidate c ----
    vac = bst == STATUS_INVALID
    run = torch.cumsum(vac.to(torch.int32), dim=2)
    c = torch.clamp(run - 1, min=0).long()
    pick = lambda x: torch.gather(x, 2, c)
    m_meta = pick(in_meta)
    took = vac & (m_meta >= 0)

    n_px = torch.where(took, pick(in_px), bpx)
    n_py = torch.where(took, pick(in_py), bpy)
    n_pz = torch.where(took, pick(in_pz), bpz)
    n_w = torch.where(took, pick(in_w), bw)
    n_stamp = torch.where(took, pick(in_stamp), bstamp)
    n_trk = torch.where(took, m_meta & 0xFFFF, btrk)
    n_lab = torch.where(took, (m_meta >> 16) & 0xFF, blab)
    n_st = torch.where(took, (m_meta >> 24) & 0x7, bst)
    n_fg = torch.where(took, (m_meta >> 27) & 0x7, bfg)

    for field, vals in (
        (flat.px, n_px), (flat.py, n_py), (flat.pz, n_pz), (flat.weight, n_w),
        (flat.label, n_lab), (flat.track, n_trk), (flat.status, n_st),
        (flat.stamp, n_stamp), (flat.forget, n_fg),
    ):
        scatter_rows_flat(field, blocks, spb, vals)

    # Staged candidate r is accepted iff r < the voxel's vacancy count.
    lane = torch.arange(K, device=in_meta.device)
    accepted = occupied_stage & (lane < run[:, :, K - 1 :])
    if want_accepted:
        return flat, accepted.sum(), accepted
    return flat, accepted.sum()


def insert_with_resample(
    cfg: MapConfig,
    particles: Particles,
    scroll: ScrollState,
    cand: Candidates,
    uniform_weight=None,
    uniform_stamp=None,
):
    """Resample targeted voxels, then insert; returns (particles,
    accepted_count, block_overflow)."""
    res = _insert_core(
        cfg, particles, scroll, cand, resample_targets=True,
        uniform_weight=uniform_weight, uniform_stamp=uniform_stamp,
    )
    return res.particles, res.accepted_count, res.block_overflow


def newborn_candidates(
    cfg: MapConfig,
    params: FilterParams,
    cloud: LabeledCloud,
    global_time,
    generator: torch.Generator,
    first_row: int = 0,
) -> Candidates:
    """One candidate per valid pixel, or nb_ptc_num_per_point jittered
    copies with depth noise (semantic_dsp_map.h:1148-1230).  Priority
    encodes the reference's 3x3-interleaved sweep order (:777-800).  The
    cloud may be a slab of image rows starting at ``first_row`` (a rank's
    row slab, parallel/shard_step.py): priorities stay the whole image's."""
    H, W = cfg.height, cfg.width
    h = cloud.pos.shape[0]
    dev = cloud.pos.device
    nb = params.nb_ptc_num_per_point if params.if_consider_depth_noise else 1

    rows = torch.arange(first_row, first_row + h, dtype=torch.int32, device=dev)[:, None]
    cols = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    pri = (((rows % 3) * 3 + cols % 3) * H + rows) * W + cols

    pos = cloud.pos.reshape(-1, 3)
    valid = cloud.valid.reshape(-1)
    label = cloud.label.reshape(-1)
    track = cloud.track.reshape(-1)
    sigma = cloud.sigma.reshape(-1)
    pri = pri.reshape(-1)

    if nb > 1:
        rep = lambda a: torch.repeat_interleave(a, nb, dim=0)
        pos, valid, label, track, sigma = map(rep, (pos, valid, label, track, sigma))
        pri = rep(pri) * nb + torch.arange(nb, dtype=torch.int32, device=dev).repeat(h * W)
        noise = torch.randn(pos.shape, generator=generator, device=dev) * sigma[:, None]
        pos = pos + noise
    elif params.if_consider_depth_noise:
        pri = pri * nb

    n = pos.shape[0]
    full = lambda v, dtype: torch.full((n,), v, dtype=dtype, device=dev)
    return Candidates(
        pos=pos,
        weight=full(PARTICLE_OCC_INIT_WEIGHT, torch.float32),
        label=label,
        track=track,
        status=full(STATUS_REGULAR_BORN, torch.int32),
        stamp=global_time.expand(n),
        forget=full(0, torch.int32),
        priority=pri,
        valid=valid,
    )


def birth_and_resample(
    cfg: MapConfig,
    params: FilterParams,
    particles: Particles,
    scroll: ScrollState,
    cloud: LabeledCloud,
    global_time,
    generator: torch.Generator,
):
    """Resample birth-target voxels, then insert newborn particles.
    Returns (particles, born_count, block_overflow, candidates)."""
    cand = newborn_candidates(cfg, params, cloud, global_time, generator)
    particles, born, overflow = insert_with_resample(
        cfg, particles, scroll, cand,
        uniform_weight=PARTICLE_OCC_INIT_WEIGHT,
        uniform_stamp=global_time,
    )
    return particles, born, overflow, cand
