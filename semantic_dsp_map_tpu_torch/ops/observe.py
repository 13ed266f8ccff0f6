"""The per-frame observation update: visibility + PHD + write-back
(counterpart of ``semantic_dsp_map_tpu/ops/observe.py``, plain path;
updateVisibleParitlcesWithBFS, operations.h:1297-1457, then
updateParticles, semantic_dsp_map.h:960-1121).

Active voxel blocks are row-gathered into a dense working set; one stable
sort by (pixel, camera depth) gives the compact entry array whose
front-most visible particles win the per-pixel table slots; occlusion and
far-free classification run on those entries; every state change is merged
into the working set and written back with row scatters (in place).

Reference semantics kept: stale-slot pruning on visit (operations.h:1374),
far-depth free-space weight reset (:1389-1395), one-sigma occlusion slack
(:1397-1400), voxel stamps incl. the empty-voxel corner rule (:1414-1431).
Capacity caps are all counted in :class:`ObserveDiag`.

The dense [V, K] candidate pass is ``front_candidates_plain`` here and the
CUDA kernel of ops/observe_cuda.py on a CUDA device when
``cfg.use_pallas_observe`` is set; ``movable_voxels_plain`` is the same
pair for the move's movable-voxel scan (map._move_and_cleanup).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import FilterParams, MapConfig, PARTICLE_OCC_INIT_WEIGHT
from ..state import Particles, STATUS_INVALID, STATUS_UPDATED, constant
from . import codecs
from .blocks import (
    ActiveBlocks,
    block_layout,
    gather_rows_flat,
    row_valid,
    scatter_rows_flat,
    segment_start_index,
    select_blocks,
    stable_lexsort,
)
from .geometry import project_to_image, project_to_image_xyz
from .phd import stencil_passes, table_from_entries
from .projection import LabeledCloud


class ObserveDiag(NamedTuple):
    visible_count: torch.Tensor    # particles in the pixel table domain
    block_overflow: torch.Tensor   # active blocks beyond capacity
    entry_overflow: torch.Tensor   # candidate entries beyond capacity
    table_dropped: torch.Tensor    # visible entries that lost slot competition
    corner_overflow: torch.Tensor  # empty-voxel blocks beyond capacity


def front_candidates_plain(cfg: MapConfig, px, py, pz, status, stamp, vox_axis, r_cw, t_cw):
    """Per voxel: (has_alive u8[V], has_cand u8[V]), whether any slot is
    alive, and whether any live slot projects into the image inside the
    depth range.  Flat [V*K] inputs; the oracle of
    ops.observe_cuda.front_candidates_cuda."""
    V = vox_axis.shape[0]
    K = px.shape[0] // V
    alive = codecs.particle_alive(status.view(V, K), stamp.view(V, K), vox_axis)
    _, _, _, ok = project_to_image_xyz(cfg, r_cw, t_cw, px.view(V, K), py.view(V, K), pz.view(V, K))
    return alive.any(dim=1).to(torch.uint8), (ok & alive).any(dim=1).to(torch.uint8)


def movable_voxels_plain(cfg: MapConfig, track, status, stamp, vox_axis, max_movable: int):
    """Per voxel: any(alive & 0 <= track <= max_movable) as u8[V]; the
    oracle of ops.observe_cuda.movable_voxels_cuda."""
    V = vox_axis.shape[0]
    K = track.shape[0] // V
    alive = codecs.particle_alive(status.view(V, K), stamp.view(V, K), vox_axis)
    trk = track.view(V, K)
    return (alive & (trk >= 0) & (trk <= max_movable)).any(dim=1).to(torch.uint8)


def use_observe_kernels(cfg: MapConfig, t: torch.Tensor) -> bool:
    """The observe/movable scans run as CUDA kernels when the flag is set
    and the store is on a CUDA device; otherwise as the plain scans."""
    return cfg.use_pallas_observe and t.is_cuda


class WorkingSet(NamedTuple):
    """The active blocks' slots as [A, spb] rows (stale slots pruned to
    INVALID in ``status``), and whether each slot is a candidate: alive and
    projecting into the image within the depth range, at (row, col, camz)."""

    blocks: ActiveBlocks
    has_alive: torch.Tensor  # bool[V]: the voxel holds a live slot
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    weight: torch.Tensor
    status: torch.Tensor     # i32
    stamp: torch.Tensor
    forget: torch.Tensor     # i32
    track: torch.Tensor
    cand: torch.Tensor       # bool
    row: torch.Tensor
    col: torch.Tensor
    camz: torch.Tensor


def gather_working_set(cfg: MapConfig, flat: Particles, vox_axis, r_cw, t_cw,
                       capacity: int) -> WorkingSet:
    """The dense [V, K] candidate pass over the store (``vox_axis`` gives V:
    the whole grid or a rank's z-slab), then the row gather of up to
    ``capacity`` blocks that hold a candidate."""
    K = cfg.slots_per_voxel
    bv, _nb, spb = block_layout(cfg)
    front = front_candidates_plain
    if use_observe_kernels(cfg, flat.px):
        from .observe_cuda import front_candidates_cuda as front
    ha, hc = front(cfg, flat.px, flat.py, flat.pz, flat.status, flat.stamp, vox_axis, r_cw, t_cw)
    blocks = select_blocks((hc.view(-1, bv) != 0).any(dim=1), capacity)
    del hc
    rv = row_valid(blocks)

    g = lambda f: gather_rows_flat(f, blocks, spb)
    bpx, bpy, bpz = g(flat.px), g(flat.py), g(flat.pz)
    bst = g(flat.status).to(torch.int32)
    bstamp = g(flat.stamp)
    baxis = torch.repeat_interleave(gather_rows_flat(vox_axis, blocks, bv), K, dim=1)
    not_invalid = bst != STATUS_INVALID
    fresh = bstamp >= baxis
    balive = not_invalid & fresh & rv[:, None]
    # Stale-slot pruning on visit (operations.h:1374-1377).
    bst = torch.where(not_invalid & ~fresh & rv[:, None], STATUS_INVALID, bst)
    brow, bcol, bcamz, bok = project_to_image_xyz(cfg, r_cw, t_cw, bpx, bpy, bpz)
    return WorkingSet(
        blocks=blocks, has_alive=ha != 0, px=bpx, py=bpy, pz=bpz, weight=g(flat.weight),
        status=bst, stamp=bstamp, forget=g(flat.forget).to(torch.int32), track=g(flat.track),
        cand=bok & balive, row=brow, col=bcol, camz=bcamz,
    )


def classify_entries(cfg: MapConfig, depth, pix, camz, real):
    """(far_free, visible) of entries at pixel ``pix`` (flat, < H*W where
    ``real``) and camera depth ``camz`` against the depth image: far-depth
    free space (operations.h:1389-1395), else visible unless behind the
    measured surface by more than the one-sigma slack (:1397-1400)."""
    HW = depth.numel()
    depth_at = depth.reshape(-1)[torch.clamp(pix, max=HW - 1)]
    one_sigma = 1.0 + cfg.depth_error_stddev_at_one_meter
    far_free = real & (depth_at > cfg.depth_range_max)
    occluded = real & ~far_free & (camz > depth_at * one_sigma)
    return far_free, real & ~far_free & ~occluded


def write_back(cfg: MapConfig, flat: Particles, voxel_stamp, ws: WorkingSet, weight, touched,
               updated, forget, observed, global_time):
    """Merge the frame's results into the working set and write its rows
    back IN PLACE: the new ``weight`` where ``touched``; UPDATED status, the
    frame's stamp and the new ``forget`` where ``updated``; the frame's stamp
    on the voxels with an ``observed`` slot.  All [A, spb]."""
    K = cfg.slots_per_voxel
    bv, _nb, spb = block_layout(cfg)
    blocks = ws.blocks
    scatter_rows_flat(flat.weight, blocks, spb, torch.where(touched, weight, ws.weight))
    scatter_rows_flat(flat.status, blocks, spb, torch.where(updated, STATUS_UPDATED, ws.status))
    scatter_rows_flat(flat.stamp, blocks, spb, torch.where(updated, global_time, ws.stamp))
    scatter_rows_flat(flat.forget, blocks, spb, torch.where(updated, forget, ws.forget))

    # Voxel observation stamps from particle evidence.
    obs_vox = observed.view(-1, bv, K).any(dim=2)
    bvst = gather_rows_flat(voxel_stamp, blocks, bv)
    bvst = torch.where(obs_vox & row_valid(blocks)[:, None], global_time, bvst)
    scatter_rows_flat(voxel_stamp, blocks, bv, bvst)


def observe_and_update(
    cfg: MapConfig,
    params: FilterParams,
    particles: Particles,
    scroll,
    voxel_stamp: torch.Tensor,
    cloud: LabeledCloud,
    depth: torch.Tensor,
    r_cw: torch.Tensor,
    t_cw: torch.Tensor,
    global_time,
):
    """Returns (particles, voxel_stamp, ObserveDiag); ``particles`` and
    ``voxel_stamp`` are updated in place."""
    H, W, S = cfg.height, cfg.width, cfg.phd_pixel_table_slots
    HW = H * W
    bv, nb, spb = block_layout(cfg)
    A = min(cfg.max_active_blocks, nb)
    C = min(cfg.max_table_entries, A * spb)
    flat = particles
    dev = depth.device

    # ---- dense [V, K] pass and the active-block working set ----
    vox_axis = codecs.axis_stamps_per_voxel(cfg, scroll)
    ws = gather_working_set(cfg, flat, vox_axis, r_cw, t_cw, A)
    bcand = ws.cand
    pix = torch.where(bcand, ws.row * W + ws.col, HW).reshape(-1)
    meta = ((ws.track << 8) | (ws.forget & 0xFF)).reshape(-1)

    # ---- one stable sort by (pixel, camera depth) ----
    order = stable_lexsort(pix, ws.camz.reshape(-1))[:C]
    pix_s = pix[order]
    camz_s = ws.camz.reshape(-1)[order]
    px_s, py_s, pz_s = (a.reshape(-1)[order] for a in (ws.px, ws.py, ws.pz))
    w_s = ws.weight.reshape(-1)[order]
    meta_s = meta[order]
    src_s = order

    entry_overflow = torch.clamp(bcand.sum() - C, min=0)

    # ---- classification on the compact entries ----
    real = pix_s < HW
    far_free, visible = classify_entries(cfg, depth, pix_s, camz_s, real)

    # ---- rank among visible entries of the same pixel (front-most first) ----
    is_start = torch.ones_like(real)
    is_start[1:] = pix_s[1:] != pix_s[:-1]
    cs = torch.cumsum(visible.to(torch.int64), 0)
    start = segment_start_index(is_start)
    vrank = cs - (cs[start] - visible[start].to(torch.int64)) - 1
    keep = visible & (vrank < S)

    # ---- PHD stencil over the dense pixel table ----
    table = table_from_entries(
        cfg, torch.where(visible, pix_s, HW), vrank, keep,
        px_s, py_s, pz_s, w_s, meta_s >> 8, meta_s & 0xFF,
    )
    _ck, new_w_t, new_f_t = stencil_passes(cfg, params, table, cloud)

    dest = torch.where(keep, torch.clamp(vrank, max=S - 1) * HW + pix_s, 0)
    nw_e = new_w_t.reshape(-1)[dest]
    nf_e = new_f_t.reshape(-1)[dest].to(torch.int32)

    # ---- per-entry results, unsorted back into the working set ----
    init_w = constant(PARTICLE_OCC_INIT_WEIGHT, torch.float32, dev)
    w_out = torch.where(keep, nw_e, torch.where(far_free, init_w, w_s))
    touched_w = keep | far_free
    observed = visible | far_free
    meta_out = (
        (torch.where(keep, nf_e, 0) & 0xFF)
        | (keep.to(torch.int32) << 8)
        | (touched_w.to(torch.int32) << 9)
        | (observed.to(torch.int32) << 10)
    )
    n_work = A * spb
    back_idx = torch.where(real, src_s, n_work)
    w_back = torch.zeros(n_work + 1, dtype=torch.float32, device=dev)
    w_back.index_copy_(0, back_idx, w_out)
    m_back = torch.zeros(n_work + 1, dtype=torch.int32, device=dev)
    m_back.index_copy_(0, back_idx, meta_out)
    w_back = w_back[:n_work].view(A, spb)
    m_back = m_back[:n_work].view(A, spb)

    # ---- write back particle rows and voxel stamps (in place) ----
    write_back(cfg, flat, voxel_stamp, ws, w_back, ((m_back >> 9) & 1) == 1,
               ((m_back >> 8) & 1) == 1, m_back & 0xFF, ((m_back >> 10) & 1) == 1, global_time)

    # ---- empty-voxel stamps (imaginary center particle rule) ----
    voxel_stamp, corner_overflow = refresh_empty_voxel_stamps(
        cfg, scroll, voxel_stamp, ws.has_alive, depth, r_cw, t_cw, global_time,
        vox_axis=vox_axis,
    )

    diag = ObserveDiag(
        visible_count=visible.sum(),
        block_overflow=ws.blocks.overflow,
        entry_overflow=entry_overflow,
        table_dropped=table.dropped,
        corner_overflow=corner_overflow,
    )
    return flat, voxel_stamp, diag


def refresh_empty_voxel_stamps(
    cfg: MapConfig,
    scroll,
    voxel_stamp: torch.Tensor,
    has_alive: torch.Tensor,
    depth: torch.Tensor,
    r_cw: torch.Tensor,
    t_cw: torch.Tensor,
    global_time,
    vox_axis=None,
    vox_base: int = 0,
):
    """Stamp voxels with no live particle whose corner point projects in
    front of the measured surface (operations.h:1414-1431), skipping voxels
    whose stamp is already valid (render-equivalent; the JAX package and
    its oracle apply the same rule).  Updates ``voxel_stamp`` in place;
    returns (voxel_stamp, corner_overflow).

    Sizes come from ``voxel_stamp``; ``vox_base`` is the global id of its
    first voxel (a rank's z-slab under voxel-slab sharding,
    parallel/shard_step.py)."""
    V = voxel_stamp.shape[0]
    H, W = cfg.height, cfg.width
    bs = min(512, V)
    nb2 = V // bs
    A2 = min(cfg.corner_gather_blocks, nb2)

    corner = codecs.voxel_to_global_pos(
        cfg, scroll,
        torch.arange(vox_base, vox_base + V, dtype=torch.int32, device=voxel_stamp.device),
    )
    crow, ccol, cz, cok = project_to_image(cfg, r_cw, t_cw, corner)
    need = ~has_alive & cok
    if vox_axis is not None:
        need = need & ~codecs.voxel_valid(voxel_stamp, vox_axis)

    blocks = select_blocks(need.view(nb2, bs).any(dim=1), A2)
    rv = row_valid(blocks)
    bneed = gather_rows_flat(need, blocks, bs) & rv[:, None]
    brow = gather_rows_flat(crow, blocks, bs)
    bcol = gather_rows_flat(ccol, blocks, bs)
    bcz = gather_rows_flat(cz, blocks, bs)

    pixd = torch.clamp(brow, 0, H - 1) * W + torch.clamp(bcol, 0, W - 1)
    depth_at = depth.reshape(-1)[pixd.reshape(-1)].view(A2, bs)
    observed = bneed & (bcz <= depth_at)

    bvst = gather_rows_flat(voxel_stamp, blocks, bs)
    bvst = torch.where(observed, global_time, bvst)
    scatter_rows_flat(voxel_stamp, blocks, bs, bvst)
    return voxel_stamp, blocks.overflow
