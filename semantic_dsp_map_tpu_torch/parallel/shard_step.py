"""The sharded frame step on ``torch.distributed`` (counterpart of
``semantic_dsp_map_tpu/parallel/shard_step.py``).

Both big domains of a frame are split over the D ranks of a process group:

  * the voxel grid, as z-slabs: the flat voxel index is z-major
    (codecs.ring_to_voxel), so rank d owns voxels ``[d*V/D, (d+1)*V/D)`` and
    their ``V/D*K`` particle slots.  Particle state, visibility masks, block
    working sets, insertion, resampling and the render are voxel-local;
  * the image, as row slabs: rank d owns rows ``[d*rpd, (d+1)*rpd)``,
    ``rpd = ceil(H/D)``, of the labeled cloud, the pixel table and both PHD
    stencils, with an R-row halo on each side (R = the stencil half-width).

They are coupled by fixed-capacity routes, one ``all_to_all_single`` each:

  observe   visible working-set entries go to the rank that owns their
            pixel row, are ranked into its table slab, stencilled there, and
            their new weight and forget counter come back (two routes);
  birth     newborn candidates of a rank's row slab go to the rank that owns
            their voxel, which inserts them with resampling (one route);
  move      rigidly moved particles go to the rank that owns their new voxel
            (one route);
  objects   the object table is tiny and replicated: every rank runs the same
            object-level update on the same draws, with no communication.

Between the two stencil passes the ranks send each other the edge rows of
their table slab and of pass A's output (``_exchange_table_halo``,
``_exchange_ck_halo``), and the nine counters are summed in one
``all_reduce``.  Every route bucket has a fixed capacity (``shard_caps``);
what does not fit is counted in the StepDiagnostics overflow counters, never
dropped silently.

Tie order: a rank's table stream is ranked by the same stable (pixel, camera
depth) sort as the single-device step, but its input arrives in (source
rank, send slot) order instead of working-set order, so two entries of one
pixel with bit-equal camera depth may swap table slots; all sums downstream
are order-independent, so results can differ only where such a tie straddles
the rank-S cutoff.  At D = 1 the two orders are the same.

The step is built in parts (:func:`build_shard_stages`, a ``map.FrameStages``
whose object layer is the single-device one) and run, as the JAX package
jits its ``shard_map`` step, on ``step_graph.StaticStep``: on the card the
frame is CUDA graphs from the second frame on, the collectives recorded
with the rest (:func:`build_shard_step`); the eager composition of the same
parts (:func:`build_shard_step_eager`) is its oracle, bit for bit.  The
card runs one rank (NCCL takes one rank a card): there the routes go to the
rank itself and the halos send nothing; the routes and halos at D > 1 are
held on the CPU (gloo), where nothing is captured.

What the JAX step does not do is not done here either: there is no template
stage (``_move_sharded`` only holds back objects flagged for re-matching,
as the single-device step does) and the render is the occupancy render of
``ops.render.render_any`` (the neighbour-smoothed one is single-device only).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..config import FilterParams, KEYPOINTS_BBOX3D, MapConfig, PARTICLE_OCC_INIT_WEIGHT
from ..frontend import FrameInput, static_label_table
from ..labels import LabelRegistry
from ..map import (
    FrameStages, StepDiagnostics, build_frame_stages, rigid_move, unpack_frame, unpack_objects,
)
from ..objects import expire_objects
from ..ops import codecs
from ..ops.birth import Candidates, _insert_core, newborn_candidates
from ..ops.blocks import (
    block_layout,
    gather_rows_flat,
    group_rank,
    row_valid,
    scatter_rows_flat,
    select_blocks,
    stable_lexsort,
)
from ..ops.geometry import camera_matrices
from ..ops.observe import (
    classify_entries,
    gather_working_set,
    movable_voxels_plain,
    refresh_empty_voxel_stamps,
    use_observe_kernels,
    write_back,
)
from ..ops.phd import PixelTable, stencil_pass_a_any, stencil_pass_b_any, table_from_entries
from ..ops.projection import LabeledCloud, generate_labeled_cloud
from ..ops.render import render_any
from ..state import MapState, STATUS_INVALID, STATUS_REGULAR_BORN, constant
from ..step_graph import StaticStep


# ---------------------------------------------------------------------------
# Fixed-capacity bucket routing (one all_to_all_single per route)
# ---------------------------------------------------------------------------


class Routed(NamedTuple):
    fields: dict               # each [D*cap] received values
    recv_valid: torch.Tensor   # bool[D*cap]
    send_slot: torch.Tensor    # i64[N] send-buffer slot of each entry (-1 dropped)
    overflow: torch.Tensor     # i64 entries beyond their bucket's capacity


def _pack_i32(fields: dict, names) -> torch.Tensor:
    """Stack 32-bit fields into one [N, F] i32 matrix (f32 by bit view)."""
    return torch.stack(
        [fields[k].view(torch.int32) if fields[k].dtype == torch.float32
         else fields[k].to(torch.int32) for k in names],
        dim=1,
    )


def _unpack_i32(mat: torch.Tensor, names, dtypes) -> dict:
    out = {}
    for j, k in enumerate(names):
        v = mat[:, j].contiguous()
        out[k] = v.view(torch.float32) if dtypes[k] == torch.float32 else v
    return out


def _route(fields: dict, valid, dest, D: int, cap: int, group=None) -> Routed:
    """Bin entries into D buckets of ``cap`` by ``dest`` and exchange them.

    An entry with ``valid`` False or ``dest`` outside [0, D) is dropped.
    Within a bucket, entries keep their original order (a stable sort on
    dest); past ``cap`` they are counted in ``overflow``.  All fields ride
    one collective as an i32 matrix, with a last column that marks the
    filled rows."""
    N = dest.shape[0]
    dev = dest.device
    dkey = torch.where(valid & (dest >= 0) & (dest < D), dest, D).to(torch.int64)
    s_dest, s_idx = torch.sort(dkey, stable=True)
    # Rank within a bucket: position less the bucket's start (D+1 buckets).
    counts = torch.zeros(D + 1, dtype=torch.int64, device=dev).index_add_(
        0, dkey, torch.ones_like(dkey))
    rank_sorted = torch.arange(N, device=dev) - (torch.cumsum(counts, 0) - counts)[s_dest]
    ok = (s_dest < D) & (rank_sorted < cap)
    slot_sorted = torch.where(ok, s_dest * cap + rank_sorted, -1)
    send_slot = torch.empty(N, dtype=torch.int64, device=dev)
    send_slot[s_idx] = slot_sorted
    overflow = (dkey < D).sum() - ok.sum()

    names = sorted(fields)
    dtypes = {k: fields[k].dtype for k in names}
    sent = send_slot >= 0
    mat = torch.cat([_pack_i32(fields, names), sent.to(torch.int32)[:, None]], dim=1)
    # Dropped entries all go to one spare row past the buffer, never sent.
    buf = torch.zeros((D * cap + 1, len(names) + 1), dtype=torch.int32, device=dev)
    buf.index_copy_(0, torch.where(sent, send_slot, D * cap), mat)
    recv = torch.empty((D * cap, len(names) + 1), dtype=torch.int32, device=dev)
    dist.all_to_all_single(recv, buf[: D * cap], group=group)
    return Routed(fields=_unpack_i32(recv, names, dtypes), recv_valid=recv[:, -1] != 0,
                  send_slot=send_slot, overflow=overflow)


def _route_back(result_fields: dict, send_slot, group=None) -> dict:
    """Send per-received-slot results back to their senders; each original
    entry reads its result at its send slot (zero where it was dropped).
    One collective."""
    names = sorted(result_fields)
    dtypes = {k: result_fields[k].dtype for k in names}
    mat = _pack_i32(result_fields, names)
    ret = torch.empty_like(mat)
    dist.all_to_all_single(ret, mat, group=group)
    sent = send_slot >= 0
    got = _unpack_i32(ret[torch.clamp(send_slot, min=0)], names, dtypes)
    return {k: torch.where(sent, v, torch.zeros_like(v)) for k, v in got.items()}


# ---------------------------------------------------------------------------
# Halo rows between neighbouring row slabs
# ---------------------------------------------------------------------------


def _peer(group, r: int) -> int:
    return r if group is None else dist.get_global_rank(group, r)


def _halo_rows(own, fill, rank: int, D: int, ext0: int, group=None):
    """The ``ext0`` image rows above and below this rank's slab.

    ``own`` [P, rpd, W] holds the rank's rows on dim 1; ``fill`` [P, 1, 1]
    is the value of a row no rank owns (beyond the image).  Only the edge
    rows a neighbour needs are sent, hop by hop: hop q reaches rank +- q and
    carries min(rpd, ext0 - (q-1)*rpd) rows, so a halo wider than a slab
    (tiny grids) takes several hops.  Returns (top, bottom), each
    [P, ext0, W]."""
    P, rpd, W = own.shape
    ns = min(-(-ext0 // rpd), D - 1)
    ops, ups, downs = [], [], []
    for q in range(1, ns + 1):
        need = min(rpd, ext0 - (q - 1) * rpd)
        up = fill.expand(P, need, W).contiguous()   # the last rows of rank - q
        dn = fill.expand(P, need, W).contiguous()   # the first rows of rank + q
        if rank - q >= 0:
            ops += [dist.P2POp(dist.isend, own[:, :need].contiguous(), _peer(group, rank - q), group),
                    dist.P2POp(dist.irecv, up, _peer(group, rank - q), group)]
        if rank + q < D:
            ops += [dist.P2POp(dist.isend, own[:, rpd - need :].contiguous(),
                               _peer(group, rank + q), group),
                    dist.P2POp(dist.irecv, dn, _peer(group, rank + q), group)]
        ups.append(up)
        downs.append(dn)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    rest = fill.expand(P, ext0 - min(ns * rpd, ext0), W)
    return torch.cat([rest] + ups[::-1], dim=1), torch.cat(downs + [rest], dim=1)


def _exchange_table_halo(t_loc: PixelTable, rank: int, D: int, ext0: int, group=None) -> PixelTable:
    """Extend a rank's owned-rows table [S, rpd, W] to [S, rpd + 2*ext0, W]
    with its neighbours' edge rows; rows beyond the image are empty slots
    (meta -1, zero planes).  All five planes ride one i32 message per hop
    and direction."""
    S = t_loc.px.shape[0]
    dev = t_loc.px.device
    planes = torch.cat([t_loc.px.view(torch.int32), t_loc.py.view(torch.int32),
                        t_loc.pz.view(torch.int32), t_loc.weight.view(torch.int32), t_loc.meta])
    fill = torch.zeros((5 * S, 1, 1), dtype=torch.int32, device=dev)
    fill[4 * S :].fill_(-1)
    top, bot = _halo_rows(planes, fill, rank, D, ext0, group)
    ext = torch.cat([top, planes, bot], dim=1)
    f32 = lambda i: ext[i * S : (i + 1) * S].view(torch.float32)
    return PixelTable(px=f32(0), py=f32(1), pz=f32(2), weight=f32(3), meta=ext[4 * S :],
                      dropped=t_loc.dropped)


def _exchange_ck_halo(ck, rank: int, D: int, rpd: int, ext0: int, group=None):
    """Overwrite the halo rows of pass A's output [rpd + 2*ext0, W] with the
    owners' complete rows: over an R-row table halo, pass A's own halo-row
    values lack the entries up to 2R away.  Rows no rank owns read 1.0, the
    value pass B's padding has beyond the image: they are never valid
    observations, but 0 there would make pass B's 0/0 a NaN."""
    own = ck[ext0 : ext0 + rpd]
    fill = torch.ones((1, 1, 1), dtype=ck.dtype, device=ck.device)
    top, bot = _halo_rows(own[None], fill, rank, D, ext0, group)
    return torch.cat([top[0], own, bot[0]], dim=0)


# ---------------------------------------------------------------------------
# Capacities
# ---------------------------------------------------------------------------


def shard_caps(cfg: MapConfig, params: FilterParams, D: int) -> dict:
    """Per-rank working-set and route-bucket capacities: about
    headroom_eff/D of the single-device knobs, where the headroom
    (config.shard_route_headroom) is scaled by a slab's relative load
    variance (1 - 1/D): none at D = 1, the full margin for many small slabs.
    Overflow beyond them is counted, never silent.  Values equal the JAX
    package's ``shard_caps``."""
    V = cfg.num_voxels
    V_loc = V // D
    H, W = cfg.height, cfg.width
    rpd = -(-H // D)
    bv, _nb_full, spb = block_layout(cfg)
    nb_loc = V_loc // bv
    hroom = 1.0 + (float(cfg.shard_route_headroom) - 1.0) * (1.0 - 1.0 / D)
    floor = int(cfg.shard_route_floor)

    def scaled(knob, lo):
        a = max(min(knob, nb_loc), min(lo, nb_loc))
        if D > 1:
            a = max(min(int(hroom * knob) // D, nb_loc), min(lo, nb_loc))
        return a

    def _cap(total, full_floor):
        # A bucket per (source, destination) pair: the full volume while it
        # is small (up to the floor: overflow impossible on small grids),
        # headroom_eff/D of it when large.
        return max(1, min(total, min(full_floor, floor)), int(hroom * total) // D)

    A_loc = scaled(cfg.max_active_blocks, 64)
    n_work = A_loc * spb
    nb_pp = params.nb_ptc_num_per_point if params.if_consider_depth_noise else 1
    n_cand = rpd * W * nb_pp
    A_move = scaled(cfg.max_moving_blocks, 16)
    A_birth = scaled(cfg.max_birth_blocks, 64)
    n_move = A_move * spb
    return dict(
        hroom=hroom, A_loc=A_loc, n_work=n_work,
        ECAP=_cap(n_work, 1024), BCAP=_cap(n_cand, 512),
        MCAP=_cap(n_move, 1024),
        A_move=A_move, A_birth=A_birth, n_move=n_move,
        C_loc=max(1, min(
            D * _cap(n_work, 1024), cfg.max_table_entries,
            max(floor, int(hroom * cfg.max_table_entries) // D),
        )),
    )


# ---------------------------------------------------------------------------
# The labeled cloud of a row slab
# ---------------------------------------------------------------------------


def cloud_slab(cfg: MapConfig, params: FilterParams, frame: FrameInput, r_wc, t_wc, rank: int,
               D: int, max_movable: int, sky_instance: int = -1) -> LabeledCloud:
    """The labeled cloud of rank ``rank``'s extended row slab: image rows
    ``[rank*rpd - R, rank*rpd + rpd + R)``, [rpd + 2R, W].  The depth is
    padded with zero rows to ``rpd*D + 2R``; rows outside the image come out
    invalid.  ``sky_instance`` >= 0 turns on the ZED2-mode sky cull and bbox
    gate."""
    H, W = frame.depth.shape
    R = cfg.neighbor_half
    rpd = -(-H // D)
    Hext, Hpad = rpd + 2 * R, rpd * D + 2 * R
    r_lo = rank * rpd - R
    pad = (0, 0, R, Hpad - H - R)
    depth = F.pad(frame.depth, pad)[r_lo + R : r_lo + R + Hext]
    raster = F.pad(frame.track_raster, pad)[r_lo + R : r_lo + R + Hext]
    bbox3d = sky_instance >= 0
    cloud = generate_labeled_cloud(
        cfg, params, depth, raster, frame.track_label_table, r_wc, t_wc, max_movable,
        sky_instance_id=sky_instance,
        inst_bbox_min=frame.inst_bbox_min if bbox3d else None,
        inst_bbox_max=frame.inst_bbox_max if bbox3d else None,
        row_offset=r_lo,
    )
    rows = torch.arange(r_lo, r_lo + Hext, device=depth.device)
    return cloud._replace(valid=cloud.valid & ((rows >= 0) & (rows < H))[:, None])


# ---------------------------------------------------------------------------
# The sharded step
# ---------------------------------------------------------------------------


class RankGenerator:
    """The generator of this rank's own draws (the birth noise and the move
    jitter), seeded from the state's seed and the rank: the JAX step's
    ``fold_in(key, device)``.  Called with a state it returns the generator,
    seeded anew whenever the state's generator is another object than the
    last one seen (a new or restored state); ``reseed(state)`` seeds it
    anew from ``state`` at once.  The generator is one object, seeded in
    place, so that a CUDA graph that registered it draws from its offsets."""

    def __init__(self, rank: int):
        self.rank = rank
        self.of = None
        self.gen = None

    def __call__(self, state: MapState) -> torch.Generator:
        if self.of is not state.rng:
            self.reseed(state)
        return self.gen

    def reseed(self, state: MapState) -> None:
        if self.gen is None:
            self.gen = torch.Generator(device=state.voxel_stamp.device)
        self.gen.manual_seed((state.rng.initial_seed() * 1_000_003 + self.rank + 1) % (1 << 63))
        self.of = state.rng


def build_shard_stages(cfg: MapConfig, params: FilterParams, registry: LabelRegistry,
                       group=None) -> FrameStages:
    """The sharded step of this rank of ``group`` (None: the default group)
    in parts, as ``map.build_frame_stages`` gives the map's: the object
    layer is the single-device one (``objects``, and where the refit is
    split, ``objects_fit`` and ``objects_finish``), replicated on every rank;
    ``rest(state_slab, frame, objects)`` runs everything after it, from the
    cloud slab to the counters' ``all_reduce``, and returns (state_slab,
    render_slab, StepDiagnostics).  ``rank_rng`` is the rank's
    :class:`RankGenerator`."""
    D = dist.get_world_size(group)
    rank = dist.get_rank(group)
    V, K = cfg.num_voxels, cfg.slots_per_voxel
    if V % D or cfg.nz % D:
        raise ValueError(f"grid ({cfg.nz} z-planes, {V} voxels) not divisible by {D} ranks")
    V_loc, nz_loc = V // D, cfg.nz // D
    H, W = cfg.height, cfg.width
    HW = H * W
    S = cfg.phd_pixel_table_slots
    R = cfg.neighbor_half
    rpd = -(-H // D)                # image rows per rank
    ext0 = R                        # halo rows on each side
    Hext = rpd + 2 * R
    r0 = rank * rpd
    vox_base = rank * V_loc

    bv, _nb_full, spb = block_layout(cfg)
    nb_loc = V_loc // bv
    caps = shard_caps(cfg, params, D)
    A_loc, ECAP, C_loc = caps["A_loc"], caps["ECAP"], caps["C_loc"]
    BCAP, MCAP = caps["BCAP"], caps["MCAP"]
    A_move, A_birth, n_move = caps["A_move"], caps["A_birth"], caps["n_move"]

    max_movable = registry.max_movable_instance_id
    bbox3d = cfg.keypoint_mode == KEYPOINTS_BBOX3D
    sky_instance = registry.static_label_to_instance.get(
        "Sky", registry.static_label_to_instance.get("sky", -1)
    ) if bbox3d else -1
    rank_rng = RankGenerator(rank)
    single = build_frame_stages(cfg, params, registry)

    # ------------------------------------------------------------------
    def _observe_sharded(particles, scroll, vox_axis, voxel_stamp, cloud_ext, depth_full,
                         r_cw, t_cw, gt):
        """Local candidates -> route to the pixel-row owners -> rank, table,
        stencils -> results route home -> write-back in place."""
        flat = particles
        dev = depth_full.device
        ws = gather_working_set(cfg, flat, vox_axis, r_cw, t_cw, A_loc)
        bcand = ws.cand.reshape(-1)
        row_f = ws.row.reshape(-1)
        pix = torch.where(bcand, row_f * W + ws.col.reshape(-1), HW)
        camz = ws.camz.reshape(-1)

        # Classification against the replicated depth image.
        far_free, visible = classify_entries(cfg, depth_full, pix, camz, bcand)

        meta = ((ws.track << 8) | (ws.forget & 0xFF)).reshape(-1)
        # Each visible entry goes to the owner of its pixel row, once; the
        # stencils' boundary rows come from the dense halo exchange.
        owner = torch.clamp(torch.div(row_f, rpd, rounding_mode="floor"), max=D - 1)
        routed = _route(
            {"pix": pix, "camz": camz, "px": ws.px.reshape(-1), "py": ws.py.reshape(-1),
             "pz": ws.pz.reshape(-1), "w": ws.weight.reshape(-1), "meta": meta},
            visible, owner, D, ECAP, group,
        )

        # Rank + table on the owned row slab: the single-device step's
        # stable (pixel, camera depth) sort over the received stream.
        f = routed.fields
        pix_r = torch.where(routed.recv_valid, f["pix"], HW)
        order = stable_lexsort(pix_r, f["camz"])
        n_real_full = (pix_r < HW).sum()
        # The rank's share of the single-device entry cap; entries past it
        # are counted in entry_overflow.
        order = order[:C_loc]
        pix_s = pix_r[order]
        real_s = pix_s < HW
        cap_dropped = n_real_full - real_s.sum()
        rank_s = group_rank(pix_s)
        keep_s = real_s & (rank_s < S)
        t_loc = table_from_entries(
            cfg, torch.where(keep_s, pix_s - r0 * W, rpd * W), rank_s, keep_s,
            f["px"][order], f["py"][order], f["pz"][order], f["w"][order],
            f["meta"][order] >> 8, f["meta"][order] & 0xFF, n_rows=rpd,
        )
        # R-row table halo for pass A's owned rows; pass A's incomplete
        # halo-row values are replaced by the owners' before pass B.
        table = _exchange_table_halo(t_loc, rank, D, ext0, group)
        ck_kappa = stencil_pass_a_any(cfg, params, table, cloud_ext)
        ck_kappa = _exchange_ck_halo(ck_kappa, rank, D, rpd, ext0, group)
        new_w_t, new_f_t = stencil_pass_b_any(cfg, params, table, cloud_ext, ck_kappa)

        pix_loc = pix_s - (r0 - ext0) * W
        dest_t = torch.where(keep_s, torch.clamp(rank_s, max=S - 1) * (Hext * W) + pix_loc, 0)
        nw_e = new_w_t.reshape(-1)[dest_t]
        nf_e = new_f_t.reshape(-1)[dest_t].to(torch.int32)
        M = D * ECAP
        res_w = torch.zeros(M, dtype=torch.float32, device=dev)
        res_w[order] = torch.where(keep_s, nw_e, 0.0)
        res_m = torch.zeros(M, dtype=torch.int32, device=dev)
        res_m[order] = torch.where(keep_s, (nf_e & 0xFF) | (1 << 8), 0)
        back = _route_back({"w": res_w, "m": res_m}, routed.send_slot, group)

        # Merge the results into the working set (home side) and write back.
        upd = ((back["m"] >> 8) & 1) == 1
        init_w = constant(PARTICLE_OCC_INIT_WEIGHT, torch.float32, dev)
        w_upd = torch.where(upd, back["w"], torch.where(far_free, init_w, ws.weight.reshape(-1)))
        shp = (A_loc, spb)
        write_back(cfg, flat, voxel_stamp, ws, w_upd.view(shp), (upd | far_free).view(shp),
                   upd.view(shp), (back["m"] & 0xFF).view(shp), (visible | far_free).view(shp), gt)

        voxel_stamp, corner_overflow = refresh_empty_voxel_stamps(
            cfg, scroll, voxel_stamp, ws.has_alive, depth_full, r_cw, t_cw, gt,
            vox_axis=vox_axis, vox_base=vox_base,
        )
        diag = dict(
            visible_count=visible.sum(),
            block_overflow=ws.blocks.overflow,
            entry_overflow=routed.overflow + cap_dropped,
            # Each received entry competes once, on its owner only.
            table_dropped=(real_s & ~keep_s).sum(),
            corner_overflow=corner_overflow,
        )
        return flat, voxel_stamp, diag

    # ------------------------------------------------------------------
    def _birth_sharded(particles, scroll, vox_axis, cloud_ext, gt, gen):
        """Newborn candidates of the owned rows, routed to the ranks that own
        their voxels, inserted there with resampling."""
        # The owned rows; those past the image are invalid (cloud_slab).
        own = LabeledCloud(*(a[ext0 : ext0 + rpd] for a in cloud_ext))
        new = newborn_candidates(cfg, params, own, gt, gen, first_row=r0)
        pos = new.pos
        dev = pos.device
        vox_g, _, _, _, in_map = codecs.global_pos_to_voxel(cfg, scroll, pos)
        valid = new.valid & in_map
        meta = (new.label.to(torch.int32) << 16) | (new.track.to(torch.int32) & 0xFFFF)
        routed = _route(
            {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2], "pri": new.priority, "meta": meta,
             "vox": vox_g},
            valid, torch.where(valid, torch.div(vox_g, V_loc, rounding_mode="floor"), -1),
            D, BCAP, group,
        )
        M = D * BCAP
        f, rvalid = routed.fields, routed.recv_valid
        full = lambda v, dtype: torch.full((M,), v, dtype=dtype, device=dev)
        cand = Candidates(
            pos=torch.stack([f["x"], f["y"], f["z"]], dim=-1),
            weight=full(PARTICLE_OCC_INIT_WEIGHT, torch.float32),
            label=(f["meta"] >> 16) & 0xFF,
            track=f["meta"] & 0xFFFF,
            status=full(STATUS_REGULAR_BORN, torch.int32),
            stamp=full(0, torch.int32),
            forget=full(0, torch.int32),
            priority=torch.where(rvalid, f["pri"], 1 << 30),
            valid=rvalid,
        )
        res = _insert_core(
            cfg, particles, scroll, cand, resample_targets=True,
            uniform_weight=PARTICLE_OCC_INIT_WEIGHT, uniform_stamp=gt,
            max_target_blocks=A_birth,
            vox=torch.where(rvalid, f["vox"] - vox_base, V_loc), valid=rvalid, vox_axis=vox_axis,
        )
        return res.particles, res.accepted_count, res.block_overflow + routed.overflow

    # ------------------------------------------------------------------
    def _move_sharded(particles, scroll, vox_axis, objects, gen):
        """Floating-particle cleanup and rigid moves on the slab, with the
        moved particles re-inserted on the rank that owns their new voxel."""
        flat = particles
        dev = flat.px.device
        scan = movable_voxels_plain
        if use_observe_kernels(cfg, flat.track):
            from ..ops.observe_cuda import movable_voxels_cuda as scan
        hm = scan(cfg, flat.track, flat.status, flat.stamp, vox_axis, max_movable)
        blocks = select_blocks((hm.view(nb_loc, bv) != 0).any(dim=1), A_move)
        del hm
        rv = row_valid(blocks)
        g = lambda f: gather_rows_flat(f, blocks, spb)
        btrk = g(flat.track)
        bst = g(flat.status).to(torch.int32)
        bstamp = g(flat.stamp)
        baxis = torch.repeat_interleave(gather_rows_flat(vox_axis, blocks, bv), K, dim=1)
        balive = (bst != STATUS_INVALID) & (bstamp >= baxis)
        bmovable = balive & (btrk >= 0) & (btrk <= max_movable) & rv[:, None]
        bst, bmove, nx, ny, nz = rigid_move(params, objects, btrk, bst, bmovable,
                                            g(flat.px), g(flat.py), g(flat.pz), gen)
        # Delete the sources, then re-insert them where they land.
        scatter_rows_flat(flat.status, blocks, spb, torch.where(bmove, STATUS_INVALID, bst))

        meta = (
            (torch.clamp(g(flat.forget).to(torch.int32), 0, 7) << 27)
            | (torch.clamp(bst, 0, 7) << 24)
            | ((g(flat.label).to(torch.int32) & 0xFF) << 16)
            | (btrk & 0xFFFF)
        ).reshape(-1)
        pos = torch.stack([nx.reshape(-1), ny.reshape(-1), nz.reshape(-1)], dim=-1)
        vox_g, _, _, _, in_map = codecs.global_pos_to_voxel(cfg, scroll, pos)
        valid = bmove.reshape(-1) & in_map
        pri = rank * n_move + torch.arange(n_move, dtype=torch.int32, device=dev)
        routed = _route(
            {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2], "w": g(flat.weight).reshape(-1),
             "stamp": bstamp.reshape(-1), "meta": meta, "vox": vox_g, "pri": pri},
            valid, torch.where(valid, torch.div(vox_g, V_loc, rounding_mode="floor"), -1),
            D, MCAP, group,
        )
        f, rvalid = routed.fields, routed.recv_valid
        cand = Candidates(
            pos=torch.stack([f["x"], f["y"], f["z"]], dim=-1),
            weight=f["w"],
            label=(f["meta"] >> 16) & 0xFF,
            track=f["meta"] & 0xFFFF,
            status=(f["meta"] >> 24) & 0x7,
            stamp=f["stamp"],
            forget=(f["meta"] >> 27) & 0x7,
            priority=torch.where(rvalid, f["pri"], 1 << 30),
            valid=rvalid,
        )
        res = _insert_core(
            cfg, flat, scroll, cand, resample_targets=False, max_target_blocks=2 * A_move,
            vox=torch.where(rvalid, f["vox"] - vox_base, V_loc), valid=rvalid, vox_axis=vox_axis,
        )
        return (res.particles, res.accepted_count,
                blocks.overflow + routed.overflow + res.block_overflow)

    # ------------------------------------------------------------------
    def rest(state: MapState, frame: FrameInput, objects):
        gt = state.global_time + 1
        r_wc, t_wc, r_cw, t_cw = camera_matrices(frame.cam_pos, frame.cam_quat)
        gen = rank_rng(state)

        # 2. Labeled cloud of the extended row slab.
        cloud_ext = cloud_slab(cfg, params, frame, r_wc, t_wc, rank, D, max_movable, sky_instance)

        # 3. Prediction on the voxel slab.
        scroll = codecs.update_ego_center(cfg, state.scroll, frame.cam_pos, gt)
        objects, _expired = expire_objects(params, objects, gt)
        vox_axis = codecs.axis_stamps_per_voxel_slab(cfg, scroll, rank * nz_loc, nz_loc)
        particles, moved, move_overflow = _move_sharded(state.particles, scroll, vox_axis, objects, gen)

        # 4+5. Visibility + PHD, 6. birth + resampling, 7. render.
        particles, voxel_stamp, odiag = _observe_sharded(
            particles, scroll, vox_axis, state.voxel_stamp, cloud_ext, frame.depth, r_cw, t_cw, gt,
        )
        particles, born, birth_overflow = _birth_sharded(particles, scroll, vox_axis, cloud_ext, gt, gen)
        particles, result = render_any(cfg, particles, voxel_stamp, vox_axis,
                                       params.occupancy_threshold)

        new_state = dataclasses.replace(
            state, particles=particles, voxel_stamp=voxel_stamp, scroll=scroll, objects=objects,
            global_time=gt, prev_frame_time=frame.time,
        )
        # The nine counters in one all_reduce.
        counters = torch.stack([
            odiag["visible_count"], born, moved, odiag["block_overflow"],
            odiag["entry_overflow"], odiag["table_dropped"], odiag["corner_overflow"],
            move_overflow, birth_overflow,
        ]).to(torch.int64)
        dist.all_reduce(counters, group=group)
        return new_state, result, StepDiagnostics(*counters.unbind())

    # 1. The object layer, replicated: the same draws on every rank.
    return single._replace(rest=rest, rank_rng=rank_rng)


def _unpacker(cfg: MapConfig, registry: LabelRegistry, device) -> Callable:
    """``map.unpack_frame`` with the registry's static label table on
    ``device``, made here (a host copy) and never inside a capture."""
    table = torch.from_numpy(static_label_table(registry)).to(device)
    return functools.partial(unpack_frame, cfg, table)


def build_shard_step_eager(cfg: MapConfig, params: FilterParams, registry: LabelRegistry,
                           group=None, packed: bool = False):
    """The sharded step of :func:`build_shard_stages`'s parts, composed
    eagerly: the oracle of :func:`build_shard_step`, with the same
    arguments and the same call.  Its ``stages`` attribute holds the parts
    (``stages.rank_rng`` the rank's generator)."""
    stages = build_shard_stages(cfg, params, registry, group)
    tables = {}

    def step(state: MapState, frame):
        if packed:
            if frame.device not in tables:
                tables[frame.device] = _unpacker(cfg, registry, frame.device)
            frame = tables[frame.device](frame)
        return stages.rest(state, frame, stages.objects(state, frame))

    step.stages = stages
    return step


class ShardStep:
    """:func:`build_shard_step`'s step: the sharded parts on a
    ``step_graph.StaticStep`` over the rank's state slab, built at the first
    call (capturing on the card); ``static`` is that StaticStep."""

    def __init__(self, cfg: MapConfig, registry: LabelRegistry, stages: FrameStages, packed: bool):
        self.cfg, self.registry, self.stages = cfg, registry, stages
        self.kind = "packed" if packed else "frame"
        self.static = None

    def __call__(self, state: MapState, frame):
        if self.static is None:
            device = state.voxel_stamp.device
            self.static = StaticStep(
                self.stages, _unpacker(self.cfg, self.registry, device),
                functools.partial(unpack_objects, self.cfg), state,
                capture=device.type == "cuda",
            )
        return self.static(self.kind, frame, state)


def build_shard_step(cfg: MapConfig, params: FilterParams, registry: LabelRegistry, group=None,
                     packed: bool = False) -> ShardStep:
    """Returns ``step(state_slab, frame) -> (state_slab, render_slab,
    StepDiagnostics)`` for this rank of ``group`` (None: the default group):
    the counterpart of the JAX package's jitted ``shard_map`` step.

    ``state_slab`` is this rank's z-slab of the map state
    (``sharding.shard_state``).  ``frame`` is the replicated FrameInput of
    device tensors or, with ``packed``, the one-buffer frame of
    ``frontend.pack_frame`` as an int32 tensor, which every rank decodes with
    ``map.unpack_frame`` inside the step.  The render slab is the rank's
    [V/D] share of the render; the counters are summed over the ranks.

    The step is :func:`build_shard_stages`'s parts on a
    ``step_graph.StaticStep``: the state's tensors keep their addresses (the
    first state's become the static ones, updated in place; a state put in
    their place is copied into them), each frame is copied into a static
    input, and on the card the first frame runs eagerly (it also makes
    NCCL's communicator), the second is captured into CUDA graphs, the
    collectives with the rest, and later frames are the copy and the
    replays: graphs "fit" and "finish" around the refit's eager SVD, which
    every rank runs alike, where ``step_graph.split_at_refit`` holds, else
    one graph "step".  On the CPU (gloo) the same parts run eagerly.  A
    capture or a replay that fails raises.  The result and the counters are
    the caller's; the returned state is the static one.

    Draws: the object layer's come from the state's generator, which every
    rank holds with the same seed and draws from with the same shapes, so
    the replicated object tables stay equal.  The birth noise and the move
    jitter come from a generator of this rank's own (:class:`RankGenerator`);
    both are registered with each graph.  :func:`build_shard_step_eager` is
    the oracle: the same bits, frame for frame."""
    return ShardStep(cfg, registry, build_shard_stages(cfg, params, registry, group), packed)
