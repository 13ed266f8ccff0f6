"""Occupancy + semantics rendering (counterpart of
``semantic_dsp_map_tpu/ops/render.py``; getOccupancyResult /
determineIfVoxelOccupied / calculateWeightAndSemanticsInVoxel,
semantic_dsp_map.h:1239-1383, operations.h:390-448, 606-639).

Per voxel of K slots: the pre-clamp weight sum of live particles, the
clamped guessed-weight sum, the summed weight per track, the argmax track
(ties to the lowest track id), the label of that track's highest-slot
contributing particle, and the occupancy code -1 unknown / 0 free /
1 occupied / 2 guessed.  Two storage side effects, in valid voxels only:
weights are clamped to <= 1, and live UPDATED particles lighter than the
newborn weight are garbage-collected to INVALID (their weight still enters
the weight sum).

``render_core_plain`` is the plain PyTorch reduction and the oracle of the
CUDA kernel in ops/render_cuda.py.  Its sums run in slot order, the order
the kernel uses, so the two agree bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import MapConfig, PARTICLE_OCC_INIT_WEIGHT
from ..state import MapState, STATUS_GUESSED_BORN, STATUS_INVALID, STATUS_UPDATED, constant
from . import codecs


class RenderResult(NamedTuple):
    occ: torch.Tensor         # i32[V]: -1 unknown, 0 free, 1 occupied, 2 guessed
    label: torch.Tensor       # i32[V]
    track: torch.Tensor       # i32[V]
    weight_sum: torch.Tensor  # f32[V] (-1 for unknown voxels)


def render_core_plain(cfg: MapConfig, p, voxel_stamp, vax, occupancy_threshold: float):
    """Returns (particles with the new weight and status, RenderResult);
    the inputs are not modified."""
    K = cfg.slots_per_voxel
    V = voxel_stamp.shape[0]
    f32 = torch.float32
    thr = constant(float(occupancy_threshold), f32, vax.device)
    init_w = constant(PARTICLE_OCC_INIT_WEIGHT, f32, vax.device)

    w = p.weight.view(V, K)
    status = p.status.view(V, K)
    trk = p.track.view(V, K).to(torch.int32)
    lab = p.label.view(V, K).to(torch.int32)
    alive = (status != STATUS_INVALID) & (p.stamp.view(V, K) >= vax[:, None])
    vvalid = (voxel_stamp != 0) & (voxel_stamp >= vax)

    w_c = torch.minimum(w, torch.ones((), dtype=f32, device=w.device))
    guessed = alive & (status == STATUS_GUESSED_BORN)
    gc = alive & (status == STATUS_UPDATED) & (w_c < init_w)
    contrib_mask = alive & ~gc
    contrib = torch.where(contrib_mask, w_c, 0.0)

    weight_sum = torch.zeros(V, dtype=f32, device=w.device)
    guessed_weight = torch.zeros(V, dtype=f32, device=w.device)
    for k in range(K):
        weight_sum = weight_sum + torch.where(alive[:, k], w[:, k], 0.0)
        guessed_weight = guessed_weight + torch.where(guessed[:, k], w_c[:, k], 0.0)

    # Per-slot same-track sum: slot d starts from its own contribution and
    # adds slots (d+1 .. d+K-1) mod K in that order.
    track_sum = contrib
    for s in range(1, K):
        t_n = torch.roll(trk, -s, dims=1)
        c_n = torch.roll(contrib, -s, dims=1)
        track_sum = track_sum + torch.where(trk == t_n, c_n, 0.0)

    big = 1 << 30
    score_ok = contrib_mask & (track_sum > 0.0)
    best_w = torch.where(score_ok, track_sum, -1.0).amax(dim=1)
    found = best_w > 0.0
    is_best = score_ok & (track_sum == best_w[:, None])
    best_track = torch.where(is_best, trk, big).amin(dim=1)
    slot_idx = torch.arange(K, dtype=torch.int32, device=w.device)[None, :]
    match = contrib_mask & (trk == best_track[:, None])
    pick = torch.where(match, (slot_idx << 8) | (lab & 0xFF), -1).amax(dim=1)
    best_label = torch.where(pick >= 0, pick & 0xFF, 0)

    best_track = torch.where(found & vvalid, best_track, 0)
    best_label = torch.where(found & vvalid, best_label, 0)
    weight_sum = torch.where(vvalid, weight_sum, -1.0)
    guessed_weight = torch.where(vvalid, guessed_weight, 0.0)

    occ = torch.where(
        weight_sum > thr,
        1,
        torch.where(weight_sum < 0, -1, torch.where(guessed_weight >= init_w, 2, 0)),
    ).to(torch.int32)

    new_weight = torch.where(alive & vvalid[:, None], w_c, w)
    new_status = torch.where(gc & vvalid[:, None], STATUS_INVALID, status.to(torch.int32))
    particles = dataclasses.replace(
        p, weight=new_weight.reshape(-1), status=new_status.reshape(-1).to(p.status.dtype)
    )
    return particles, RenderResult(
        occ=occ, label=best_label, track=best_track, weight_sum=weight_sum
    )


def render_any(cfg: MapConfig, p, voxel_stamp, vax, occupancy_threshold: float):
    """Returns (particles_after_gc, RenderResult) of the voxels of ``vax``
    (the whole grid or a z-slab): the CUDA kernel on a CUDA device when
    ``cfg.use_pallas_render`` is set (in place), else the plain reduction."""
    if cfg.use_pallas_render and p.weight.is_cuda:
        from .render_cuda import render_core_cuda

        return render_core_cuda(cfg, p, voxel_stamp, vax, occupancy_threshold)
    return render_core_plain(cfg, p, voxel_stamp, vax, occupancy_threshold)


def render_occupancy(cfg: MapConfig, state: MapState, occupancy_threshold: float):
    """Returns (particles_after_gc, RenderResult) of the whole grid
    (``render_any``)."""
    vax = codecs.axis_stamps_per_voxel(cfg, state.scroll)
    return render_any(cfg, state.particles, state.voxel_stamp, vax, occupancy_threshold)


#: Voxels per chunk of the smoothed render's candidate pass (whole z-planes;
#: bounds its [chunk, 5K] temporaries).
SMOOTHED_CHUNK_VOXELS = 1 << 20


def render_occupancy_smoothed(cfg: MapConfig, state: MapState, occupancy_threshold: float):
    """calculateWeightAndSemanticsInVoxelConsiderNeighbors
    (operations.h:457-600), the 4-neighbourhood variant of the reduction
    behind ``FilterParams.if_use_neighbor_smoothed_occupancy`` (no call site
    in the reference engine; the JAX package's
    ``render_occupancy_smoothed``).  Plain PyTorch on every device; returns
    (particles_after_gc, RenderResult).

    Reference quirks kept:
      - the neighbourhood is taken in RING indices with no torus wrap and
        asymmetric bounds (x-1 >= 1 and x+1 < Nx-1, :486-516);
      - an occupied voxel with no occupied neighbour is suppressed to weight
        0 (:563-575); an empty voxel with >= 2 occupied neighbours is
        inferred occupied at weight threshold + 0.1 (:577-588);
      - guessed particles add their raw weight to the per-track sums but
        not to the occupancy weight (:532-556);
      - the semantics argmax spans the voxel and its neighbours.

    The 5K candidates (5 offsets x K slots) of each voxel are scored in one
    pass per summand: the total of candidate i adds the candidates k with
    its track in ascending k, one add at a time, the JAX package's order,
    so the argmax ties agree bit for bit."""
    K = cfg.slots_per_voxel
    V = cfg.num_voxels
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    p = state.particles
    dev = p.weight.device
    f32 = torch.float32
    thr = constant(float(occupancy_threshold), f32, dev)
    init_w = constant(PARTICLE_OCC_INIT_WEIGHT, f32, dev)

    vax = codecs.axis_stamps_per_voxel(cfg, state.scroll)
    status = p.status.view(V, K)
    w = p.weight.view(V, K)
    alive = codecs.particle_alive(status, p.stamp.view(V, K), vax)
    vvalid = codecs.voxel_valid(state.voxel_stamp, vax)

    w_c = torch.minimum(w, torch.ones((), dtype=f32, device=dev))
    guessed = alive & (status == STATUS_GUESSED_BORN)
    gc = alive & (status == STATUS_UPDATED) & (w_c < init_w)
    contrib = alive & ~gc

    # Per-voxel pieces of weight_sum_vec / guessed_weight (:524-546).
    wv = torch.zeros(V, dtype=f32, device=dev)
    gw = torch.zeros(V, dtype=f32, device=dev)
    for k in range(K):
        wv = wv + torch.where(contrib[:, k] & ~guessed[:, k], w_c[:, k], 0.0)
        gw = gw + torch.where(guessed[:, k], w[:, k], 0.0)
    # Per-slot track-map contributions (guessed at raw weight, :549-556).
    wct = torch.where(contrib, torch.where(guessed, w, w_c), 0.0)
    trk = torch.where(contrib, p.track.view(V, K).to(torch.int32), -1)
    lab = p.label.view(V, K).to(torch.int32)

    g3 = lambda a: a.reshape(nz, ny, nx)
    xi = torch.arange(nx, device=dev)[None, None, :]
    yi = torch.arange(ny, device=dev)[None, :, None]
    vv3 = g3(vvalid)

    def shifted(a3, dx, dy):
        """out[z, y, x] = a3[z, y - dy, x - dx] (ring space, wrapped; the
        presence masks exclude the wrapped rows)."""
        return torch.roll(a3, shifts=(dy, dx), dims=(1, 2))

    offsets = [  # (dx, dy, neighbour present at the centre voxel)
        (0, 0, torch.ones((nz, ny, nx), dtype=torch.bool, device=dev)),  # self
        (1, 0, (xi >= 2) & shifted(vv3, 1, 0)),                          # x-1
        (-1, 0, (xi < nx - 2) & shifted(vv3, -1, 0)),                    # x+1
        (0, 1, (yi >= 2) & shifted(vv3, 0, 1)),                          # y-1
        (0, -1, (yi < ny - 2) & shifted(vv3, 0, -1)),                    # y+1
    ]

    # Smoothing decision (:563-588).
    wv3 = g3(wv)
    any_big = torch.zeros((nz, ny, nx), dtype=torch.bool, device=dev)
    big_count = torch.zeros((nz, ny, nx), dtype=torch.int32, device=dev)
    gw3 = g3(gw)
    gw_total = gw3
    for dx, dy, present in offsets[1:]:
        is_big = present & (shifted(wv3, dx, dy) > thr)
        any_big = any_big | is_big
        big_count = big_count + is_big.to(torch.int32)
        gw_total = gw_total + torch.where(present, shifted(gw3, dx, dy), 0.0)
    ws_sm = torch.where(
        wv3 > thr,
        torch.where(any_big, wv3, 0.0),
        torch.where(big_count >= 2, thr + constant(0.1, f32, dev), wv3),
    ).reshape(-1)
    gw_total = gw_total.reshape(-1)

    # Neighbourhood-wide per-track argmax over the candidates i = offset * K
    # + slot, in chunks of whole z-planes (shifts stay inside a plane).
    trk3 = [g3(trk[:, j]) for j in range(K)]
    wct3 = [g3(wct[:, j]) for j in range(K)]
    lab3 = [g3(lab[:, j]) for j in range(K)]
    n_cand = 5 * K
    planes = max(1, SMOOTHED_CHUNK_VOXELS // (ny * nx))
    best_track = torch.zeros(V, dtype=torch.int32, device=dev)
    best_label = torch.zeros(V, dtype=torch.int32, device=dev)
    big = 1 << 30
    cand_idx = torch.arange(n_cand, device=dev)
    for z0 in range(0, nz, planes):
        z1 = min(nz, z0 + planes)
        ct, cw, cl = [], [], []
        for dx, dy, present in offsets:
            pr = present[z0:z1]
            for j in range(K):
                ct.append(torch.where(pr, shifted(trk3[j][z0:z1], dx, dy), -1).reshape(-1))
                cw.append(torch.where(pr, shifted(wct3[j][z0:z1], dx, dy), 0.0).reshape(-1))
                cl.append(shifted(lab3[j][z0:z1], dx, dy).reshape(-1))
        ct, cw, cl = torch.stack(ct, 1), torch.stack(cw, 1), torch.stack(cl, 1)  # [n, 5K]
        tot = torch.zeros_like(cw)
        for k in range(n_cand):
            tot = tot + torch.where(ct == ct[:, k : k + 1], cw[:, k : k + 1], 0.0)
        ok = (ct >= 0) & (tot > 0.0)
        found = ok.any(dim=1)
        best_w = torch.where(ok, tot, -1.0).amax(dim=1)
        bt = torch.where(ok & (tot == best_w[:, None]), ct, big).amin(dim=1)
        # Label: the last candidate in visit order carrying the best track (:556).
        last = torch.where((ct >= 0) & (ct == bt[:, None]), cand_idx, -1).amax(dim=1)
        bl = torch.gather(cl, 1, last.clamp(min=0)[:, None])[:, 0]
        sl = slice(z0 * ny * nx, z1 * ny * nx)
        best_track[sl] = torch.where(found, bt, 0)
        best_label[sl] = torch.where(found & (last >= 0), bl, 0)

    weight_sum = torch.where(vvalid, ws_sm, -1.0)
    gw_total = torch.where(vvalid, gw_total, 0.0)
    best_track = torch.where(vvalid, best_track, 0)
    best_label = torch.where(vvalid, best_label, 0)
    occ = torch.where(
        weight_sum > thr,
        1,
        torch.where(weight_sum < 0, -1, torch.where(gw_total >= init_w, 2, 0)),
    ).to(torch.int32)

    # The plain reduction's storage side effects (:533-543).
    new_weight = torch.where(alive & vvalid[:, None], w_c, w)
    new_status = torch.where(gc & vvalid[:, None], STATUS_INVALID, status.to(torch.int32))
    particles = dataclasses.replace(
        p, weight=new_weight.reshape(-1), status=new_status.reshape(-1).to(p.status.dtype)
    )
    return particles, RenderResult(occ=occ, label=best_label, track=best_track, weight_sum=weight_sum)
