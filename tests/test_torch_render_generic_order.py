"""The order of the generic render and merge kernels (csrc/render.cu
``render_generic_kernel``, csrc/birth.cu ``merge_generic_kernel``, K past
31), replayed on the CPU and held bit for bit against the plain versions.

The kernels leave out every term the plain versions add as +0.0: the render
sums only the alive slots (weight and guessed sums) and, for each
contributing slot d, only the contributing slots of d's track, first those
after d in slot order and then those before it (the plain version's cyclic
order d+1 .. K-1, 0 .. d-1); the merge's resample sums and walks only the
UPDATED slots.  ``render_order`` and ``walk_order`` below compute what the
kernels compute in the kernels' order, vectorised over voxels: the
contributing (UPDATED) slots compacted in slot order, the zero terms
skipped.  They must give the plain versions' bits (``render_core_plain``,
``resample_slots``), and the render's the Pallas render's results in
interpret mode as tests/test_torch_render.py runs it, on the stores that
the kernels' design has to get right (``STORE_EDGES``,
``RENDER_GENERIC_EDGES``, ``MERGE_KINDS``) at K = 63 and 127.  The kernels
themselves are held to the plain versions on the card in
tests/test_torch_kernels_gpu.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import semantic_dsp_map_tpu as J
from semantic_dsp_map_tpu.ops.render_pallas import render_core_pallas
from semantic_dsp_map_tpu.state import init_map_state as j_init

from semantic_dsp_map_tpu_torch.config import PARTICLE_OCC_INIT_WEIGHT, tiny_test_config
from semantic_dsp_map_tpu_torch.ops.birth import resample_slots
from semantic_dsp_map_tpu_torch.ops.render import render_core_plain
from semantic_dsp_map_tpu_torch.state import Particles

from torch_parity import (
    MERGE_KINDS, RENDER_GENERIC_EDGES, STORE_EDGES, merge_working_set, render_generic_store,
    render_store,
)

torch.set_num_threads(2)

#: Not a multiple of the kernel's 256-voxel span; a multiple of the 128
#: voxels a row of the Pallas render holds.
V = 1152
THR = 0.4


def _store(K, kind, seed):
    if kind in RENDER_GENERIC_EDGES:
        return render_generic_store(V, K, seed, kind)
    return render_store(V, K, seed, kind)


def _particles(d):
    T = lambda k: torch.from_numpy(d[k].copy())
    n = d["weight"].shape[0]
    z = torch.zeros(n)
    return Particles(px=z, py=z, pz=z, weight=T("weight"), label=T("label"), track=T("track"),
                     status=T("status"), forget=torch.zeros(n, dtype=torch.uint8), stamp=T("stamp"))


def render_order(K, p, voxel_stamp, vax, thr):
    """The generic render kernel's results in its own order: (new weight,
    new status, occ, label, track, weight_sum, the voxels whose argmax had
    two tracks at the best sum)."""
    nv = voxel_stamp.shape[0]
    f32 = torch.float32
    init_w = torch.tensor(PARTICLE_OCC_INIT_WEIGHT, dtype=f32)
    w = p.weight.view(nv, K)
    st = p.status.view(nv, K).int()
    trk = p.track.view(nv, K)
    lab = p.label.view(nv, K).int()
    alive = (st != 0) & (p.stamp.view(nv, K) >= vax[:, None])
    vvalid = (voxel_stamp != 0) & (voxel_stamp >= vax)
    listed = vvalid & (st != 0).any(1)  # the voxels a warp reads; the rest from their stamps
    wc = torch.where(w > 1, torch.ones((), dtype=f32), w)
    guessed = alive & (st == 3)
    gc = alive & (st == 1) & (wc < init_w)
    cmask = alive & ~gc

    # the alive (guessed) slots' terms in slot order, none of +0.0
    wsum = torch.zeros(nv, dtype=f32)
    gsum = torch.zeros(nv, dtype=f32)
    for k in range(K):
        wsum = torch.where(alive[:, k], wsum + w[:, k], wsum)
        gsum = torch.where(guessed[:, k], gsum + wc[:, k], gsum)

    # the contributing slots, compacted in slot order: the warp's buffer
    L = cmask.sum(1)
    order = torch.sort((~cmask).int(), dim=1, stable=True).indices
    tt = trk.gather(1, order)
    cc = wc.gather(1, order)
    code = (order.int() << 8) | lab.gather(1, order)
    d = torch.arange(K)[None, :]
    entry = d < L[:, None]
    # entry d's sum: its own weight, its track's entries after it, then before
    ts = cc.clone()
    for after in (True, False):
        for e in range(K):
            take = entry[:, e:e + 1] & ((e > d) if after else (e < d)) & (tt[:, e:e + 1] == tt)
            ts = torch.where(take, ts + cc[:, e:e + 1], ts)
    score = entry & (ts > 0)
    best_w = torch.where(score, ts, -1.0).amax(1)
    found = best_w > 0
    best_t = torch.where(score & (ts == best_w[:, None]), tt, 1 << 30).amin(1)
    top_t = torch.where(score & (ts == best_w[:, None]), tt, -1).amax(1)
    pick = torch.where(entry & (tt == best_t[:, None]), code, -1).amax(1)

    ws = torch.where(listed, wsum, torch.where(vvalid, 0.0, -1.0))
    gw = torch.where(listed, gsum, 0.0)
    occ = torch.where(ws > thr, 1, torch.where(ws < 0, -1, torch.where(gw >= init_w, 2, 0)))
    track = torch.where(listed & found, best_t, 0)
    label = torch.where(listed & found & (pick >= 0), pick & 0xFF, 0)
    touched = listed[:, None]
    new_w = torch.where(touched & alive & (w > 1), wc, w).reshape(-1)
    new_st = torch.where(touched & gc, 0, st).reshape(-1).to(torch.uint8)
    return new_w, new_st, occ.int(), label.int(), track.int(), ws, listed & found & (top_t != best_t)


def _bits(x):
    return x.view(torch.int32)


def _same_weights(got, want):
    """The new weights' bits, NaN for NaN: the plain clamp (torch.minimum on
    the CPU) gives a NaN of its own bits, where the kernel leaves a NaN
    weight as it is."""
    nan = torch.isnan(got)
    assert torch.equal(nan, torch.isnan(want))
    assert torch.equal(_bits(got[~nan]), _bits(want[~nan]))


@pytest.mark.parametrize("K", [63, 127])
@pytest.mark.parametrize("kind", STORE_EDGES + RENDER_GENERIC_EDGES)
def test_render_order_has_the_plain_bits(kind, K):
    """The kernel's order against render_core_plain: occ, label, track, the
    new status and weight_sum's bits equal, the new weights' bits too (NaN
    for NaN)."""
    d = _store(K, kind, seed=K + 11)
    p = _particles(d)
    vst, vax = torch.from_numpy(d["voxel_stamp"]), torch.from_numpy(d["vax"])
    cfg = tiny_test_config(max_particle_num_per_voxel_n=K.bit_length())
    new, want = render_core_plain(cfg, p, vst, vax, THR)
    new_w, new_st, occ, label, track, ws, tied = render_order(K, p, vst, vax, THR)
    for name, got in (("occ", occ), ("label", label), ("track", track)):
        assert torch.equal(got, getattr(want, name)), name
    assert torch.equal(_bits(ws), _bits(want.weight_sum))
    assert torch.equal(new_st, new.status)
    _same_weights(new_w, new.weight)
    if kind not in ("all_dead",):
        assert (occ == 1).any()
    if kind == "signed_zeros_nan":
        assert torch.isnan(ws).any() and not torch.isnan(ws).all()
    if kind == "track_ties":
        # ties decided: the winner is the lower of two tracks with equal sums
        assert int(tied.sum()) > V // 4 and (track > 0).any() and (label > 0).any()


@pytest.mark.parametrize("K", [63, 127])
@pytest.mark.parametrize("kind", STORE_EDGES + RENDER_GENERIC_EDGES)
def test_render_order_matches_pallas(kind, K):
    """The kernel's order against the Pallas render in interpret mode on the
    same store: occ, label, track and the new status equal, the new weights
    equal (NaN for NaN), weight_sum at rtol 2e-5 / atol 1e-6 (the Pallas
    kernel sums a voxel's slots by a matrix product, in another order).  In
    that matrix product a NaN times 0 reaches every voxel of the NaN's
    128-voxel row, so the NaN weights of the signed-zero store are 0.5 here
    (its -0.0 and +0.0 weights stay)."""
    slots_n = K.bit_length()
    cfg_j = J.config.tiny_test_config(max_particle_num_per_voxel_n=slots_n)
    d = _store(K, kind, seed=K + 29)
    d["weight"] = np.where(np.isnan(d["weight"]), np.float32(0.5), d["weight"])
    n = V * K
    jp = j_init(cfg_j).particles.replace(
        px=jnp.zeros(n), py=jnp.zeros(n), pz=jnp.zeros(n), forget=jnp.zeros(n, jnp.uint8),
        weight=jnp.asarray(d["weight"]), stamp=jnp.asarray(d["stamp"]),
        status=jnp.asarray(d["status"]), track=jnp.asarray(d["track"].astype(np.uint16)),
        label=jnp.asarray(d["label"]))
    jnew, jr = render_core_pallas(cfg_j, jp, jnp.asarray(d["voxel_stamp"]), jnp.asarray(d["vax"]),
                                  THR, interpret=True)
    p = _particles(d)
    new_w, new_st, occ, label, track, ws, _ = render_order(
        K, p, torch.from_numpy(d["voxel_stamp"]), torch.from_numpy(d["vax"]), THR)
    for name, got in (("occ", occ), ("label", label), ("track", track)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jr, name)), err_msg=name)
    np.testing.assert_array_equal(new_st.numpy(), np.asarray(jnew.status))
    np.testing.assert_array_equal(new_w.numpy(), np.asarray(jnew.weight))
    np.testing.assert_allclose(ws.numpy(), np.asarray(jr.weight_sum), rtol=2e-5, atol=1e-6)


def walk_order(K, trigger, status, weight, target):
    """resample_slots as the generic merge kernel runs it: the UPDATED slots
    compacted in slot order, the weight sum and the walk over them alone,
    the threshold's loop left at its first false step.  Returns (new
    status, new weight, voxels whose loop ran to its K + 8 bound)."""
    f32 = torch.float32
    upd = status == 1
    nv = status.shape[0]
    L = upd.sum(1)
    order = torch.sort((~upd).int(), dim=1, stable=True).indices
    wl = weight.gather(1, order)
    entry = torch.arange(K)[None, :] < L[:, None]
    wsum = torch.zeros(nv, dtype=f32)
    for e in range(K):
        wsum = torch.where(entry[:, e], wsum + wl[:, e], wsum)
    do = target & (L > trigger)
    wipe = do & (wsum < 0.01)
    walk = do & ~wipe
    q = wsum * torch.tensor(1.0 / trigger, dtype=f32)
    wpp = torch.where(torch.isnan(q), q, torch.minimum(q, torch.ones((), dtype=f32)))
    csum = torch.zeros(nv, dtype=f32)
    thresh = wpp.clone()
    kept = torch.zeros_like(upd)
    deleted = torch.zeros_like(upd)
    at_bound = torch.zeros(nv, dtype=torch.bool)
    for e in range(K):
        a = walk & entry[:, e]
        csum_e = csum + wl[:, e]
        keep = a & ~(csum_e < thresh)
        nxt = thresh + wpp
        more = keep & (csum_e > nxt)
        for _ in range(K + 8):
            if not more.any():
                break
            nxt = torch.where(more, nxt + wpp, nxt)
            more = more & (csum_e > nxt)
        at_bound |= more
        kept[:, e] = keep
        deleted[:, e] = a & (csum_e < thresh)
        thresh = torch.where(keep, nxt, thresh)
        csum = torch.where(a, csum_e, csum)
    back = torch.argsort(order, dim=1)  # slot k's entry
    kept, deleted = kept.gather(1, back), deleted.gather(1, back)
    new_st = torch.where(deleted | (wipe[:, None] & upd), 0, status)
    new_w = torch.where(kept, wpp[:, None], weight)
    return new_st, new_w, at_bound


@pytest.mark.parametrize("K", [63, 127])
@pytest.mark.parametrize("kind", MERGE_KINDS)
def test_walk_order_has_the_plain_bits(kind, K):
    """The generic merge's resample order against resample_slots on the
    target rows of a working set of ``kind`` (status pruned as the merge
    prunes it; a voxel is a target where it has a staged candidate): the new
    statuses and the new weights' bits equal.  The heavy slots of
    ``walk_bound`` run the threshold's loop to its K + 8 bound; ``wipe``
    wipes."""
    bv, A, n_real, nb = {63: (8, 64, 50, 128), 127: (4, 64, 50, 256)}[K]
    d = merge_working_set(K, bv, A, n_real, nb, seed=K, kind=kind)
    rows = d["ids"][:n_real]
    slots = (rows[:, None] * bv * K + np.arange(bv * K)).reshape(-1)
    vox = (rows[:, None] * bv + np.arange(bv)).reshape(-1)
    status = torch.from_numpy(d["status"][slots].astype(np.int32)).view(-1, K)
    stale = torch.from_numpy(d["stamp"][slots]).view(-1, K) < torch.from_numpy(d["vox_axis"][vox])[:, None]
    status = torch.where((status != 0) & stale, 0, status)
    weight = torch.from_numpy(d["weight"][slots]).view(-1, K)
    target = torch.from_numpy((d["in_meta"][:n_real] >= 0).any(-1).reshape(-1))
    trigger = (K + 1) // 2
    cfg = tiny_test_config(max_particle_num_per_voxel_n=K.bit_length())
    want_st, want_w = resample_slots(cfg, status, weight, target)
    got_st, got_w, at_bound = walk_order(K, trigger, status, weight, target)
    assert torch.equal(got_st, want_st)
    assert torch.equal(_bits(got_w), _bits(want_w))
    changed = (got_st != status).any(1)
    assert changed.any()
    if kind == "walk_bound":
        assert at_bound.any()
    if kind == "wipe":
        assert (got_st[target] == 0).all()
