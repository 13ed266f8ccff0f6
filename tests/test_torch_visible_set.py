"""The port's PHD update over a VisibleSet against the JAX package's, jitted
as the JAX package runs it: ``build_pixel_table`` field for field,
``compute_ck_kappa`` and ``phd_weight_update`` with the floats at rtol 2e-5 /
atol 1e-6 (the two sides sum a window's terms in another order) and every
integer equal, on the inputs of tests/test_phd.py (the joint and the
independent filter) and on sets made to reach the edges of the pixel
ranking: a pixel holding more than S entries, tied weights inside it, -0.0
beside 0.0, padding and invisible entries among the real ones, and a set
with no real entry.  On the CPU the passes are the plain stencils; the
card's kernels are held to them in tests/test_torch_kernels_gpu.py and in
``chip_smoke.py --phase visible``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_dsp_map_tpu.config import FilterParams as JFilterParams
from semantic_dsp_map_tpu.config import tiny_test_config as j_tiny
from semantic_dsp_map_tpu.ops import phd as jphd
from semantic_dsp_map_tpu.ops.projection import LabeledCloud as JCloud
from semantic_dsp_map_tpu.ops.projection import VisibleSet as JVisibleSet
from semantic_dsp_map_tpu.state import Particles as JParticles

from semantic_dsp_map_tpu_torch.config import FilterParams, tiny_test_config
from semantic_dsp_map_tpu_torch.ops import phd as tphd
from semantic_dsp_map_tpu_torch.ops.projection import LabeledCloud, visible_set_from_numpy
from semantic_dsp_map_tpu_torch.state import Particles

torch.set_num_threads(2)

RTOL, ATOL = 2e-5, 1e-6
#: tests/test_phd.py's two filters
PARAMS = {
    "joint": dict(detection_probability=0.9, noise_number=0.05, forgetting_rate=1.0,
                  max_forget_count=3, id_transition_probability=0.2),
    "independent": dict(detection_probability=0.95, noise_number=0.1,
                        if_use_independent_filter=True),
}
FIELDS = ("px", "py", "pz", "weight", "label", "track", "status", "forget", "stamp")


def _cloud(rng, H, W):
    """tests/test_phd.py's observation cloud."""
    valid = rng.rand(H, W) > 0.3
    return dict(
        pos=rng.randn(H, W, 3).astype(np.float32) * 0.5,
        sigma=(0.05 + rng.rand(H, W) * 0.2).astype(np.float32),
        label=np.zeros((H, W), np.int32),
        track=rng.randint(0, 3, (H, W)).astype(np.int32),
        valid=valid,
    )


def _store(rng, V, K):
    """A random particle store (the JAX package's dtypes): the write-back
    must leave every slot it does not own as it was."""
    n = V * K
    return dict(
        px=rng.randn(n).astype(np.float32), py=rng.randn(n).astype(np.float32),
        pz=rng.randn(n).astype(np.float32), weight=rng.rand(n).astype(np.float32),
        label=rng.randint(0, 9, n).astype(np.uint8), track=rng.randint(0, 6, n).astype(np.uint16),
        status=rng.randint(0, 4, n).astype(np.uint8), forget=rng.randint(0, 6, n).astype(np.uint8),
        stamp=rng.randint(0, 5, n).astype(np.int32),
    )


def _case(kind, seed=0, S=12):
    """(cfg pair, numpy VisibleSet, cloud, store) of one kind:
    "phd": tests/test_phd.py's 40 particles, each in a voxel of its own, P
    padded to 64; "crowded": the same plus 18 entries in one pixel and 6 in
    another, with tied weights, -0.0 and 0.0, invisible entries and padding
    among them; "no_real": only padding and invisible entries."""
    cfg_j = j_tiny(phd_neighbor_half=2, phd_pixel_table_slots=S)
    cfg_t = tiny_test_config(phd_neighbor_half=2, phd_pixel_table_slots=S)
    rng = np.random.RandomState(seed)
    H, W, K, V = cfg_t.height, cfg_t.width, cfg_t.slots_per_voxel, cfg_t.num_voxels
    cloud = _cloud(rng, H, W)
    n = 40
    row, col = rng.randint(0, H, n), rng.randint(0, W, n)
    pos = cloud["pos"][row, col] + rng.randn(n, 3).astype(np.float32) * 0.1
    weight = (rng.rand(n) * 0.5 + 0.01).astype(np.float32)
    track = rng.randint(0, 3, n)
    forget = rng.randint(0, 6, n)
    visible = np.ones(n, bool)
    if kind in ("crowded", "no_real"):
        # 18 entries in pixel (5, 7) (15 visible), 6 in pixel (11, 20): ties
        # in weight, signed zeros, an invisible entry with the largest weight
        crowd_w = np.array([0.3, 0.3, 0.7, 0.3, 0.1, 0.7, 0.0, -0.0, 0.3, 0.05, 0.7, 0.2, 0.2,
                            0.9, 0.3, 0.7, 0.0, 0.3, 0.4, 0.4, 0.4, 0.1, 0.4, 0.4], np.float32)
        m = crowd_w.shape[0]
        crowd_px = np.array([(5, 7)] * 18 + [(11, 20)] * 6)
        row = np.concatenate([row, crowd_px[:, 0]])
        col = np.concatenate([col, crowd_px[:, 1]])
        pos = np.concatenate([pos, cloud["pos"][crowd_px[:, 0], crowd_px[:, 1]]
                              + rng.randn(m, 3).astype(np.float32) * 0.05])
        weight = np.concatenate([weight, crowd_w])
        track = np.concatenate([track, rng.randint(0, 3, m)])
        forget = np.concatenate([forget, rng.randint(0, 6, m)])
        vis_crowd = np.ones(m, bool)
        vis_crowd[13] = False
        visible = np.concatenate([visible, vis_crowd])
        visible[::9] = False
        n += m
    if kind == "no_real":
        visible[:] = False
    P = n + 24
    order = rng.permutation(P)  # padding and real entries interleaved
    pad = lambda a, fill: np.concatenate([a, np.full((P - n,) + a.shape[1:], fill, a.dtype)])[order]
    real = pad(np.ones(n, bool), False)
    vis = dict(
        vox=np.where(real, pad(rng.permutation(V)[:n], 0), -1).astype(np.int32),
        slot=pad(rng.randint(0, K, n), 0).astype(np.int32),
        row=pad(row, 0).astype(np.int32), col=pad(col, 0).astype(np.int32),
        pos=pad(pos, 0.0).astype(np.float32), weight=pad(weight, 0.0).astype(np.float32),
        track=pad(track, -1).astype(np.int32), forget=pad(forget, 0).astype(np.int32),
        visible=pad(visible, False),
    )
    vis["count"] = np.int32(int((real & vis["visible"]).sum()))
    return (cfg_j, cfg_t), vis, cloud, _store(rng, V, K)


def _jax_vis(vis):
    return JVisibleSet(**{k: jnp.asarray(v) for k, v in vis.items()})


def _params(name):
    kw = PARAMS[name]
    return JFilterParams(**kw), FilterParams(**kw)


def _assert_table(tt, jt):
    for name in jt._fields:
        np.testing.assert_array_equal(
            getattr(tt, name).numpy(), np.asarray(getattr(jt, name)), err_msg=name)


@pytest.mark.parametrize("S", [12, 4])
@pytest.mark.parametrize("kind", ["phd", "crowded", "no_real"])
def test_build_pixel_table_equals_jax(kind, S):
    (cfg_j, cfg_t), vis, _, _ = _case(kind, S=S)
    jt = jphd.build_pixel_table(cfg_j, _jax_vis(vis))
    tt = tphd.build_pixel_table(cfg_t, visible_set_from_numpy(vis, "cpu"))
    _assert_table(tt, jt)
    if kind == "crowded":
        assert int(tt.dropped) > 0  # the crowded pixel overflows S = 4 and 12
    if kind == "no_real":
        assert int(tt.dropped) == 0 and not bool((tt.meta >= 0).any())


@pytest.mark.parametrize("weights", ["ties", "signed_zeros_and_nan", "random"])
def test_rank_in_pixel_equals_jax(weights):
    """The rank of each entry among its pixel's, higher weight first: JAX's
    ``lexsort((-weight, key))`` against ``stable_lexsort(key, -weight)`` and
    ``group_rank``, with every entry's index as the tie-break."""
    rng = np.random.RandomState(4)
    P = 300
    key = rng.randint(0, 12, P).astype(np.int32)
    if weights == "ties":
        w = rng.choice([0.1, 0.25, 0.5], P).astype(np.float32)
    elif weights == "signed_zeros_and_nan":
        w = rng.choice([0.0, -0.0, 0.5, np.nan, -np.inf, np.inf], P).astype(np.float32)
    else:
        w = rng.rand(P).astype(np.float32)
    want = np.asarray(jphd._rank_in_pixel(jnp.asarray(key), jnp.asarray(w), P))
    got = tphd._rank_in_pixel(torch.from_numpy(key), torch.from_numpy(w), P)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("S", [12, 4])
@pytest.mark.parametrize("kind", ["phd", "crowded", "no_real"])
@pytest.mark.parametrize("filt", sorted(PARAMS))
def test_compute_ck_kappa_and_phd_weight_update_equal_jax(filt, kind, S):
    (cfg_j, cfg_t), vis, cloud, store = _case(kind, seed=0 if filt == "joint" else 1, S=S)
    pj, pt = _params(filt)
    jv, tv = _jax_vis(vis), visible_set_from_numpy(vis, "cpu")
    jc = JCloud(**{k: jnp.asarray(v) for k, v in cloud.items()})
    tc = LabeledCloud(**{k: torch.from_numpy(v) for k, v in cloud.items()})

    ck_j = np.asarray(jphd.compute_ck_kappa(cfg_j, pj, jv, jc))
    ck_t = tphd.compute_ck_kappa(cfg_t, pt, tv, tc)
    np.testing.assert_allclose(ck_t.numpy(), ck_j, rtol=RTOL, atol=ATOL)

    jp = jphd.phd_weight_update(cfg_j, pj, jv, jc, JParticles(
        **{k: jnp.asarray(v) for k, v in store.items()}), jnp.int32(7))
    tp = Particles(**{k: torch.from_numpy(v.astype(np.int32) if k == "track" else v.copy())
                      for k, v in store.items()})
    out = tphd.phd_weight_update(cfg_t, pt, tv, tc, tp, torch.tensor(7, dtype=torch.int32))
    assert out is tp  # written in place
    for name in FIELDS:
        got, want = getattr(tp, name).numpy(), np.asarray(getattr(jp, name))
        if name in ("px", "py", "pz", "weight"):
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)
        else:
            np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64),
                                          err_msg=name)
    changed = tp.stamp.numpy() != store["stamp"]
    if kind == "no_real":
        assert not changed.any()
    else:
        assert changed.sum() > 20


def test_phd_weight_update_of_an_empty_set_changes_nothing():
    """A VisibleSet with no entry at all (P = 0; the JAX package's
    ``group_rank`` takes no empty input, so this is the port's alone)."""
    (_, cfg_t), vis, cloud, store = _case("phd")
    empty = {k: (v[:0] if k != "count" else np.int32(0)) for k, v in vis.items()}
    _, pt = _params("joint")
    tc = LabeledCloud(**{k: torch.from_numpy(v) for k, v in cloud.items()})
    tp = Particles(**{k: torch.from_numpy(v.astype(np.int32) if k == "track" else v.copy())
                      for k, v in store.items()})
    tphd.phd_weight_update(cfg_t, pt, visible_set_from_numpy(empty, "cpu"), tc, tp, 7)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(tp, name).numpy().astype(np.float64),
                                      store[name].astype(np.float64), err_msg=name)
    # no particle: ck_kappa is the clutter term kappa at every pixel
    ck = tphd.compute_ck_kappa(cfg_t, pt, visible_set_from_numpy(empty, "cpu"), tc)
    assert torch.equal(ck, torch.full_like(ck, pt.noise_number))
