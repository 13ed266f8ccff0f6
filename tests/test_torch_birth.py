"""The port's resampling, slot-constrained insertion and birth against the
JAX package: integer state equal, floats at rtol 2e-5 (resampling is a
sequential f32 walk in both, so equal in practice)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_dsp_map_tpu.config import FilterParams as JFilterParams
from semantic_dsp_map_tpu.config import tiny_test_config as j_tiny
from semantic_dsp_map_tpu.ops import birth as jbirth
from semantic_dsp_map_tpu.ops import codecs as jcodecs
from semantic_dsp_map_tpu.ops.projection import LabeledCloud as JCloud
from semantic_dsp_map_tpu.state import init_map_state as j_init

from semantic_dsp_map_tpu_torch.config import FilterParams, tiny_test_config
from semantic_dsp_map_tpu_torch.ops import birth as tbirth
from semantic_dsp_map_tpu_torch.ops.projection import LabeledCloud
from semantic_dsp_map_tpu_torch.state import map_state_from_numpy

from torch_parity import jax_state_to_numpy

torch.set_num_threads(2)

CFG_J, CFG_T = j_tiny(), tiny_test_config()


def _state(seed):
    """JAX state with random particles, stamps and a scrolled ego."""
    rng = np.random.RandomState(seed)
    V, K = CFG_J.num_voxels, CFG_J.slots_per_voxel
    s = j_init(CFG_J)
    scroll = jcodecs.update_ego_center(CFG_J, s.scroll, jnp.asarray([0.3, -0.1, 0.6], jnp.float32),
                                       jnp.int32(3))
    p = s.particles.replace(
        px=jnp.asarray(rng.randn(V * K).astype(np.float32)),
        weight=jnp.asarray((rng.rand(V * K) * 0.8).astype(np.float32)),
        status=jnp.asarray(rng.choice([0, 1, 2], V * K, p=[0.35, 0.5, 0.15]).astype(np.uint8)),
        track=jnp.asarray(rng.randint(0, 6, V * K).astype(np.uint16)),
        label=jnp.asarray(rng.randint(0, 9, V * K).astype(np.uint8)),
        forget=jnp.asarray(rng.randint(0, 4, V * K).astype(np.uint8)),
        stamp=jnp.asarray(rng.randint(0, 5, V * K).astype(np.int32)),
    )
    return s.replace(particles=p, scroll=scroll, global_time=jnp.int32(4))


def _assert_particles(tp, jp):
    for name in ("status", "track", "label", "forget", "stamp"):
        np.testing.assert_array_equal(getattr(tp, name).numpy().astype(np.int64),
                                      np.asarray(getattr(jp, name)).astype(np.int64), err_msg=name)
    for name in ("px", "py", "pz", "weight"):
        np.testing.assert_allclose(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                   rtol=2e-5, err_msg=name)


def test_resample_matches_jax():
    js = _state(3)
    ts = map_state_from_numpy(jax_state_to_numpy(js), device="cpu")
    target = np.random.RandomState(9).rand(CFG_J.num_voxels) > 0.3
    jp = jbirth.resample_voxels(CFG_J, js.particles, jnp.asarray(target))
    tp = tbirth.resample_voxels(CFG_T, ts.particles, torch.from_numpy(target))
    _assert_particles(tp, jp)
    assert (np.asarray(jp.status) != np.asarray(js.particles.status)).any()


def _candidates(rng, n, scroll_center):
    pos = (rng.randn(n, 3) * 0.6 + scroll_center).astype(np.float32)
    pos[::17] += 50.0  # out of the map
    d = dict(
        pos=pos,
        weight=rng.rand(n).astype(np.float32),
        label=rng.randint(0, 9, n).astype(np.int32),
        track=rng.randint(0, 6, n).astype(np.int32),
        status=rng.randint(1, 3, n).astype(np.int32),
        stamp=rng.randint(1, 5, n).astype(np.int32),
        forget=rng.randint(0, 5, n).astype(np.int32),
        priority=rng.permutation(n).astype(np.int32),
        valid=rng.rand(n) < 0.9,
    )
    return jbirth.Candidates(**{k: jnp.asarray(v) for k, v in d.items()}), \
        tbirth.Candidates(**{k: torch.from_numpy(v) for k, v in d.items()})


@pytest.mark.parametrize("resample", [False, True])
@pytest.mark.parametrize("cap", [None, 2])
def test_insert_core_matches_jax(resample, cap):
    """Crowded voxels (more candidates than vacancies), stale slots, and
    with ``cap`` a target-block capacity that overflows."""
    js = _state(5)
    ts = map_state_from_numpy(jax_state_to_numpy(js), device="cpu")
    jc, tc = _candidates(np.random.RandomState(6), 300, np.array([0.3, -0.1, 0.6]))
    jr = jbirth._insert_core(CFG_J, js.particles, js.scroll, jc, resample_targets=resample,
                             need_src=False, max_target_blocks=cap)
    tr = tbirth._insert_core(CFG_T, ts.particles, ts.scroll, tc, resample_targets=resample,
                             max_target_blocks=cap)
    assert int(tr.accepted_count) == int(jr.accepted_count) > 0
    assert int(tr.block_overflow) == int(jr.block_overflow)
    if cap:
        assert int(tr.block_overflow) > 0
    _assert_particles(tr.particles, jr.particles)


@pytest.mark.parametrize("resample", [False, True])
@pytest.mark.parametrize("rank", [1, 2])
def test_insert_core_on_a_voxel_slab_matches_jax(rank, resample):
    """Insertion into one rank's z-slab (D = 4) with explicit slab-local
    voxel ids, validity and per-voxel scroll stamps, as the sharded step
    calls it: the candidates of other slabs are invalid."""
    D = 4
    js = _state(5)
    ts = map_state_from_numpy(jax_state_to_numpy(js), device="cpu")
    V_loc, nz_loc = CFG_T.num_voxels // D, CFG_T.nz // D
    n = V_loc * CFG_T.slots_per_voxel
    cut = slice(rank * n, (rank + 1) * n)
    jp = js.particles.replace(**{f: getattr(js.particles, f)[cut] for f in
                                 ("px", "py", "pz", "weight", "label", "track", "status", "forget", "stamp")})
    tp = tbirth.Particles(**{f: getattr(ts.particles, f)[cut].clone() for f in
                             ("px", "py", "pz", "weight", "label", "track", "status", "forget", "stamp")})
    jc, tc = _candidates(np.random.RandomState(6), 600, np.array([0.3, -0.1, 0.6]))
    vox, _, _, _, in_map = jcodecs.global_pos_to_voxel(CFG_J, js.scroll, jc.pos)
    vox, ok = np.asarray(vox), np.asarray(jc.valid & in_map)
    mine = ok & (vox // V_loc == rank)
    local = np.where(mine, vox - rank * V_loc, V_loc).astype(np.int32)
    assert mine.sum() > 20
    jax_axis = jcodecs.axis_stamps_per_voxel_slab(CFG_J, js.scroll, rank * nz_loc, nz_loc)
    jr = jbirth._insert_core(CFG_J, jp, js.scroll, jc, resample_targets=resample, need_src=False,
                             vox=jnp.asarray(local), valid=jnp.asarray(mine), vox_axis=jax_axis)
    tr = tbirth._insert_core(CFG_T, tp, ts.scroll, tc, resample_targets=resample,
                             vox=torch.from_numpy(local), valid=torch.from_numpy(mine),
                             vox_axis=torch.from_numpy(np.array(jax_axis)))
    assert int(tr.accepted_count) == int(jr.accepted_count) > 0
    assert int(tr.block_overflow) == int(jr.block_overflow)
    _assert_particles(tr.particles, jr.particles)


def test_birth_and_resample_matches_jax():
    rng = np.random.RandomState(8)
    H, W = CFG_J.height, CFG_J.width
    js = _state(7)
    ts = map_state_from_numpy(jax_state_to_numpy(js), device="cpu")
    cloud = dict(
        pos=(rng.randn(H, W, 3) * 0.8 + np.array([0.3, -0.1, 0.6])).astype(np.float32),
        sigma=np.full((H, W), 0.2, np.float32),
        label=rng.randint(0, 9, (H, W)).astype(np.int32),
        track=rng.randint(0, 6, (H, W)).astype(np.int32),
        valid=rng.rand(H, W) < 0.8,
    )
    kw = dict(if_consider_depth_noise=True, nb_ptc_num_per_point=1)
    gt = 5
    jp, jborn, jov, jcand = jbirth.birth_and_resample(
        CFG_J, JFilterParams(**kw), js.particles, js.scroll,
        JCloud(**{k: jnp.asarray(v) for k, v in cloud.items()}), jnp.int32(gt),
        jax.random.PRNGKey(0),
    )
    tp, tborn, tov, tcand = tbirth.birth_and_resample(
        CFG_T, FilterParams(**kw), ts.particles, ts.scroll,
        LabeledCloud(**{k: torch.from_numpy(v) for k, v in cloud.items()}),
        torch.tensor(gt, dtype=torch.int32), torch.Generator().manual_seed(0),
    )
    for name in jcand._fields:
        np.testing.assert_array_equal(getattr(tcand, name).numpy(), np.asarray(getattr(jcand, name)),
                                      err_msg=name)
    assert int(tborn) == int(jborn) > 0
    assert int(tov) == int(jov)
    _assert_particles(tp, jp)


# ---------------------------------------------------------------------------
# insert_particles: the per-candidate acceptance (need_src)
# ---------------------------------------------------------------------------

def _insert_both(cfg_j, cfg_t, js, jc, tc):
    """insert_particles on both sides; the port's store is a fresh copy of
    the JAX one.  Returns (JAX result, port result)."""
    ts = map_state_from_numpy(jax_state_to_numpy(js), device="cpu")
    jr = jbirth.insert_particles(cfg_j, js.particles, js.scroll, jc)
    tr = tbirth.insert_particles(cfg_t, ts.particles, ts.scroll, tc)
    assert tr[0] is ts.particles  # written in place
    assert tr[1].dtype == torch.bool and tr[2].dtype == torch.int32
    _assert_particles(tr[0], jr[0])
    np.testing.assert_array_equal(tr[1].numpy(), np.asarray(jr[1]), err_msg="accepted")
    np.testing.assert_array_equal(tr[2].numpy(), np.asarray(jr[2]), err_msg="vox")
    return jr, tr


def _few(pos, weight, label, priority, stamp=2):
    n = len(pos)
    d = dict(
        pos=np.asarray(pos, np.float32), weight=np.asarray(weight, np.float32),
        label=np.asarray(label, np.int32), track=np.full(n, 7, np.int32),
        status=np.full(n, 2, np.int32), stamp=np.full(n, stamp, np.int32),
        forget=np.zeros(n, np.int32), priority=np.asarray(priority, np.int32),
        valid=np.ones(n, bool),
    )
    return jbirth.Candidates(**{k: jnp.asarray(v) for k, v in d.items()}), \
        tbirth.Candidates(**{k: torch.from_numpy(v) for k, v in d.items()})


def test_insert_particles_first_vacant_and_capacity_matches_jax():
    """tests/test_birth.py's first case: 4 candidates into one voxel of K = 3
    slots with slot 1 taken; the two lowest priorities are accepted."""
    K = CFG_J.slots_per_voxel
    js = j_init(CFG_J)
    p0 = np.array([[0.1, 0.1, 0.1]], np.float32)
    v0 = int(np.asarray(jcodecs.global_pos_to_voxel(CFG_J, js.scroll, jnp.asarray(p0))[0])[0])
    p = js.particles
    js = js.replace(particles=p.replace(status=p.status.at[v0 * K + 1].set(1),
                                        stamp=p.stamp.at[v0 * K + 1].set(1)))
    jc, tc = _few(np.repeat(p0, 4, 0), [0.1, 0.2, 0.3, 0.4], [0, 1, 2, 3], [5, 2, 9, 0])
    _, tr = _insert_both(CFG_J, CFG_T, js, jc, tc)
    np.testing.assert_array_equal(tr[1].numpy(), [False, True, False, True])


def test_insert_particles_out_of_map_dropped_matches_jax():
    """tests/test_birth.py's second case: an out-of-map candidate is not
    accepted and its voxel is num_voxels."""
    jc, tc = _few([[100.0, 0, 0], [0.1, 0.1, 0.1]], [0.05, 0.05], [0, 0], [0, 1], stamp=1)
    _, tr = _insert_both(CFG_J, CFG_T, j_init(CFG_J), jc, tc)
    np.testing.assert_array_equal(tr[1].numpy(), [False, True])
    assert int(tr[2][0]) == CFG_T.num_voxels


@pytest.mark.parametrize("blocks", [None, 4])
def test_insert_particles_crowded_matches_jax(blocks):
    """A seeded batch: more candidates than K a voxel, stale and live slots,
    invalid and out-of-map candidates, and with ``blocks`` a birth capacity
    of 4 target blocks that overflows (candidates of the blocks past it are
    not accepted)."""
    kw = {} if blocks is None else dict(max_birth_blocks=blocks)
    cfg_j, cfg_t = j_tiny(**kw), tiny_test_config(**kw)
    js = _state(11)
    jc, tc = _candidates(np.random.RandomState(12), 700, np.array([0.3, -0.1, 0.6]))
    jr, tr = _insert_both(cfg_j, cfg_t, js, jc, tc)
    acc, vox = tr[1].numpy(), tr[2].numpy()
    counts = np.bincount(vox[vox < cfg_t.num_voxels], minlength=cfg_t.num_voxels)
    assert counts.max() > cfg_t.slots_per_voxel  # voxels with more candidates than slots
    assert (vox == cfg_t.num_voxels).sum() > 30  # invalid or out of the map
    assert 0 < acc.sum() < (vox < cfg_t.num_voxels).sum()
    res = jbirth._insert_core(cfg_j, js.particles, js.scroll, jc, resample_targets=False)
    if blocks:
        assert int(res.block_overflow) > 0
    assert int(acc.sum()) == int(res.accepted_count)


@pytest.mark.parametrize("resample", [False, True])
def test_insert_core_need_src_matches_jax(resample):
    """``_insert_core(need_src=True)``: the staged acceptance and source
    index equal the JAX package's ([A, spb] there, [A, bv, K] here), and the
    store and count equal those of ``need_src=False``, which leaves both
    None."""
    js = _state(5)
    jc, tc = _candidates(np.random.RandomState(6), 300, np.array([0.3, -0.1, 0.6]))
    jr = jbirth._insert_core(CFG_J, js.particles, js.scroll, jc, resample_targets=resample)
    with_src = map_state_from_numpy(jax_state_to_numpy(js), device="cpu")
    without = map_state_from_numpy(jax_state_to_numpy(js), device="cpu")
    tr = tbirth._insert_core(CFG_T, with_src.particles, with_src.scroll, tc,
                             resample_targets=resample, need_src=True)
    t0 = tbirth._insert_core(CFG_T, without.particles, without.scroll, tc,
                             resample_targets=resample)
    assert t0.accepted_staged is None and t0.staged_src is None
    A = tr.accepted_staged.shape[0]
    np.testing.assert_array_equal(tr.accepted_staged.reshape(A, -1).numpy(),
                                  np.asarray(jr.accepted_staged))
    np.testing.assert_array_equal(tr.staged_src.reshape(A, -1).numpy(), np.asarray(jr.staged_src))
    assert int(tr.accepted_count) == int(t0.accepted_count) == int(jr.accepted_count) > 0
    assert int(tr.accepted_staged.sum()) == int(tr.accepted_count)
    for f in tbirth.Particles.__dataclass_fields__:
        a, b = getattr(tr.particles, f), getattr(t0.particles, f)
        assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b), f
    _assert_particles(tr.particles, jr.particles)
