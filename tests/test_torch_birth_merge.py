"""Birth's merge stage (``ops.birth.merge_blocks_plain``, the CPU path of
``_insert_core`` and the oracle of the CUDA kernel of csrc/birth.cu)
against the JAX package's ``_insert_core``: every vacancy pattern of a K = 3
voxel with 0 to K staged candidates, K = 7 and K = 31 at random on the grid
and on a voxel slab, stale slots, a voxel whose resample wipes and one that walks,
resample on and off.  Integers equal, floats at rtol 2e-5 (the merge moves
floats and the resample walk is a sequential f32 walk in both, so they are
equal in practice).  Also: the CPU path never imports ops/birth_cuda.py,
``merge_blocks`` runs the plain version on CPU tensors and the kernel's
wrapper refuses them."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_dsp_map_tpu.config import tiny_test_config as j_tiny
from semantic_dsp_map_tpu.ops import birth as jbirth
from semantic_dsp_map_tpu.ops import codecs as jcodecs
from semantic_dsp_map_tpu.state import init_map_state as j_init

from semantic_dsp_map_tpu_torch.config import tiny_test_config
from semantic_dsp_map_tpu_torch.ops import birth as tbirth
from semantic_dsp_map_tpu_torch.ops.blocks import ActiveBlocks
from semantic_dsp_map_tpu_torch.state import (
    STATUS_INVALID, STATUS_REGULAR_BORN, STATUS_UPDATED, Particles, map_state_from_numpy,
)

from torch_parity import jax_state_to_numpy, merge_working_set

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("px", "py", "pz", "weight", "label", "track", "status", "forget", "stamp")
EGO = np.array([0.3, -0.1, 0.6], np.float32)


def _configs(slots_n):
    return j_tiny(max_particle_num_per_voxel_n=slots_n), tiny_test_config(
        max_particle_num_per_voxel_n=slots_n)


def _jax_state(cfg, fields):
    """A JAX state with the scroll moved (stale axis stamps) and the given
    particle fields."""
    s = j_init(cfg)
    scroll = jcodecs.update_ego_center(cfg, s.scroll, jnp.asarray(EGO), jnp.int32(3))
    p = s.particles.replace(**{k: jnp.asarray(v) for k, v in fields.items()})
    return s.replace(particles=p, scroll=scroll, global_time=jnp.int32(4))


def _candidates(d):
    return (jbirth.Candidates(**{k: jnp.asarray(v) for k, v in d.items()}),
            tbirth.Candidates(**{k: torch.from_numpy(v) for k, v in d.items()}))


def _run_both(cfg_j, cfg_t, js, d, resample, slab=None):
    """Both ``_insert_core``s on ``js`` and the candidates ``d``; with
    ``slab = (rank, D)`` on that z-slab of the store, the candidates' voxel
    ids, validity and the slab's scroll stamps given as the sharded step
    gives them.  Returns (port result, JAX result)."""
    ts = map_state_from_numpy(jax_state_to_numpy(js), device="cpu")
    jc, tc = _candidates(d)
    jp, tp, kw_j, kw_t = js.particles, ts.particles, {}, {}
    if slab is not None:
        rank, D = slab
        V_loc = cfg_t.num_voxels // D
        n = V_loc * cfg_t.slots_per_voxel
        cut = slice(rank * n, (rank + 1) * n)
        jp = jp.replace(**{f: getattr(jp, f)[cut] for f in FIELDS})
        tp = Particles(**{f: getattr(tp, f)[cut].clone() for f in FIELDS})
        vox, _, _, _, in_map = jcodecs.global_pos_to_voxel(cfg_j, js.scroll, jc.pos)
        vox, ok = np.asarray(vox), np.asarray(jc.valid & in_map)
        mine = ok & (vox // V_loc == rank)
        local = np.where(mine, vox - rank * V_loc, V_loc).astype(np.int32)
        nz_loc = cfg_j.nz // D
        axis = jcodecs.axis_stamps_per_voxel_slab(cfg_j, js.scroll, rank * nz_loc, nz_loc)
        kw_j = dict(vox=jnp.asarray(local), valid=jnp.asarray(mine), vox_axis=axis)
        kw_t = dict(vox=torch.from_numpy(local), valid=torch.from_numpy(mine),
                    vox_axis=torch.from_numpy(np.array(axis)))
    jr = jbirth._insert_core(cfg_j, jp, js.scroll, jc, resample_targets=resample, need_src=False,
                             **kw_j)
    tr = tbirth._insert_core(cfg_t, tp, ts.scroll, tc, resample_targets=resample, **kw_t)
    return tr, jr


def _assert_same(tr, jr):
    assert tr.accepted_count.dtype == torch.int64 and tr.accepted_count.shape == ()
    assert int(tr.accepted_count) == int(jr.accepted_count)
    assert int(tr.block_overflow) == int(jr.block_overflow)
    for name in FIELDS:
        t, j = getattr(tr.particles, name).numpy(), np.asarray(getattr(jr.particles, name))
        if t.dtype == np.float32:
            np.testing.assert_allclose(t, j, rtol=2e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(t.astype(np.int64), j.astype(np.int64), err_msg=name)


def _voxel_candidates(cfg_j, js, voxels, counts, rng, extra=0):
    """``counts[i]`` candidates inside voxel ``voxels[i]`` (off its
    faces), random fields and priorities, plus ``extra`` scattered ones."""
    corner = np.asarray(jcodecs.voxel_to_global_pos(cfg_j, js.scroll, jnp.asarray(voxels)))
    pos = np.repeat(corner, counts, axis=0)
    pos = pos + rng.uniform(0.2, 0.8, pos.shape) * cfg_j.voxel_size
    if extra:
        pos = np.concatenate([pos, rng.randn(extra, 3) * 0.8 + EGO])
    n = pos.shape[0]
    return dict(
        pos=pos.astype(np.float32),
        weight=rng.rand(n).astype(np.float32),
        label=rng.randint(0, 9, n).astype(np.int32),
        track=rng.randint(0, 6, n).astype(np.int32),
        status=rng.randint(1, 4, n).astype(np.int32),
        stamp=rng.randint(1, 5, n).astype(np.int32),
        forget=rng.randint(0, 5, n).astype(np.int32),
        priority=rng.permutation(n).astype(np.int32),
        valid=np.ones(n, bool),
    )


@pytest.mark.parametrize("resample", [False, True])
def test_every_vacancy_pattern_of_a_k3_voxel(resample):
    """K = 3: each of the 2^3 vacancy patterns with 0 to 3 candidates, in a
    voxel of its own; a vacant slot is empty or stale at random, an
    occupied one UPDATED (so a full voxel may resample) or REGULAR_BORN."""
    cfg_j, cfg_t = _configs(2)
    K, V = cfg_t.slots_per_voxel, cfg_t.num_voxels
    rng = np.random.RandomState(11)
    js = _jax_state(cfg_j, {})
    axis = np.asarray(jcodecs.axis_stamps_per_voxel(cfg_j, js.scroll))
    # voxels near the ego, so that the candidates land in the map
    near = np.flatnonzero(np.linalg.norm(
        np.asarray(jcodecs.voxel_to_global_pos(cfg_j, js.scroll, jnp.arange(V))) - EGO, axis=1) < 1.2)
    combos = [(p, c) for p in range(1 << K) for c in range(K + 1)]
    voxels = rng.choice(near, len(combos), replace=False)
    status = np.zeros(V * K, np.uint8)
    stamp = np.zeros(V * K, np.int32)
    weight = (rng.rand(V * K) * 0.8).astype(np.float32)
    for v, (pattern, _) in zip(voxels, combos):
        for k in range(K):
            i = v * K + k
            if pattern >> k & 1:  # vacant: empty, or stale (a stamp below the voxel's)
                if rng.rand() < 0.5:
                    status[i], stamp[i] = STATUS_UPDATED, axis[v] - 1
            else:
                status[i] = STATUS_UPDATED if rng.rand() < 0.8 else STATUS_REGULAR_BORN
                stamp[i] = axis[v] + rng.randint(0, 3)
    js = _jax_state(cfg_j, dict(status=status, stamp=stamp, weight=weight,
                                px=rng.randn(V * K).astype(np.float32)))
    d = _voxel_candidates(cfg_j, js, voxels, [c for _, c in combos], rng)
    tr, jr = _run_both(cfg_j, cfg_t, js, d, resample)
    _assert_same(tr, jr)
    assert int(tr.accepted_count) > 0


@pytest.mark.parametrize("form", ["grid", "slab"])
@pytest.mark.parametrize("resample", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_k7_at_random(seed, resample, form):
    """K = 7 (the VKITTI2 preset's), random store with stale slots, crowded
    voxels and scattered candidates, on the whole grid and on one rank's
    z-slab of four."""
    cfg_j, cfg_t = _configs(3)
    K, V = cfg_t.slots_per_voxel, cfg_t.num_voxels
    rng = np.random.RandomState(100 + seed)
    n = V * K
    js = _jax_state(cfg_j, dict(
        px=rng.randn(n).astype(np.float32),
        weight=np.where(rng.rand(n) < 0.1, 1e-4, rng.rand(n) * 0.8).astype(np.float32),
        status=rng.choice([0, 1, 2], n, p=[0.3, 0.6, 0.1]).astype(np.uint8),
        track=rng.randint(0, 6, n).astype(np.uint16),
        label=rng.randint(0, 9, n).astype(np.uint8),
        forget=rng.randint(0, 4, n).astype(np.uint8),
        stamp=rng.randint(0, 5, n).astype(np.int32),
    ))
    voxels = rng.choice(V, 60, replace=False)
    d = _voxel_candidates(cfg_j, js, voxels, rng.randint(0, K + 3, 60), rng, extra=400)
    slab = (1, 4) if form == "slab" else None
    tr, jr = _run_both(cfg_j, cfg_t, js, d, resample, slab)
    _assert_same(tr, jr)
    assert int(tr.accepted_count) > 0


@pytest.mark.parametrize("form", ["grid", "slab"])
@pytest.mark.parametrize("resample", [False, True])
def test_k31_at_random(resample, form):
    """K = 31 (max_particle_num_per_voxel_n = 5, the largest K the CUDA
    kernels take; rows of 16 voxels): a random store with stale slots,
    voxels of the first 16 blocks with up to K + 3 candidates each (a voxel
    resamples when more than 16 of its slots are UPDATED), on the whole
    grid and on one rank's z-slab of four."""
    cfg_j, cfg_t = _configs(5)
    K, V = cfg_t.slots_per_voxel, cfg_t.num_voxels
    bv = tbirth.block_layout(cfg_t)[0]
    assert (K, bv) == (31, 16)
    rng = np.random.RandomState(31)
    n = V * K
    js = _jax_state(cfg_j, dict(
        px=rng.randn(n).astype(np.float32),
        weight=np.where(rng.rand(n) < 0.1, 1e-4, rng.rand(n) * 0.8).astype(np.float32),
        status=rng.choice([0, 1, 2], n, p=[0.3, 0.6, 0.1]).astype(np.uint8),
        track=rng.randint(0, 6, n).astype(np.uint16),
        label=rng.randint(0, 9, n).astype(np.uint8),
        forget=rng.randint(0, 4, n).astype(np.uint8),
        stamp=rng.randint(0, 5, n).astype(np.int32),
    ))
    voxels = rng.choice(16 * bv, 48, replace=False)
    d = _voxel_candidates(cfg_j, js, voxels, rng.randint(0, K + 4, 48), rng, extra=40)
    slab = (1, 4) if form == "slab" else None
    tr, jr = _run_both(cfg_j, cfg_t, js, d, resample, slab)
    _assert_same(tr, jr)
    assert int(tr.accepted_count) > 0


def test_resample_wipes_one_voxel_and_walks_another():
    """K = 3, resample on: two full voxels of UPDATED particles, each
    targeted by one candidate.  Weights 1e-3 sum below 0.01: the voxel is
    wiped and the candidate takes slot 0.  Weights 0.5, 0.2, 0.9: wpp =
    min(1.6 / 2, 1) = 0.8 (in f32 sums), slots 0 and 1 fall below their thresholds and are
    deleted, slot 2 is kept with weight 0.8, and the candidate takes slot
    0."""
    cfg_j, cfg_t = _configs(2)
    K, V = cfg_t.slots_per_voxel, cfg_t.num_voxels
    js = _jax_state(cfg_j, {})
    axis = np.asarray(jcodecs.axis_stamps_per_voxel(cfg_j, js.scroll))
    centre = np.asarray(jcodecs.voxel_to_global_pos(cfg_j, js.scroll, jnp.arange(V)))
    wipe, walk = np.argsort(np.linalg.norm(centre - EGO, axis=1))[:2]
    status = np.zeros(V * K, np.uint8)
    stamp = np.zeros(V * K, np.int32)
    weight = np.zeros(V * K, np.float32)
    for v, w in ((wipe, [1e-3] * 3), (walk, [0.5, 0.2, 0.9])):
        status[v * K:(v + 1) * K] = STATUS_UPDATED
        stamp[v * K:(v + 1) * K] = axis[v]
        weight[v * K:(v + 1) * K] = w
    js = _jax_state(cfg_j, dict(status=status, stamp=stamp, weight=weight))
    d = _voxel_candidates(cfg_j, js, np.array([wipe, walk]), [1, 1], np.random.RandomState(3))
    tr, jr = _run_both(cfg_j, cfg_t, js, d, True)
    _assert_same(tr, jr)
    st = tr.particles.status.view(V, K)
    w = tr.particles.weight.view(V, K)
    assert st[wipe, 1:].tolist() == [STATUS_INVALID] * 2 and st[wipe, 0] != STATUS_INVALID
    assert st[walk, 1] == STATUS_INVALID and st[walk, 0] != STATUS_INVALID
    f32 = np.float32
    assert st[walk, 2] == STATUS_UPDATED
    assert float(w[walk, 2]) == (f32(0.5) + f32(0.2) + f32(0.9)) / f32(2)  # f32 sums
    assert int(tr.accepted_count) == 2


def _working_set(cfg, seed, n_real):
    """merge_working_set at ``cfg``'s block layout, as CPU tensors."""
    K = cfg.slots_per_voxel
    bv, nb, _spb = tbirth.block_layout(cfg)
    A = min(cfg.max_birth_blocks, nb)
    d = merge_working_set(K, bv, A, n_real, nb, seed)
    T = lambda k: torch.from_numpy(d[k]).clone()
    flat = Particles(**{k: T(k) for k in FIELDS})
    blocks = ActiveBlocks(ids=T("ids"), count=torch.tensor(d["count"]),
                          overflow=torch.zeros((), dtype=torch.int64))
    staged = tbirth.Staged(*(T(k) for k in ("in_px", "in_py", "in_pz", "in_w", "in_stamp",
                                            "in_meta")))
    return flat, blocks, T("vox_axis"), staged


@pytest.mark.parametrize("resample", [False, True])
def test_merge_blocks_runs_the_plain_merge_on_cpu_tensors(resample):
    """``merge_blocks`` on CPU tensors is ``merge_blocks_plain`` (the same
    bits, a 0-d int64 count); the merge touches only the real rows.  The
    kernel's wrapper takes CUDA tensors only: on CPU tensors it raises and
    counts no launch."""
    from semantic_dsp_map_tpu_torch.ops.birth_cuda import merge_blocks_cuda

    cfg = tiny_test_config()
    K = cfg.slots_per_voxel
    bv, _nb, spb = tbirth.block_layout(cfg)
    flat_p, blocks, vax, staged = _working_set(cfg, 4, 9)
    flat_k = _working_set(cfg, 4, 9)[0]
    before = {k: getattr(flat_p, k).clone() for k in FIELDS}
    launches = merge_blocks_cuda.launches
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        merge_blocks_cuda(cfg, flat_k, blocks, vax, staged, resample)
    assert merge_blocks_cuda.launches == launches
    for k in FIELDS:
        assert torch.equal(getattr(flat_k, k), before[k]), k
    _, acc_p = tbirth.merge_blocks_plain(cfg, flat_p, blocks, vax, staged, resample)
    _, acc_k = tbirth.merge_blocks(cfg, flat_k, blocks, vax, staged, resample)
    assert acc_k.dtype == acc_p.dtype == torch.int64 and acc_k.shape == acc_p.shape == ()
    assert int(acc_k) == int(acc_p) > 0
    real = torch.zeros(flat_p.px.shape[0] // spb, dtype=torch.bool)
    real[blocks.ids[:9]] = True
    for k in FIELDS:
        assert torch.equal(getattr(flat_k, k), getattr(flat_p, k)), k
        rows, old = getattr(flat_p, k).view(-1, spb), before[k].view(-1, spb)
        assert torch.equal(rows[~real], old[~real]), k
    assert not torch.equal(flat_p.status, before["status"])
    assert bv * K == spb


def test_cpu_path_never_imports_birth_cuda():
    """A CPU map inserts (birth and the moving-object cleanup on every
    frame) without loading ops/birth_cuda.py: the merge's plain version is
    the CPU path, and the wrapper module is for the card alone."""
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tests')\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from semantic_dsp_map_tpu_torch import FilterParams, MaskKpts, SemanticDSPMap, "
        "tiny_test_config\n"
        "from semantic_dsp_map_tpu_torch.ops import birth\n"
        "from torch_parity import dynamic_scene\n"
        "calls = []\n"
        "plain = birth.merge_blocks_plain\n"
        "birth.merge_blocks_plain = lambda *a: calls.append(1) or plain(*a)\n"
        "dsp = SemanticDSPMap(tiny_test_config(), FilterParams(), device='cpu')\n"
        "for t in range(3):\n"
        "    _, diag = dsp.update(*dynamic_scene(dsp.cfg, t, MaskKpts))\n"
        "assert int(diag.born_count) >= 0\n"
        "assert len(calls) == 6, len(calls)\n"
        "bad = [m for m in sys.modules if m.endswith('birth_cuda')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"
