"""The port's occupancy render against the JAX package's XLA reduction:
occ / label / track / new status equal, weight_sum and new weight at
rtol 2e-5.  Inputs: seeded random states (the generator of
tests/test_render_pallas.py) and a JAX state dumped after a few frames of
the dynamic scene.  The CUDA kernel is held against the plain reduction in
tests/test_torch_kernels_gpu.py; the plain reduction is also held against the
Pallas kernel in interpret mode on the stores that kernel's design has to
get right (every slot dead, every slot alive, a map empty but for one
stretch, stale voxel stamps) with K = 1, 3 and 7."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import semantic_dsp_map_tpu as J
from semantic_dsp_map_tpu.frontend import build_frame_input
from semantic_dsp_map_tpu.ops.render import render_occupancy_xla as j_render
from semantic_dsp_map_tpu.ops.render_pallas import render_core_pallas
from semantic_dsp_map_tpu.state import init_map_state as j_init

from semantic_dsp_map_tpu_torch.config import tiny_test_config
from semantic_dsp_map_tpu_torch.ops import codecs
from semantic_dsp_map_tpu_torch.ops.render import render_core_plain, render_occupancy
from semantic_dsp_map_tpu_torch.ops.render_cuda import render_core_cuda
from semantic_dsp_map_tpu_torch.state import map_state_from_numpy

from torch_parity import STORE_EDGES, dynamic_scene, jax_state_to_numpy, render_store

torch.set_num_threads(2)


def _random_jax_state(seed):
    cfg = J.config.tiny_test_config()
    rng = np.random.RandomState(seed)
    V, K = cfg.num_voxels, cfg.slots_per_voxel
    state = j_init(cfg)
    status = rng.choice([0, 1, 2, 3], size=V * K, p=[0.3, 0.4, 0.2, 0.1]).astype(np.uint8)
    weight = (rng.rand(V * K) * 1.4).astype(np.float32)
    weight[: V * K // 8] *= 0.05  # hit the GC path
    state = state.replace(
        particles=state.particles.replace(
            status=jnp.asarray(status),
            weight=jnp.asarray(weight),
            track=jnp.asarray(rng.randint(0, 4, V * K).astype(np.uint16)),
            label=jnp.asarray(rng.randint(0, 8, V * K).astype(np.uint8)),
            stamp=jnp.asarray(rng.randint(0, 3, V * K).astype(np.int32)),
        ),
        voxel_stamp=jnp.asarray(rng.randint(0, 3, V).astype(np.int32)),
    )
    sc = state.scroll.replace(
        axis_stamp_x=jnp.asarray(rng.randint(0, 2, cfg.nx).astype(np.int32)),
        axis_stamp_y=jnp.asarray(rng.randint(0, 2, cfg.ny).astype(np.int32)),
    )
    return state.replace(scroll=sc)


def _dumped_jax_state(n_frames):
    kw = dict(if_consider_depth_noise=True, nb_ptc_num_per_point=1,
              depth_noise_model_zero_order=0.2, prediction_stddev=0.0)
    jm = J.SemanticDSPMap(J.config.tiny_test_config(), J.FilterParams(**kw))
    for t in range(n_frames):
        d, m, p, q, tt = dynamic_scene(jm.cfg, t, J.MaskKpts)
        jm.update_from_frame(build_frame_input(jm.cfg, jm.registry, d, m, p, q, tt))
    # weights above 1 and feeble UPDATED particles exercise both side effects
    w = np.asarray(jm.state.particles.weight).copy()
    w[::5] *= 3.0
    w[1::7] *= 0.01
    return jm.state.replace(particles=jm.state.particles.replace(weight=jnp.asarray(w)))


@pytest.mark.parametrize("source", ["random5", "random17", "frames6"])
@pytest.mark.parametrize("thr", [0.2, 0.4])
def test_render_matches_jax(source, thr):
    js = _dumped_jax_state(6) if source == "frames6" else _random_jax_state(int(source[6:]))
    cfg = tiny_test_config()
    ts = map_state_from_numpy(jax_state_to_numpy(js), device="cpu")

    jp, jr = j_render(J.config.tiny_test_config(), js, thr)
    tp, tr = render_occupancy(cfg, ts, thr)

    for name in ("occ", "label", "track"):
        np.testing.assert_array_equal(getattr(tr, name).numpy(), np.asarray(getattr(jr, name)),
                                      err_msg=name)
    assert (tr.occ.numpy() == 1).any()
    np.testing.assert_allclose(tr.weight_sum.numpy(), np.asarray(jr.weight_sum), rtol=2e-5)
    np.testing.assert_array_equal(tp.status.numpy(), np.asarray(jp.status))
    np.testing.assert_allclose(tp.weight.numpy(), np.asarray(jp.weight), rtol=2e-5)


@pytest.mark.parametrize("slots_n", [1, 2, 3, 5])  # K = 1, 3, 7, 31
@pytest.mark.parametrize("kind", STORE_EDGES)
def test_render_plain_matches_pallas_at_the_edges(kind, slots_n):
    """render_core_plain against the Pallas render (interpret mode) on the
    same store: occ, label, track and the new status equal; weight_sum at
    rtol 2e-5 / atol 1e-6 (the Pallas kernel sums a voxel's slots by a matrix
    product, in another order) and the new weight equal (a clamp, no sum)."""
    cfg_j = J.config.tiny_test_config(max_particle_num_per_voxel_n=slots_n)
    cfg_t = tiny_test_config(max_particle_num_per_voxel_n=slots_n)
    K, V = cfg_t.slots_per_voxel, 1024  # the Pallas kernel takes multiples of 128 voxels
    d = render_store(V, K, seed=7 + slots_n, kind=kind)
    thr = 0.4

    base = j_init(cfg_j).particles
    n = V * K
    jp = base.replace(
        px=jnp.zeros(n), py=jnp.zeros(n), pz=jnp.zeros(n), forget=jnp.zeros(n, jnp.uint8),
        weight=jnp.asarray(d["weight"]), stamp=jnp.asarray(d["stamp"]),
        status=jnp.asarray(d["status"]), track=jnp.asarray(d["track"].astype(np.uint16)),
        label=jnp.asarray(d["label"]))
    jnew, jr = render_core_pallas(cfg_j, jp, jnp.asarray(d["voxel_stamp"]), jnp.asarray(d["vax"]),
                                  thr, interpret=True)

    from semantic_dsp_map_tpu_torch.state import Particles
    T = torch.from_numpy
    tp = Particles(px=torch.zeros(n), py=torch.zeros(n), pz=torch.zeros(n),
                   weight=T(d["weight"]), label=T(d["label"]), track=T(d["track"]),
                   status=T(d["status"]), forget=torch.zeros(n, dtype=torch.uint8),
                   stamp=T(d["stamp"]))
    tnew, tr = render_core_plain(cfg_t, tp, T(d["voxel_stamp"]), T(d["vax"]), thr)

    for name in ("occ", "label", "track"):
        np.testing.assert_array_equal(getattr(tr, name).numpy(), np.asarray(getattr(jr, name)),
                                      err_msg=name)
    np.testing.assert_allclose(tr.weight_sum.numpy(), np.asarray(jr.weight_sum), rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(tnew.status.numpy(), np.asarray(jnew.status))
    np.testing.assert_array_equal(tnew.weight.numpy(), np.asarray(jnew.weight))

    occ = tr.occ.numpy()
    stale = (d["voxel_stamp"] == 0) | (d["voxel_stamp"] < d["vax"])
    assert 0 < stale.sum() < V and (occ[stale] == -1).all() and (occ[~stale] >= 0).all()
    if kind == "all_dead":
        assert not (occ > 0).any() and not tr.label.any() and not tr.track.any()
        assert torch.equal(tnew.weight, tp.weight) and torch.equal(tnew.status, tp.status)
    else:
        assert (occ == 1).any()
    if kind == "sparse":
        assert (occ > 0).sum() < V // 20
    if kind in ("mixed", "all_alive"):
        assert (tnew.weight != tp.weight).any()                 # the clamp
        if K > 1:
            assert (tnew.status != tp.status).any()             # the collection


def test_render_wrapper_in_place_on_cpu():
    """On CPU tensors the kernel wrapper runs the plain reduction and, like
    the kernel, writes the new weight and status into the store."""
    cfg = tiny_test_config()
    ts = map_state_from_numpy(jax_state_to_numpy(_random_jax_state(5)), device="cpu")
    vax = codecs.axis_stamps_per_voxel(cfg, ts.scroll)
    new, want = render_core_plain(cfg, ts.particles, ts.voxel_stamp, vax, 0.3)
    before = render_core_cuda.launches
    p, got = render_core_cuda(cfg, ts.particles, ts.voxel_stamp, vax, 0.3)
    assert p.weight is ts.particles.weight
    assert render_core_cuda.launches == before
    assert torch.equal(p.weight, new.weight) and torch.equal(p.status, new.status)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
