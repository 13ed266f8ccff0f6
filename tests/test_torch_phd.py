"""The port's PHD stencils and observe update against the JAX package.

The cases of tests/test_phd_pallas.py go through the port's plain passes
and its dispatching ``stencil_passes`` (on the CPU both run the plain
stencils) and are held against the JAX package's XLA stencils: ck and the
new weight at rtol 2e-5 / atol 1e-6 (float association differs), the
forget counts equal.  The plain pass B, which the CUDA kernel is held
against on the card (tests/test_torch_kernels_gpu.py), are also held against
the Pallas kernels in interpret mode at the edges the CUDA kernels' designs
have: an image that is no multiple of any tile (37 x 53) with R = 5 and 3,
a table with every slot occupied, an empty one, one occupied in a single
patch, and an occupied entry with forgetting factor 0 (its weight counts
for nothing in pass A; its "rightly updated" flag must still be set in pass
B).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_dsp_map_tpu.config import FilterParams as JFilterParams
from semantic_dsp_map_tpu.config import tiny_test_config as j_tiny
from semantic_dsp_map_tpu.ops import phd as jphd
from semantic_dsp_map_tpu.ops.phd_pallas import pass_a_pallas, pass_b_pallas
from semantic_dsp_map_tpu.ops.projection import LabeledCloud as JCloud

from semantic_dsp_map_tpu_torch.config import FilterParams, tiny_test_config
from semantic_dsp_map_tpu_torch.ops import phd as tphd
from semantic_dsp_map_tpu_torch.ops import phd_cuda
from semantic_dsp_map_tpu_torch.ops.projection import LabeledCloud

from torch_parity import PHD_EDGE_TABLES, ZERO_FF_ENTRY, phd_table_cloud

torch.set_num_threads(2)

CASES = [(False, False, 0.4), (True, False, 0.4), (False, True, 0.12)]


def _inputs(cfg, seed=0, fill=0.4, front_fill=False, kind=None):
    """numpy table + cloud (torch_parity.phd_table_cloud)."""
    return phd_table_cloud(cfg.phd_pixel_table_slots, cfg.height, cfg.width,
                           seed, fill, front_fill, kind)


def _jax(table, cloud):
    t = jphd.PixelTable(**{k: jnp.asarray(v) for k, v in table.items()}, dropped=jnp.int32(0))
    return t, JCloud(**{k: jnp.asarray(v) for k, v in cloud.items()})


def _torch(table, cloud, device="cpu"):
    t = tphd.PixelTable(
        **{k: torch.from_numpy(v).to(device) for k, v in table.items()},
        dropped=torch.zeros((), dtype=torch.int64, device=device),
    )
    return t, LabeledCloud(**{k: torch.from_numpy(v).to(device) for k, v in cloud.items()})


def _params(independent):
    kw = dict(
        detection_probability=0.9, noise_number=0.1,
        if_use_independent_filter=independent, if_consider_depth_noise=True,
    )
    return JFilterParams(**kw), FilterParams(**kw)


@pytest.mark.parametrize("independent,front_fill,fill", CASES)
@pytest.mark.parametrize("entry", ["plain", "stencil_passes"])
def test_phd_passes_match_jax(independent, front_fill, fill, entry):
    cfg_j, cfg_t = j_tiny(phd_pixel_table_slots=4), tiny_test_config(phd_pixel_table_slots=4)
    pj, pt = _params(independent)
    table, cloud = _inputs(cfg_t, fill=fill, front_fill=front_fill)
    jt, jc = _jax(table, cloud)
    tt, tc = _torch(table, cloud)

    ck_j = jphd.stencil_pass_a(cfg_j, pj, jt, jc)
    nw_j, nf_j = jphd.stencil_pass_b(cfg_j, pj, jt, jc, ck_j)
    if entry == "plain":
        ck_t = tphd.stencil_pass_a(cfg_t, pt, tt, tc)
        nw_t, nf_t = tphd.stencil_pass_b(cfg_t, pt, tt, tc, ck_t)
    else:
        ck_t, nw_t, nf_t = tphd.stencil_passes(cfg_t, pt, tt, tc)

    np.testing.assert_allclose(ck_t.numpy(), np.asarray(ck_j), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(nw_t.numpy(), np.asarray(nw_j), rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(nf_t.numpy(), np.asarray(nf_j))


EDGE_CASES = [(kind, False) for kind in (*PHD_EDGE_TABLES, None)] + [(None, True)]


@pytest.mark.parametrize("R", [5, 3])
@pytest.mark.parametrize("kind,independent", EDGE_CASES)
def test_pass_a_plain_matches_pallas_at_the_edges(kind, independent, R):
    """pass_a_raw against the Pallas pass A (interpret mode) on the arguments
    ops.phd._pass_a makes: ck at rtol 2e-5 / atol 1e-6 (the Pallas kernel
    folds COEF^3 into the weight plane and sums in slot groups)."""
    _pass_a_at_the_edges(kind, independent, R)


def _pass_a_at_the_edges(kind, independent, R, S=5, h=37, w=53):
    """The body of test_pass_a_plain_matches_pallas_at_the_edges on an
    h x w image with S slot planes."""
    shape = dict(image_width=w, image_height=h, phd_pixel_table_slots=S, phd_neighbor_half=R)
    cfg_j, cfg_t = j_tiny(**shape), tiny_test_config(**shape)
    pj, pt = _params(independent)
    table, cloud = _inputs(cfg_t, seed=4, fill=0.3, front_fill=True, kind=kind)
    t, c = _torch(table, cloud)

    occupied = t.meta >= 0
    ff = tphd.forgetting_factor(t.meta & 0xFF, pt.forgetting_rate, pt.max_forget_count)
    weff = torch.where(occupied, t.weight if independent else t.weight * ff, 0.0)
    args = (t.px, t.py, t.pz, weff, t.meta >> 8, *(c.pos[..., i].contiguous() for i in range(3)),
            1.0 / torch.clamp(c.sigma, min=1e-6), c.track)
    ck_t = tphd.pass_a_raw(cfg_t, pt, *args)
    ck_j = pass_a_pallas(cfg_j, pj, *(jnp.asarray(a.numpy()) for a in args),
                         interpret=True, th=8, tw=32)

    np.testing.assert_allclose(ck_t.numpy(), np.asarray(ck_j), rtol=2e-5, atol=1e-6)
    assert ck_t.shape == (h, w) and bool(torch.isfinite(ck_t).all())
    live = weff != 0
    if kind == "empty":
        assert not live.any() and not ck_t.any()
    elif kind == "full":
        assert occupied.all() and (ck_t > 0).all()
    elif kind == "patch":
        # nothing beyond R pixels of the patch
        near = torch.nn.functional.max_pool2d(live.any(0)[None, None].float(), 2 * R + 1, 1, R)[0, 0] > 0
        assert not ck_t[~near].any() and (ck_t[near] > 0).any()
    elif kind == "zero_ff" and not independent:
        assert occupied[ZERO_FF_ENTRY] and weff[ZERO_FF_ENTRY] == 0
    if kind != "empty" and not independent:
        # occupied entries whose forget count is at its maximum have no weight
        assert bool((occupied & ~live).any())


@pytest.mark.parametrize("R", [5, 3])
@pytest.mark.parametrize("kind,independent", EDGE_CASES)
def test_pass_b_plain_matches_pallas_at_the_edges(kind, independent, R):
    """pass_b_raw against the Pallas pass B (interpret mode) on identical
    inputs: acc at rtol 2e-5 / atol 1e-6 (the Pallas kernel multiplies by a
    reciprocal and folds COEF^3 into the forgetting plane), flags equal."""
    _pass_b_at_the_edges(kind, independent, R)


def _pass_b_at_the_edges(kind, independent, R, S=5, h=37, w=53):
    """The body of test_pass_b_plain_matches_pallas_at_the_edges on an
    h x w image with S slot planes."""
    shape = dict(image_width=w, image_height=h, phd_pixel_table_slots=S, phd_neighbor_half=R)
    cfg_j, cfg_t = j_tiny(**shape), tiny_test_config(**shape)
    pj, pt = _params(independent)
    table, cloud = _inputs(cfg_t, seed=4, fill=0.3, front_fill=True, kind=kind)
    t, c = _torch(table, cloud)

    ck = tphd.stencil_pass_a(cfg_t, pt, t, c)
    occupied = t.meta >= 0
    ff = tphd.forgetting_factor(t.meta & 0xFF, pt.forgetting_rate, pt.max_forget_count)
    ff_eff = occupied.float() if independent else torch.where(occupied, ff, 0.0)
    args = (t.px, t.py, t.pz, torch.where(occupied, t.meta >> 8, -2), ff_eff,
            1.0 / torch.clamp(c.sigma, min=1e-6), *(c.pos[..., i].contiguous() for i in range(3)),
            c.valid, c.track, ck)
    acc_t, right_t = tphd.pass_b_raw(cfg_t, pt, *args)
    acc_j, right_j = pass_b_pallas(cfg_j, pj, *(jnp.asarray(a.numpy()) for a in args),
                                   interpret=True, th=8, tw=32)

    np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j), rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(right_t.numpy(), np.asarray(right_j) > 0.0)
    # an empty entry has neither a sum nor a flag
    assert not acc_t[~occupied].any() and not right_t[~occupied].any()
    if kind == "empty":
        assert not occupied.any()
    elif kind == "full":
        assert occupied.all() and (acc_t > 0).any()
    elif kind == "patch":
        assert 0 < int(occupied.any(0).sum()) < 0.2 * occupied[0].numel()
    elif kind == "zero_ff":
        assert ff_eff[ZERO_FF_ENTRY] == 0 and occupied[ZERO_FF_ENTRY]
        assert acc_t[ZERO_FF_ENTRY] == 0 and right_t[ZERO_FF_ENTRY]
        _, new_forget = tphd.stencil_pass_b(cfg_t, pt, t, c, ck)
        assert new_forget[ZERO_FF_ENTRY] == 0
    if independent:
        assert not right_t.any()
    elif kind != "empty":
        assert right_t.any()


def test_table_from_entries_matches_jax():
    cfg_j, cfg_t = j_tiny(phd_pixel_table_slots=3), tiny_test_config(phd_pixel_table_slots=3)
    rng = np.random.RandomState(7)
    HW = cfg_t.height * cfg_t.width
    C = 400
    pix = np.sort(rng.randint(0, HW + 40, C)).astype(np.int32)  # some padding >= HW
    real = pix < HW
    is_start = np.concatenate([[True], pix[1:] != pix[:-1]])
    start = np.maximum.accumulate(np.where(is_start, np.arange(C), 0))
    rank = (np.arange(C) - start).astype(np.int32)
    keep = real & (rank < 3)
    vals = [rng.randn(C).astype(np.float32) for _ in range(4)]
    track = rng.randint(0, 70000, C).astype(np.int32) & 0xFFFF
    forget = rng.randint(0, 6, C).astype(np.int32)
    jt = jphd.table_from_entries(
        cfg_j, *(jnp.asarray(a) for a in (pix, rank, keep, *vals, track, forget))
    )
    tt = tphd.table_from_entries(
        cfg_t, *(torch.from_numpy(a) for a in (pix, rank, keep, *vals, track, forget))
    )
    for name in ("px", "py", "pz", "weight", "meta", "dropped"):
        np.testing.assert_array_equal(
            getattr(tt, name).numpy(), np.asarray(getattr(jt, name)), err_msg=name
        )


@pytest.mark.parametrize("n_rows", [3, 7])
def test_table_from_entries_on_a_row_slab_matches_jax(n_rows):
    """``n_rows`` sets the table's rows (a rank's row slab): slab-local
    pixel ids, padding at n_rows * W and beyond."""
    cfg_j, cfg_t = j_tiny(phd_pixel_table_slots=3), tiny_test_config(phd_pixel_table_slots=3)
    rng = np.random.RandomState(n_rows)
    n = n_rows * cfg_t.width
    C = 200
    pix = np.sort(rng.randint(0, n + 30, C)).astype(np.int32)
    is_start = np.concatenate([[True], pix[1:] != pix[:-1]])
    start = np.maximum.accumulate(np.where(is_start, np.arange(C), 0))
    rank = (np.arange(C) - start).astype(np.int32)
    keep = (pix < n) & (rank < 3)
    vals = [rng.randn(C).astype(np.float32) for _ in range(4)]
    track = rng.randint(0, 1 << 16, C).astype(np.int32)
    forget = rng.randint(0, 6, C).astype(np.int32)
    args = (pix, rank, keep, *vals, track, forget)
    jt = jphd.table_from_entries(cfg_j, *(jnp.asarray(a) for a in args), n_rows=n_rows)
    tt = tphd.table_from_entries(cfg_t, *(torch.from_numpy(a) for a in args), n_rows=n_rows)
    assert tt.px.shape == (3, n_rows, cfg_t.width)
    for name in ("px", "py", "pz", "weight", "meta", "dropped"):
        np.testing.assert_array_equal(
            getattr(tt, name).numpy(), np.asarray(getattr(jt, name)), err_msg=name
        )


def test_kernel_wrappers_run_plain_on_cpu():
    """On CPU tensors the kernel wrappers are their plain versions."""
    cfg = tiny_test_config(phd_pixel_table_slots=4)
    _, pt = _params(False)
    table, cloud = _inputs(cfg, front_fill=True, fill=0.12)
    t, c = _torch(table, cloud)
    before = (phd_cuda.pass_a_cuda.launches, phd_cuda.pass_b_cuda.launches)
    ck_any = tphd.stencil_pass_a_any(cfg, pt, t, c)
    ck_plain = tphd.stencil_pass_a(cfg, pt, t, c)
    np.testing.assert_array_equal(ck_any.numpy(), ck_plain.numpy())
    ox, oy, oz = (c.pos[..., i].contiguous() for i in range(3))
    occupied = t.meta >= 0
    args = (cfg, pt, t.px, t.py, t.pz, torch.where(occupied, t.meta >> 8, -2),
            occupied.float(), 1.0 / c.sigma, ox, oy, oz, c.valid, c.track, ck_plain)
    for a, b in zip(phd_cuda.pass_b_cuda(*args), tphd.pass_b_raw(*args)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (phd_cuda.pass_a_cuda.launches, phd_cuda.pass_b_cuda.launches) == before


def test_observe_update_matches_jax():
    """observe_and_update (plain path) on a JAX state after 4 frames of the
    dynamic scene: particle state, voxel stamps and ObserveDiag equal."""
    import semantic_dsp_map_tpu as J
    from semantic_dsp_map_tpu.frontend import build_frame_input
    from semantic_dsp_map_tpu.ops.geometry import camera_matrices as j_cam
    from semantic_dsp_map_tpu.ops.observe import observe_and_update as j_observe
    from semantic_dsp_map_tpu.ops.projection import generate_labeled_cloud as j_cloud

    from semantic_dsp_map_tpu_torch.ops.observe import observe_and_update as t_observe
    from semantic_dsp_map_tpu_torch.state import map_state_from_numpy, map_state_to_numpy
    from torch_parity import dynamic_scene, jax_state_to_numpy

    kw = dict(if_consider_depth_noise=True, nb_ptc_num_per_point=1,
              depth_noise_model_zero_order=0.2, prediction_stddev=0.0)
    jm = J.SemanticDSPMap(J.config.tiny_test_config(), J.FilterParams(**kw))
    for t in range(4):
        d, m, p, q, tt = dynamic_scene(jm.cfg, t, J.MaskKpts)
        jm.update_from_frame(build_frame_input(jm.cfg, jm.registry, d, m, p, q, tt))
    d, m, p, q, tt = dynamic_scene(jm.cfg, 4, J.MaskKpts)
    f = build_frame_input(jm.cfg, jm.registry, d, m, p, q, tt)
    r_wc, t_wc, r_cw, t_cw = j_cam(jnp.asarray(f.cam_pos), jnp.asarray(f.cam_quat))
    cloud = j_cloud(jm.cfg, jm.params, jnp.asarray(f.depth), jnp.asarray(f.track_raster),
                    jnp.asarray(f.track_label_table), r_wc, t_wc, 65523)
    state = jm.state
    gt = state.global_time + 1
    ts = map_state_from_numpy(jax_state_to_numpy(state), device="cpu")
    jp, jv, jd = j_observe(jm.cfg, jm.params, state.particles, state.scroll,
                           state.voxel_stamp, cloud, jnp.asarray(f.depth), r_cw, t_cw, gt)

    cfg_t = tiny_test_config()
    params_t = FilterParams(**kw)
    T = lambda a: torch.from_numpy(np.array(a))
    tcloud = LabeledCloud(*(T(a) for a in cloud))
    tp, tv, td = t_observe(cfg_t, params_t, ts.particles, ts.scroll, ts.voxel_stamp, tcloud,
                           T(f.depth), T(r_cw), T(t_cw), T(gt))
    assert {k: int(v) for k, v in td._asdict().items()} == {
        k: int(v) for k, v in jd._asdict().items()
    }
    assert int(jd.visible_count) > 0
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    got = map_state_to_numpy(dataclasses.replace(ts, particles=tp))
    for name in ("status", "stamp", "forget", "track", "label"):
        np.testing.assert_array_equal(
            got[f"particles.{name}"].astype(np.int64),
            np.asarray(getattr(jp, name)).astype(np.int64), err_msg=name,
        )
    np.testing.assert_allclose(got["particles.weight"], np.asarray(jp.weight),
                               rtol=2e-5, atol=1e-6)
