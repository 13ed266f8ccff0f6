"""The port's object layer against the JAX package: Kabsch, RANSAC with the
JAX Gumbel draws injected, object_level_update over a moving-object
sequence, and expiry.  Floats that come out of a 3x3 f32 SVD are compared
at atol 1e-4: the two frameworks' LAPACK paths differ by a few ulp."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_dsp_map_tpu.config import FilterParams as JFilterParams
from semantic_dsp_map_tpu.config import tiny_test_config as j_tiny
from semantic_dsp_map_tpu.objects import ObservedInstances as JObs
from semantic_dsp_map_tpu.objects import expire_objects as j_expire
from semantic_dsp_map_tpu.objects import object_level_update as j_update
from semantic_dsp_map_tpu.ops.geometry import camera_matrices as j_cam
from semantic_dsp_map_tpu.ops.transforms import kabsch as j_kabsch
from semantic_dsp_map_tpu.ops.transforms import ransac_transform as j_ransac
from semantic_dsp_map_tpu.state import init_objects as j_init_objects

from semantic_dsp_map_tpu_torch.config import FilterParams, tiny_test_config
from semantic_dsp_map_tpu_torch.objects import (
    RANSAC_ITERS,
    ObservedInstances,
    expire_objects,
    object_level_update,
)
from semantic_dsp_map_tpu_torch.ops.transforms import kabsch, ransac_transform
from semantic_dsp_map_tpu_torch.state import ObjectTable, init_objects

torch.set_num_threads(2)

SVD_ATOL = 1e-4
KW = dict(
    bayesian_movement_distance_threshold=0.1,
    bayesian_movement_probability_threshold=0.69,
    bayesian_movement_increment=0.1,
    bayesian_movement_decrement=0.15,
)


def _rigid(rng):
    U, _, Vt = np.linalg.svd(rng.randn(3, 3))
    R = U @ Vt
    if np.linalg.det(R) < 0:
        U[:, 2] *= -1
        R = U @ Vt
    return R.astype(np.float32), rng.randn(3).astype(np.float32)


def test_kabsch_matches_jax():
    rng = np.random.RandomState(0)
    R, t = _rigid(rng)
    P = rng.randn(10, 3).astype(np.float32)
    Q = (P @ R.T + t).astype(np.float32)
    mask = np.ones(10, bool)
    mask[3] = False
    Tj, okj = j_kabsch(jnp.asarray(P), jnp.asarray(Q), jnp.asarray(mask))
    Tt, okt = kabsch(torch.from_numpy(P), torch.from_numpy(Q), torch.from_numpy(mask))
    assert bool(okt) == bool(okj)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=SVD_ATOL)


@pytest.mark.parametrize("refit", [True, False])
def test_ransac_matches_jax_with_injected_draws(refit):
    rng = np.random.RandomState(1)
    R, t = _rigid(rng)
    n = 20
    P = rng.randn(n, 3).astype(np.float32)
    Q = (P @ R.T + t).astype(np.float32)
    Q[0] += 10.0
    Q[5] -= 7.0
    mask = np.ones(n, bool)
    mask[-2:] = False
    key = jax.random.PRNGKey(0)
    j_out = j_ransac(key, jnp.asarray(P), jnp.asarray(Q), jnp.asarray(mask), 100, 0.5, refit)
    g = np.array(jax.random.gumbel(key, (100, n)))  # the draws j_ransac made
    t_out = ransac_transform(torch.from_numpy(g), torch.from_numpy(P), torch.from_numpy(Q),
                             torch.from_numpy(mask), 0.5, refit)
    Tj, inl_j, n_j, mse_j, first_j = (np.asarray(a) for a in j_out)
    Tt, inl_t, n_t, mse_t, first_t = (a.numpy() for a in t_out)
    np.testing.assert_array_equal(inl_t, inl_j)
    assert int(n_t) == int(n_j) == n - 4
    assert int(first_t) == int(first_j)
    np.testing.assert_allclose(Tt, Tj, atol=SVD_ATOL)
    np.testing.assert_allclose(mse_t, mse_j, atol=1e-6)


def _obs(cfg, track, label, kpts_prev, kpts_curr):
    I, Kp = cfg.max_instances_per_frame, cfg.max_keypoints
    d = dict(
        valid=np.zeros(I, bool), track=np.zeros(I, np.int32), label=np.full(I, -1, np.int32),
        kpts_curr=np.zeros((I, Kp, 3), np.float32), kpts_prev=np.zeros((I, Kp, 3), np.float32),
        kpts_count=np.zeros(I, np.int32),
    )
    n = kpts_curr.shape[0]
    d["valid"][0] = True
    d["track"][0] = track
    d["label"][0] = label
    d["kpts_curr"][0, :n] = kpts_curr
    d["kpts_prev"][0, :n] = kpts_prev
    d["kpts_count"][0] = n
    return d


def _objects_to_torch(jo):
    return ObjectTable(**{
        f.name: torch.from_numpy(np.array(getattr(jo, f.name)))
        for f in dataclasses.fields(ObjectTable)
    })


def _assert_objects_close(to, jo, msg):
    for f in dataclasses.fields(ObjectTable):
        a, b = getattr(to, f.name).numpy(), np.asarray(getattr(jo, f.name))
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, atol=SVD_ATOL, err_msg=f"{f.name} {msg}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{f.name} {msg}")


@pytest.mark.parametrize("shift", [0.5, 0.0])
def test_object_level_update_matches_jax(shift):
    """A new object appears, then translates by ``shift`` per frame (moving
    decision, window push, velocity) or stays put (probability decays);
    frames 5-6 drop the observation (coasting prediction)."""
    cfg_j, cfg_t = j_tiny(), tiny_test_config()
    pj, pt = JFilterParams(**KW), FilterParams(**KW)
    rng = np.random.RandomState(2)
    kpts = rng.randn(8, 3).astype(np.float32) * 0.3 + np.array([0, 0, 1.5], np.float32)
    jo, to = j_init_objects(cfg_j), init_objects(cfg_t, device="cpu")
    cam_pos = np.zeros(3, np.float32)
    _, _, r_cw, t_cw = j_cam(jnp.asarray(cam_pos), jnp.asarray([1.0, 0, 0, 0], jnp.float32))
    cur = kpts
    for gt in range(1, 7):
        prev, cur = cur, cur + np.array([shift, 0, 0], np.float32)
        d = _obs(cfg_t, 3, 14, prev, cur)
        if gt >= 5:
            d["valid"][:] = False
        key = jax.random.PRNGKey(gt)
        time_now, prev_time = 0.1 * gt, 0.1 * (gt - 1)
        jo = j_update(cfg_j, pj, jo, JObs(**{k: jnp.asarray(v) for k, v in d.items()}),
                      jnp.asarray(cam_pos), r_cw, t_cw, jnp.float32(time_now),
                      jnp.float32(prev_time), jnp.int32(gt), key)
        # the Gumbel draws the JAX update made for its RANSAC hypotheses
        draws = jax.vmap(lambda k: jax.random.gumbel(k, (RANSAC_ITERS, cfg_t.max_keypoints)))(
            jax.random.split(key, cfg_t.max_instances_per_frame)
        )
        to = object_level_update(
            cfg_t, pt, to, ObservedInstances(**{k: torch.from_numpy(v) for k, v in d.items()}),
            torch.from_numpy(cam_pos), torch.from_numpy(np.array(r_cw)),
            torch.from_numpy(np.array(t_cw)), torch.tensor(time_now, dtype=torch.float32),
            torch.tensor(prev_time, dtype=torch.float32), torch.tensor(gt, dtype=torch.int32),
            torch.from_numpy(np.array(draws)),
        )
        _assert_objects_close(to, jo, f"frame {gt}")
    assert bool(to.valid.any())
    if shift:
        assert bool(to.moving[to.valid].all()) and bool(to.vel_valid[to.valid].all())


def test_expire_objects_matches_jax():
    rng = np.random.RandomState(4)
    jo = j_init_objects(j_tiny())
    O = jo.valid.shape[0]
    jo = jo.replace(
        valid=jnp.asarray(rng.rand(O) < 0.7),
        moving=jnp.asarray(rng.rand(O) < 0.7),
        has_moved_record=jnp.asarray(rng.rand(O) < 0.7),
        has_last_kpts=jnp.asarray(rng.rand(O) < 0.7),
        last_obs_step=jnp.asarray(rng.randint(0, 10, O).astype(np.int32)),
    )
    to = _objects_to_torch(jo)
    for gt in (3, 8, 14):
        jn, je = j_expire(JFilterParams(max_observation_lost_time=5), jo, jnp.int32(gt))
        tn, te = expire_objects(FilterParams(max_observation_lost_time=5), to,
                                torch.tensor(gt, dtype=torch.int32))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        _assert_objects_close(tn, jn, f"gt {gt}")
