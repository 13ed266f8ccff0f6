"""The port's object layer against the JAX package: Kabsch, RANSAC with the
JAX Gumbel draws injected, object_level_update over a moving-object
sequence, and expiry.  Floats that come out of a 3x3 f32 SVD are compared
at atol 1e-4: the two frameworks' LAPACK paths differ by a few ulp.

The parts the captured step runs on either side of the refit's SVD
(``kabsch_cov`` / ``kabsch_finish``, ``ransac_fit`` / ``ransac_finish``,
``object_fit`` / ``object_finish``) are held bit for bit to the functions
they were cut from."""

import collections
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
from semantic_dsp_map_tpu.objects import track_lookup_table as j_lookup
from semantic_dsp_map_tpu.ops.geometry import camera_matrices as j_cam
from semantic_dsp_map_tpu.ops.transforms import kabsch as j_kabsch
from semantic_dsp_map_tpu.ops.transforms import ransac_transform as j_ransac
from semantic_dsp_map_tpu.state import init_objects as j_init_objects

from semantic_dsp_map_tpu_torch.config import FilterParams, tiny_test_config
from semantic_dsp_map_tpu_torch.objects import (
    RANSAC_ITERS,
    ObservedInstances,
    expire_objects,
    object_finish,
    object_fit,
    object_level_update,
    refit_svd,
    track_lookup_table,
)
from semantic_dsp_map_tpu_torch.ops.transforms import (
    _compose,
    apply_transform,
    kabsch,
    kabsch_cov,
    kabsch_finish,
    kabsch_svd,
    ransac_finish,
    ransac_fit,
    ransac_transform,
    triangle_fit,
)
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


# ---------------------------------------------------------------------------
# The parts on either side of the refit's SVD, against the unsplit functions
# ---------------------------------------------------------------------------

def _kabsch_unsplit(P, Q, mask):
    """``kabsch`` as one function, before it was cut at its SVD."""
    m = mask.to(torch.float32)[..., None]
    cnt = torch.clamp(m.sum(dim=-2), min=1e-9)
    cp = (P * m).sum(dim=-2) / cnt
    cq = (Q * m).sum(dim=-2) / cnt
    Pc = (P - cp[..., None, :]) * m
    Qc = (Q - cq[..., None, :]) * m
    H = torch.einsum("...ni,...nj->...ij", Pc, Qc)
    U, _, Vt = torch.linalg.svd(H)
    V = Vt.transpose(-1, -2)
    R = V @ U.transpose(-1, -2)
    det = torch.linalg.det(R)
    flip = torch.ones_like(V)
    flip[..., :, 2] = torch.where(det < 0, -1.0, 1.0)[..., None]
    R = (V * flip) @ U.transpose(-1, -2)
    t = cq - torch.einsum("...ij,...j->...i", R, cp)
    return _compose(R, t), mask.sum(dim=-1) >= 3


def _ransac_unsplit(gumbel, P, Q, mask, threshold, refit_with_inliers):
    """``ransac_transform`` as one function, before it was cut at the
    refit's SVD."""
    batch = P.shape[:-2]
    n_iter, N = gumbel.shape[-2:]
    P, Q = P.reshape(-1, N, 3), Q.reshape(-1, N, 3)
    mask = mask.reshape(-1, N)
    B = P.shape[0]
    bi = torch.arange(B, device=P.device)
    g = torch.where(mask[:, None, :], gumbel.reshape(B, n_iter, N), float("-inf"))
    triple = torch.topk(g, 3, dim=-1).indices
    T_h = triangle_fit(P[bi[:, None, None], triple], Q[bi[:, None, None], triple])
    Pt = apply_transform(T_h, P[:, None].expand(B, n_iter, N, 3))
    err = torch.linalg.vector_norm(Pt - Q[:, None], dim=-1)
    inl = mask[:, None, :] & (err < threshold)
    counts = inl.sum(dim=-1)
    best = torch.argmax(counts, dim=-1)
    best_T, best_inl, n_inl = T_h[bi, best], inl[bi, best], counts[bi, best]
    if refit_with_inliers:
        refit_T, refit_ok = _kabsch_unsplit(P, Q, best_inl)
        use_refit = refit_ok & (n_inl >= 3)
        best_T = torch.where(use_refit[..., None, None], refit_T, best_T)
    Pf = apply_transform(best_T, P)
    sq = ((Pf - Q) ** 2).sum(dim=-1)
    mse = torch.where(best_inl, sq, 0.0).sum(dim=-1) / torch.clamp(n_inl, min=1)
    first_inlier = torch.argmax(best_inl.to(torch.int32), dim=-1)
    first_inlier = torch.where(best_inl.any(dim=-1), first_inlier, 0)
    return (best_T.reshape(batch + (4, 4)), best_inl.reshape(batch + (N,)),
            n_inl.reshape(batch), mse.reshape(batch), first_inlier.reshape(batch))


def _point_sets(seed, B, N):
    """B point sets of N points and their images under a random rigid
    motion with noise and a few outliers; set 1 is mirrored (its Kabsch fit
    needs the reflection fix), set 2 keeps 2 valid points, set 3 none."""
    rng = np.random.RandomState(seed)
    P = rng.randn(B, N, 3).astype(np.float32) * 2.0 + rng.randn(B, 1, 3).astype(np.float32) * 10
    Q = np.empty_like(P)
    for b in range(B):
        R, t = _rigid(rng)
        Q[b] = P[b] @ R.T + t + rng.randn(N, 3).astype(np.float32) * 0.02
    Q[1] = P[1] * np.array([1.0, 1.0, -1.0], np.float32)
    Q[:, :2] += rng.randn(B, 2, 3).astype(np.float32) * 5.0  # outliers
    mask = rng.rand(B, N) < 0.85
    mask[2] = False
    mask[2, :2] = True
    mask[3] = False
    return torch.from_numpy(P), torch.from_numpy(Q), torch.from_numpy(mask)


def _assert_bits(got, want, msg=""):
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, (i, msg)
        assert torch.equal(a, b), f"output {i} {msg}"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kabsch_parts_equal_unsplit_kabsch(seed):
    """``kabsch_cov``, ``kabsch_svd`` and ``kabsch_finish`` in a row, and
    ``kabsch`` itself, give the unsplit fit's bits, with the reflection fix
    taken for the mirrored set and too few points for the others."""
    P, Q, mask = _point_sets(seed, 6, 12)
    want = _kabsch_unsplit(P, Q, mask)
    H, cp, cq, ok = kabsch_cov(P, Q, mask)
    U, Vt = kabsch_svd(H)
    _assert_bits((kabsch_finish(U, Vt, cp, cq), ok), want, "parts")
    _assert_bits(kabsch(P, Q, mask), want, "kabsch")
    det = torch.linalg.det(Vt.transpose(-1, -2) @ U.transpose(-1, -2))
    assert bool(det[1] < 0) and not bool(ok[2]) and not bool(ok[3])


@pytest.mark.parametrize("refit", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_parts_equal_unsplit_ransac(seed, refit):
    """``ransac_fit``, the refit's SVD and ``ransac_finish`` give the
    unsplit RANSAC's bits, over sets where the refit is used, where it is
    not (fewer than 3 inliers) and a mirrored set."""
    P, Q, mask = _point_sets(seed, 6, 16)
    g = torch.from_numpy(np.random.RandomState(seed + 10).gumbel(size=(6, 40, 16))
                         .astype(np.float32))
    want = _ransac_unsplit(g, P, Q, mask, 0.5, refit)
    fit = ransac_fit(g, P, Q, mask, 0.5, refit)
    assert (fit.H is None) == (not refit)
    got = ransac_finish(fit, *kabsch_svd(fit.H)) if refit else ransac_finish(fit)
    _assert_bits(got, want, "parts")
    _assert_bits(ransac_transform(g, P, Q, mask, 0.5, refit), want, "ransac_transform")
    n_inl = want[2]
    assert bool((n_inl < 3).any()) and bool((n_inl >= 3).any())


def _static_copy(fit):
    """The fit as the finishing graph reads it: every tensor at another
    address (a graph's output), the rest of the tuple as it is."""
    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{f.name: copy(getattr(x, f.name))
                                             for f in dataclasses.fields(x)})
        if isinstance(x, tuple):
            return type(x)(*(copy(v) for v in x))
        return x
    return copy(fit)


def test_object_parts_equal_object_level_update():
    """``object_fit``, the bridge (the SVD's U and Vt copied into tensors of
    their own) and ``object_finish`` give ``object_level_update``'s table bit
    for bit, frame after frame: 8 instances of random tracks, some with
    fewer than 5 keypoints or fewer than 3 (no refit), one mirrored between
    frames (the reflection fix), moving by random rigid motions."""
    cfg, params = tiny_test_config(), FilterParams(**KW)
    I, Kp = cfg.max_instances_per_frame, cfg.max_keypoints
    rng = np.random.RandomState(7)
    whole = split = init_objects(cfg, device="cpu")
    cam_pos = torch.zeros(3)
    r_cw, t_cw = torch.eye(3), torch.zeros(3)
    base = rng.randn(I, Kp, 3).astype(np.float32) * 0.3 + np.array([0, 0, 1.5], np.float32)
    prev = base
    seen = collections.Counter()
    for gt in range(1, 8):
        cur = np.empty_like(prev)
        for i in range(I):
            R, t = _rigid(rng)
            cur[i] = prev[i] @ (np.eye(3) * 0.9 + R * 0.1).T.astype(np.float32) + t * 0.1
        cur[5] = prev[5] * np.float32([1, 1, -1]) + np.float32([0, 0, 3])
        cur += rng.randn(*cur.shape).astype(np.float32) * 0.01
        obs = ObservedInstances(
            valid=torch.from_numpy(rng.rand(I) < 0.9),
            track=torch.from_numpy(rng.randint(0, 5, I).astype(np.int32)),
            label=torch.from_numpy(np.where(rng.rand(I) < 0.9, 14, -1).astype(np.int32)),
            kpts_curr=torch.from_numpy(cur), kpts_prev=torch.from_numpy(prev),
            kpts_count=torch.from_numpy(rng.choice([2, 3, 4, 8, 12, 16], I).astype(np.int32)),
        )
        draws = torch.from_numpy(rng.gumbel(size=(I, RANSAC_ITERS, Kp)).astype(np.float32))
        times = (torch.tensor(0.1 * gt, dtype=torch.float32),
                 torch.tensor(0.1 * (gt - 1), dtype=torch.float32),
                 torch.tensor(gt, dtype=torch.int32))
        whole = object_level_update(cfg, params, whole, obs, cam_pos, r_cw, t_cw, *times, draws)
        fit = _static_copy(object_fit(cfg, split, obs, cam_pos, *times, draws))
        U, Vt = refit_svd(fit)
        uv = (torch.empty_like(U).copy_(U), torch.empty_like(Vt).copy_(Vt))
        used = fit.ransac.refit_ok & (fit.ransac.n_inl >= 3)
        tracked = fit.relevant & fit.has & ~fit.new_mask
        seen["refit"] += int(used.sum())
        seen["no refit"] += int((~used).sum())
        seen["reflection"] += int((used & (torch.linalg.det(Vt.mT @ U.mT) < 0)).sum())
        seen["few keypoints"] += int((tracked & (obs.kpts_count < 5)).sum())
        seen["case 2"] += int(fit.exist_obs.sum())
        split = object_finish(cfg, params, fit, *uv)
        for f in dataclasses.fields(ObjectTable):
            a, b = getattr(split, f.name), getattr(whole, f.name)
            assert torch.equal(a, b), f"{f.name} frame {gt}"
        prev = cur
    assert len(seen) == 5 and all(seen.values()), seen
    assert bool(whole.valid.any()) and bool(whole.has_tmatrix.any())


@pytest.mark.parametrize("size", [65536, 64])
def test_track_lookup_table_matches_jax(size):
    """Live rows keyed by their track ids; invalid rows, negative ids and
    ids of ``size`` or more own no entry (dropped, not wrapped)."""
    rng = np.random.RandomState(9)
    jo = j_init_objects(j_tiny())
    O = jo.valid.shape[0]
    ids = rng.permutation(np.arange(-5, size + 5))[:O].astype(np.int32)
    ids[:4] = [-1, size, size + 3, -size]
    valid = rng.rand(O) < 0.7
    valid[:4] = True
    jo = jo.replace(valid=jnp.asarray(valid), track_id=jnp.asarray(ids))
    want = np.asarray(j_lookup(jo, size))
    got = track_lookup_table(_objects_to_torch(jo), size)
    assert got.dtype == torch.int32 and got.shape == (size,)
    np.testing.assert_array_equal(got.numpy(), want)
    owned = valid & (ids >= 0) & (ids < size)
    assert (got.numpy() >= 0).sum() == owned.sum() > 0
    assert got[-1] == -1 or owned[int(got[-1])]
