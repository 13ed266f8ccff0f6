"""The port's back-projection, forgetting factor and package surface against
the JAX package as its users run it: jitted.

XLA turns the cloud's division by the focal length into a multiplication by
its reciprocal; eager JAX and a CPU division do not, and differ from it by
1 ulp in a share of the columns (1% at the VKITTI2 intrinsics, 20% at the
ZED2 ones).  Those positions are truncated to pixels and voxels, so the
port's cloud is held to the jitted one bit for bit, at the full image size of
both presets.  The forgetting factor's division stays a division under jit;
the port's must give its bits at any rate, on any device."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import semantic_dsp_map_tpu as J
from semantic_dsp_map_tpu.ops import geometry as jgeom
from semantic_dsp_map_tpu.ops.projection import generate_labeled_cloud as j_cloud

import semantic_dsp_map_tpu_torch as T
from semantic_dsp_map_tpu_torch.ops import geometry as tgeom
from semantic_dsp_map_tpu_torch.ops.projection import generate_labeled_cloud as t_cloud

torch.set_num_threads(2)

MAX_MOVABLE = 65523
POSES = {
    "identity": ([1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0]),
    "rotated": ([0.9833, 0.0428, 0.1737, 0.0076], [0.3, -0.2, 0.5]),
}


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.int32)


@pytest.mark.parametrize("pose", sorted(POSES))
@pytest.mark.parametrize("preset", ["virtual_kitti2_config", "zed2_config"])
def test_labeled_cloud_equals_jitted_jax_bit_for_bit(preset, pose):
    cfg_j, cfg_t = getattr(J.config, preset)(), getattr(T.config, preset)()
    H, W = cfg_t.height, cfg_t.width
    rng = np.random.RandomState(11)
    depth = (rng.rand(H, W) * 30 + 0.3).astype(np.float32)
    depth[rng.rand(H, W) < 0.02] = np.nan
    raster = rng.randint(0, 5, (H, W)).astype(np.int32)
    table = (np.arange(65536) % 10).astype(np.int32)
    quat, pos = (np.asarray(a, np.float32) for a in POSES[pose])
    quat /= np.linalg.norm(quat)
    r_wc, t_wc, _, _ = (np.array(a) for a in jgeom.camera_matrices(jnp.asarray(pos), jnp.asarray(quat)))
    params = dict(if_consider_depth_noise=True, depth_noise_model_first_order=0.01,
                  depth_noise_model_zero_order=0.2)

    jitted = jax.jit(lambda *a: j_cloud(cfg_j, J.FilterParams(**params), *a, MAX_MOVABLE))
    want = jitted(depth, raster, table, r_wc, t_wc)
    got = t_cloud(cfg_t, T.FilterParams(**params),
                  *(torch.from_numpy(a) for a in (depth, raster, table, r_wc, t_wc)), MAX_MOVABLE)

    np.testing.assert_array_equal(_bits(got.pos.numpy()), _bits(want.pos))
    # sigma = zero_order + first_order * depth is one fused multiply-add in
    # XLA's CPU code and two roundings in eager JAX and in the port: 1 ulp,
    # in a float that decides no pixel or voxel
    np.testing.assert_allclose(got.sigma.numpy(), np.asarray(want.sigma), rtol=1.2e-7, atol=0)
    for name in ("label", "track", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    assert 0.3 < float(got.valid.float().mean()) < 1.0  # both sides of the depth range


@pytest.mark.parametrize("first_row", [0, 37])
@pytest.mark.parametrize("preset", ["virtual_kitti2_config", "zed2_config"])
def test_labeled_cloud_of_a_row_slab_equals_jitted_jax(preset, first_row):
    """A row slab's cloud, with its first row as ``row_offset``, under the
    rotated pose: bit for bit the jitted JAX cloud of the same slab (the
    offset traced, as in the JAX sharded step) and the whole image's
    rows."""
    cfg_j, cfg_t = getattr(J.config, preset)(), getattr(T.config, preset)()
    H, W = cfg_t.height, cfg_t.width
    n = 64
    rng = np.random.RandomState(5)
    depth = (rng.rand(H, W) * 30 + 0.3).astype(np.float32)
    raster = rng.randint(0, 5, (H, W)).astype(np.int32)
    table = (np.arange(65536) % 10).astype(np.int32)
    quat, pos = (np.asarray(a, np.float32) for a in POSES["rotated"])
    quat /= np.linalg.norm(quat)
    r_wc, t_wc, _, _ = (np.array(a) for a in jgeom.camera_matrices(jnp.asarray(pos), jnp.asarray(quat)))
    params = dict(if_consider_depth_noise=True, depth_noise_model_first_order=0.01,
                  depth_noise_model_zero_order=0.2)
    rows = slice(first_row, first_row + n)

    jitted = jax.jit(lambda d, r, tb, rw, tw, off: j_cloud(
        cfg_j, J.FilterParams(**params), d, r, tb, rw, tw, MAX_MOVABLE, row_offset=off))
    want = jitted(depth[rows], raster[rows], table, r_wc, t_wc, jnp.int32(first_row))
    T_ = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = t_cloud(cfg_t, T.FilterParams(**params), T_(depth[rows]), T_(raster[rows]), T_(table),
                  T_(r_wc), T_(t_wc), MAX_MOVABLE, row_offset=first_row)
    whole = t_cloud(cfg_t, T.FilterParams(**params), *(T_(a) for a in (depth, raster, table, r_wc, t_wc)),
                    MAX_MOVABLE)
    np.testing.assert_array_equal(_bits(got.pos.numpy()), _bits(want.pos))
    np.testing.assert_array_equal(_bits(got.pos.numpy()), _bits(whole.pos[rows].numpy()))
    for name in ("label", "track", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))


@pytest.mark.parametrize("rate", [1.0, 1.7, 0.6])
def test_forgetting_factor_equals_jitted_jax_bit_for_bit(rate):
    n = np.arange(8, dtype=np.int32)
    want = jax.jit(lambda a: jgeom.forgetting_factor(a, rate, 5))(n)
    got = tgeom.forgetting_factor(torch.from_numpy(n), rate, 5)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert got[0] == 1 and not got[5:].any() and (got[1:5] > 0).all()


@pytest.mark.parametrize("pose", sorted(POSES))
@pytest.mark.parametrize("preset", ["virtual_kitti2_config", "zed2_config"])
def test_point_in_frustum_equals_jax(preset, pose):
    """Seeded points, and points 1e-3 inside and outside each edge of the
    frustum: the depth range and both half-FOV planes on either side."""
    jcfg, tcfg = getattr(J, preset)(), getattr(T, preset)()
    quat, cam_pos = POSES[pose]
    _, _, r_cw, t_cw = jgeom.camera_matrices(jnp.asarray(cam_pos, jnp.float32),
                                             jnp.asarray(quat, jnp.float32))
    rng = np.random.RandomState(3)
    dmin, dmax = tcfg.depth_range_min, tcfg.depth_range_max
    tx, ty = tcfg.tan_half_fov_x, tcfg.tan_half_fov_y
    z = rng.uniform(dmin, dmax, 64)
    cam = [np.stack([rng.uniform(-1.3, 1.3, 64) * tx * z, rng.uniform(-1.3, 1.3, 64) * ty * z,
                     rng.uniform(dmin - 1, dmax + 1, 64)], -1)]
    for e in (-1e-3, 1e-3):
        zs = rng.uniform(dmin + 0.01, dmax - 0.01, 8)
        cam += [np.stack([(1 + e) * s * tx * zs, 0.2 * ty * zs, zs], -1) for s in (-1, 1)]
        cam += [np.stack([0.2 * tx * zs, (1 + e) * s * ty * zs, zs], -1) for s in (-1, 1)]
        cam += [np.stack([0 * zs, 0 * zs, np.full(8, d + e * s)], -1)
                for d, s in ((dmin, 1), (dmax, -1))]
    cam = np.concatenate(cam).astype(np.float32)
    # world points whose camera coordinates are ``cam``: p = R_wc (c - t_cw)
    r = np.asarray(r_cw, np.float64)
    pts = ((cam - np.asarray(t_cw, np.float64)) @ r).astype(np.float32)
    want = np.asarray(jax.jit(lambda p: jgeom.point_in_frustum(jcfg, r_cw, t_cw, p))(pts))
    got = tgeom.point_in_frustum(tcfg, torch.from_numpy(np.array(r_cw)),
                                 torch.from_numpy(np.array(t_cw)), torch.from_numpy(pts))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


def test_package_exports_every_name_of_the_jax_package():
    missing = sorted(set(J.__all__) - set(T.__all__))
    assert not missing, f"the port's __all__ lacks {missing}"
    for name in T.__all__:
        assert hasattr(T, name), name
    assert T.__version__ == J.__version__
    assert T.ObjectTable.__name__ == "ObjectTable" and callable(T.rasterize_masks)
