"""The port's index codecs, scroll and block helpers against the JAX
package (mirrors tests/test_codecs.py, with the JAX functions as the
reference)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_dsp_map_tpu.config import tiny_test_config as j_tiny
from semantic_dsp_map_tpu.ops import blocks as jblocks
from semantic_dsp_map_tpu.ops import codecs as jcodecs
from semantic_dsp_map_tpu.ops import geometry as jgeom
from semantic_dsp_map_tpu.state import init_scroll as j_init_scroll

from semantic_dsp_map_tpu_torch.config import tiny_test_config as t_tiny
from semantic_dsp_map_tpu_torch.ops import blocks as tblocks
from semantic_dsp_map_tpu_torch.ops import codecs as tcodecs
from semantic_dsp_map_tpu_torch.ops import geometry as tgeom
from semantic_dsp_map_tpu_torch.state import ScrollState, init_scroll as t_init_scroll

torch.set_num_threads(2)

JCFG, TCFG = j_tiny(), t_tiny()


def _assert_scroll_equal(ts, js):
    for f in dataclasses.fields(ScrollState):
        np.testing.assert_array_equal(
            getattr(ts, f.name).numpy(), np.asarray(getattr(js, f.name)), err_msg=f.name
        )


def test_ring_voxel_roundtrip():
    v = torch.arange(TCFG.num_voxels, dtype=torch.int32)
    xi, yi, zi = tcodecs.voxel_to_ring(TCFG, v)
    np.testing.assert_array_equal(tcodecs.ring_to_voxel(TCFG, xi, yi, zi).numpy(), v.numpy())
    jx, jy, jz = jcodecs.voxel_to_ring(JCFG, jnp.asarray(v.numpy()))
    for a, b in ((xi, jx), (yi, jy), (zi, jz)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_scroll_and_codecs_match_jax():
    """Random ego walk with large jumps (the multi-step path): scroll state,
    position -> voxel, voxel -> position and the per-voxel axis stamps
    agree with the JAX package at every step."""
    rng = np.random.RandomState(1)
    js, ts = j_init_scroll(JCFG), t_init_scroll(TCFG, device="cpu")
    pos = np.zeros(3)
    for t in range(1, 30):
        step = rng.uniform(-4, 6, 3) if t % 7 == 0 else rng.uniform(-0.4, 0.6, 3)
        pos = pos + step
        p32 = pos.astype(np.float32)
        js = jcodecs.update_ego_center(JCFG, js, jnp.asarray(p32), jnp.int32(t))
        ts = tcodecs.update_ego_center(
            TCFG, ts, torch.from_numpy(p32), torch.tensor(t, dtype=torch.int32)
        )
        _assert_scroll_equal(ts, js)

        pts = (pos + rng.uniform(-2, 2, size=(50, 3))).astype(np.float32)
        jv = jcodecs.global_pos_to_voxel(JCFG, js, jnp.asarray(pts))
        tv = tcodecs.global_pos_to_voxel(TCFG, ts, torch.from_numpy(pts))
        for a, b in zip(tv, jv):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

        vs = rng.randint(0, TCFG.num_voxels, 20).astype(np.int32)
        np.testing.assert_array_equal(
            tcodecs.voxel_to_global_pos(TCFG, ts, torch.from_numpy(vs)).numpy(),
            np.asarray(jcodecs.voxel_to_global_pos(JCFG, js, jnp.asarray(vs))),
        )
        np.testing.assert_array_equal(
            tcodecs.axis_stamps_per_voxel(TCFG, ts).numpy(),
            np.asarray(jcodecs.axis_stamps_per_voxel(JCFG, js)),
        )


@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_axis_stamps_per_voxel_slab_match_jax(D):
    """Each rank's z-slab of the per-voxel scroll stamps equals the JAX
    package's and its share of the whole grid's."""
    rng = np.random.RandomState(D)
    stamps = {a: rng.randint(0, 9, n).astype(np.int32) for a, n in zip("xyz", (TCFG.nx, TCFG.ny, TCFG.nz))}
    js = j_init_scroll(JCFG).replace(**{f"axis_stamp_{a}": jnp.asarray(v) for a, v in stamps.items()})
    ts = dataclasses.replace(t_init_scroll(TCFG, device="cpu"),
                             **{f"axis_stamp_{a}": torch.from_numpy(v) for a, v in stamps.items()})
    whole = tcodecs.axis_stamps_per_voxel(TCFG, ts).numpy()
    nz_loc, V_loc = TCFG.nz // D, TCFG.num_voxels // D
    for rank in range(D):
        got = tcodecs.axis_stamps_per_voxel_slab(TCFG, ts, rank * nz_loc, nz_loc).numpy()
        want = jcodecs.axis_stamps_per_voxel_slab(JCFG, js, rank * nz_loc, nz_loc)
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(got, whole[rank * V_loc : (rank + 1) * V_loc])


def test_alive_and_valid_match_jax():
    rng = np.random.RandomState(3)
    V, K = TCFG.num_voxels, TCFG.slots_per_voxel
    status = rng.randint(0, 4, (V, K)).astype(np.uint8)
    stamp = rng.randint(0, 4, (V, K)).astype(np.int32)
    vax = rng.randint(0, 3, V).astype(np.int32)
    vst = rng.randint(0, 4, V).astype(np.int32)
    np.testing.assert_array_equal(
        tcodecs.particle_alive(torch.from_numpy(status), torch.from_numpy(stamp),
                               torch.from_numpy(vax)).numpy(),
        np.asarray(jcodecs.particle_alive(status, stamp, vax)),
    )
    np.testing.assert_array_equal(
        tcodecs.voxel_valid(torch.from_numpy(vst), torch.from_numpy(vax)).numpy(),
        np.asarray(jcodecs.voxel_valid(vst, vax)),
    )


@pytest.mark.parametrize("quat", [[1, 0, 0, 0], [0.9, 0.1, -0.3, 0.2]])
def test_camera_projection_matches_jax(quat):
    rng = np.random.RandomState(4)
    q = np.asarray(quat, np.float32)
    q /= np.linalg.norm(q)
    cam_pos = np.array([0.3, -0.2, 0.5], np.float32)
    jm = jgeom.camera_matrices(jnp.asarray(cam_pos), jnp.asarray(q))
    tm = tgeom.camera_matrices(torch.from_numpy(cam_pos), torch.from_numpy(q))
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    pts = (rng.randn(400, 3) * 2 + np.array([0, 0, 3])).astype(np.float32)
    x, y, z = (pts[:, i] for i in range(3))
    jr = jgeom.project_to_image_xyz(JCFG, jm[2], jm[3], x, y, z)
    # same matrices on both sides: the projection itself must agree exactly
    r_cw, t_cw = (torch.from_numpy(np.array(a)) for a in jm[2:])
    tr = tgeom.project_to_image_xyz(TCFG, r_cw, t_cw, *(torch.from_numpy(a) for a in (x, y, z)))
    for a, b in zip(tr, jr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ff = np.arange(7, dtype=np.int32)
    np.testing.assert_allclose(
        tgeom.forgetting_factor(torch.from_numpy(ff), 1.0, 5).numpy(),
        np.asarray(jgeom.forgetting_factor(jnp.asarray(ff), 1.0, 5)),
        rtol=1e-6,
    )


def test_blocks_match_jax():
    """select_blocks / row gathers / row scatters / group_rank, including
    capacity overflow and padding rows."""
    rng = np.random.RandomState(5)
    nb = 40
    for capacity in (8, 40):
        mask = rng.rand(nb) < 0.4
        jb = jblocks.select_blocks(jnp.asarray(mask), capacity)
        tb = tblocks.select_blocks(torch.from_numpy(mask), capacity)
        np.testing.assert_array_equal(tb.ids.numpy(), np.asarray(jb.ids))
        assert int(tb.count) == int(jb.count) and int(tb.overflow) == int(jb.overflow)

        field = rng.randn(nb * 6).astype(np.float32)
        rows = rng.randn(capacity, 6).astype(np.float32)
        np.testing.assert_array_equal(
            tblocks.gather_rows_flat(torch.from_numpy(field), tb, 6).numpy(),
            np.asarray(jblocks.gather_rows_flat(jnp.asarray(field), jb, 6)),
        )
        out = tblocks.scatter_rows_flat(torch.from_numpy(field.copy()), tb, 6, torch.from_numpy(rows))
        want = jblocks.scatter_rows_flat(jnp.asarray(field), jb, 6, jnp.asarray(rows))
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))

    none = tblocks.select_blocks(torch.zeros(nb, dtype=torch.bool), 4)
    field = rng.randn(nb * 6).astype(np.float32)
    out = tblocks.scatter_rows_flat(torch.from_numpy(field.copy()), none, 6, torch.ones(4, 6))
    np.testing.assert_array_equal(out.numpy(), field)

    keys = np.sort(rng.randint(0, 9, 60)).astype(np.int32)
    np.testing.assert_array_equal(
        tblocks.group_rank(torch.from_numpy(keys)).numpy(),
        np.asarray(jblocks.group_rank(jnp.asarray(keys))),
    )
