"""The plain versions of the port's observe kernels against the JAX Pallas
kernels (interpret mode on the CPU): the dense candidate scan
(front_candidates) and the movable-voxel scan (movable_voxels), on
numpy-seeded stores with mixed status, stamps and tracks, a scrolled map and
an identity or rotated pose, and on stores with every slot dead, every slot
alive and all but one stretch of slots empty, at K = 3 and K = 7 (the
movable scan at K = 31 too).  Outputs are u8 flags and must be equal.
Also: the CUDA wrappers run the plain scans on CPU tensors and count no
launch."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_dsp_map_tpu.config import tiny_test_config as j_tiny
from semantic_dsp_map_tpu.ops import codecs as j_codecs
from semantic_dsp_map_tpu.ops.geometry import camera_matrices as j_cam
from semantic_dsp_map_tpu.ops.observe import refresh_empty_voxel_stamps as j_refresh
from semantic_dsp_map_tpu.ops.observe_pallas import front_candidates, movable_voxels
from semantic_dsp_map_tpu.state import init_map_state as j_init_state

from semantic_dsp_map_tpu_torch.config import tiny_test_config
from semantic_dsp_map_tpu_torch.labels import LabelRegistry
from semantic_dsp_map_tpu_torch.ops import codecs
from semantic_dsp_map_tpu_torch.ops.geometry import camera_matrices
from semantic_dsp_map_tpu_torch.ops.observe import (
    front_candidates_plain, movable_voxels_plain, refresh_empty_voxel_stamps,
)
from semantic_dsp_map_tpu_torch.ops.observe_cuda import front_candidates_cuda, movable_voxels_cuda
from semantic_dsp_map_tpu_torch.state import init_scroll

from torch_parity import particle_store

torch.set_num_threads(2)

POSES = {
    "identity": ([0.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0]),
    # 30 degrees about y, then a small roll, off the origin
    "rotated": ([0.4, -0.2, 0.7], [0.9622502, 0.0544331, 0.2613872, 0.0555144]),
}
MAX_MOVABLE = LabelRegistry.default().max_movable_instance_id


def _store(cfg, seed, kind="mixed"):
    """Flat particle fields and axis stamps as numpy (torch_parity.particle_store)."""
    return particle_store(cfg.num_voxels * cfg.slots_per_voxel, (cfg.nx, cfg.ny, cfg.nz),
                          seed, MAX_MOVABLE, kind)


def _jax_inputs(cfg, d):
    s = j_init_state(cfg)
    p = s.particles.replace(
        **{k: jnp.asarray(d[k]) for k in ("px", "py", "pz", "status", "stamp")},
        track=jnp.asarray(d["track"].astype(np.uint16)),
    )
    sc = s.scroll.replace(**{f"axis_stamp_{a}": jnp.asarray(v) for a, v in zip("xyz", d["axis"])})
    return p, sc


def _torch_inputs(cfg, d):
    scroll = dataclasses.replace(
        init_scroll(cfg, device="cpu"), **{f"axis_stamp_{a}": torch.from_numpy(v) for a, v in zip("xyz", d["axis"])}
    )
    t = {k: torch.from_numpy(d[k]) for k in ("px", "py", "pz", "status", "stamp", "track")}
    return t, codecs.axis_stamps_per_voxel(cfg, scroll)


@pytest.mark.parametrize("seed", [3, 8])
@pytest.mark.parametrize("pose", sorted(POSES))
def test_front_candidates_plain_matches_pallas(pose, seed):
    cfg_j, cfg_t = j_tiny(), tiny_test_config()
    d = _store(cfg_t, seed)
    pos, quat = (np.asarray(a, np.float32) for a in POSES[pose])
    _, _, jr, jt = j_cam(jnp.asarray(pos), jnp.asarray(quat))
    _, _, tr, tt = camera_matrices(torch.from_numpy(pos), torch.from_numpy(quat))
    jp, jsc = _jax_inputs(cfg_j, d)
    ha_j, hc_j = front_candidates(cfg_j, jp, jsc, jr, jt, True)

    t, vax = _torch_inputs(cfg_t, d)
    args = (cfg_t, t["px"], t["py"], t["pz"], t["status"], t["stamp"], vax, tr, tt)
    ha, hc = front_candidates_plain(*args)
    assert ha.dtype == hc.dtype == torch.uint8
    np.testing.assert_array_equal(ha.numpy(), np.asarray(ha_j))
    np.testing.assert_array_equal(hc.numpy(), np.asarray(hc_j))
    # a real share of voxels on both sides of each flag
    V = cfg_t.num_voxels
    assert 0 < int(hc.sum()) < int(ha.sum()) < V

    before = front_candidates_cuda.launches
    ha_w, hc_w = front_candidates_cuda(*args)
    assert front_candidates_cuda.launches == before
    assert torch.equal(ha_w, ha) and torch.equal(hc_w, hc)


@pytest.mark.parametrize("slots_n", [2, 3])  # K = 3 and K = 7
@pytest.mark.parametrize("kind", ["all_dead", "all_alive", "sparse"])
def test_front_candidates_plain_matches_pallas_at_the_edges(kind, slots_n):
    """Stores with no live slot, with only live slots and with one stretch of
    slots in use: what the CUDA
    kernel's per-voxel OR is held against on the card is itself held to the
    Pallas kernel here, byte for byte."""
    cfg_j = j_tiny(max_particle_num_per_voxel_n=slots_n)
    cfg_t = tiny_test_config(max_particle_num_per_voxel_n=slots_n)
    d = _store(cfg_t, 5, kind)
    pos, quat = (np.asarray(a, np.float32) for a in POSES["rotated"])
    _, _, jr, jt = j_cam(jnp.asarray(pos), jnp.asarray(quat))
    _, _, tr, tt = camera_matrices(torch.from_numpy(pos), torch.from_numpy(quat))
    jp, jsc = _jax_inputs(cfg_j, d)
    ha_j, hc_j = front_candidates(cfg_j, jp, jsc, jr, jt, True)

    t, vax = _torch_inputs(cfg_t, d)
    ha, hc = front_candidates_plain(
        cfg_t, t["px"], t["py"], t["pz"], t["status"], t["stamp"], vax, tr, tt)
    np.testing.assert_array_equal(ha.numpy(), np.asarray(ha_j))
    np.testing.assert_array_equal(hc.numpy(), np.asarray(hc_j))
    V = cfg_t.num_voxels
    if kind == "all_dead":
        assert int(ha.sum()) == 0 and int(hc.sum()) == 0
    elif kind == "all_alive":
        assert int(ha.sum()) == V and 0 < int(hc.sum()) < V
    else:
        assert 0 < int(ha.sum()) < V // 20


@pytest.mark.parametrize("slots_n", [2, 3, 5])  # K = 3, 7 and 31
@pytest.mark.parametrize("kind", ["mixed", "all_dead", "all_alive", "sparse"])
def test_movable_voxels_plain_matches_pallas_at_the_edges(kind, slots_n):
    """The movable scan's plain version, the oracle of the CUDA kernel, held
    to the Pallas kernel byte for byte up to the 31 slots a voxel the CUDA
    kernels take, on stores with no live slot, only live slots and one
    stretch of slots in use."""
    cfg_j = j_tiny(max_particle_num_per_voxel_n=slots_n)
    cfg_t = tiny_test_config(max_particle_num_per_voxel_n=slots_n)
    d = _store(cfg_t, 6, kind)
    jp, jsc = _jax_inputs(cfg_j, d)
    hm_j = movable_voxels(cfg_j, jp, jsc, MAX_MOVABLE, True)
    t, vax = _torch_inputs(cfg_t, d)
    hm = movable_voxels_plain(cfg_t, t["track"], t["status"], t["stamp"], vax, MAX_MOVABLE)
    np.testing.assert_array_equal(hm.numpy(), np.asarray(hm_j))
    V = cfg_t.num_voxels
    if kind == "all_dead":
        assert int(hm.sum()) == 0
    else:
        assert 0 < int(hm.sum()) <= V


@pytest.mark.parametrize("seed", [3, 8])
def test_movable_voxels_plain_matches_pallas(seed):
    cfg_j, cfg_t = j_tiny(), tiny_test_config()
    d = _store(cfg_t, seed)
    jp, jsc = _jax_inputs(cfg_j, d)
    hm_j = movable_voxels(cfg_j, jp, jsc, MAX_MOVABLE, True)

    t, vax = _torch_inputs(cfg_t, d)
    args = (cfg_t, t["track"], t["status"], t["stamp"], vax, MAX_MOVABLE)
    hm = movable_voxels_plain(*args)
    assert hm.dtype == torch.uint8
    np.testing.assert_array_equal(hm.numpy(), np.asarray(hm_j))
    assert 0 < int(hm.sum()) < cfg_t.num_voxels

    before = movable_voxels_cuda.launches
    assert torch.equal(movable_voxels_cuda(*args), hm)
    assert movable_voxels_cuda.launches == before


@pytest.mark.parametrize("rank", [0, 1, 3])
def test_empty_voxel_stamps_on_a_slab_match_jax(rank):
    """The empty-voxel rule on one rank's z-slab (D = 4, ``vox_base`` its
    first voxel): the corners project from their global ids, under the
    rotated pose, against a random depth image."""
    D = 4
    jcfg, tcfg = j_tiny(corner_gather_blocks=1), tiny_test_config(corner_gather_blocks=1)
    V_loc, nz_loc = tcfg.num_voxels // D, tcfg.nz // D
    rng = np.random.RandomState(rank)
    stamp = np.where(rng.rand(V_loc) < 0.3, rng.randint(1, 4, V_loc), 0).astype(np.int32)
    has_alive = rng.rand(V_loc) < 0.2
    depth = (rng.rand(tcfg.height, tcfg.width) * 3 + 0.5).astype(np.float32)
    axis = [rng.randint(0, 3, n).astype(np.int32) for n in (tcfg.nx, tcfg.ny, tcfg.nz)]
    pos, quat = (np.asarray(a, np.float32) for a in POSES["rotated"])
    jsc = j_init_state(jcfg).scroll.replace(**{f"axis_stamp_{a}": jnp.asarray(v) for a, v in zip("xyz", axis)})
    tsc = dataclasses.replace(init_scroll(tcfg, device="cpu"),
                              **{f"axis_stamp_{a}": torch.from_numpy(v) for a, v in zip("xyz", axis)})
    _, _, jr, jt = j_cam(jnp.asarray(pos), jnp.asarray(quat))
    _, _, tr, tt = camera_matrices(torch.from_numpy(pos), torch.from_numpy(quat))
    j_axis = j_codecs.axis_stamps_per_voxel_slab(jcfg, jsc, rank * nz_loc, nz_loc)
    t_axis = codecs.axis_stamps_per_voxel_slab(tcfg, tsc, rank * nz_loc, nz_loc)
    want, want_ov = j_refresh(jcfg, jsc, jnp.asarray(stamp), jnp.asarray(has_alive), jnp.asarray(depth),
                              jr, jt, jnp.int32(5), vox_base=rank * V_loc, vox_axis=j_axis)
    got, got_ov = refresh_empty_voxel_stamps(
        tcfg, tsc, torch.from_numpy(stamp.copy()), torch.from_numpy(has_alive),
        torch.from_numpy(depth), tr, tt, torch.tensor(5, dtype=torch.int32), vox_axis=t_axis,
        vox_base=rank * V_loc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got_ov) == int(want_ov)
