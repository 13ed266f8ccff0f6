"""The plain versions of the port's observe kernels against the JAX Pallas
kernels (interpret mode on the CPU): the dense candidate scan
(front_candidates) and the movable-voxel scan (movable_voxels), on
numpy-seeded stores with mixed status, stamps and tracks, a scrolled map and
an identity or rotated pose, and on stores with every slot dead, every slot
alive and all but one stretch of slots empty, at K = 3 and K = 7.  Outputs are u8 flags and must be equal.
Also: the CUDA wrappers run the plain scans on CPU tensors and count no
launch."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_dsp_map_tpu.config import tiny_test_config as j_tiny
from semantic_dsp_map_tpu.ops.geometry import camera_matrices as j_cam
from semantic_dsp_map_tpu.ops.observe_pallas import front_candidates, movable_voxels
from semantic_dsp_map_tpu.state import init_map_state as j_init_state

from semantic_dsp_map_tpu_torch.config import tiny_test_config
from semantic_dsp_map_tpu_torch.labels import LabelRegistry
from semantic_dsp_map_tpu_torch.ops import codecs
from semantic_dsp_map_tpu_torch.ops.geometry import camera_matrices
from semantic_dsp_map_tpu_torch.ops.observe import front_candidates_plain, movable_voxels_plain
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
