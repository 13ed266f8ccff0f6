"""Stores of 31 slots a voxel (``max_particle_num_per_voxel_n = 5``), the
largest K the port's CUDA kernels take, and the refusal above it.

- ``ops.cuda_lib.check_slots``: K <= 31 passes on every device; K = 63
  (n = 6, which the config accepts) raises a ValueError that names K, the
  limit and the config field on a CUDA device and passes on the CPU;
- ``SemanticDSPMap`` and ``build_shard_step`` call it when they are built
  (tested here without a card: the device, or the group's backend, is
  made to read as the card's), and a CPU map still runs K = 63;
- three frames of the dynamic scene at K = 31 through the JAX map and the
  port's CPU map: every counter, ``occ``, ``label`` and ``track`` equal,
  the state within the parity tolerances.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import semantic_dsp_map_tpu as J

import semantic_dsp_map_tpu_torch as T
from semantic_dsp_map_tpu_torch import map as map_module
from semantic_dsp_map_tpu_torch.ops import cuda_lib
from semantic_dsp_map_tpu_torch.parallel import distributed, shard_step

from torch_parity import dynamic_scene, hold_scene_against_jax

torch.set_num_threads(2)

SCENE_PARAMS = dict(
    if_consider_depth_noise=True,
    nb_ptc_num_per_point=1,
    depth_noise_model_zero_order=0.2,
    prediction_stddev=0.0,
)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("slots_n", [1, 2, 3, 4, 5, 6])
def test_check_slots(slots_n, device):
    """K = 2^n - 1: the kernels take K = 1 to 31; K = 63 raises on a CUDA
    device only, naming K, the limit and the config field."""
    cfg = T.tiny_test_config(max_particle_num_per_voxel_n=slots_n)
    K = cfg.slots_per_voxel
    assert cuda_lib.MAX_SLOTS == 31
    if K <= cuda_lib.MAX_SLOTS or device == "cpu":
        cuda_lib.check_slots(cfg, device)
        cuda_lib.check_slots(cfg, torch.device(device))
        return
    for dev in (device, torch.device("cuda", 0)):
        with pytest.raises(ValueError) as err:
            cuda_lib.check_slots(cfg, dev)
        msg = str(err.value)
        assert "K = 63" in msg and "K <= 31" in msg, msg
        assert "max_particle_num_per_voxel_n = 6" in msg and "<= 5" in msg, msg


def test_map_refuses_k63_on_the_card(monkeypatch):
    """The map checks K as it is built, before it allocates anything: with
    the device resolved to the card, K = 63 raises."""
    allocated = []
    monkeypatch.setattr(map_module, "resolve_device", lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(map_module, "init_map_state", lambda *a: allocated.append(a))
    with pytest.raises(ValueError, match="K <= 31"):
        T.SemanticDSPMap(T.tiny_test_config(max_particle_num_per_voxel_n=6))
    assert not allocated


def test_shard_step_refuses_k63_in_an_nccl_group(monkeypatch):
    """``build_shard_step`` checks K against the group's backend: NCCL (the
    ranks are cards) refuses K = 63, gloo (the CPU) builds it."""
    distributed.initialize(device="cpu")
    try:
        cfg = T.tiny_test_config(max_particle_num_per_voxel_n=6)
        params, registry = T.FilterParams(), T.LabelRegistry.default()
        assert shard_step.build_shard_step(cfg, params, registry).static is None
        monkeypatch.setattr(shard_step.dist, "get_backend", lambda group=None: "nccl")
        with pytest.raises(ValueError, match="max_particle_num_per_voxel_n = 6"):
            shard_step.build_shard_step(cfg, params, registry)
        shard_step.build_shard_step(T.tiny_test_config(max_particle_num_per_voxel_n=5), params,
                                    registry)
    finally:
        dist.destroy_process_group()


def test_a_cpu_map_runs_k63():
    """The CPU runs every K the config accepts through the plain versions."""
    dsp = T.SemanticDSPMap(T.tiny_test_config(max_particle_num_per_voxel_n=6),
                           T.FilterParams(**SCENE_PARAMS), device="cpu")
    for t in range(2):
        res, diag = dsp.update(*dynamic_scene(dsp.cfg, t, T.MaskKpts))
    assert dsp.cfg.slots_per_voxel == 63
    assert int(diag.born_count) > 0 and (res.occ == 1).any()
    assert int((dsp.state.particles.status != 0).sum()) > 0


def test_three_frames_at_k31_match_jax():
    """Three frames of the dynamic scene at K = 31 through the JAX map and
    the port's CPU map (the plain versions of the four per-voxel kernels on
    every frame): counters, occ, label and track equal, the state within
    the parity tolerances; the car moves and voxels fill more than one
    slot."""
    diags, _, tm = hold_scene_against_jax(
        J.config.tiny_test_config(max_particle_num_per_voxel_n=5),
        T.tiny_test_config(max_particle_num_per_voxel_n=5), SCENE_PARAMS, dynamic_scene, 3)
    assert tm.cfg.slots_per_voxel == 31
    assert sum(d["moved_count"] for d in diags) > 0
    assert all(d["born_count"] > 0 for d in diags)
    occupied = (tm.state.particles.status.view(-1, 31) != 0).sum(1)
    assert int(occupied.max()) > 1 and np.isfinite(tm.state.particles.weight.numpy()).all()
