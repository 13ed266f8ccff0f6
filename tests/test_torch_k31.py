"""Stores of 31 slots a voxel (``max_particle_num_per_voxel_n = 5``) and
more: every K the config accepts runs on the card, and on the CPU through
the plain versions.

- ``SemanticDSPMap`` and ``build_shard_step`` built for the card (tested
  here without one: the device, or the group's backend, is made to read as
  the card's) at K = 63, 127 and 255 take the store as it is: the map goes
  on to allocate it, the sharded step is built;
- a CPU map runs K = 63;
- three frames of the dynamic scene at K = 31 through the JAX map and the
  port's CPU map: every counter, ``occ``, ``label`` and ``track`` equal, the
  state within the parity tolerances (K = 63 and 127:
  tests/test_torch_wide_k.py).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import semantic_dsp_map_tpu as J

import semantic_dsp_map_tpu_torch as T
from semantic_dsp_map_tpu_torch import map as map_module
from semantic_dsp_map_tpu_torch.parallel import distributed, shard_step

from torch_parity import dynamic_scene, hold_scene_against_jax

torch.set_num_threads(2)

SCENE_PARAMS = dict(
    if_consider_depth_noise=True,
    nb_ptc_num_per_point=1,
    depth_noise_model_zero_order=0.2,
    prediction_stddev=0.0,
)


class _Allocating(Exception):
    """Raised in place of the store's allocation on a card this host lacks."""


@pytest.mark.parametrize("slots_n", [6, 7, 8])  # K = 63, 127, 255
def test_map_takes_a_wide_store_on_the_card(monkeypatch, slots_n):
    """With the device resolved to the card, the map goes on to allocate a
    store of K = 63, 127 or 255 slots a voxel: nothing refuses it by K (a
    store the card cannot hold fails in the allocator, as any tensor)."""
    allocated = []

    def allocate(cfg, seed, device):
        allocated.append((cfg.slots_per_voxel, device))
        raise _Allocating

    monkeypatch.setattr(map_module, "resolve_device", lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(map_module, "init_map_state", allocate)
    with pytest.raises(_Allocating):
        T.SemanticDSPMap(T.tiny_test_config(max_particle_num_per_voxel_n=slots_n))
    assert allocated == [((1 << slots_n) - 1, torch.device("cuda", 0))]


@pytest.mark.parametrize("slots_n", [6, 7, 8])  # K = 63, 127, 255
def test_shard_step_takes_a_wide_store_in_an_nccl_group(monkeypatch, slots_n):
    """``build_shard_step`` in a group whose backend reads as NCCL (the
    ranks are cards) builds the step for K = 63, 127 and 255, as gloo (the
    CPU) does."""
    distributed.initialize(device="cpu")
    try:
        cfg = T.tiny_test_config(max_particle_num_per_voxel_n=slots_n)
        params, registry = T.FilterParams(), T.LabelRegistry.default()
        assert shard_step.build_shard_step(cfg, params, registry).static is None
        monkeypatch.setattr(shard_step.dist, "get_backend", lambda group=None: "nccl")
        step = shard_step.build_shard_step(cfg, params, registry)
        assert step.static is None and step.cfg.slots_per_voxel == (1 << slots_n) - 1
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
