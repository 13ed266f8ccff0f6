"""The z-slab split of the map state over the ranks of a process group
(counterpart of ``semantic_dsp_map_tpu/parallel/sharding.py``'s
``shard_state``).

Every [V] and [V*K] tensor of the state (the particle store, the voxel
stamps) splits on its leading dimension: the flat voxel index is z-major
(codecs.ring_to_voxel), so rank d holds nz/D whole z-planes.  The scroll
state, the object table and the counters are small and replicated.
``unshard_state`` and ``gather_render`` put the slabs back together on every
rank, for checks against the single-device step.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..config import MapConfig
from ..ops.render import RenderResult
from ..state import MapState, Particles


def shard_state(cfg: MapConfig, state: MapState, rank: int, D: int) -> MapState:
    """Rank ``rank``'s z-slab of the whole-grid ``state``: its share of every
    voxel-sized tensor, copies of the replicated ones, and a generator in
    the same state as the given one (the same seed on every rank)."""
    V, K = cfg.num_voxels, cfg.slots_per_voxel
    if V % D or cfg.nz % D:
        raise ValueError(f"grid ({cfg.nz} z-planes, {V} voxels) not divisible by {D} ranks")
    cut = lambda t: t[rank * (t.shape[0] // D) : (rank + 1) * (t.shape[0] // D)].clone()
    copy = lambda obj: dataclasses.replace(
        obj, **{f.name: getattr(obj, f.name).clone() for f in dataclasses.fields(obj)})
    rng = torch.Generator(device=state.rng.device)
    rng.set_state(state.rng.get_state())
    return MapState(
        particles=Particles(**{f.name: cut(getattr(state.particles, f.name))
                               for f in dataclasses.fields(Particles)}),
        voxel_stamp=cut(state.voxel_stamp),
        scroll=copy(state.scroll),
        objects=copy(state.objects),
        global_time=state.global_time.clone(),
        prev_frame_time=state.prev_frame_time.clone(),
        rng=rng,
    )


def _all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def unshard_state(state: MapState, group=None) -> MapState:
    """The whole-grid state from every rank's slab, on every rank (the
    replicated parts are this rank's)."""
    return dataclasses.replace(
        state,
        particles=Particles(**{f.name: _all_gather(getattr(state.particles, f.name), group)
                               for f in dataclasses.fields(Particles)}),
        voxel_stamp=_all_gather(state.voxel_stamp, group),
    )


def gather_render(result: RenderResult, group=None) -> RenderResult:
    """The whole-grid render from every rank's [V/D] slab, on every rank."""
    return RenderResult(*(_all_gather(t, group) for t in result))
