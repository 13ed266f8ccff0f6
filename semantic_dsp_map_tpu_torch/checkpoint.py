"""Checkpoint / resume for the map state (counterpart of
``semantic_dsp_map_tpu/checkpoint.py``; the reference has no persistence,
SemanticDSPMap::clear, semantic_dsp_map.h:73-81).

A checkpoint is a directory with ``meta.json`` and ``state.pt``: every
state leaf as a tensor, keyed by its ``state.map_state_to_numpy`` name,
plus the generator's state.  A JAX checkpoint's leaves (the MapState
pytree leaves in field order, e.g. the ``leaf_<i>`` arrays of its npz
format) convert with ``jax_leaves_to_numpy`` and
``state.map_state_from_numpy``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .config import MapConfig
from .state import (
    MapState,
    ObjectTable,
    Particles,
    ScrollState,
    init_objects,
    init_particles,
    init_scroll,
    map_state_from_numpy,
    map_state_to_numpy,
    resolve_device,
)

_GROUPS = {"particles": Particles, "scroll": ScrollState, "objects": ObjectTable}


def leaf_names() -> List[str]:
    """The MapState leaves in field order (the JAX pytree's flatten order),
    ``rng`` last."""
    names = []
    for f in dataclasses.fields(MapState):
        cls = _GROUPS.get(f.name)
        names += [f"{f.name}.{g.name}" for g in dataclasses.fields(cls)] if cls else [f.name]
    return names


def jax_leaves_to_numpy(leaves: Sequence[np.ndarray]) -> Dict[str, np.ndarray]:
    """The leaves of a JAX MapState (``jax.tree_util.tree_leaves`` order, or
    a JAX npz checkpoint's ``leaf_0..``) -> the named numpy dict that
    ``state.map_state_from_numpy`` takes.  The JAX RNG key is dropped."""
    names = leaf_names()
    if len(leaves) != len(names):
        raise ValueError(f"{len(leaves)} leaves; a MapState has {len(names)}")
    return {n: np.asarray(a) for n, a in zip(names, leaves) if n != "rng"}


def _expected_shapes(cfg: MapConfig) -> Dict[str, tuple]:
    shapes = {"voxel_stamp": (cfg.num_voxels,), "global_time": (), "prev_frame_time": ()}
    for group, obj in (("particles", init_particles(cfg, "meta")), ("scroll", init_scroll(cfg, "meta")),
                       ("objects", init_objects(cfg, "meta"))):
        for f in dataclasses.fields(obj):
            shapes[f"{group}.{f.name}"] = tuple(getattr(obj, f.name).shape)
    return shapes


def save_checkpoint(path: str, state: MapState, step: Optional[int] = None):
    """Save the full map state under ``path`` (a directory)."""
    os.makedirs(path, exist_ok=True)
    leaves = {k: torch.from_numpy(np.array(v)) for k, v in map_state_to_numpy(state).items()}
    torch.save(
        {"leaves": leaves, "rng": state.rng.get_state(), "rng_device": state.rng.device.type},
        os.path.join(path, "state.pt"),
    )
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"format": "torch", "num_leaves": len(leaves), "step": step}, f)


def load_checkpoint(path: str, cfg: MapConfig, device=None) -> MapState:
    """Restore a map state saved by :func:`save_checkpoint`; ``cfg`` must
    match the saved configuration.  ``device=None`` means the card
    (state.resolve_device)."""
    device = resolve_device(device)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format") != "torch":
        raise ValueError(
            f"{path} holds a {meta.get('format')!r} checkpoint, not this package's; a JAX "
            "checkpoint's leaves convert with jax_leaves_to_numpy"
        )
    blob = torch.load(os.path.join(path, "state.pt"), weights_only=True)
    arrays = {k: v.numpy() for k, v in blob["leaves"].items()}
    for name, shape in _expected_shapes(cfg).items():
        if name not in arrays:
            raise ValueError(f"checkpoint has no leaf {name}")
        if tuple(arrays[name].shape) != shape:
            raise ValueError(f"{name}: checkpoint shape {arrays[name].shape} != config shape {shape}")
    state = map_state_from_numpy(arrays, device)
    if blob["rng_device"] == state.rng.device.type:
        state.rng.set_state(blob["rng"])
    return state
