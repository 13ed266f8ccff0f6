"""The benchmark's plain reference: a frozen copy of the eager frame step of
the PyTorch port (its config, frontend, labels, state, object layer, the
step and the step's ops), with every hand-written kernel replaced by its
plain PyTorch version (``ops.phd.stencil_passes``, ``ops.observe``'s two
scans, ``ops.render.render_any``, ``ops.birth.merge_blocks``).

It imports nothing of the port, of JAX or of the JAX package.  The
benchmark hands it the host arrays it hands the program (depth, masks,
pose, time) and the seed; it packs, unpacks and steps them itself.  It runs
with TF32 off, as its float32 arithmetic states.  ``Reference.frame(...,
lower=True)`` is the control of the output check: each float32
computation one step down, TF32 for the matmuls and bfloat16 for the state
the step keeps (:func:`round_state`).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .config import FilterParams, MapConfig
from .frontend import MaskKpts, pack_frame, static_label_table
from .labels import LabelRegistry
from .state import MapState, ObjectTable, Particles, ScrollState, init_map_state
from .step import build_frame_step, unpack_frame

__all__ = ["Reference", "round_state", "state_from_fields"]


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 matmuls (and cuDNN convolutions) on or off inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def round_state(state: MapState) -> MapState:
    """The state's float32 fields (particle positions and weights, the
    object table's floats) rounded to bfloat16 in place, as a store kept
    in bfloat16 would hold them."""
    groups = [state.particles, state.objects]
    for group in groups:
        for f in dataclasses.fields(group):
            t = getattr(group, f.name)
            if t.dtype == torch.float32:
                t.copy_(t.to(torch.bfloat16))
    return state


class Reference:
    """The frozen step for one configuration: ``cfg`` and ``params`` are
    the field dictionaries of ``MapConfig`` and ``FilterParams``."""

    def __init__(self, cfg: dict, params: dict, device):
        self.cfg = MapConfig(**cfg)
        self.params = FilterParams(**params)
        self.registry = LabelRegistry.default()
        self.device = torch.device(device)
        self.table = torch.from_numpy(static_label_table(self.registry)).to(self.device)
        self.step = build_frame_step(self.cfg, self.params, self.registry)

    def init_state(self, seed: int) -> MapState:
        return init_map_state(self.cfg, seed, self.device)

    def frame(self, state: MapState, depth: np.ndarray, masks, cam_pos, cam_quat, time: float,
              lower: bool = False):
        """One frame on ``state`` (updated in place): ``masks`` is a list of
        dictionaries with MaskKpts' fields.  Returns (state, RenderResult,
        StepDiagnostics).  With ``lower`` the control's: TF32 matmuls and
        the state rounded to bfloat16 before and after the step."""
        masks = [MaskKpts(**m) for m in masks]
        buf = pack_frame(self.cfg, self.registry, depth, masks, cam_pos, cam_quat, time)
        f = unpack_frame(self.cfg, self.table, torch.from_numpy(buf).to(self.device))
        with torch.no_grad(), tf32(lower):
            if lower:
                round_state(state)
            state, result, diag = self.step(state, f)
            if lower:
                round_state(state)
        return state, result, diag


def state_from_fields(fields: dict, device) -> MapState:
    """A MapState of this package from a nested dictionary of tensors, by
    field name (``particles``, ``scroll`` and ``objects`` dictionaries,
    ``voxel_stamp``, ``global_time``, ``prev_frame_time``, and ``rng`` a
    generator state to seed the state's generator with).  Every tensor is
    copied."""
    def build(cls, d):
        return cls(**{f.name: d[f.name].to(device, copy=True) for f in dataclasses.fields(cls)})

    rng = torch.Generator(device=device)
    rng.set_state(fields["rng"])
    return MapState(
        particles=build(Particles, fields["particles"]),
        voxel_stamp=fields["voxel_stamp"].to(device, copy=True),
        scroll=build(ScrollState, fields["scroll"]),
        objects=build(ObjectTable, fields["objects"]),
        global_time=fields["global_time"].to(device, copy=True),
        prev_frame_time=fields["prev_frame_time"].to(device, copy=True),
        rng=rng,
    )
