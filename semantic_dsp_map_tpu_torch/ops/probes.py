"""Plain PyTorch versions of the two primitive-op probes: the oracles of the
hand-written kernels in csrc/probes.cu, used by the CPU tests and by the
check on the card.

``gather_plain`` computes what the TPU kernel ``gather_kernel``
(``pallas_gather``, benchmarks/prim_bench7.py) computes, ``scale2_plain``
what ``k_`` (benchmarks/prim_bench1.py) computes.
"""

from __future__ import annotations

import torch


def gather_plain(depth: torch.Tensor, rc: torch.Tensor) -> torch.Tensor:
    """``out[i] = depth.reshape(-1)[rc[i]]``: f32[N] from an f32 table of any
    shape and i32[N] flat indices.  Indices outside ``[0, depth.numel())``
    are the caller's error."""
    if depth.dtype != torch.float32:
        raise ValueError(f"depth: expected torch.float32, got {depth.dtype}")
    if rc.dtype != torch.int32:
        raise ValueError(f"rc: expected torch.int32, got {rc.dtype}")
    if rc.dim() != 1:
        raise ValueError(f"rc: expected one dimension, got shape {tuple(rc.shape)}")
    return depth.reshape(-1)[rc]


def scale2_plain(x: torch.Tensor) -> torch.Tensor:
    """``x * 2.0`` for an f32 tensor."""
    if x.dtype != torch.float32:
        raise ValueError(f"x: expected torch.float32, got {x.dtype}")
    return x * 2.0
