"""Voxel-block working sets (counterpart of
``semantic_dsp_map_tpu/ops/blocks.py``).

Per-particle work touches only the blocks (``block_voxels`` consecutive
voxels) that hold relevant particles: reduce the per-slot predicate to a
per-block mask, pick active blocks with one small sort into a FIXED-capacity
id list (overflow is counted, never silent), row-gather the working set,
compute on it densely, and row-scatter the rows back.  Fixed capacities keep
every shape static, so the frame step needs no data-dependent host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MapConfig


def block_layout(cfg: MapConfig):
    """(block_voxels, num_blocks, slots_per_block): blocks of ~256-512 slots."""
    K = cfg.slots_per_voxel
    bv = 1
    while bv * 2 * K <= 512 and bv * 2 <= cfg.num_voxels:
        bv *= 2
    return bv, cfg.num_voxels // bv, bv * K


class ActiveBlocks(NamedTuple):
    """``ids`` lists active block indices ascending, then padding ids
    (>= the block count, unique); ``count`` is the number of real rows and
    ``overflow`` the active blocks that did not fit."""

    ids: torch.Tensor       # i64[A]
    count: torch.Tensor     # i64 scalar
    overflow: torch.Tensor  # i64 scalar


def select_blocks(block_mask: torch.Tensor, capacity: int) -> ActiveBlocks:
    """Indices of the True entries of ``block_mask`` (bool[NB]), padded to
    ``capacity``."""
    nb = block_mask.shape[0]
    idx = torch.arange(nb, device=block_mask.device)
    key = torch.where(block_mask, idx, nb + idx)
    ids = torch.sort(key).values[:capacity]
    count = block_mask.sum()
    overflow = torch.clamp(count - capacity, min=0)
    return ActiveBlocks(ids=ids, count=torch.clamp(count, max=capacity), overflow=overflow)


def row_valid(blocks: ActiveBlocks) -> torch.Tensor:
    """bool[A]: which rows of a gathered working set are real."""
    return torch.arange(blocks.ids.shape[0], device=blocks.ids.device) < blocks.count


def gather_rows_flat(field: torch.Tensor, blocks: ActiveBlocks, row_len: int) -> torch.Tensor:
    """Rows ``[A, row_len]`` of the flat field viewed as ``[N/row_len,
    row_len]``; padding rows read the last row (callers mask them)."""
    nbk = field.shape[0] // row_len
    rows = field.view(nbk, row_len)
    return rows[torch.clamp(blocks.ids, max=nbk - 1)]


def scatter_rows_flat(
    field: torch.Tensor, blocks: ActiveBlocks, row_len: int, values: torch.Tensor
) -> torch.Tensor:
    """Write the working-set rows back into ``field`` IN PLACE and return it.

    Only the first ``count`` rows are real.  Padding rows are redirected to
    the first real row with that row's values (or, with no real row, to the
    last row with its current contents), so every duplicate index carries
    identical bytes and the result does not depend on write order."""
    nbk = field.shape[0] // row_len
    rows = field.view(nbk, row_len)
    values = values.reshape(values.shape[0], row_len).to(field.dtype)
    real = row_valid(blocks)
    has_real = blocks.count > 0
    first = torch.where(has_real, blocks.ids[0], nbk - 1)
    fill = torch.where(has_real, values[0], rows[nbk - 1])
    tgt = torch.where(real, blocks.ids, first)
    vals = torch.where(real[:, None], values, fill[None, :])
    rows.index_copy_(0, tgt, vals)
    return field


def segment_first(values: torch.Tensor, is_start: torch.Tensor) -> torch.Tensor:
    """``values`` at the first element of each element's segment; a segment
    starts where ``is_start`` (bool, same length) is set.  ``is_start[0]``
    must be set: every caller sets it, and it is not checked, since a check
    would read the device.

    The counterpart of the JAX package's associative scans: a segment id by
    ``cumsum``, one fixed-size scatter of the starts' values and one gather.
    Every non-start element writes 0 into the buffer's spare last slot, so
    the bytes do not depend on the order of the writes.  No host read and no
    shape that depends on the data: the captured step runs it."""
    n = is_start.shape[0]
    seg = torch.cumsum(is_start, 0) - 1
    first = torch.zeros(n + 1, dtype=values.dtype, device=values.device)
    first.index_copy_(0, torch.where(is_start, seg, n), torch.where(is_start, values, 0))
    return first[seg]


def segment_start_index(is_start: torch.Tensor) -> torch.Tensor:
    """Index of the first element of each element's segment (``is_start[0]``
    set, as for :func:`segment_first`)."""
    return segment_first(torch.arange(is_start.shape[0], device=is_start.device), is_start)


def segment_cumsum(values: torch.Tensor, is_start: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum of integer ``values`` that restarts at each
    segment start (``is_start[0]`` set, as for :func:`segment_first`)."""
    cs = torch.cumsum(values, 0)
    return cs - segment_first(cs - values, is_start)


def group_rank(sorted_key: torch.Tensor) -> torch.Tensor:
    """Rank of each element within runs of equal keys (input sorted)."""
    is_start = torch.ones(sorted_key.shape[0], dtype=torch.bool, device=sorted_key.device)
    is_start[1:] = sorted_key[1:] != sorted_key[:-1]
    return torch.arange(sorted_key.shape[0], device=sorted_key.device) - segment_start_index(is_start)


def stable_lexsort(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Permutation sorting by (primary, secondary), ties kept in input
    order — the order of the JAX package's stable two-key ``lax.sort``."""
    o = torch.sort(secondary, stable=True).indices
    return o[torch.sort(primary[o], stable=True).indices]
