"""The port's segment scans (``ops/blocks.segment_start_index``,
``group_rank``, ``segment_cumsum``) against the JAX package's associative
scans: ``group_rank``'s max-scan (``semantic_dsp_map_tpu/ops/blocks.py``) and
observe's segmented sum ``_seg_cumsum`` (``semantic_dsp_map_tpu/ops/observe.py``),
and against the ``torch.cummax`` form the port used before.  Integers must be
equal.  Inputs are made from a seed with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_dsp_map_tpu.ops import blocks as jblocks
from semantic_dsp_map_tpu.ops.observe import _seg_cumsum

from semantic_dsp_map_tpu_torch.ops import blocks

from host_sync_audit import HostSyncAudit

torch.set_num_threads(2)

LENGTHS = [1, 2, 3, 4096, 1_000_003]
#: HW at the VKITTI2 preset (observe's pixel sentinel) and V (birth's voxel
#: sentinel): the sorted streams end in one long run of the sentinel.
HW, V = 1242 * 375, 8_388_608
PATTERNS = ["first_only", "every", "density_0.01", "density_0.1", "density_0.5",
            "tail_at_HW", "tail_at_V"]

_j_group_rank = jax.jit(jblocks.group_rank)
_j_seg_cumsum = jax.jit(_seg_cumsum)


def sorted_keys(n, pattern, seed=0):
    """int32[n], sorted: runs of equal keys as ``pattern`` says."""
    rng = np.random.RandomState(seed + n)
    if pattern.startswith("tail_at_"):
        sentinel = HW if pattern == "tail_at_HW" else V
        keys = np.sort(rng.randint(0, sentinel, n))
        keys[n - max(1, n // 4):] = sentinel
        return keys.astype(np.int32)
    if pattern == "first_only":
        start = np.zeros(n, bool)
    elif pattern == "every":
        start = np.ones(n, bool)
    else:
        start = rng.rand(n) < float(pattern.split("_")[1])
    start[0] = True
    return (7 * (np.cumsum(start) - 1)).astype(np.int32)


def starts_of(keys):
    return np.concatenate([[True], keys[1:] != keys[:-1]])


def cummax_start(is_start):
    """The form the port used before: a running max of the starts' indices."""
    idx = torch.arange(is_start.shape[0])
    return torch.cummax(torch.where(is_start, idx, 0), dim=0).values


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("n", LENGTHS)
def test_group_rank_matches_jax(n, pattern):
    keys = sorted_keys(n, pattern)
    is_start = torch.from_numpy(starts_of(keys))
    want = np.asarray(_j_group_rank(jnp.asarray(keys)))
    rank = blocks.group_rank(torch.from_numpy(keys))
    np.testing.assert_array_equal(rank.numpy(), want)
    start = blocks.segment_start_index(is_start)
    np.testing.assert_array_equal(start.numpy(), np.arange(n) - want)
    assert torch.equal(start, cummax_start(is_start))


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("n", LENGTHS)
def test_visible_rank_matches_seg_cumsum(n, pattern):
    """observe's rank among the visible entries of a pixel's run:
    ``segment_cumsum(visible, is_start) - 1`` against the JAX package's
    ``_seg_cumsum(visible, is_start) - 1`` and the ``cummax`` form."""
    keys = sorted_keys(n, pattern, seed=1)
    visible = np.random.RandomState(n).rand(n) < 0.6
    is_start = starts_of(keys)
    want = np.asarray(_j_seg_cumsum(jnp.asarray(visible.astype(np.int32)), jnp.asarray(is_start))) - 1
    v, s = torch.from_numpy(visible).to(torch.int64), torch.from_numpy(is_start)
    vrank = blocks.segment_cumsum(v, s) - 1
    np.testing.assert_array_equal(vrank.numpy(), want)
    start = cummax_start(s)
    cs = torch.cumsum(v, 0)
    assert torch.equal(vrank, cs - (cs[start] - v[start]) - 1)


def test_scans_make_no_host_read():
    """The new form runs inside the captured step: no op that reads the
    device to the host, sizes an output by the data or copies from the host."""
    keys = torch.from_numpy(sorted_keys(4096, "density_0.1"))
    is_start = torch.from_numpy(starts_of(keys.numpy()))
    visible = torch.from_numpy(np.random.RandomState(3).rand(4096) < 0.6).to(torch.int64)
    audit = HostSyncAudit()
    with audit:
        blocks.group_rank(keys)
        blocks.segment_start_index(is_start)
        blocks.segment_cumsum(visible, is_start)
    assert not audit.hits, dict(audit.hits)
