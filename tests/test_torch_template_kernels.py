"""Template mode's kernel wrappers on the CPU (``ops/templates_cuda.py``):
on CPU tensors they run the plain versions and launch nothing.  The plain
delete pass against its definition at every edge case; the kernels
themselves against the plain versions in tests/test_torch_kernels_gpu.py,
on the card."""

import numpy as np
import pytest
import torch

from semantic_dsp_map_tpu_torch.ops.templates_cuda import delete_matched_cuda, template_gate_cuda
from semantic_dsp_map_tpu_torch.template_engine import delete_matched_plain, template_gate

from torch_parity import (
    GATE_CAR, TEMPLATE_DELETE_EDGES, TEMPLATE_GATE_EDGES, deleted_as_expected,
    template_delete_case, template_gate_tensors,
)


@pytest.mark.parametrize("O", [64, 8])
@pytest.mark.parametrize("kind", TEMPLATE_GATE_EDGES)
def test_gate_wrapper_takes_the_plain_path_on_the_cpu(kind, O):
    objects, cloud = template_gate_tensors(kind, O, 7, 13, "cpu")
    before = template_gate_cuda.launches
    got = template_gate_cuda(GATE_CAR, objects, cloud)
    assert template_gate_cuda.launches == before
    assert got.dtype == torch.int32 and got.shape == (O, 8)
    assert torch.equal(got, template_gate(GATE_CAR, objects, cloud))


@pytest.mark.parametrize("n", [1001, 4096])  # with and without a ragged tail
@pytest.mark.parametrize("kind", TEMPLATE_DELETE_EDGES)
def test_delete_wrapper_takes_the_plain_path_on_the_cpu(kind, n):
    """INVALID exactly where a good slot's id is the track, every other
    status and every track as they were."""
    track, status, good, tid = template_delete_case(kind, n)
    want = deleted_as_expected(track, status, good, tid)
    t, s = torch.from_numpy(track.copy()), torch.from_numpy(status.copy())
    before = delete_matched_cuda.launches
    delete_matched_cuda(t, s, torch.from_numpy(good), torch.from_numpy(tid))
    assert delete_matched_cuda.launches == before
    np.testing.assert_array_equal(s.numpy(), want)
    np.testing.assert_array_equal(t.numpy(), track)
    s2 = torch.from_numpy(status.copy())
    delete_matched_plain(t, s2, torch.from_numpy(good), torch.from_numpy(tid))
    assert torch.equal(s, s2)
