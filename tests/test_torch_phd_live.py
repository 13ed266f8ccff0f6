"""The live planes of a pixel table (``ops.phd.live_planes``): the words
the PHD passes' wide instances work from, and the CPU path of their CUDA
passes' wrappers (``ops.phd_cuda.live_weights_cuda``,
``live_tracks_cuda``), against numpy's bit packing."""

import numpy as np
import pytest
import torch

from semantic_dsp_map_tpu_torch.ops import phd, phd_cuda


def _packed(live: np.ndarray) -> np.ndarray:
    """bool[S, H, W] -> i32 words [ceil(S / 32), H, W], bit b of word g for
    plane 32g + b, by numpy's little-endian bit packing."""
    S, H, W = live.shape
    G = -(-S // 32)
    planes = np.zeros((G * 32, H, W), bool)
    planes[:S] = live
    packed = np.packbits(planes.reshape(G, 32, H, W), axis=1, bitorder="little")
    return np.ascontiguousarray(packed.transpose(0, 2, 3, 1)).view("<u4")[..., 0].view(np.int32)


@pytest.mark.parametrize("S,H,W", [(1, 3, 5), (31, 4, 7), (32, 2, 9), (33, 5, 3), (70, 3, 4),
                                   (512, 2, 3)])
def test_live_planes_pack_the_planes_as_numpy_does(S, H, W):
    rng = np.random.RandomState(S)
    live = rng.rand(S, H, W) < 0.3
    live[:, 0, 0] = True  # a pixel with every plane live: bit 31 is the sign bit
    words = phd.live_planes(torch.from_numpy(live))
    assert words.dtype == torch.int32 and words.shape == (-(-S // 32), H, W)
    np.testing.assert_array_equal(words.numpy(), _packed(live))


def test_live_wrappers_on_the_cpu_run_the_plain_version():
    """On CPU tensors the wrappers run ``live_planes``: w_eff's +0 and -0
    are empty and NaN is live; trk_eff's -2 is empty, and there acc and
    right are zeroed while the occupied entries keep what they held.  No
    launch is counted."""
    rng = np.random.RandomState(3)
    u = torch.from_numpy(rng.rand(40, 6, 7).astype(np.float32))
    weff = torch.where(u < 0.4, 0.0, u)
    weff = torch.where(u < 0.2, -0.0, weff)
    weff = torch.where(u > 0.95, float("nan"), weff)
    launches = (phd_cuda.live_weights_cuda.launches, phd_cuda.live_tracks_cuda.launches)
    np.testing.assert_array_equal(phd_cuda.live_weights_cuda(weff).numpy(),
                                  _packed((u >= 0.4).numpy()))
    trk = torch.where(u < 0.5, -2, (u * 50).int())
    acc = torch.full(u.shape, 7.0)
    right = torch.ones(u.shape, dtype=torch.bool)
    words = phd_cuda.live_tracks_cuda(trk, acc, right)
    occupied = trk != -2
    np.testing.assert_array_equal(words.numpy(), _packed(occupied.numpy()))
    assert torch.equal(acc, torch.where(occupied, 7.0, 0.0)) and torch.equal(right, occupied)
    assert (phd_cuda.live_weights_cuda.launches, phd_cuda.live_tracks_cuda.launches) == launches
