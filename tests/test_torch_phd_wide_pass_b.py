"""Pass B's cases of tests/test_torch_phd_wide.py (see there): the plain
stencil against the Pallas pass B in interpret mode at R = 9, 12 and 16 and
at S = 512, and a half-width past the image."""

import pytest
import torch

from semantic_dsp_map_tpu.ops import phd_pallas

from test_torch_phd import _pass_b_at_the_edges
from test_torch_phd_wide import WIDE_CASES, _image, window_past_the_image

torch.set_num_threads(2)


@pytest.mark.parametrize("R,S,kind", WIDE_CASES)
def test_pass_b_plain_matches_pallas_at_the_edges_wide(monkeypatch, R, S, kind):
    monkeypatch.setattr(phd_pallas, "_GS", S)
    _pass_b_at_the_edges(kind, False, R, S, *_image(S))


def test_window_past_the_image_matches_pallas_pass_b(monkeypatch):
    window_past_the_image(monkeypatch, "pass_b")
