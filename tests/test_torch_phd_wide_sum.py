"""The summation order of pass A's wide instance (csrc/phd.cu
``pass_a_wide_kernel``), replayed in float32 on the CPU.

The kernel adds a pixel's terms in list order: plane groups of 32 in
ascending order, inside a group sub-groups of ``A_CAP // n`` planes where the
group's live entries overflow the block's list, inside those window row by
window row, each row's entries (columns ascending, each column's slots
ascending) into a partial of its own that is then added to the pixel's total.
One accumulator added to term by term parted from the plain stencil by 5.1e-5
relative on a full table at S = 512 and R = 5 (61,952 terms a pixel, on an
H100), past the rtol 2e-5 of every check.  Here that order is replayed over
a full S = 512, R = 5 table on a 19 x 40 image and held to ``pass_a_raw``
with a margin; the one-accumulator order is replayed beside it and must do
worse."""

import numpy as np
import pytest
import torch

from semantic_dsp_map_tpu_torch import FilterParams, tiny_test_config
from semantic_dsp_map_tpu_torch.ops import phd

from torch_parity import phd_table_cloud

torch.set_num_threads(2)

#: pass_a_wide_kernel's list and tile (csrc/phd.cu A_CAP, A_TW, A_TH).
A_CAP, A_TW, A_TH = 2048, 32, 8
S, R, H, W = 512, 5, 19, 40


def _terms(params, slots, px, py, pz, weff, trk, ox, oy, oz, isg, otrk):
    """term[i, dm, dn, y, x]: the kernel's f32 expression for the entry of
    slot ``slots[i]`` at window offset (dm, dn) of pixel (y, x); 0 outside
    the image."""
    side = 2 * R + 1
    pad = lambda a, fill: torch.nn.functional.pad(a[slots], (R, R, R, R), value=fill)
    ppx, ppy, ppz, pw = (pad(a, 0.0) for a in (px, py, pz, weff))
    ptrk = pad(trk, -1)
    out = torch.empty((len(slots), side, side, H, W), dtype=torch.float32)
    coef3 = torch.tensor(phd._COEF3, dtype=torch.float32)
    for dm in range(side):
        for dn in range(side):
            win = lambda a: a[:, dm:dm + H, dn:dn + W]
            zx = (win(ppx) - ox) * isg
            zy = (win(ppy) - oy) * isg
            zz = (win(ppz) - oz) * isg
            gk = coef3 * torch.exp(-0.5 * (zx * zx + zy * zy + zz * zz))
            gk = torch.where(win(ptrk) != otrk, gk * params.id_transition_probability, gk)
            out[:, dm, dn] = win(pw) * gk
    return out


def _fewest_halo_pixels():
    """The fewest pixels of the image in one tile's halo."""
    def span(lo, size, n):
        return min(lo + size + R, n) - max(lo - R, 0)
    return min(span(x0, A_TW, W) * span(y0, A_TH, H)
               for x0 in range(0, W, A_TW) for y0 in range(0, H, A_TH))


def _kernel_order(params, args):
    """(the kernel's sum, one accumulator's sum) in the list order of a full
    table: every tile's halo overflows the list with one group's planes, so
    every group runs in sub-groups of A_CAP // n planes (n: the halo's
    pixels, those outside the image included)."""
    n = (A_TW + 2 * R) * (A_TH + 2 * R)
    assert _fewest_halo_pixels() * 32 > A_CAP
    step = A_CAP // n
    side = 2 * R + 1
    total = torch.zeros((H, W), dtype=torch.float32)
    single = torch.zeros((H, W), dtype=torch.float32)
    for g in range(0, S, 32):
        for b0 in range(0, 32, step):
            slots = list(range(g + b0, g + min(b0 + step, 32)))
            terms = _terms(params, slots, *args)
            for dm in range(side):
                part = torch.zeros((H, W), dtype=torch.float32)
                for dn in range(side):
                    for i in range(len(slots)):
                        part += terms[i, dm, dn]
                        single += terms[i, dm, dn]
                total += part
    return total, single


def _max_rel(got, want):
    big = want.abs() > 1e-6
    return float(((got.double() - want.double()).abs() / want.double().abs())[big].max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pass_a_wide_sum_order_holds_the_tolerance_on_a_full_table(seed):
    cfg = tiny_test_config(image_width=W, image_height=H, phd_pixel_table_slots=S,
                           phd_neighbor_half=R)
    params = FilterParams(detection_probability=0.9, noise_number=0.1, if_consider_depth_noise=True)
    table, cloud = phd_table_cloud(S, H, W, seed, kind="full")
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    pos = T(cloud["pos"])
    args = (T(table["px"]), T(table["py"]), T(table["pz"]), T(table["weight"]),
            T(table["meta"]) >> 8, pos[..., 0].contiguous(), pos[..., 1].contiguous(),
            pos[..., 2].contiguous(), 1.0 / torch.clamp(T(cloud["sigma"]), min=1e-6),
            T(cloud["track"]))
    assert bool((args[3] != 0).all())
    want = phd.pass_a_raw(cfg, params, *args)
    got, single = _kernel_order(params, args)
    rel, rel_single = _max_rel(got, want), _max_rel(single, want)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-6)
    assert rel < 0.25 * 2e-5, f"the kernel's order parts by {rel:.2e}"
    assert rel < rel_single, f"row partials {rel:.2e}, one accumulator {rel_single:.2e}"
