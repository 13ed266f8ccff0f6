"""The command's own behaviour without a card, and the allocator setting."""

import subprocess
import sys
from pathlib import Path

import pytest

from dspbench import run

REPO = Path(__file__).resolve().parents[2]


def test_without_a_card_it_fails_and_prints_no_result():
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "dspbench.run", "--workload", "vkitti2.drive",
                          "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


def test_an_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        from dspbench import harness

        harness.load_cell("no_such.cell")


def test_the_allocator_thresholds_can_be_fixed():
    run.fix_allocator()  # raises where glibc refuses


def test_the_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "semantic_dsp_map_tpu_torch_like", object())
    assert "semantic_dsp_map_tpu" not in run.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_loaded() == ["jax"]
