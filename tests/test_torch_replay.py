"""The port's replay entry point on the committed sequence data/replay_tiny:
``run_replay`` on the CPU equal to EXPECTED.json frame for frame and to the
JAX package's ``run_replay`` (frame count, last occupancy, PLY vertices);
``replay.main`` with ``--device cpu``; and the default device."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import semantic_dsp_map_tpu as J
from semantic_dsp_map_tpu import replay as jreplay
from semantic_dsp_map_tpu.datasets import NpzSequence as JNpzSequence

import semantic_dsp_map_tpu_torch as T
from semantic_dsp_map_tpu_torch import replay as treplay
from semantic_dsp_map_tpu_torch.datasets import NpzSequence
from semantic_dsp_map_tpu_torch.io import read_ply
from semantic_dsp_map_tpu_torch.tools import make_replay_sequence as make_replay

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data", "replay_tiny")


def _replay_params():
    return dataclasses.asdict(make_replay.replay_params())


def test_replay_params_are_the_jax_tool_s():
    """The port's copy of the generator's parameters against the JAX tool's,
    field by field; and one generated frame against the JAX tool's."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import make_replay_sequence as jtool

    jp, tp = dataclasses.asdict(jtool.replay_params()), _replay_params()
    assert list(jp) == list(tp)
    for field in jp:
        assert jp[field] == tp[field] and type(jp[field]) is type(tp[field]), field
    assert (jtool.N_FRAMES, 2) == (make_replay.N_FRAMES, make_replay.DROP_FIRST)
    jf = jtool.make_frame(J.config.tiny_test_config(), 7)
    tf = make_replay.make_frame(T.tiny_test_config(), 7)
    assert jf.depth.tobytes() == tf.depth.tobytes() and (jf.time, jf.index) == (tf.time, tf.index)
    assert jf.masks[1].kpts_previous.tobytes() == tf.masks[1].kpts_previous.tobytes()


def test_replay_generator_writes_the_committed_sequence(tmp_path, capsys):
    """The port's generator into a directory of its own: the 12 npz frames
    equal to data/replay_tiny's array by array, the summary equal to
    EXPECTED.json, and nothing written elsewhere."""
    before = sorted(os.listdir(DATA))
    out = tmp_path / "seq"
    summary = make_replay.main(["--out", str(out), "--device", "cpu"])
    with open(os.path.join(DATA, "EXPECTED.json")) as f:
        expected = json.load(f)
    assert summary == expected
    with open(out / "EXPECTED.json") as f:
        assert json.load(f) == expected
    names = sorted(n for n in os.listdir(out) if n.endswith(".npz"))
    assert names == sorted(n for n in before if n.endswith(".npz")) and len(names) == 12
    for name in names:
        with np.load(out / name, allow_pickle=False) as got, \
                np.load(os.path.join(DATA, name), allow_pickle=False) as want:
            assert sorted(got.files) == sorted(want.files)
            for key in want.files:
                assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
                assert got[key].tobytes() == want[key].tobytes(), (name, key)
    assert sorted(os.listdir(DATA)) == before
    assert json.loads(capsys.readouterr().out.splitlines()[-2]) == expected["frames"][-1]


def test_replay_generator_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_replay.main(["--out", str(tmp_path / "seq")])
    assert not (tmp_path / "seq").exists()


def test_run_replay_matches_expected_and_jax(tmp_path, capsys):
    with open(os.path.join(DATA, "EXPECTED.json")) as f:
        expected = json.load(f)
    params = _replay_params()
    tm = T.SemanticDSPMap(T.tiny_test_config(), T.FilterParams(**params), device="cpu")
    ts, tr = treplay.run_replay(tm, NpzSequence(DATA), out_dir=str(tmp_path / "t"), ply_every=5,
                                drop_first=expected["drop_first"], verbose=True)
    out = capsys.readouterr().out.splitlines()

    # frame for frame: the verbose lines carry the index, the occupied count
    # and the diagnostics
    lines = [ln for ln in out if ln.startswith("frame ")]
    assert len(lines) == len(expected["frames"]) == ts["frames"]
    for ln, want in zip(lines, expected["frames"]):
        head, diag = ln.split(" {", 1)
        diag = json.loads(("{" + diag).replace("'", '"'))
        assert head.startswith(f"frame {want['index']}:")
        assert f"occupied={want['occupied']} " in head + " "
        assert (diag["visible_count"], diag["born_count"], diag["moved_count"]) == (
            want["visible"], want["born"], want["moved"])
    assert json.loads(out[-1]) == ts
    occ = tr.occ.numpy()
    last = expected["frames"][-1]
    assert (int((occ == 1).sum()), int((occ == 0).sum()), int((occ == -1).sum())) == (
        last["occupied"], last["free"], last["unknown"])

    # against the JAX package's run_replay
    jm = J.SemanticDSPMap(J.config.tiny_test_config(), J.FilterParams(**params))
    js, jr = jreplay.run_replay(jm, JNpzSequence(DATA), out_dir=str(tmp_path / "j"), ply_every=5,
                                drop_first=expected["drop_first"], verbose=False)
    assert ts["frames"] == js["frames"] == 10
    np.testing.assert_array_equal(occ, np.asarray(jr.occ))
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    assert names == ["final_occupied.ply", "frame_000006_occupied.ply", "frame_000011_occupied.ply"]
    for name in names:
        tx, tc = read_ply(str(tmp_path / "t" / name))
        jx, jc = read_ply(str(tmp_path / "j" / name))
        assert tx.shape[0] > 0
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(tc, jc)


def test_run_replay_writes_freespace_when_asked(tmp_path):
    params = dict(_replay_params(), if_output_freespace=True)
    tm = T.SemanticDSPMap(T.tiny_test_config(), T.FilterParams(**params), device="cpu")
    summary, _ = treplay.run_replay(tm, NpzSequence(DATA), out_dir=str(tmp_path), drop_first=8,
                                    verbose=False)
    assert summary["frames"] == 4
    assert sorted(os.listdir(tmp_path)) == ["final_freespace.ply", "final_occupied.ply"]
    xyz, _ = read_ply(str(tmp_path / "final_freespace.ply"))
    assert xyz.shape[0] > 0


def test_replay_main_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The CLI with ``--device cpu`` (the vkitti2 preset stands in at the
    tiny size, which is the size of the committed sequence)."""
    monkeypatch.setitem(treplay._PRESETS, "vkitti2", T.tiny_test_config)
    options = tmp_path / "options.yaml"
    options.write_text("nb_ptc_num_per_point: 1\nif_consider_depth_noise: true\n"
                       "depth_noise_model_zero_order: 0.2\nprediction_stddev: 0.0\n")
    summary, result = treplay.main([
        "--dataset", "npz", "--data", DATA, "--options", str(options), "--out", str(tmp_path / "o"),
        "--ply-every", "4", "--max-frames", "9", "--device", "cpu"])
    assert summary["frames"] == 7 and summary["fps"] > 0
    assert result.occ.device.type == "cpu" and int((result.occ == 1).sum()) > 0
    assert sorted(os.listdir(tmp_path / "o")) == [
        "final_occupied.ply", "frame_000005_occupied.ply"]
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == summary


def test_replay_main_defaults_to_the_card(tmp_path, monkeypatch):
    """Without ``--device`` the CLI asks for the card: on a machine without
    one it raises and names device="cpu" instead of mapping on the host."""
    monkeypatch.setitem(treplay._PRESETS, "vkitti2", T.tiny_test_config)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        treplay.main(["--dataset", "npz", "--data", DATA])
