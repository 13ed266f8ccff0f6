"""The port's bench (``benchmarks/scenes.py``, ``benchmarks/bench.py``) on
the CPU:

- each of the four scenes equal in bytes to the JAX package's ``bench.py``
  at a reduced config (the scenes are empty at ``tiny_test_config()``);
- the reduced hostile scene (20 movers, ego yaw) through the JAX map and the
  port: every counter equal on every frame with ``move_overflow``,
  ``table_dropped`` and ``moved_count`` non-zero, state equal; and what both
  drop with more instances than rows;
- ``run_config``: the keys, ``peak_diag`` and the update count against the
  same frames stepped one by one, and no host read inside the timed loop;
- ``main`` with ``--cells``, ``--device cpu`` and ``--out``.
"""

import json

import numpy as np
import pytest
import torch

import semantic_dsp_map_tpu as J

import semantic_dsp_map_tpu_torch as T
from semantic_dsp_map_tpu_torch.benchmarks import bench as tbench
from semantic_dsp_map_tpu_torch.benchmarks import scenes

from torch_parity import (
    OBJECT_ATOL_FAR, REDUCED_VKITTI2, REDUCED_ZED2, dynamic_scene, hold_scene_against_jax,
)

torch.set_num_threads(2)


def _reduced(pkg, preset, **over):
    base = REDUCED_ZED2 if preset == "zed2_config" else REDUCED_VKITTI2
    return getattr(pkg.config, preset)(**dict(base, **over))


#: scene name -> (preset, the port's scene, the same scene of bench.py)
def _jax_scenes():
    import bench as jbench  # the JAX package's bench, at the repository root

    return {
        "vkitti2": ("virtual_kitti2_config", scenes.synth_vkitti2_frame,
                    jbench.synth_vkitti2_frame),
        # the port's template cell: bench.py's scene with the taller car
        "vkitti2_template": (
            "virtual_kitti2_config", scenes.synth_template_frame,
            lambda c, t: jbench.synth_vkitti2_frame(c, t, car_h_div=5, car_w_div=14)),
        "vkitti2_hostile": ("virtual_kitti2_config", scenes.synth_hostile_frame,
                            jbench.synth_hostile_frame),
        "zed2": ("zed2_config", scenes.synth_zed2_frame, jbench.synth_zed2_frame),
    }


@pytest.mark.parametrize("t", [0, 1, 7])
@pytest.mark.parametrize("name", ["vkitti2", "vkitti2_template", "vkitti2_hostile", "zed2"])
def test_scene_is_the_jax_bench_s(name, t):
    """Depth, masks, track ids, labels, keypoints and pose: the same bytes."""
    preset, t_scene, j_scene = _jax_scenes()[name]
    jd, jm, jp, jq = j_scene(_reduced(J, preset), t)
    td, tm, tp, tq = t_scene(_reduced(T, preset), t)
    for a, b in ((jd, td), (jp, tp), (jq, tq)):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    assert len(jm) == len(tm) and len(tm) == (21 if name == "vkitti2_hostile" else 2)
    assert float(td.max()) > 8.0  # the scene is there (nothing of it fits the tiny config)
    for a, b in zip(jm, tm):
        assert (a.track_id, a.label, a.bbox) == (b.track_id, b.label, b.bbox)
        assert isinstance(b, T.MaskKpts)
        for field in ("mask", "kpts_current", "kpts_previous"):
            x, y = getattr(a, field), getattr(b, field)
            assert (x is None) == (y is None)
            if x is not None:
                assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()


def test_scene_parameters_are_the_jax_bench_s():
    """VK_PARAMS, ZED2_PARAMS and TPL_PARAMS against the literals of
    bench.py's main (read from its source: main() runs the bench)."""
    import ast
    import inspect

    import bench as jbench

    calls = {}
    for node in ast.walk(ast.parse(inspect.getsource(jbench.main))):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and getattr(node.value.func, "id", "") == "FilterParams"):
            calls[node.targets[0].id] = {
                kw.arg: ast.literal_eval(kw.value) for kw in node.value.keywords}
    assert calls["vk_params"] == scenes.VK_PARAMS
    assert calls["zed2_params"] == scenes.ZED2_PARAMS
    assert calls["tpl_params"] == scenes.TPL_PARAMS


def _offset_hostile(cfg, t, mask_cls):
    # The cars' depths moved off the exact constants 8, 10, ... m: on such a
    # constant a moved particle sits on a voxel boundary, where the last bit
    # of the rigid move decides its voxel (see test_torch_paths.py).
    return scenes.synth_hostile_frame(cfg, t, mask_cls, car_depth_offset=0.07)


@pytest.mark.parametrize(
    "over,dropped_instances",
    [(dict(phd_pixel_table_slots=3), False),
     (dict(phd_pixel_table_slots=3, max_instances_per_frame=8, max_objects=8), True)],
    ids=["all_cars", "more_instances_than_rows"],
)
def test_hostile_scene_matches_jax(over, dropped_instances):
    """6 frames of the hostile scene at the reduced config: all nine
    counters, occ, label, track and the state equal to the JAX map's, with
    the move cap and the pixel-table cap binding."""
    params = dict(scenes.VK_PARAMS, prediction_stddev=0.0)
    diags, jm, tm = hold_scene_against_jax(
        _reduced(J, "virtual_kitti2_config", **over), _reduced(T, "virtual_kitti2_config", **over),
        params, _offset_hostile, 6, object_atol=OBJECT_ATOL_FAR)
    peak = {k: max(d[k] for d in diags) for k in diags[0]}
    assert peak["move_overflow"] > 0 and peak["table_dropped"] > 0 and peak["moved_count"] > 0
    n_objects = int(tm.state.objects.valid.sum())
    assert n_objects == int(np.asarray(jm.state.objects.valid).sum())
    assert n_objects == (8 if dropped_instances else 20)


# ---------------------------------------------------------------------------
# run_config and main
# ---------------------------------------------------------------------------

TINY_PARAMS = dict(if_consider_depth_noise=True, nb_ptc_num_per_point=1,
                   depth_noise_model_zero_order=0.2, prediction_stddev=0.0)


def _tiny_synth(cfg, t, mask_cls=T.MaskKpts):
    return dynamic_scene(cfg, t, mask_cls)[:4]


CELL_KEYS = {"config", "frames", "fps", "sec_per_frame", "particle_updates_per_sec", "peak_diag",
             "runs", "card", "occ_histogram", "nan_weights"}


@pytest.mark.parametrize("runs", [1, 3])
def test_run_config_against_frames_stepped_one_by_one(runs):
    cfg, params = T.tiny_test_config(), T.FilterParams(**TINY_PARAMS)
    warmup, iters = 2, 4
    cell = tbench.run_config("tiny", cfg, params, _tiny_synth, iters, warmup=warmup,
                             device="cpu", runs=runs)
    assert CELL_KEYS <= set(cell)
    assert (cell["config"], cell["frames"], cell["card"]) == ("tiny", iters, "cpu")
    assert len(cell["runs"]) == runs and cell["nan_weights"] == 0
    assert [r["first_frame"] for r in cell["runs"]] == [warmup + i * iters for i in range(runs)]
    assert "events_sec_per_frame" not in cell  # the CPU has the host clock only

    dsp = T.SemanticDSPMap(cfg, params, device="cpu")
    diags = []
    for t in range(warmup + runs * iters):
        result, diag = dsp.update(*_tiny_synth(cfg, t), time=t * 0.1)
        if t >= warmup:
            diags.append({k: int(v) for k, v in diag._asdict().items()})
    assert cell["peak_diag"] == {k: max(d[k] for d in diags) for k in diags[0]}
    for i, row in enumerate(cell["runs"]):  # each loop's own peak: the first is the JAX bench's
        loop = diags[i * iters : (i + 1) * iters]
        assert row["peak_diag"] == {k: max(d[k] for d in loop) for k in loop[0]}
        assert row["particle_updates"] == sum(d["visible_count"] for d in loop)
    assert cell["peak_diag"]["moved_count"] > 0
    updates = sum(d["visible_count"] for d in diags)
    assert cell["particle_updates"] == updates
    dt = sum(r["seconds"] for r in cell["runs"])
    assert cell["seconds"] == dt
    assert abs(cell["particle_updates_per_sec"] * dt - updates) <= dt  # int() of the rate
    per_frame = sorted(r["sec_per_frame"] for r in cell["runs"])
    assert cell["sec_per_frame"] == pytest.approx(float(np.median(per_frame)))
    assert cell["fps"] == pytest.approx(1.0 / cell["sec_per_frame"])
    assert (cell["sec_per_frame_min"], cell["sec_per_frame_max"]) == (per_frame[0], per_frame[-1])
    occ = result.occ.numpy()
    assert cell["occ_histogram"] == {str(v): int((occ == v).sum()) for v in (-1, 0, 1, 2)}


def test_timed_loop_reads_nothing_on_the_host(monkeypatch):
    """Inside the timed loop: no synchronize, and no ``.item()``, ``int()``,
    ``.cpu()`` or ``.numpy()`` on any tensor (a StepDiagnostics field
    included).  The reduction that follows the loop does read."""
    cfg, params = T.tiny_test_config(), T.FilterParams(**TINY_PARAMS)
    dsp = T.SemanticDSPMap(cfg, params, device="cpu")
    frames = [_tiny_synth(cfg, t) for t in range(4)]
    reads = []
    for name in ("item", "__int__", "__float__", "__bool__", "__index__", "cpu", "numpy",
                 "tolist"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **k):
            reads.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, spy)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: reads.append("synchronize"))

    result, diags = tbench.timed_loop(dsp, frames, 0)
    in_loop = list(reads)
    assert in_loop == [], in_loop
    assert len(diags) == 4 and result is not None
    int(diags[-1].visible_count)
    assert reads == ["__int__"]  # the spy does see a read


def test_bench_main_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The CLI with two cells, the presets swapped for reduced ones."""
    monkeypatch.setitem(tbench._PRESETS, "vkitti2", lambda: _reduced(T, "virtual_kitti2_config"))
    monkeypatch.setitem(tbench._PRESETS, "zed2", lambda: _reduced(T, "zed2_config"))
    out = tmp_path / "cells.json"
    cells = tbench.main(["--cells", "zed2,vkitti2_hostile", "--iters", "4", "--device", "cpu",
                         "--out", str(out)])
    assert list(cells) == ["zed2", "vkitti2_hostile"]
    with open(out) as f:
        assert json.load(f) == cells
    assert cells["zed2"]["frames"] == 4 and cells["vkitti2_hostile"]["frames"] == 10
    assert all(len(c["runs"]) == 3 and c["warmup"] == 3 for c in cells.values())
    for cell in cells.values():
        assert CELL_KEYS <= set(cell) and cell["occ_histogram"]["1"] > 0
        assert cell["peak_diag"]["visible_count"] > 0 and cell["nan_weights"] == 0
    assert cells["vkitti2_hostile"]["peak_diag"]["move_overflow"] > 0
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last["zed2_fps"] == cells["zed2"]["fps"] and last["unit"] == "frames/s"
    assert "vs_baseline" not in last and "value" not in last  # the vkitti2 cell did not run


def test_bench_main_writes_nothing_by_default_and_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tbench.main(["--cells", "zed2"])
    monkeypatch.setitem(tbench._PRESETS, "zed2", lambda: _reduced(T, "zed2_config"))
    tbench.main(["--cells", "zed2", "--iters", "2", "--device", "cpu"])
    assert list(tmp_path.iterdir()) == []


def test_sharded_cell_on_the_cpu(monkeypatch):
    """The zed2_sharded cell at the reduced ZED2 preset: the sharded step at
    one rank equal to the single-device step (it raises otherwise), in a
    group of its own that it leaves destroyed; no kernel launches on the
    CPU."""
    monkeypatch.setitem(tbench._PRESETS, "zed2", lambda: _reduced(T, "zed2_config"))
    cell = tbench.run_sharded_check(iters=3, device="cpu")
    assert cell["config"] == "zed2_sharded_ranks1" and cell["render_equal_vs_plain"]
    assert cell["frames"] == 3 and cell["fps"] > 0 and cell["card"] == "cpu"
    assert set(cell["kernel_launches"].values()) == {0}
    assert not torch.distributed.is_initialized()
