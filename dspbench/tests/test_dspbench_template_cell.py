"""The template-mode cell ``vkitti2_template.drive``: its files load, its
configuration names the reference with the template stages and the bank,
that reference loads nothing of the port or of JAX, its traffic puts every
car inside template birth's gate, and the four metrics of the template
stages read the program's stamps and counters (None without them)."""

import json

import numpy as np
import pytest
import torch

from dspbench import harness, traffic
from dspbench.tests.small import reduced_map_config
from dspbench.tests.test_dspbench_imports import JAX_SIDE, PORT, loaded_after

CELL = "vkitti2_template.drive"
METRICS = ("rematch_device_ms", "template_birth_device_ms", "template_sweeps_per_frame",
           "guessed_born_per_frame")


def test_the_cell_loads():
    cell = harness.load_cell(CELL)
    vkitti2 = harness.load_cell("vkitti2.drive")
    assert cell.chips == 1
    assert cell.config["reference"] == "dspbench.reference_template"
    assert cell.config["filter_params"] == dict(vkitti2.config["filter_params"],
                                                if_use_template_matching=True)
    assert cell.config["map_config"] == vkitti2.config["map_config"]
    assert [m["track"] for m in cell.mix["movers"]] == [20, 21, 22, 23]
    assert set(cell.limits) == set(vkitti2.limits)
    setup = harness.cell_setup(cell.config)
    assert setup == {"templates": str(harness.ROOT.parent / "data" / "templates")}
    bench = json.loads((harness.ROOT.parent / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in METRICS:
            assert m["workloads"] == [CELL] and m["layer"] == "template stages", m


def test_the_reference_module_is_the_one_with_the_template_stages():
    module = harness.reference_module(harness.load_cell(CELL).config)
    assert module.__name__ == "dspbench.reference_template"
    assert callable(module.Reference) and callable(module.state_from_fields)


def test_the_reference_with_the_template_stages_loads_nothing_of_the_port():
    names = loaded_after(
        "import torch, json\n"
        "from dspbench.reference_template import Reference\n"
        "from dspbench import traffic\n"
        "from dspbench.tests.small import reduced_map_config\n"
        "cfg = json.load(open('dspbench/configs/vkitti2_template.json'))\n"
        "m = reduced_map_config(cfg, 'vkitti2')\n"
        "ref = Reference(m, cfg['filter_params'], 'cpu', templates='data/templates')\n"
        "assert len(ref.bank) == 1 and ref.bank[0].shape == (1760, 3)\n"
        "ring = traffic.Ring(traffic.load('template_drive'), traffic.Camera.of(m), 1)\n"
        "st = ref.init_state(1)\n"
        "f = ring.frame(0)\n"
        "st, r, d = ref.frame(st, f.depth, f.masks, f.cam_pos, f.cam_quat, f.time)\n"
        "assert int((r.occ >= 0).sum()) > 0\n")
    assert PORT not in names and not names & JAX_SIDE


def test_every_car_of_the_mix_is_inside_template_births_gate():
    """At the configuration's full size: each car's pixels (its cloud
    points; its depth is exact) more than 1,500 and fewer than 8,000, its
    face at least 1 m wide and tall, in every image of the ring."""
    cell = harness.load_cell(CELL)
    cam = traffic.Camera.of(cell.config["map_config"])
    mix = cell.mix
    for index in (0, mix["ring"] // 2, mix["ring"] - 1):
        depth, masks = traffic.image(mix, cam, 2**31 + 3, index)
        for m, mover in zip(masks[1:], mix["movers"]):
            rows, cols = np.nonzero(m["mask"])
            assert 1500 < len(rows) < 8000, (index, mover["track"], len(rows))
            z = mover["depth"]
            assert (cols.max() - cols.min()) * z / cam.fx >= 1.0, (index, mover["track"])
            assert (rows.max() - rows.min()) * z / cam.fy >= 1.0, (index, mover["track"])
            assert (depth[rows, cols] == np.float32(z)).all()


def _trace(templating: bool, width: int = None):
    """A traced run's records for frames 3-5: stamps in ms, the template
    stages' (with ``templating``) 2 and 3 ms, a birth sweep on each frame
    and 4,000 guessed particles on frame 3; ``width`` cuts the rings to the
    first nine columns (a ring without the template columns)."""
    from semantic_dsp_map_tpu_torch.timing import COUNTERS, STAMPS, Trace

    stamps = np.full((3, len(STAMPS)), -1, np.int64)
    counters = np.full((3, len(COUNTERS)), -1, np.int64)
    stamps[:, :9] = np.array([0, 1, 3, 4, 5, 7, 10, 11, 12])
    counters[:, :9] = 0
    if templating:
        stamps[:, 9:] = [5, 7, 10, 13]
        counters[:, COUNTERS.index("rematch_sweeps")] = 0
        counters[:, COUNTERS.index("template_birth_sweeps")] = [4, 5, 6]
        counters[:, COUNTERS.index("guessed_born_count")] = [4000, 0, 0]
    if width:
        stamps, counters = stamps[:, :width], counters[:, :width]
    return Trace(np.array([3, 4, 5]), [], stamps * 1_000_000, counters, 3)


def _run(program):
    run = harness.Run()
    run.frames = [harness.Frame(i, 0.0, 0.02, 0.03, False) for i in range(3, 7)]
    run.window, run.traced, run.program = (0.0, 1.0), range(5, 6), program
    return run


def test_the_template_metrics_read_the_programs_template_stages():
    """Frames 3 and 4 (frame 5 is in the slice): rematch 2 ms, template
    birth 3 ms, a sweep each frame (the first held frame's share is unknown
    after lost frames), 2,000 guessed particles a frame."""
    run = _run(_trace(True))
    want = {"rematch_device_ms": 2.0, "template_birth_device_ms": 3.0,
            "template_sweeps_per_frame": 1.0, "guessed_born_per_frame": 2000.0}
    for name, value in want.items():
        assert harness.reader(name)(run) == pytest.approx(value), name


@pytest.mark.parametrize("program", ["none", "untemplated", "narrow"])
def test_the_template_metrics_read_none_without_template_stages(program):
    trace = {"none": None, "untemplated": _trace(False), "narrow": _trace(False, width=9)}
    run = _run(trace[program])
    for name in METRICS:
        assert harness.reader(name)(run) is None, name
    if program != "none":  # the stages outside the template stages still read
        assert harness.reader("predict_device_ms")(run) == pytest.approx(2.0)


def test_a_cpu_run_of_the_cell_reports_the_template_metrics(monkeypatch):
    """The reduced cell, traced, on the CPU: correct, and the template
    stages' times and counts reported (at this size no car passes the
    gate: no sweep)."""
    monkeypatch.setattr(harness, "TRACE_FIRST", 1)
    monkeypatch.setattr(harness, "TRACE_FRAMES", 1)
    monkeypatch.setattr(harness, "PACK_SECONDS", 0.05)
    torch.set_num_threads(2)
    cell = harness.load_cell(CELL)
    cell = cell._replace(config={**cell.config,
                                 "map_config": reduced_map_config(cell.config, "vkitti2")})
    out = harness.run_cell(cell, 2**31 + 29, 1.5, True, device="cpu")
    assert out["correct"], out
    assert set(METRICS) <= set(out["metrics"]), sorted(out["metrics"])
    assert out["metrics"]["template_sweeps_per_frame"]["value"] == 0.0
    assert out["metrics"]["rematch_device_ms"]["value"] > 0
