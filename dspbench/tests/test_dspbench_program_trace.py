"""The readers of the program's own records (``program_trace``) on a
synthetic run and trace, None where the program recorded nothing (a
program without a tracer), each a metric file of the benchmark, and CPU
runs of a cell with the tracer on and off."""

import json

import numpy as np
import pytest
import torch

from dspbench import harness, program_trace, trace
from dspbench.tests.small import small_cell


def frame(i, handed=0.0, returned=0.02):
    return harness.Frame(i, handed, returned, returned + 0.01, False)


def span(frame_no, name, parent, start_ms, end_ms):
    from semantic_dsp_map_tpu_torch.timing import SpanRecord

    return SpanRecord(frame_no, name, parent, int(start_ms * 1e6), int(end_ms * 1e6))


def fake_trace(frames=(3, 4, 5)):
    """Frames 3-5: a split step, spans and stamps in whole ms, counters 10
    visible and 2 born a frame, one overflow on frame 4."""
    from semantic_dsp_map_tpu_torch.timing import Trace

    spans, stamps, counters = [], [], []
    for f in frames:
        base = len(spans)
        spans += [span(f, "dsp.update", -1, 0, 20), span(f, "dsp.pack", base, 0, 15),
                  span(f, "dsp.input_copy", base, 15, 16), span(f, "dsp.replay.fit", base, 16, 17),
                  span(f, "dsp.bridge", base, 17, 18), span(f, "dsp.replay.finish", base, 18, 19)]
        stamps.append(np.array([0, 1, 3, 4, 5, 7, 10, 11, 12], np.int64) * 1_000_000)
        counters.append([10, 2, 0, 0, 0, 0, 0, 0, int(f == 4)])
    return Trace(np.array(frames), spans, np.array(stamps), np.array(counters), 3)


def fake_run(frames, traced=range(0)):
    run = harness.Run()
    run.frames, run.window, run.traced = frames, (0.0, 1.0), traced
    return run


def test_the_readers_on_a_trace():
    run = fake_run([frame(i) for i in range(3, 7)], traced=range(5, 6))
    t = fake_trace()
    want = {"pack_span_ms": 15, "input_copy_ms": 1, "replay_host_ms": 2, "bridge_host_ms": 1,
            "objects_device_ms": 2, "bridge_device_ms": 2, "cloud_device_ms": 1,
            "predict_device_ms": 2, "observe_device_ms": 3, "birth_device_ms": 1,
            "render_device_ms": 1, "visible_per_frame": 10, "born_per_frame": 2,
            "overflow_per_frame": 0.5}  # frames 3 and 4: frame 5 is in the slice
    for name, value in want.items():
        assert program_trace.READERS[name](run, t) == pytest.approx(value), name
    assert program_trace.READERS["idle_in_pack_pct"](run, t) is None  # no slice
    a = program_trace.agreement(run, t, {k: program_trace.READERS[k](run, t) for k in want})
    assert a["update_span_ms"] == pytest.approx(20) and a["update_host_ms"] == pytest.approx(20)
    assert a["children_over_update_span"] == pytest.approx(19 / 20)
    assert a["frames_lost"] == 3 and "stages_ms" not in a  # no slice to hold them to


def test_the_readers_without_a_trace_return_none():
    run = fake_run([frame(i) for i in range(4)])
    for name, read in program_trace.READERS.items():
        assert read(run, None) is None, name
    assert program_trace.agreement(run, fake_trace((90,)), {}) == {}  # no frame in common


def ev(name, cat, start, dur):
    return trace.Event(name, cat, start, dur)


def test_idle_in_pack_is_read_over_the_steady_state():
    """Frames hand in at 0, 30, 60, 90; the device is busy 40-70; pack
    ranges 30-45 and 62-80: idle inside a pack 30-40 and 70-80 of the
    steady 30-90."""
    device = [ev("k", "kernel", 40, 30)]
    host = [ev(trace.FRAME_SPAN, "user_annotation", t, 25) for t in (0, 30, 60, 90)]
    host += [ev("dsp.pack", "user_annotation", 30, 15), ev("dsp.pack", "user_annotation", 62, 18)]
    spans = sorted((h for h in host if h.name.startswith("dspbench")), key=lambda e: e.start_us)
    run = fake_run([])
    run.slice = trace.Slice(4, device, [], host, spans)
    assert program_trace.idle_in_pack_pct(run) == pytest.approx(100 * 20 / 60)
    # the slice names those gaps after the program's span
    assert run.slice.host_at(35) == "dsp.pack"
    run.slice = trace.Slice(4, device, [], [h for h in host if h.name != "dsp.pack"], spans)
    assert program_trace.idle_in_pack_pct(run) is None


def test_a_cpu_run_carries_the_programs_numbers():
    torch.set_num_threads(2)
    out = program_trace.traced_run(small_cell("vkitti2.drive"), 2**31 + 5, 0.5, True,
                                   device="cpu")
    assert out["result"]["correct"], out["result"]
    program = out["program"]
    missing = set(program_trace.READERS) - set(program) - {"idle_in_pack_pct"}  # no slice
    assert not missing, missing
    assert program["visible_per_frame"] > 0
    a = out["agreement"]
    assert 0.9 < a["update_span_over_host"] <= 1.0
    assert a["children_over_update_span"] > 0.9
    off = program_trace.traced_run(small_cell("vkitti2.drive"), 2**31 + 5, 0.5, False,
                                   tracer=False, device="cpu")
    assert off["program"] == {} and "agreement" not in off
    assert off["host"]["update_host_ms"] > 0


def test_each_reader_is_a_metric_of_the_benchmark():
    bench = json.loads((harness.ROOT.parent / "BENCHMARK.json").read_text())
    per_layer = {m["name"] for m in bench["per_layer"]}
    run = fake_run([frame(i) for i in range(3, 7)], traced=range(5, 6))
    for name, read in program_trace.READERS.items():
        assert name in per_layer, name
        run.program = fake_trace()
        assert harness.reader(name)(run) == read(run, run.program), name
        run.program = None
        assert harness.reader(name)(run) is None, name


@pytest.mark.parametrize("traced", [False, True])
def test_only_a_traced_run_hands_the_map_a_tracer(monkeypatch, traced):
    import semantic_dsp_map_tpu_torch as port
    from semantic_dsp_map_tpu_torch.timing import Tracer

    made = []

    class Spy(port.SemanticDSPMap):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(port, "SemanticDSPMap", Spy)
    torch.set_num_threads(2)
    cell = small_cell("vkitti2.drive")
    run = harness.Run()
    out = harness.run_cell(cell, 2**31 + 13, 0.5, traced, device="cpu", run=run)
    assert out["correct"], out
    assert len(made) == 1
    if traced:
        assert isinstance(made[0].tracer, Tracer) and run.program is not None
        missing = set(program_trace.READERS) - set(out["metrics"]) - {"idle_in_pack_pct"}
        assert not missing, missing  # idle_in_pack_pct needs a slice with device time
    else:
        assert made[0].tracer is None and run.program is None
        assert set(out["metrics"]) == {name for name, _ in cell.end_to_end}
