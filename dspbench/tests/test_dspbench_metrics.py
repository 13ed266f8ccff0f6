"""The metrics' arithmetic, the census bounds and the trace's reduction."""

import math

import pytest
import torch

from dspbench import census, harness, stats, trace
from dspbench.roofline import share


def test_p95_is_over_all_frames():
    values = list(range(1, 101))  # 1..100
    assert stats.nearest_rank(values, 0.95) == 95
    assert stats.nearest_rank([5.0], 0.95) == 5.0
    assert stats.nearest_rank(list(range(20)) + [1000.0], 0.95) == 19  # 20th of 21
    with pytest.raises(ValueError):
        stats.nearest_rank([], 0.95)


def test_rate_and_spread():
    assert stats.rate(300, 3.0) == 100.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert stats.spread([90, 100, 100, 110]) == pytest.approx(15 / 100)  # 92.5 to 107.5


def frame(i, handed, returned, done, failed=False):
    return harness.Frame(i, handed, returned, done, failed)


def fake_run(frames, window):
    run = harness.Run()
    run.frames, run.window = frames, window
    return run


def test_the_end_to_end_readers():
    frames = [frame(i, i * 0.01, i * 0.01 + 0.004, i * 0.01 + 0.02) for i in range(100)]
    frames[50] = frame(50, 0.5, 0.54, 0.6)  # one slow frame: 100 ms
    run = fake_run(frames, (0.0, 1.0))
    run.setup_s = 12.5
    assert harness.reader("frames_per_s")(run) == pytest.approx(100.0)
    assert harness.reader("frame_ms_p95")(run) == pytest.approx(20.0)
    assert harness.reader("setup_s")(run) == 12.5
    frames[3] = frame(3, 0.03, 0.031, 0.032, failed=True)
    assert harness.reader("frames_per_s")(run) == pytest.approx(99.0)
    assert harness.reader("update_host_ms")(run) == pytest.approx((98 * 4 + 40) / 99)


def test_a_failed_frame_lies_in_the_tail():
    frames = [frame(i, 0.0, 0.0, 0.001, failed=i < 10) for i in range(100)]
    assert math.isinf(harness.reader("frame_ms_p95")(fake_run(frames, (0.0, 1.0))))


def test_the_census_counts_what_the_render_and_the_scan_need():
    K, V = 4, 3
    status = torch.tensor([1, 0, 0, 2, 0, 0, 0, 0, 3, 1, 0, 0], dtype=torch.uint8)
    stamp = torch.tensor([5, 0, 0, 1, 0, 0, 0, 0, 9, 2, 0, 0], dtype=torch.int32)
    vax = torch.tensor([2, 0, 3], dtype=torch.int32)
    c = census.census(status, stamp, vax, V, K)
    assert (c["with_status"], c["alive"]) == (4, 2)  # slots 0 and 8 are alive
    assert c["render_bytes"] == V * K + 8 * V + 16 * V + 4 * 4 + 9 * 2
    assert c["front_bytes"] == V * K + 4 * V + 48 + 2 * V + 4 * 4 + 12 * 2
    assert c["render_bound_ms"] == pytest.approx(1e3 * c["render_bytes"] / 3.35e12)


def ev(name, cat, start, dur):
    return trace.Event(name, cat, start, dur)


def fake_slice():
    device = [ev("void render_kernel<7>(float const*)", "kernel", 10, 5),
              ev("void at::native::cat(...)", "kernel", 12, 6),
              ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 30, 10),
              ev("void render_kernel<7>(float const*)", "kernel", 60, 3)]
    host = [ev(trace.FRAME_SPAN, "user_annotation", 0, 50),
            ev("cudaGraphLaunch", "cuda_runtime", 2, 1),
            ev("aten::linalg_svd", "cpu_op", 40, 15),
            ev(trace.WAIT_SPAN, "user_annotation", 50, 50)]
    spans = [h for h in host if h.cat == "user_annotation"]
    return trace.Slice(2, device, [h for h in host if h.cat == "cuda_runtime"], host, spans)


def test_the_slice_busy_idle_and_breakdown():
    s = fake_slice()
    assert s.window == (0, 100)
    assert s.busy_intervals() == [[10, 18], [30, 40], [60, 63]]
    assert s.busy_us() == 21
    assert s.idle_gaps() == [(0, 10), (18, 12), (40, 20), (63, 37)]
    b = trace.breakdown(s)
    assert b["device_ops"][0] == ["Memcpy DtoH (Device -> Pinned)", 10e-6]
    assert b["idle_gaps"][0] == [trace.WAIT_SPAN, 37e-6]
    assert b["idle_gaps"][1][0] == "aten::linalg_svd"  # 40 + 10: inside the SVD
    assert trace.hand_written("void render_kernel<7>(float const*)") == "render_kernel"
    assert trace.hand_written("void at::native::cat(...)") is None


def test_the_idle_share_is_read_over_the_steady_frames():
    device = [ev("k", "kernel", 5, 10), ev("k", "kernel", 40, 30), ev("k", "kernel", 95, 10)]
    host = [ev(trace.FRAME_SPAN, "user_annotation", t, 5) for t in (0, 30, 60, 90)]
    host.append(ev(trace.WAIT_SPAN, "user_annotation", 95, 20))
    s = trace.Slice(4, device, [], host, sorted(host, key=lambda e: e.start_us))
    assert s.window == (0, 115)
    assert s.steady == (30, 90)  # the second frame's hand-in to the last one's
    assert s.busy_intervals() == [[40, 70]]
    assert s.idle_gaps() == [(30, 10), (70, 20)]
    run = fake_run([], (0.0, 1.0))
    run.slice = s
    assert harness.reader("device_idle_pct")(run) == pytest.approx(50.0)
    assert harness.reader("kernels_per_frame")(run) == 0.75  # counts over the whole slice


def test_the_trace_readers():
    run = fake_run([], (0.0, 1.0))
    run.slice = fake_slice()
    assert harness.reader("kernels_per_frame")(run) == 1.5
    assert harness.reader("host_api_calls_per_frame")(run) == 0.5
    assert harness.reader("torch_ops_ms_per_frame")(run) == pytest.approx(6 / 1e3 / 2)
    assert harness.reader("device_idle_pct")(run) == pytest.approx(79.0)
    assert harness.reader("render_roofline_pct")(run) is None  # no census taken
    run.census = [{"render_bound_ms": 0.002, "front_bound_ms": 1.0}] * 2
    assert share(run, ("render_kernel",), "render_bound_ms") == pytest.approx(100 * 0.002 / 0.004)
    assert harness.reader("front_roofline_pct")(run) is None  # no front kernel ran


def test_readers_with_nothing_to_read_return_none():
    run = fake_run([], (0.0, 1.0))
    for name in ("frames_per_s", "frame_ms_p95", "update_host_ms", "pack_ms",
                 "host_api_calls_per_frame", "kernels_per_frame", "torch_ops_ms_per_frame",
                 "render_roofline_pct", "front_roofline_pct", "device_idle_pct", "peak_mem_gib"):
        assert harness.reader(name)(run) is None, name


def test_the_tracers_stamps_are_not_counted_as_the_frames_work():
    run = fake_run([], (0.0, 1.0))
    s = fake_slice()
    stamps = [ev("(anonymous namespace)::stamp_kernel(long long*, long long*, long long*, int)",
                 "kernel", t, 1) for t in (5, 20, 70)]
    run.slice = s._replace(device=s.device + stamps)
    assert harness.reader("kernels_per_frame")(run) == 1.5
    assert harness.reader("torch_ops_ms_per_frame")(run) == pytest.approx(6 / 1e3 / 2)
    assert len(run.slice.kernels()) == len(run.slice.work_kernels()) + 3
