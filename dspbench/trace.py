"""The profiled slice of a traced run: ``torch.profiler`` around a fixed
run of frames, read back from its Chrome trace.

The trace's events are reduced to plain lists here, so that the per-layer
readers (``dspbench/metrics/``) read numbers and names, never the
profiler: the device's kernels, copies and sets with their start and
length, the host's CUDA runtime and driver calls, the host's operations,
and the spans the harness marks around each traced frame.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import NamedTuple

import torch

#: The markers the harness puts around each traced frame's hand-in to
#: ``update()`` and around the host's wait for its ``occ``.
FRAME_SPAN = "dspbench.frame"
WAIT_SPAN = "dspbench.wait"

_DEVICE = {"kernel", "gpu_memcpy", "gpu_memset"}
_API = {"cuda_runtime", "cuda_driver"}
_HOST = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function"}

#: The port's hand-written kernels (the ``__global__`` functions of its
#: ``csrc/``), by name: every other device kernel is a library's or
#: PyTorch's own.
HAND_WRITTEN = ("front_generic_kernel", "front_kernel", "gather_kernel", "live_planes_kernel",
                "merge_generic_kernel", "merge_kernel", "movable_generic_kernel",
                "movable_kernel", "pass_a_kernel", "pass_a_wide_kernel", "pass_b_kernel",
                "pass_b_wide_kernel", "render_generic_kernel", "render_kernel",
                "scale2_kernel", "set_if_condition")
_HAND = re.compile(r"\b(%s)\b" % "|".join(HAND_WRITTEN))
#: The kernels of the program's tracer (``timing.Tracer``: ``csrc/graph.cu``'s
#: ``stamp_kernel``, nine a frame in a traced run): they record the frame
#: and are none of its work.
TRACER_KERNELS = ("stamp_kernel",)
_TRACER = re.compile(r"\b(%s)\b" % "|".join(TRACER_KERNELS))


def hand_written(name: str):
    """The hand-written kernel a device event's name is, or None."""
    m = _HAND.search(name)
    return m.group(1) if m else None


class Event(NamedTuple):
    name: str
    cat: str
    start_us: float
    dur_us: float

    @property
    def end_us(self) -> float:
        return self.start_us + self.dur_us


class Slice(NamedTuple):
    """What the profiler saw over ``frames`` traced frames."""

    frames: int
    device: list   # Event: kernels, copies and sets on the device
    api: list      # Event: CUDA runtime and driver calls of the host
    host: list     # Event: every host event (operations, calls, spans)
    spans: list    # Event: the harness's hand-in and wait spans, in order

    @property
    def window(self):
        """(start, end) in µs: the first span's start to the last one's
        end."""
        return self.spans[0].start_us, max(e.end_us for e in self.spans)

    @property
    def steady(self):
        """(start, end) in µs of the slice's steady state, over which the
        device's busy and idle time are read: the second traced frame's
        hand-in to the last one's.  The pipe is drained before the first
        traced frame and after the last, so those two run without the
        overlap of a frame in flight beside them.  The whole window where
        the slice has fewer than three frames."""
        starts = [e.start_us for e in self.spans if e.name == FRAME_SPAN]
        return (starts[1], starts[-1]) if len(starts) >= 3 else self.window

    def kernels(self) -> list:
        return [e for e in self.device if e.cat == "kernel"]

    def work_kernels(self) -> list:
        """The kernels of the frame's work: the tracer's
        (:data:`TRACER_KERNELS`) left out."""
        return [e for e in self.kernels() if not _TRACER.search(e.name)]

    def busy_intervals(self) -> list:
        """The merged intervals in which anything ran on the device, cut to
        the steady state."""
        lo, hi = self.steady
        spans = sorted((max(e.start_us, lo), min(e.end_us, hi)) for e in self.device
                       if e.end_us > lo and e.start_us < hi)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def idle_gaps(self) -> list:
        """(start, length) in µs of each stretch of the steady state with
        nothing on the device."""
        lo, hi = self.steady
        gaps, at = [], lo
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s - at))
            at = max(at, e)
        if hi > at:
            gaps.append((at, hi - at))
        return gaps

    def host_at(self, t_us: float) -> str:
        """The innermost host event under way at ``t_us`` (the shortest one
        that holds it), or "host idle"."""
        best = None
        for e in self.host:
            if e.start_us <= t_us <= e.end_us and (best is None or e.dur_us < best.dur_us):
                best = e
        return best.name if best is not None else "host idle"


def read_profile(prof, frames: int) -> Slice:
    """The Slice of a stopped ``torch.profiler.profile``: its Chrome trace,
    written to a temporary file (under ``TMPDIR``) and deleted."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="dspbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    finally:
        os.remove(path)
    device, api, host, spans = [], [], [], []
    for ev in raw.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        e = Event(str(ev.get("name", "")), cat, float(ev["ts"]), float(ev.get("dur", 0.0)))
        if cat in _DEVICE:
            device.append(e)
        if cat in _API:
            api.append(e)
        if cat in _HOST:
            host.append(e)
        if cat == "user_annotation" and e.name in (FRAME_SPAN, WAIT_SPAN):
            spans.append(e)
    spans.sort(key=lambda e: e.start_us)
    return Slice(frames, device, api, host, spans)


def activities(device: torch.device) -> list:
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def breakdown(s: Slice, n: int = 10) -> dict:
    """The ``n`` device operations with the most time (seconds, summed by
    name) and the ``n`` longest idle gaps, each named by what the host was
    doing in its middle."""
    by_name = {}
    for e in s.device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.dur_us
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    gaps = sorted(s.idle_gaps(), key=lambda g: -g[1])[:n]
    return {"device_ops": [[name[:160], us / 1e6] for name, us in ops],
            "idle_gaps": [[s.host_at(at + length / 2)[:160], length / 1e6]
                          for at, length in gaps]}
