"""Timing helpers shared by the stage profiler and the primitive-op probes:
CUDA events on the card, the host clock on the CPU, and the card's name and
power limit for the lines that report a time.

And the map's frame tracer (:class:`Tracer`), which is off unless a map is
given one (``SemanticDSPMap(..., tracer=Tracer())``).  It records, for
every frame from the map's first ``update()`` on:

- **host spans** of ``update()``: ``dsp.update`` (the root, the whole
  call), ``dsp.pack`` (``frontend.pack_frame``), ``dsp.input_copy`` (the
  state taken over and the frame copied into the step's static input; the
  pageable copy ends in a stream synchronize), ``dsp.replay.fit``,
  ``dsp.bridge``, ``dsp.replay.finish`` where the step is split at the
  refit, else ``dsp.replay.step`` (a graph's replay, or the eager body on
  the frames that run eagerly or capture).  Each is timed by
  ``time.perf_counter_ns`` and is also a ``torch.profiler`` range of its
  name, so a profile names the host's time after the program's spans;
- **device stamps**: ``stamp_cuda`` writes the device's clock into a ring
  on the device at each boundary of :data:`STAMPS`; the stamps are
  captured into the step's CUDA graphs, so a replay stamps with no host
  call.  On the CPU a stamp is the host clock;
- **counters**: the frame's StepDiagnostics, copied by the last stamp into
  a second ring on the device.

Nothing is read to the host until :meth:`Tracer.collect`, with one
device-to-host copy.  Both rings hold the last ``capacity`` frames.
"""

from __future__ import annotations

import collections
import ctypes
import subprocess
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.autograd.profiler import record_function

from .ops import cuda_lib


def card_line(device: torch.device) -> str:
    """``name, power limit`` of the card as nvidia-smi prints them (the
    power limit decides the clocks under load); ``cpu`` for the CPU."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    lines = out.stdout.strip().splitlines()
    if not lines:
        return f"{torch.cuda.get_device_name(device)}, power limit unknown"
    return lines[device.index or 0].strip()


class Span:
    """One timed span.  On a CUDA device: ``device_ms`` from CUDA events
    around the span, ``enqueue_ms`` the host clock until the span's last call
    returned, ``wall_ms`` the host clock until a final synchronize.  On the
    CPU all three are the host clock."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"

    def __enter__(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e1 = torch.cuda.Event(enable_timing=True)
            self.e0.record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.enqueue_ms = (time.perf_counter() - self.t0) * 1e3
        if self.cuda:
            self.e1.record()
            torch.cuda.synchronize(self.device)
        self.wall_ms = (time.perf_counter() - self.t0) * 1e3
        self.device_ms = self.e0.elapsed_time(self.e1) if self.cuda else self.wall_ms
        return False


def bench(fn, device: torch.device, iters: int = 10) -> dict:
    """``fn()`` once to warm up, then ``iters`` times inside one span; ms per
    call (``device_ms``, and ``enqueue_ms`` for the host's share)."""
    fn()
    with Span(device) as span:
        for _ in range(iters):
            fn()
    return dict(device_ms=span.device_ms / iters, enqueue_ms=span.enqueue_ms / iters)


# ---------------------------------------------------------------------------
# The frame tracer
# ---------------------------------------------------------------------------

#: The columns of a frame's row in the stamp ring, in the order the device
#: reaches them: graph "fit" start and end, graph "finish" start (each where
#: the step is split at the refit; where it is one graph "step", its start
#: stamps ``fit_start`` and ``fit_end`` and ``finish_start`` stays unset),
#: then the end of each stage: the object layer, the labeled cloud, the
#: prediction, ``observe_and_update``, birth (template birth included), the
#: render with the state's write-back.
STAMPS = ("fit_start", "fit_end", "finish_start", "objects", "cloud", "predict", "observe",
          "birth", "render")

#: The stages a Trace derives from the stamps (``Trace.stage_ms``).
STAGES = ("objects", "bridge", "cloud", "predict", "observe", "birth", "render")

class SpanRecord(NamedTuple):
    """One host span: its frame, name, the index of its parent in
    ``Trace.spans`` (-1 for the frame's root) and its ends by
    ``time.perf_counter_ns``."""

    frame: int
    name: str
    parent: int
    start_ns: int
    end_ns: int

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class Trace(NamedTuple):
    """What a Tracer holds, read to the host (``Tracer.collect``).

    ``frames`` are the frame numbers the rings still hold, oldest first, and
    ``lost`` the frames before them that the rings have overwritten.  Row i
    of ``stamps`` and ``counters`` is frame ``frames[i]``: stamps in ns
    (the device's ``%globaltimer`` on the card, the host's
    ``perf_counter_ns`` on the CPU; -1 where the frame set none), one column
    a name of :data:`STAMPS`; counters the StepDiagnostics in field order.
    ``spans`` holds those frames' host spans."""

    frames: np.ndarray
    spans: list
    stamps: np.ndarray
    counters: np.ndarray
    lost: int

    def span_ms(self, name: str) -> np.ndarray:
        """ms a frame (one value a row of ``frames``) in spans named
        ``name`` or, for a prefix such as ``dsp.replay``, ``name.*``."""
        index = {int(f): i for i, f in enumerate(self.frames)}
        out = np.zeros(len(self.frames))
        for s in self.spans:
            if s.frame in index and (s.name == name or s.name.startswith(name + ".")):
                out[index[s.frame]] += s.ms
        return out

    def stage_ms(self, stage: str) -> np.ndarray:
        """Device ms a frame of ``stage`` (a name of :data:`STAGES`) from the
        stamps: the object layer is graph "fit" and the finishing graph's
        start to the object layer's end; the bridge (NaN where the step is
        one graph) the fit graph's end to the finishing graph's start (the
        refit's SVD and the device's wait while the host reads its flags);
        each later stage runs from the previous stage's end to its own."""
        s = np.where(self.stamps >= 0, self.stamps, np.nan)
        col = {name: s[:, i] for i, name in enumerate(STAMPS)}
        finish_start = np.where(np.isnan(col["finish_start"]), col["fit_end"],
                                col["finish_start"])
        if stage == "objects":
            ns = (col["fit_end"] - col["fit_start"]) + (col["objects"] - finish_start)
        elif stage == "bridge":
            ns = col["finish_start"] - col["fit_end"]
        elif stage in STAGES:
            ns = col[stage] - col[STAMPS[STAMPS.index(stage) - 1]]
        else:
            raise ValueError(f"no stage {stage!r}; the stages are {STAGES}")
        return ns / 1e6

    def counter(self, name: str) -> np.ndarray:
        """The StepDiagnostics counter ``name`` a frame."""
        from .map import StepDiagnostics

        return self.counters[:, StepDiagnostics._fields.index(name)]


class _NoSpan:
    """The span of a trace site whose map has no tracer: it does nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


#: ``with NO_SPAN if tracer is None else tracer.span(name):`` is a trace
#: site: off, it costs the ``is None`` test and this object's two calls.
NO_SPAN = _NoSpan()


class _Span:
    """A host span of a Tracer (``Tracer.span``)."""

    __slots__ = ("tracer", "name", "index", "parent", "start", "range")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        t = self.tracer
        if not t._stack:  # a root: the next frame
            t.frame += 1
            t._frames.append((t.frame, []))
        records = t._frames[-1][1]
        self.parent = t._stack[-1] if t._stack else -1
        self.index = len(records)
        records.append(None)
        t._stack.append(self.index)
        self.range = record_function(self.name)
        self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.range.__exit__(*exc)
        t = self.tracer
        t._stack.pop()
        t._frames[-1][1][self.index] = SpanRecord(t.frame, self.name, self.parent, self.start,
                                                  end)
        return False


class Tracer:
    """The map's frame tracer: host spans, device stamps and counters,
    kept in memory for the last ``capacity`` frames (see the module's
    docstring).  Hand one to a map (``SemanticDSPMap(..., tracer=t)``),
    which binds it to its device; ``collect()`` reads what it holds.  A
    tracer records one map."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be at least 1, got {capacity}")
        self.capacity = capacity
        self.frame = -1        # the frame under way (or last), from the map's first update()
        self._frames = collections.deque(maxlen=capacity)  # (frame, [SpanRecord])
        self._stack = []       # indices of the open spans in the frame's records
        self.device = None
        self._data = None      # int64 [2 + 2 * capacity * 9] on the device

    def bind(self, device) -> None:
        """Allocate the rings on ``device`` (once; the map calls this)."""
        if self._data is not None:
            raise ValueError("a Tracer records one map; this one is bound already")
        self.device = torch.device(device)
        n = self.capacity * len(STAMPS)
        self._data = torch.full((2 + 2 * n,), -1, dtype=torch.int64, device=self.device)
        self._data[0].zero_()
        self._cursor = self._data[:2]          # frames begun, the current row
        self._stamps = self._data[2 : 2 + n].view(self.capacity, len(STAMPS))
        self._counters = self._data[2 + n :].view(self.capacity, len(STAMPS))
        # On the CPU the stamps are written through numpy views of the rings.
        self._host = None if self.device.type == "cuda" else tuple(
            t.numpy() for t in (self._cursor, self._stamps, self._counters))

    def span(self, name: str) -> _Span:
        """A host span of ``name`` (a context manager); one opened while no
        span is open is a frame's root and starts the next frame."""
        return _Span(self, name)

    def stamp(self, name: str, first: bool = False, counts=None) -> None:
        """Stamp the column ``name`` (of :data:`STAMPS`) of the current
        frame's row; ``first`` starts the frame's row; ``counts`` (the
        frame's StepDiagnostics, 0-d int64 tensors on the map's device) are
        copied into the counter ring."""
        column = STAMPS.index(name)
        if self._host is None:
            stamp_cuda(self._cursor, self._stamps, self._counters, column, first, counts)
            return
        cursor, stamps, counters = self._host
        if first:
            cursor[1] = cursor[0] % self.capacity
            cursor[0] += 1
            stamps[cursor[1]] = counters[cursor[1]] = -1
        stamps[cursor[1], column] = time.perf_counter_ns()
        if counts is not None:
            counters[cursor[1]] = [_count(c) for c in counts]

    def collect(self) -> Trace:
        """What the tracer holds, read to the host with one device-to-host
        copy (which waits for the device's queued work)."""
        host = self._data.cpu().numpy()
        n_begun = int(host[0])
        first = max(0, n_begun - self.capacity)
        frames = np.arange(first, n_begun, dtype=np.int64)
        rows = frames % self.capacity
        n = self.capacity * len(STAMPS)
        stamps = host[2 : 2 + n].reshape(self.capacity, -1)[rows]
        counters = host[2 + n :].reshape(self.capacity, -1)[rows]
        spans = []
        for frame, records in self._frames:
            if first <= frame < n_begun:
                base = len(spans)
                spans += [r._replace(parent=r.parent + base if r.parent >= 0 else -1)
                          for r in records if r is not None]
        return Trace(frames, spans, stamps, counters, first)


def _count(c: torch.Tensor) -> int:
    if c.dtype != torch.int64 or c.dim() != 0:
        raise ValueError(f"a counter must be a 0-d int64 tensor, got {c.dtype} {tuple(c.shape)}")
    return int(c)


@cuda_lib.counted
def stamp_cuda(cursor: torch.Tensor, stamps: torch.Tensor, counters: torch.Tensor, column: int,
               first: bool, counts=None) -> None:
    """Launch ``csrc/graph.cu``'s ``stamp_kernel``: the device's clock into
    column ``column`` of the current row of ``stamps`` (the row advanced
    first where ``first``), ``counts`` (nine 0-d int64 device tensors, or
    None) into the same row of ``counters``.  Card tensors only."""
    index = cursor.get_device()
    if index < 0:
        raise ValueError("stamp_cuda: the stamp kernel takes card tensors (a CPU Tracer stamps "
                         "the host clock)")
    capacity, width = stamps.shape
    ptrs = cuda_lib.pointers(index, torch.int64, (2,), (cursor,), ("cursor",))
    ptrs += cuda_lib.pointers(index, torch.int64, (capacity, width), (stamps, counters),
                              ("stamps", "counters"))
    if not 0 <= column < width:
        raise ValueError(f"column must be in [0, {width}), got {column}")
    array = None
    if counts is not None:
        counts = tuple(counts)
        if len(counts) != width:
            raise ValueError(f"counts: expected {width} counters, got {len(counts)}")
        array = (ctypes.c_void_p * width)(*cuda_lib.pointers(
            index, torch.int64, (), counts, [f"counts[{i}]" for i in range(width)]))
    err = cuda_lib.entry.dsp_stamp(*ptrs, capacity, column, int(first),
                                   None if array is None else ctypes.addressof(array),
                                   cuda_lib.stream_ptr(index))
    if err:
        raise cuda_lib.error(err, "dsp_stamp")
    stamp_cuda.launches += 1
