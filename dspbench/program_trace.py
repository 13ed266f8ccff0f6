"""The program's own records of a cell's run (the port's ``timing.Tracer``),
read beside the harness's outside clocks.

Each reader of :data:`READERS` is the reader of ``metrics/<name>.py``
(:func:`read`): in a traced run (``--trace 1``) ``harness.run_cell`` hands
the map a ``Tracer`` and keeps its records as ``Run.program``.

    python3 -m dspbench.program_trace --workload vkitti2.drive --seed 7 --seconds 40 --trace 1

runs ``harness.run_cell`` as ``dspbench.run`` does (the allocator held,
the same window, slice and output check), with the map's tracer set apart
from the profiled slice: ``--tracer 1`` (the default) hands the map a
``Tracer`` whatever ``--trace`` is, ``--tracer 0`` hands it none.  The last
line of standard output is one JSON object: ``result``, the harness's
result line; ``host``, the harness's ``update_host_ms`` and end-to-end
metrics of the run whatever ``--trace`` is; ``program``, each per-layer
number of :data:`READERS` (absent where the program recorded nothing, as
in a run without a tracer); and ``agreement``, the program's records held
against the outside clocks.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from typing import Optional  # noqa: E402

import numpy as np  # noqa: E402

from . import harness  # noqa: E402

#: The six overflow counters of the port's StepDiagnostics.
OVERFLOWS = ("block_overflow", "entry_overflow", "table_dropped", "corner_overflow",
             "move_overflow", "birth_overflow")
#: The span that ``frontend.pack_frame`` runs in.
PACK_SPAN = "dsp.pack"


def window_rows(run, trace) -> Optional[np.ndarray]:
    """The rows of ``trace`` of the window's frames outside the profiled
    slice (those ``update_host_ms`` is read over), or None."""
    if trace is None:
        return None
    wanted = {f.index for f in run.frames if not f.failed and f.index not in run.traced}
    rows = np.array([i for i, frame in enumerate(trace.frames) if int(frame) in wanted], np.int64)
    return rows if len(rows) else None


def _mean(values) -> Optional[float]:
    values = np.asarray(values, dtype=np.float64)
    values = values[~np.isnan(values)]
    return float(values.mean()) if len(values) else None


def _span(name: str):
    def read(run, trace):
        rows = window_rows(run, trace)
        if rows is None or not any(s.name == name or s.name.startswith(name + ".")
                                   for s in trace.spans):
            return None
        return _mean(trace.span_ms(name)[rows])
    read.__doc__ = f"ms a frame in the program's ``{name}`` span(s), mean over the window."
    return read


def _stage(stage: str):
    def read(run, trace):
        rows = window_rows(run, trace)
        return None if rows is None else _mean(trace.stage_ms(stage)[rows])
    read.__doc__ = f"device ms a frame of the stage ``{stage}`` from the program's stamps."
    return read


def _counter(names):
    def read(run, trace):
        rows = window_rows(run, trace)
        if rows is None:
            return None
        return _mean(sum(trace.counter(n)[rows].astype(np.float64) for n in names))
    read.__doc__ = f"the program's counters {names} a frame, summed, mean over the window."
    return read


def idle_in_pack_pct(run, trace=None) -> Optional[float]:
    """The share of the profiled slice's steady state in which the device
    is idle while the host is inside a ``dsp.pack`` range (the program's
    span of ``frontend.pack_frame``, a profiler range)."""
    s = run.slice
    if s is None or not s.device:
        return None
    packs = [(e.start_us, e.end_us) for e in s.host if e.name == PACK_SPAN]
    if not packs:
        return None
    lo, hi = s.steady
    idle = 0.0
    for at, length in s.idle_gaps():
        for p0, p1 in packs:
            idle += max(0.0, min(at + length, p1, hi) - max(at, p0, lo))
    return 100.0 * idle / (hi - lo)


#: Each per-layer number the program's records give, by the name a metric
#: file of ``metrics/`` would give it: ``read(run, trace)`` returns it, or
#: None where there is nothing to read.
READERS = {
    "pack_span_ms": _span(PACK_SPAN),
    "input_copy_ms": _span("dsp.input_copy"),
    "replay_host_ms": _span("dsp.replay"),
    "bridge_host_ms": _span("dsp.bridge"),
    **{f"{stage}_device_ms": _stage(stage)
       for stage in ("objects", "bridge", "cloud", "predict", "observe", "birth", "render")},
    "visible_per_frame": _counter(("visible_count",)),
    "born_per_frame": _counter(("born_count",)),
    "overflow_per_frame": _counter(OVERFLOWS),
    "idle_in_pack_pct": idle_in_pack_pct,
}


def read(name: str, run) -> Optional[float]:
    """``READERS[name]`` on ``run`` and the program's records it holds
    (``run.program``, None where the map had no tracer): None where there
    is nothing to read."""
    value = READERS[name](run, run.program)
    return None if value is None or math.isnan(value) else value


def slice_kernel_ms(run) -> Optional[float]:
    """Device ms a frame of every kernel in the profiled slice."""
    s = run.slice
    if s is None:
        return None
    lo, hi = s.window
    us = [e.dur_us for e in s.kernels() if lo <= e.start_us <= hi]
    return sum(us) / 1e3 / s.frames if us else None


def agreement(run, trace, program: dict) -> dict:
    """The program's records against the outside clocks: the ``dsp.update``
    span against ``update_host_ms``, the share of it its child spans
    cover, and the six stages (the bridge left out) against the slice's
    kernel time a frame."""
    out = {}
    update = _span("dsp.update")(run, trace)
    host = harness.reader("update_host_ms")(run)
    if update is None or host is None:
        return out
    out["update_span_ms"], out["update_host_ms"] = update, host
    out["update_span_over_host"] = update / host
    parts = [program.get(k) for k in ("pack_span_ms", "input_copy_ms", "replay_host_ms",
                                      "bridge_host_ms")]
    out["children_over_update_span"] = sum(p for p in parts if p is not None) / update
    stages = [program.get(f"{s}_device_ms") for s in
              ("objects", "cloud", "predict", "observe", "birth", "render")]
    kernels = slice_kernel_ms(run)
    if kernels is not None and None not in stages:
        out["stages_ms"], out["slice_kernel_ms_per_frame"] = sum(stages), kernels
        out["stages_over_slice_kernels"] = sum(stages) / kernels
    out["frames_lost"] = int(trace.lost)
    return out


def traced_run(cell: harness.Cell, seed: int, seconds: float, traced: bool, tracer: bool = True,
               device=None, t_process: Optional[float] = None) -> dict:
    """One run of ``cell`` (``harness.run_cell``) with the program's
    tracer on where ``tracer``; returns the dictionary the command
    prints."""
    run = harness.Run()
    result = harness.run_cell(cell, seed, seconds, traced, device=device, t_process=t_process,
                              tracer=tracer, run=run)
    host = {name: harness.reader(name)(run) for name in
            ("frames_per_s", "frame_ms_p95", "setup_s", "update_host_ms")}
    program = {name: value for name in READERS if (value := read(name, run)) is not None}
    out = {"result": result, "host": host, "program": program}
    if run.program is not None:
        out["agreement"] = agreement(run, run.program, program)
    return out


def main(argv=None) -> int:
    import argparse
    import os

    from . import run as run_mod

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    run_mod.fix_allocator()
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    import torch

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"dspbench: {args.workload} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    out = traced_run(cell, args.seed, args.seconds, bool(args.trace), bool(args.tracer),
                     t_process=T_PROCESS)
    found = run_mod.forbidden_loaded()
    if found:
        print(f"dspbench: loaded in this process: {found}", file=sys.stderr)
        return 3
    print(f"card: {harness.card_line()}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
