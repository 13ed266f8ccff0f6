"""One run of one cell: set-up, the measured window, the traced slice, the
output check, and the result line.

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json`` names its configuration (``configs/<name>.json``) and
its traffic mix (``traffic/<name>.json``); each metric is read by
``metrics/<name>.py``; each cell's limits of the output check are
``limits/<cell>.json``.  A configuration names the reference its output
check uses (``"reference"``: a module under ``dspbench.``, by default the
frozen ``dspbench.reference``) and what its set-up loads besides the map
(``"setup"``: ``{"templates": "<folder relative to the repository
root>"}``, the template bank); see :func:`reference_module` and
:func:`cell_setup`.

In a traced run (``--trace 1``) the map is handed the program's own
tracer (``timing.Tracer``); its records are ``Run.program``, which the
readers of the program's spans, stage times and counters read
(``program_trace.READERS``).

The window drives ``SemanticDSPMap.update()`` of the PyTorch port, the
packed path through its captured step, as a closed loop of one stream of
frames with at most two in flight: frame i + 1 is handed in before the
host waits for frame i's ``occ``, which a side stream copies into pinned
host memory; that copy's event marks the frame done.  A frame's latency
runs from its hand-in to the moment the host sees its ``occ`` there.

The output check runs after the window has closed, the memory peak has
been read and the program has been freed; see ``check`` and
``PERF.md``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import re
import time
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from . import census as census_mod
from . import check, trace as trace_mod, traffic

ROOT = Path(__file__).resolve().parent

#: Frames run in set-up: the first runs eagerly (and loads, on a checkout's
#: first run builds, the kernel library), the second is captured, the rest
#: replay.  The output check's reference replays these from the seed.
WARMUP = 4
#: Frames run after the window for the output check, each compared with
#: one reference step from the program's state before it.
CHECK_FRAMES = 2
#: The traced slice: frames [TRACE_FIRST, TRACE_FIRST + TRACE_FRAMES) of
#: the window.
TRACE_FIRST = 200
TRACE_FRAMES = 16
#: How long ``pack_ms`` times ``pack_frame`` (seconds of the host clock).
PACK_SECONDS = 0.5
#: The output check's reference where a configuration names none.
DEFAULT_REFERENCE = "dspbench.reference"
_REFERENCE_NAME = re.compile(r"dspbench(\.[A-Za-z_][A-Za-z0-9_]*)+")
#: The keys a configuration's ``setup`` may hold.
SETUP_KEYS = ("templates",)


class Cell(NamedTuple):
    """A cell as ``BENCHMARK.json`` and its files give it."""

    name: str
    chips: int
    config: dict          # configs/<config>.json
    mix: dict             # traffic/<traffic>.json
    end_to_end: list      # (name, unit) of the end-to-end metrics
    per_layer: list       # (name, unit) of the per-layer metrics
    limits: dict          # limits/<cell>.json


def load_cell(name: str, bench: Optional[dict] = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` (default: the repository's
    ``BENCHMARK.json``), its files read from ``root``."""
    if bench is None:
        with open(root.parent / "BENCHMARK.json") as f:
            bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the benchmark has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"].split("/", 1)[1]) as f:
        config = json.load(f)
    with open(root / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    return Cell(
        name=name, chips=w["chips"], config=config,
        mix=traffic.load(w["traffic"], root / "traffic"),
        end_to_end=[(m["name"], m["unit"]) for m in bench["end_to_end"]],
        per_layer=[(m["name"], m["unit"]) for m in bench["per_layer"]],
        limits=limits,
    )


def reference_module(config: dict):
    """The module the configuration's ``reference`` key names (default
    :data:`DEFAULT_REFERENCE`), imported.  It provides ``Reference`` and
    ``state_from_fields`` with the frozen package's signatures.  A name
    that is not a module under ``dspbench.`` is refused, so that no
    configuration points the output check at the program."""
    name = config.get("reference", DEFAULT_REFERENCE)
    if not isinstance(name, str) or not _REFERENCE_NAME.fullmatch(name):
        raise ValueError(f"reference {name!r}: the output check's reference is a module under "
                         f"dspbench. (default {DEFAULT_REFERENCE!r})")
    module = importlib.import_module(name)
    missing = [a for a in ("Reference", "state_from_fields") if not hasattr(module, a)]
    if missing:
        raise ValueError(f"reference {name!r} provides no {', '.join(missing)}")
    return module


def cell_setup(config: dict, root: Optional[Path] = None) -> dict:
    """The configuration's ``setup``, checked, as the keywords its
    reference takes beyond the frozen package's: ``templates``, the
    template bank's folder (given relative to the repository ``root``,
    by default the checkout's) made absolute.  Empty where the
    configuration has no ``setup``.  Refuses an unknown key, a folder that
    does not exist, lies outside ``root`` or holds no ``.pcd`` file, and
    template matching without a bank or a bank without template matching
    (an empty bank silently matches nothing)."""
    root = ROOT.parent if root is None else root
    setup = config.get("setup", {})
    if not isinstance(setup, dict):
        raise ValueError(f"setup must be an object, got {setup!r}")
    unknown = sorted(set(setup) - set(SETUP_KEYS))
    if unknown:
        raise ValueError(f"setup: unknown key(s) {unknown}; a setup may hold {list(SETUP_KEYS)}")
    out = {}
    if "templates" in setup:
        rel = setup["templates"]
        folder = (root / rel).resolve() if isinstance(rel, str) else None
        if folder is None or Path(rel).is_absolute() or not folder.is_relative_to(root.resolve()):
            raise ValueError(f"setup templates {rel!r}: a folder relative to the repository root")
        if not folder.is_dir():
            raise ValueError(f"setup templates {rel!r}: no such folder under {root}")
        if not any(folder.rglob("*.pcd")):
            raise ValueError(f"setup templates {rel!r}: no template (.pcd file) in the folder")
        out["templates"] = str(folder)
    matching = config["filter_params"].get("if_use_template_matching", False)
    if matching and "templates" not in out:
        raise ValueError("if_use_template_matching is true and setup names no templates: an "
                         "empty bank matches nothing")
    if "templates" in out and not matching:
        raise ValueError("setup names templates and if_use_template_matching is false")
    return out


def reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"dspbench_metric:{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Frame(NamedTuple):
    """One frame of the window, by the host clock (``time.perf_counter``)."""

    index: int
    handed: float      # hand-in to update()
    returned: float    # update() returned
    done: float        # its occ seen on the host
    failed: bool


class Run:
    """What the metric readers read (``metrics/<name>.py``: ``read(run)``
    returns a number, or None where it has nothing to read)."""

    def __init__(self):
        self.setup_s: float = 0.0
        self.frames: list = []              # Frame, every frame of the window
        self.window: tuple = (0.0, 0.0)     # (start, end) by the host clock
        self.traced: range = range(0)       # frame indices of the traced slice
        self.slice: Optional[trace_mod.Slice] = None
        self.census: list = []              # census.census of the slice's first and last state
        self.pack_ms: Optional[float] = None
        self.peak_bytes: int = 0
        self.device_kind: str = ""
        self.templates: int = 0             # templates the map's bank loaded at set-up
        self.program = None                 # timing.Trace of the map's tracer, or None


class _Pending(NamedTuple):
    index: int
    handed: float
    returned: float
    result: object
    event: object
    host: torch.Tensor
    failed: bool


class Pipe:
    """Hands frames to the map and brings each frame's ``occ`` to pinned
    host memory on a side stream, without blocking the host."""

    def __init__(self, dsp, ring: traffic.Ring, device: torch.device):
        self.dsp, self.ring, self.device = dsp, ring, device
        self.cuda = device.type == "cuda"
        V = dsp.cfg.num_voxels
        self.host = [torch.empty(V, dtype=torch.int32, pin_memory=self.cuda) for _ in range(2)]
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        # The ring's frames as the port takes them (MaskKpts), made once.
        from semantic_dsp_map_tpu_torch import MaskKpts

        self.masks = [[MaskKpts(**m) for m in masks] for _, masks in ring.images]

    def hand(self, i: int) -> _Pending:
        f = self.ring.frame(i)
        host = self.host[i % 2]
        handed = time.perf_counter()
        try:
            result, _diag = self.dsp.update(f.depth, self.masks[i % len(self.ring)], f.cam_pos,
                                            f.cam_quat, f.time)
        except Exception as err:  # a frame that raises counts as failed
            import traceback

            traceback.print_exception(err)
            return _Pending(i, handed, time.perf_counter(), None, None, host, True)
        returned = time.perf_counter()
        if self.cuda:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.stream):
                host.copy_(result.occ, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self.stream)
        else:
            host.copy_(result.occ)
            event = None
        return _Pending(i, handed, returned, result, event, host, False)

    def wait(self, p: _Pending) -> Frame:
        if p.event is not None:
            p.event.synchronize()
        return Frame(p.index, p.handed, p.returned, time.perf_counter(), p.failed)


def _window(pipe: Pipe, first: int, seconds: float, run: Run, traced: bool, device,
            ref_cfg) -> int:
    """Frames from index ``first`` until ``seconds`` have passed; returns
    the next index.  In a traced run the profiler holds over the slice: the
    pipe is drained before its first frame and after its last, so that the
    slice holds those frames whole; the device's busy and idle time are
    read over its steady state (``trace.Slice.steady``)."""
    from torch.profiler import profile, record_function

    lo, hi = first + TRACE_FIRST, first + TRACE_FIRST + TRACE_FRAMES
    prof = None
    pending = None
    i = first
    start = time.perf_counter()
    end = start + seconds
    while time.perf_counter() < end:
        if traced and i == lo:
            _drain(pipe, pending, run)
            pending = None
            run.census.append(_census(pipe.dsp, ref_cfg, run))
            prof = profile(activities=trace_mod.activities(device))
            prof.start()
        if prof is not None and i == hi:
            with record_function(trace_mod.WAIT_SPAN):
                _drain(pipe, pending, run)
            pending = None
            prof.stop()
            run.slice = trace_mod.read_profile(prof, TRACE_FRAMES)
            run.traced = range(lo, hi)
            prof = None
            run.census.append(_census(pipe.dsp, ref_cfg, run))
        with record_function(trace_mod.FRAME_SPAN) if prof else _nothing():
            p = pipe.hand(i)
        if pending is not None:
            with record_function(trace_mod.WAIT_SPAN) if prof else _nothing():
                run.frames.append(pipe.wait(pending))
        pending = p
        i += 1
    _drain(pipe, pending, run)
    if prof is not None:  # the window closed inside the slice: no trace
        prof.stop()
    last = max(f.done for f in run.frames) if run.frames else end
    run.window = (start, last)
    return i


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _drain(pipe: Pipe, pending, run: Run) -> None:
    if pending is not None:
        run.frames.append(pipe.wait(pending))


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def _census(dsp, ref_cfg, run: Run) -> dict:
    """The render's and the candidate scan's bytes on the map's state as it
    stands (the device drained); the memory the count takes is kept out of
    the run's peak."""
    from .reference.ops.codecs import axis_stamps_per_voxel

    device = dsp.device
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    run.peak_bytes = max(run.peak_bytes, _peak(device))
    p = dsp.state.particles
    vax = axis_stamps_per_voxel(ref_cfg, dsp.state.scroll)
    c = census_mod.census(p.status, p.stamp, vax, ref_cfg.num_voxels, ref_cfg.slots_per_voxel)
    del vax
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    return c


def _time_pack(dsp, pipe: Pipe, ring: traffic.Ring) -> float:
    """``frontend.pack_frame`` alone on the ring's frames, ms a frame, over
    at least PACK_SECONDS of the host clock."""
    from semantic_dsp_map_tpu_torch.frontend import pack_frame

    n, t0 = 0, time.perf_counter()
    while True:
        f = ring.frame(n)
        pack_frame(dsp.cfg, dsp.registry, f.depth, pipe.masks[n % len(ring)], f.cam_pos,
                   f.cam_quat, f.time)
        n += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= PACK_SECONDS:
            return 1e3 * elapsed / n


def _outputs(result, host: torch.Tensor) -> dict:
    return {"occ": host.clone(), "label": result.label.clone(), "track": result.track.clone(),
            "weight_sum": result.weight_sum.clone()}


class Program(NamedTuple):
    """What the program produced for the output check: its state after the
    set-up frames and their last render, and around each check frame its
    state before and after and its render."""

    start_state: dict
    start_out: dict
    states: list          # CHECK_FRAMES + 1 states
    outs: list            # CHECK_FRAMES renders
    first_check: int      # the first check frame's index


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device=None,
             t_process: Optional[float] = None, control: bool = False,
             tracer: Optional[bool] = None, run: Optional[Run] = None) -> dict:
    """One run; returns the result line's dictionary.  ``device`` defaults
    to the card; a test may name the CPU.  ``t_process`` is the host clock
    at the process's start (set-up is counted from it).  With ``control``
    the output check also reads the control (the reference one precision
    step down in the program's place: ``Reference.frame(..., lower=True)``)
    and the result has its numbers under ``control_checks``.  ``tracer``
    (default: ``traced``) hands the map the program's tracer, whose records
    become ``run.program`` after the window.  ``run``, where given, is the
    Run filled, for a caller that reads more than the result line."""
    t0 = time.perf_counter() if t_process is None else t_process
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    ref_module, setup = reference_module(cell.config), cell_setup(cell.config)
    from semantic_dsp_map_tpu_torch import FilterParams, MapConfig, SemanticDSPMap
    from semantic_dsp_map_tpu_torch.timing import Tracer

    from .reference import config as ref_config

    cfgd, paramsd = cell.config["map_config"], cell.config["filter_params"]
    cfg, params = MapConfig(**cfgd), FilterParams(**paramsd)
    ref_cfg = ref_config.MapConfig(**cfgd)
    run = Run() if run is None else run
    ring = traffic.Ring(cell.mix, traffic.Camera.of(cfgd), seed)
    map_tracer = Tracer() if (traced if tracer is None else tracer) else None
    dsp = SemanticDSPMap(cfg, params, seed=seed, device=device, tracer=map_tracer)
    if "templates" in setup:
        run.templates = dsp.set_template_path(setup["templates"])
    pipe = Pipe(dsp, ring, device)

    # Set-up: the warm-up frames, through the window's own path.
    last = None
    for i in range(WARMUP):
        p = pipe.hand(i)
        if p.failed:
            raise RuntimeError(f"set-up frame {i} raised")
        pipe.wait(p)
        last = p
    start_out = {k: v.cpu() for k, v in _outputs(last.result, last.host).items()}
    start_state = check.snapshot(dsp.state, torch.device("cpu"))
    del last
    if traced:  # the profiler's own first start, kept out of the slice
        from torch.profiler import profile

        with profile(activities=trace_mod.activities(device)):
            pipe.wait(pipe.hand(WARMUP))
        first = WARMUP + 1
    else:
        first = WARMUP
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    run.setup_s = time.perf_counter() - t0

    nxt = _window(pipe, first, seconds, run, traced, device, ref_cfg)
    run.peak_bytes = max(run.peak_bytes, _peak(device))
    if map_tracer is not None:
        run.program = map_tracer.collect()
    if traced:
        run.pack_ms = _time_pack(dsp, pipe, ring)

    # The check frames: the window's path on, the state copied around each.
    states, outs = [check.snapshot(dsp.state)], []
    for c in range(CHECK_FRAMES):
        p = pipe.hand(nxt + c)
        if p.failed:
            break
        pipe.wait(p)
        outs.append(_outputs(p.result, p.host))
        states.append(check.snapshot(dsp.state))
        del p
    prog = Program(start_state, start_out, states, outs, nxt)
    run.device_kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    del pipe, dsp
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    numbers, control_numbers = reference_check(cell, seed, ring, prog, device, control,
                                               ref_module, setup)
    ok = (len(outs) == CHECK_FRAMES and check.verdict(numbers, cell.limits))
    attempted = len(run.frames)
    failed = sum(f.failed for f in run.frames)
    metrics = {}
    for name, unit in (cell.per_layer if traced else cell.end_to_end):
        value = reader(name)(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": run.device_kind,
           "count": 1, "memory_peak_bytes": run.peak_bytes}
    out = {"correct": ok, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": dev}
    if traced and run.slice is not None:
        lo, hi = run.slice.steady
        dev["busy_s"] = run.slice.busy_us() / 1e6
        dev["window_s"] = (hi - lo) / 1e6
        out["breakdown"] = trace_mod.breakdown(run.slice)
    if control_numbers is not None:
        out["control_checks"] = control_numbers
    out["checks"] = {k: {"value": numbers[k], "limit": cell.limits[k]} for k in check.NUMBERS}
    return out


def reference_check(cell: Cell, seed: int, ring: traffic.Ring, prog: Program, device,
                    control: bool, module, setup: dict):
    """The output check's numbers (``check.NUMBERS``, the worst over the
    frames compared) and, with ``control``, the control's (the reference
    one precision step down in the program's place): the set-up frames
    replayed from the seed, then one reference step from the program's
    state before each check frame.  ``module`` is the reference the
    configuration names (:func:`reference_module`); its ``Reference`` is
    also handed the ``setup`` keywords (:func:`cell_setup`), none where
    the configuration has no ``setup``."""
    state_from_fields = module.state_from_fields
    ref = module.Reference(cell.config["map_config"], cell.config["filter_params"], device,
                           **setup)

    def replay(lower: bool):
        st = ref.init_state(seed)
        for i in range(WARMUP):
            f = ring.frame(i)
            st, r, _ = ref.frame(st, f.depth, f.masks, f.cam_pos, f.cam_quat, f.time, lower)
        return st, r

    def stepped(c: int, lower: bool):
        f = ring.frame(prog.first_check + c)
        st = state_from_fields(prog.states[c], device)
        return ref.frame(st, f.depth, f.masks, f.cam_pos, f.cam_quat, f.time, lower)[:2]

    start_state = check.snapshot(prog.start_state, device)
    start_out = {k: v.to(device) for k, v in prog.start_out.items()}
    readings, control_readings = [], []
    runs = [(lambda lower: replay(lower), start_state, start_out)]
    runs += [(lambda lower, c=c: stepped(c, lower), prog.states[c + 1], prog.outs[c])
             for c in range(len(prog.outs))]
    for step, prog_state, prog_out in runs:
        st, r = step(False)
        readings.append(check.compare(prog_state, prog_out, st, r))
        if control:
            st_c, r_c = step(True)
            control_readings.append(check.compare(check.snapshot(st_c), _as_out(r_c), st, r))
            del st_c, r_c
        del st, r
    return check.worst(readings), (check.worst(control_readings) if control else None)


def _as_out(r) -> dict:
    return {"occ": r.occ, "label": r.label, "track": r.track, "weight_sum": r.weight_sum}


def card_line() -> str:
    """``name, power limit`` of card 0 as nvidia-smi prints them (the limit
    decides the clocks under load); a copy of the port's
    ``timing.card_line``."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "power limit unknown"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else "power limit unknown"


def limits_lines(result: dict) -> list:
    """Each compared number beside its limit, one a line."""
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in result["checks"].items()]
