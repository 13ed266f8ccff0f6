"""The frame step at fixed addresses, captured into a CUDA graph on the card:
the counterpart of the JAX package's ``jax.jit(step, donate_argnums=0)``
(``semantic_dsp_map_tpu/map.py:446-487``): one replay a frame (two, and an
eager SVD between them, where the superpoint refit runs) where the eager
step issues some 2,300 dispatches.

:class:`StaticStep` holds a map's step on tensors that keep their addresses
from frame to frame:

- **input**: a device ``int32`` buffer of ``pack_frame``'s length for
  ``update()`` (unpacked inside the step), one tensor per ``FrameInput``
  field for ``update_from_frame()``; each frame is copied into them: from
  host memory a synchronous copy, as the eager map's, from the device (the
  sharded step's callers) a device-to-device copy;
- **state**: the particle store and the voxel stamps are updated in place by
  the step; the object table, the scroll state, the global time and the
  previous frame time come out of it as new tensors and are copied back into
  the static ones as its last operations (the counterpart of donation).  The
  map's ``state`` always names the static tensors.  A state put in their
  place from outside (``clear()``, a restored checkpoint) is copied into
  them before the next frame, the generator's seed and offset included
  (and a rank generator of the stages reseeded).
  A part of the state that a caller holds across a frame takes the new
  values;
- **output**: the RenderResult and StepDiagnostics of a replay live in the
  graph's memory and are cloned after each replay, so that a result the
  caller keeps survives the next frame, as a JAX array does.

On the card the first frame of each input kind runs eagerly (it loads the
kernel library, sets the kernels' shared-memory attributes and warms the
allocator); the second is captured with ``torch.cuda.graph`` and replayed;
every later frame is the input copy and the replays.  The map's
``torch.Generator`` (and the sharded stages' rank generator) is registered
with each graph, so a replay draws from the Philox offsets the eager step
would have drawn from, in the same order.  A capture or a replay that fails
raises: there is no step back to eager.

The superpoint object layer refits its RANSAC hypotheses with a Kabsch fit
whose ``torch.linalg.svd`` reads cuSOLVER's convergence flags to the host, a
synchronization that capture refuses.  Where it runs
(:func:`split_at_refit`), a frame is two graphs and one eager bridge:

- graph "fit": the object layer up to the refit's SVD
  (``FrameStages.objects_fit`` on its own fields of the frame,
  ``map.unpack_objects``), the RANSAC draws included;
- the bridge: ``objects.refit_svd`` of that graph's covariance, eager (the
  frame's one host synchronization), its U and Vt copied into static
  tensors;
- graph "finish": the rest of the object layer from those U and Vt
  (``FrameStages.objects_finish``, ``torch.linalg.det`` of the refit
  included) and stages 1-5; the five frame kernels all run here.

The frame that captures runs: capture "fit", replay it, the bridge on its
real outputs, capture "finish", replay it.  Both graphs draw from the map's
generator, each its own Philox offsets, in the eager order.  Elsewhere the
frame is one graph, "step".  Template mode is captured with the rest: its
gate stays on the device, and each of its slots (:func:`slot_cond`) is a
conditional IF node of the graph, whose body a replay runs only where the
slot has work, as XLA runs only the taken branch of the JAX package's
``lax.cond``.

The sharded step (``parallel/shard_step.build_shard_step``, the counterpart
of the JAX package's jitted ``shard_map`` step) is a StaticStep over a
rank's slab of the state, with the same parts and the same split: its
stages (``shard_step.build_shard_stages``) take the object layer from
``map.build_frame_stages`` and run the rest of the frame, the routes,
halos and the counters' ``all_reduce`` included, inside graph "finish" or
"step".  The collectives are recorded into the graph: the first frame runs
eagerly and makes NCCL's communicator, so none is made under capture.  The
sharded stages also draw from a generator of the rank's own
(``FrameStages.rank_rng``): it is registered with every graph beside the
state's, and reseeded where a state from outside is taken, as the eager
sharded step reseeds it.

With a frame tracer (``FrameStages.tracer``, a ``timing.Tracer``) the
step is traced: host spans around the input copy, each part and the
bridge, and device stamps at each graph's start, at each stage's end and
after the state's write-back, the last one with the frame's counters.
The stamps are kernels captured into the graphs with the rest; without a
tracer the graphs hold none.

On the CPU nothing is captured: the same static-state parts run eagerly,
in the same order.  The eager ``map.build_frame_step`` stays the oracle of
this step, and ``shard_step.build_shard_step_eager`` of the sharded one.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
from typing import Callable

import numpy as np
import torch

from .config import KEYPOINTS_SUPERPOINT, MapConfig
from .frontend import FrameInput
from .objects import refit_svd
from .ops import cuda_lib, observe_cuda, phd_cuda, render_cuda
from .state import MapState
from .timing import NO_SPAN

#: Kernel launches over every graph of the process, by wrapper name:
#: ``captured`` holds those recorded into a graph at its capture (a wrapper
#: counts them in its own ``launches`` while it is captured, though the
#: kernel runs only when the graph is replayed), ``replayed`` those that the
#: replays ran.  A wrapper's kernel ran ``launches - captured + replayed``
#: times.
captured: collections.Counter = collections.Counter()
replayed: collections.Counter = collections.Counter()


def kernel_runs(fn) -> int:
    """How often the kernel of wrapper ``fn`` ran: the wrapper's own count,
    less the launches it recorded into graphs, plus those their replays ran."""
    return fn.launches - captured[fn.__name__] + replayed[fn.__name__]


#: The wrappers of the five frame kernels, each launched once a frame; each
#: counts its launches.
FRAME_KERNELS = (phd_cuda.pass_a_cuda, phd_cuda.pass_b_cuda, render_cuda.render_core_cuda,
                 observe_cuda.front_candidates_cuda, observe_cuda.movable_voxels_cuda)


def split_at_refit(cfg: MapConfig) -> bool:
    """Whether the step is split at the RANSAC refit's ``torch.linalg.svd``
    into two graphs and an eager bridge: with instances in superpoint
    mode."""
    return cfg.consider_instance and cfg.keypoint_mode == KEYPOINTS_SUPERPOINT


def copy_into(static, new) -> None:
    """Copy every tensor of the dataclass ``new`` into the same field of
    ``static`` where it is another tensor; a ``torch.Generator`` that is
    another one gives ``static``'s its seed and offset."""
    for field in dataclasses.fields(static):
        s, n = getattr(static, field.name), getattr(new, field.name)
        if n is s:
            continue
        if isinstance(s, torch.Tensor):
            s.copy_(n)
        elif isinstance(s, torch.Generator):
            s.set_state(n.get_state())
        else:
            copy_into(s, n)


class Capture:
    """What ``slot_cond`` needs of the capture underway: the CUDA graph, the
    stream it is captured on, a side stream on which each branch's body is
    captured (into the body graph of its node), and the memory pool of the
    bodies' tensors.

    A body is a capture of its own, whose allocations the allocator does
    not give the graph's pool (and refuses to route there a second time);
    they go to a private pool of their own, which each body holds once
    (``bodies``) and which is let go when this object, kept beside the
    graph by ``_Graph``, is: the bodies' memory stays reserved while the
    graph can be replayed."""

    def __init__(self, graph: torch.cuda.CUDAGraph):
        self.graph = graph
        # The stream the graph is captured on and the bodies' side stream:
        # two streams taken in a row from PyTorch's pool, which hands out its
        # 32 a device in turn, so never the same one.  A side stream taken
        # alone is, every 32nd time, torch.cuda.graph's own default capture
        # stream, and ending a body's capture then ends the graph's.
        self.main = torch.cuda.Stream()
        self.stream = torch.cuda.Stream()
        self.device = torch.cuda.current_device()
        self.pool = torch.cuda.graph_pool_handle()
        self.bodies = 0

    def __del__(self):
        for _ in range(self.bodies):
            torch._C._cuda_releasePool(self.device, self.pool)


_capturing: list = []  # the Capture of the capture underway, if any


@contextlib.contextmanager
def capturing(capture: Capture):
    """``torch.cuda.graph(capture.graph)`` on ``capture.main``, with
    ``capture`` the one that ``slot_cond`` captures its branches for."""
    err = cuda_lib.entry.dsp_if_node_prepare()
    if err:
        raise cuda_lib.error(err, "dsp_if_node_prepare")
    _capturing.append(capture)
    try:
        with torch.cuda.graph(capture.graph, stream=capture.main):
            yield
    finally:
        _capturing.pop()


def slot_cond(pred: torch.Tensor, do: Callable, no: Callable) -> tuple:
    """``do()`` where the 0-d bool tensor ``pred`` is true, else ``no()``:
    the counterpart of one ``lax.cond`` of the JAX package's template
    stages.  Both return tuples of tensors of the same shapes and dtypes,
    small ones (the particle store never passes through a branch), and have
    no side effects.

    Under CUDA-graph capture (inside :func:`capturing`), ``no()``'s outputs
    are made first, then ``do()`` is captured into a conditional IF node on
    ``pred`` (``csrc/graph.cu``) and copies its outputs into them: a replay
    runs ``do()``'s kernels only where ``pred`` holds, as XLA runs only the
    taken branch.  Elsewhere (the CPU, an eager frame) both run and the
    outputs are selected leaf by leaf with ``torch.where``: the same bits,
    no host read, and every kernel of the branch runs once before its
    capture."""
    if not (pred.is_cuda and torch.cuda.is_current_stream_capturing()):
        return tuple(torch.where(pred, d, n) for d, n in zip(do(), no(), strict=True))
    if not _capturing:
        raise RuntimeError("slot_cond: a capture that step_graph.capturing did not start")
    capture = _capturing[-1]
    outs = tuple(t.clone() for t in no())
    index = pred.get_device()
    (flag,) = cuda_lib.pointers(index, torch.bool, (), (pred,), ("pred",))
    err = cuda_lib.entry.dsp_if_node_begin(cuda_lib.stream_ptr(index), flag,
                                           capture.stream.cuda_stream)
    if err:
        raise cuda_lib.error(err, "dsp_if_node_begin")
    # While the body is captured, what this thread allocates off the
    # capture stream (the side stream's tensors) goes to the bodies' pool.
    torch._C._cuda_beginAllocateCurrentThreadToPool(capture.device, capture.pool)
    capture.bodies += 1
    try:
        with torch.cuda.stream(capture.stream):
            for out, value in zip(outs, do(), strict=True):
                out.copy_(value)
    finally:
        torch._C._cuda_endAllocateToPool(capture.device, capture.pool)
        err = cuda_lib.entry.dsp_if_node_end(capture.stream.cuda_stream)
    if err:
        raise cuda_lib.error(err, "dsp_if_node_end")
    return outs


def _clone(outputs):
    return type(outputs)(*(t.clone() for t in outputs))


class _Graph:
    """One captured part of the frame step and its outputs in the graph's
    memory, which each replay overwrites."""

    def __init__(self, body: Callable, generators, part: str):
        self.graph = torch.cuda.CUDAGraph()
        for generator in generators:
            self.graph.register_generator_state(generator)
        self.capture = Capture(self.graph)
        # Every wrapper's launches (cuda_lib.WRAPPERS; a wrapper whose module
        # the capture imports starts at 0).
        before = {fn: fn.launches for fn in cuda_lib.WRAPPERS}
        # Another map's graph destroyed during the capture (by the garbage
        # collector, at any allocation) would invalidate it: the dead go
        # first, and the collector waits until the capture ends.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with capturing(self.capture):
                self.outputs = body()
        except Exception as err:
            raise RuntimeError(f"capturing the frame step ({part}) into a CUDA graph failed: "
                               f"{err}") from err
        finally:
            if collecting:
                gc.enable()
        self.launches = {fn.__name__: fn.launches - before.get(fn, 0) for fn in cuda_lib.WRAPPERS}
        captured.update(self.launches)

    def replay(self):
        self.graph.replay()
        replayed.update(self.launches)
        return self.outputs


class StaticStep:
    """A map's frame step on static tensors.  ``stages`` is
    ``map.build_frame_stages``'s FrameStages (split at the refit where its
    ``objects_fit`` is set), ``unpack`` maps the packed buffer to a
    FrameInput on the device and ``unpack_objects`` to the part of it that
    the object layer reads (``map.unpack_objects``: the fit part's input),
    ``state`` is the map's state (a rank's slab of it for the sharded
    stages), whose tensors become the static ones.  ``capture`` captures
    the step from each input kind's second frame on (the card); without it
    every frame runs the same parts eagerly."""

    def __init__(self, stages, unpack: Callable, unpack_objects: Callable, state: MapState,
                 capture: bool):
        self.stages, self.unpack, self.unpack_objects = stages, unpack, unpack_objects
        self.state = state
        self.capture = capture
        self.split = stages.objects_fit is not None
        self.inputs = {}  # "packed": int32 buffer; "frame": FrameInput
        self.graphs = {}  # (input kind, part) -> _Graph
        self.uv = None    # the bridge's static (U, Vt)
        self.frames = collections.Counter()
        self.tracer = stages.tracer

    def __call__(self, kind: str, frame, state: MapState):
        """One frame (``kind`` "packed": pack_frame's int32 array or tensor;
        "frame": a FrameInput of arrays or tensors), from the host or the
        device, on ``state``, the map's state.  Returns (the static state,
        RenderResult, StepDiagnostics)."""
        tracer = self.tracer
        with NO_SPAN if tracer is None else tracer.span("dsp.input_copy"):
            self._take(state)
            self._put(kind, frame)
        if self.split:
            with NO_SPAN if tracer is None else tracer.span("dsp.replay.fit"):
                fit = self._part(kind, "fit", lambda: self._fit(kind))
            with NO_SPAN if tracer is None else tracer.span("dsp.bridge"):
                self._bridge(fit)
            part, body = "finish", lambda: self._body(kind, fit)
        else:
            part, body = "step", lambda: self._body(kind)
        with NO_SPAN if tracer is None else tracer.span(f"dsp.replay.{part}"):
            result, diag = self._part(kind, part, body)
        if (kind, part) in self.graphs:  # the graph's own tensors
            result, diag = _clone(result), _clone(diag)
        self.frames[kind] += 1
        return self.state, result, diag

    def _part(self, kind: str, part: str, body: Callable):
        """``body()`` eagerly, or as the replay of its graph, captured on
        the second frame of ``kind`` and replayed at once."""
        graph = self.graphs.get((kind, part))
        if graph is None and self.capture and self.frames[kind] > 0:
            generators = [self.state.rng]
            if self.stages.rank_rng is not None:
                generators.append(self.stages.rank_rng(self.state))
            graph = self.graphs[kind, part] = _Graph(body, generators, part)
        return body() if graph is None else graph.replay()

    def _fit(self, kind: str):
        """The object layer up to the refit's SVD, on the frame's object
        fields."""
        if self.tracer is not None:
            self.tracer.stamp("fit_start", first=True)
        x = self.inputs[kind]
        f = self.unpack_objects(x) if kind == "packed" else x
        fit = self.stages.objects_fit(self.state, f)
        if self.tracer is not None:
            self.tracer.stamp("fit_end")
        return fit

    def _bridge(self, fit) -> None:
        """The refit's SVD, eager, its U and Vt copied into the static pair
        that the finishing part reads."""
        U, Vt = refit_svd(fit)
        if self.uv is None:
            self.uv = (torch.empty_like(U), torch.empty_like(Vt))
        self.uv[0].copy_(U)
        self.uv[1].copy_(Vt)

    def _body(self, kind: str, fit=None):
        """The object layer (or its part from ``fit`` and the bridge's U and
        Vt on) and stages 1-5 on the static tensors; ends by copying the new
        state into them.  Traced, it starts with the finishing graph's stamp
        (the step's two first where it is one graph) and ends with the
        frame's last, which carries the counters."""
        tracer = self.tracer
        if tracer is not None:
            if fit is None:
                tracer.stamp("fit_start", first=True)
                tracer.stamp("fit_end")
            else:
                tracer.stamp("finish_start")
        f = self._frame(kind)
        if fit is None:
            objects = self.stages.objects(self.state, f)
        else:
            objects = self.stages.objects_finish(fit, *self.uv)
        new, result, diag = self.stages.rest(self.state, f, objects)
        copy_into(self.state, new)
        if tracer is not None:
            tracer.stamp("render", counts=diag)
        return result, diag

    def _take(self, state: MapState) -> None:
        """Make ``state`` the map's: copied into the static tensors.  A state
        with a generator of its own (a restored one) also reseeds the
        stages' rank generator from it, as the eager sharded step does."""
        if state is self.state:
            return
        foreign = state.rng is not self.state.rng
        copy_into(self.state, state)
        if foreign and self.stages.rank_rng is not None:
            self.stages.rank_rng.reseed(self.state)

    def _put(self, kind: str, frame) -> None:
        """Copy a frame into the static input of ``kind``."""
        device = self.state.voxel_stamp.device
        if kind == "packed":
            src = _tensor(frame)
            if kind not in self.inputs:
                self.inputs[kind] = torch.empty(src.shape, dtype=src.dtype, device=device)
            _copy_checked(self.inputs[kind], src, "packed frame")
            return
        srcs = [_tensor(a) for a in frame]
        if kind not in self.inputs:
            self.inputs[kind] = FrameInput(*(torch.empty_like(t, device=device) for t in srcs))
        for name, dst, src in zip(FrameInput._fields, self.inputs[kind], srcs):
            _copy_checked(dst, src, name)

    def _frame(self, kind: str) -> FrameInput:
        x = self.inputs[kind]
        return self.unpack(x) if kind == "packed" else x


def _tensor(a) -> torch.Tensor:
    """A tensor as it is (on the host or the device); an array as a host
    tensor."""
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def _copy_checked(dst: torch.Tensor, src: torch.Tensor, name: str) -> None:
    if src.shape != dst.shape:
        raise ValueError(f"{name}: shape {tuple(src.shape)}, the map's step takes "
                         f"{tuple(dst.shape)}")
    dst.copy_(src)
