"""The frame step at fixed addresses, captured into a CUDA graph on the card:
the counterpart of the JAX package's ``jax.jit(step, donate_argnums=0)``
(``semantic_dsp_map_tpu/map.py:446-487``), one dispatch a frame where the
eager step issues some 2,300.

:class:`StaticStep` holds a map's step on tensors that keep their addresses
from frame to frame:

- **input**: a device ``int32`` buffer of ``pack_frame``'s length for
  ``update()`` (unpacked inside the step), one tensor per ``FrameInput``
  field for ``update_from_frame()``; each frame is copied into them, a
  synchronous copy, as the eager map's;
- **state**: the particle store and the voxel stamps are updated in place by
  the step; the object table, the scroll state, the global time and the
  previous frame time come out of it as new tensors and are copied back into
  the static ones as its last operations (the counterpart of donation).  The
  map's ``state`` always names the static tensors.  A state put in their
  place from outside (``clear()``, a restored checkpoint) is copied into
  them before the next frame, the generator's seed and offset included.
  A part of the state that a caller holds across a frame takes the new
  values;
- **output**: the RenderResult and StepDiagnostics of a replay live in the
  graph's memory and are cloned after each replay, so that a result the
  caller keeps survives the next frame, as a JAX array does.

On the card the first frame of each input kind runs eagerly (it loads the
kernel library, sets the kernels' shared-memory attributes and warms the
allocator); the second is captured with ``torch.cuda.graph`` and replayed;
every later frame is the input copy and one ``replay()``.  The map's
``torch.Generator`` is registered with the graph, so a replay draws from the
Philox offsets the eager step would have drawn from, in the same order.  A
capture or a replay that fails raises: there is no step back to eager.

The superpoint object layer refits its RANSAC hypotheses with a Kabsch fit
whose ``torch.linalg.svd`` reads cuSOLVER's convergence flags to the host, a
synchronization that capture refuses.  Where it runs
(:func:`objects_outside_graph`), the object layer (stage 0) runs eagerly
ahead of the graph on its own fields of the frame (``map.unpack_objects``)
and writes the static object table, and the graph holds stages 1-5.  Template mode reads its gate to the host every frame and the
sharded step talks to other ranks through NCCL: both stay eager
(``SemanticDSPMap`` and ``parallel/shard_step.py``).

On the CPU nothing is captured: the same static-state function runs eagerly.
The eager ``map.build_frame_step`` stays the oracle of this step.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
from typing import Callable

import numpy as np
import torch

from .config import KEYPOINTS_SUPERPOINT, MapConfig
from .frontend import FrameInput
from .ops import observe_cuda, phd_cuda, render_cuda
from .state import MapState

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


def objects_outside_graph(cfg: MapConfig) -> bool:
    """Whether the object layer runs ahead of the graph: with instances in
    superpoint mode, where the RANSAC refit calls ``torch.linalg.svd``."""
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


def _clone(outputs):
    return type(outputs)(*(t.clone() for t in outputs))


class _Graph:
    """One captured frame step and its outputs in the graph's memory."""

    def __init__(self, body: Callable, generator: torch.Generator):
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)
        before = [fn.launches for fn in FRAME_KERNELS]
        # Another map's graph destroyed during the capture (by the garbage
        # collector, at any allocation) would invalidate it: the dead go
        # first, and the collector waits until the capture ends.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph):
                self.outputs = body()
        except Exception as err:
            raise RuntimeError(f"capturing the frame step into a CUDA graph failed: {err}") from err
        finally:
            if collecting:
                gc.enable()
        self.launches = {fn.__name__: fn.launches - n for fn, n in zip(FRAME_KERNELS, before)}
        captured.update(self.launches)

    def replay(self):
        self.graph.replay()
        replayed.update(self.launches)
        return tuple(_clone(out) for out in self.outputs)


class StaticStep:
    """A map's frame step on static tensors.  ``stages`` is
    ``map.build_frame_stages``'s pair, ``unpack`` maps the packed buffer to a
    FrameInput on the device and ``unpack_objects`` to the part of it that
    the object layer reads (``map.unpack_objects``: used where the object
    layer runs ahead of the graph), ``state`` is the map's state, whose
    tensors become the static ones.  ``capture`` captures the step from each
    input kind's second frame on (the card); without it every frame runs
    eagerly."""

    def __init__(self, stages, unpack: Callable, unpack_objects: Callable, state: MapState,
                 capture: bool, objects_eager: bool):
        self.stages, self.unpack, self.unpack_objects = stages, unpack, unpack_objects
        self.state = state
        self.capture = capture
        self.objects_eager = objects_eager
        self.inputs = {}  # "packed": int32 buffer; "frame": FrameInput
        self.graphs = {}  # input kind -> _Graph
        self.frames = collections.Counter()

    def __call__(self, kind: str, host, state: MapState):
        """One frame from host data (``kind`` "packed": pack_frame's int32
        array; "frame": a FrameInput of host arrays) on ``state``, the map's
        state.  Returns (the static state, RenderResult, StepDiagnostics)."""
        self._take(state)
        self._put(kind, host)
        if self.objects_eager:
            # The object layer's fields only: the graph unpacks the rest.
            x = self.inputs[kind]
            f = self.unpack_objects(x) if kind == "packed" else x
            copy_into(self.state.objects, self.stages.objects(self.state, f))
        graph = self.graphs.get(kind)
        if graph is None and self.capture and self.frames[kind] > 0:
            graph = self.graphs[kind] = _Graph(lambda: self._body(kind), self.state.rng)
        self.frames[kind] += 1
        result, diag = self._body(kind) if graph is None else graph.replay()
        return self.state, result, diag

    def _body(self, kind: str):
        """Stages 1-5 (and the object layer, where it is captured) on the
        static tensors; ends by copying the new state into them."""
        f = self._frame(kind)
        objects = self.state.objects if self.objects_eager else self.stages.objects(self.state, f)
        new, result, diag = self.stages.rest(self.state, f, objects)
        copy_into(self.state, new)
        return result, diag

    def _take(self, state: MapState) -> None:
        """Make ``state`` the map's: copied into the static tensors."""
        if state is not self.state:
            copy_into(self.state, state)

    def _put(self, kind: str, host) -> None:
        """Copy a frame's host data into the static input of ``kind``."""
        device = self.state.voxel_stamp.device
        if kind == "packed":
            src = torch.from_numpy(host)
            if kind not in self.inputs:
                self.inputs[kind] = torch.empty(src.shape, dtype=src.dtype, device=device)
            _copy_checked(self.inputs[kind], src, "packed frame")
            return
        srcs = [torch.as_tensor(np.asarray(a)) for a in host]
        if kind not in self.inputs:
            self.inputs[kind] = FrameInput(*(torch.empty_like(t, device=device) for t in srcs))
        for name, dst, src in zip(FrameInput._fields, self.inputs[kind], srcs):
            _copy_checked(dst, src, name)

    def _frame(self, kind: str) -> FrameInput:
        x = self.inputs[kind]
        return self.unpack(x) if kind == "packed" else x


def _copy_checked(dst: torch.Tensor, src: torch.Tensor, name: str) -> None:
    if src.shape != dst.shape:
        raise ValueError(f"{name}: shape {tuple(src.shape)}, the map's step takes "
                         f"{tuple(dst.shape)}")
    dst.copy_(src)
