"""semantic_dsp_map_tpu_torch — the PyTorch/CUDA port of the semantic DSP map.

It mirrors the module layout of the JAX package ``semantic_dsp_map_tpu``
(the reference implementation) and imports neither JAX nor that package.
The TPU's Pallas kernels on the main path are hand-written CUDA kernels
here (``csrc/``, bound in ``ops/phd_cuda.py``, ``ops/render_cuda.py`` and
``ops/observe_cuda.py``), and so are the two probe kernels of its benchmarks
(``ops/probes_cuda.py``); on CPU tensors every op runs its plain PyTorch
version.  The card is the default device: ``device=None`` means ``cuda``
and raises where there is none; the CPU is asked for by name
(``state.resolve_device``).

Key entry points:
  - ``MapConfig`` / presets: static configuration
  - ``MapState``: the map state as dataclasses of tensors
  - ``SemanticDSPMap``: the map engine (``update`` per frame)
  - ``python -m semantic_dsp_map_tpu_torch.replay`` / ``.profiling`` /
    ``.tools.soak`` / ``.benchmarks.prim_bench1`` / ``.benchmarks.prim_bench7``
"""

from .config import (
    FilterParams,
    MapConfig,
    coda_config,
    kitti360_config,
    tiny_test_config,
    virtual_kitti2_config,
    zed2_config,
)
from .frontend import FrameInput, MaskKpts, rasterize_masks
from .labels import LabelRegistry
from .map import SemanticDSPMap, StepDiagnostics
from .state import MapState, ObjectTable, init_map_state

__version__ = "0.1.0"

__all__ = [
    "FilterParams",
    "MapConfig",
    "coda_config",
    "kitti360_config",
    "tiny_test_config",
    "virtual_kitti2_config",
    "zed2_config",
    "FrameInput",
    "MaskKpts",
    "rasterize_masks",
    "LabelRegistry",
    "SemanticDSPMap",
    "StepDiagnostics",
    "MapState",
    "ObjectTable",
    "init_map_state",
]
