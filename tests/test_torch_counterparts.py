"""Function by function, the port does what the JAX package does.

Both packages' sources are parsed with ``ast`` (nothing is imported, so no
JAX is loaded): every public top-level name of each module of the JAX
package (a function, a class or a constant) must have a namesake in the
port's module of the same path, defined there or imported into it, or be
listed in ``NOT_PORTED`` with its reason.  Each listed name must still exist
in the JAX package and still lack a namesake in the port, and a "renamed"
entry names its counterpart, which must exist: the map stays true as either
package changes."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "semantic_dsp_map_tpu"
PORT_PKG = ROOT / "semantic_dsp_map_tpu_torch"

#: (module path in the JAX package, name) -> (reason, the port's counterpart
#: as "module path:name" for "renamed", else what stands in its place)
NOT_PORTED = {
    # the Pallas kernels' modules: the CUDA kernels' wrappers take their place
    ("ops/phd_pallas.py", "pass_a_pallas"): ("renamed", "ops/phd_cuda.py:pass_a_cuda"),
    ("ops/phd_pallas.py", "pass_b_pallas"): ("renamed", "ops/phd_cuda.py:pass_b_cuda"),
    ("ops/render_pallas.py", "render_core_pallas"): (
        "renamed", "ops/render_cuda.py:render_core_cuda"),
    ("ops/render_pallas.py", "render_occupancy_pallas"): ("renamed", "ops/render.py:render_any"),
    ("ops/render_pallas.py", "render_pallas_supported"): (
        "no torch analog", "the CUDA render takes every shape and every K (a generic instance "
        "past K = 31)"),
    ("ops/observe_pallas.py", "front_candidates"): (
        "renamed", "ops/observe_cuda.py:front_candidates_cuda"),
    ("ops/observe_pallas.py", "movable_voxels"): (
        "renamed", "ops/observe_cuda.py:movable_voxels_cuda"),
    ("ops/observe_pallas.py", "front_pallas_supported"): (
        "no torch analog", "the CUDA scan takes every shape and every K (a generic instance "
        "past K = 31)"),
    # the XLA render and its chunking
    ("ops/render.py", "render_core_xla"): ("renamed", "ops/render.py:render_core_plain"),
    ("ops/render.py", "render_occupancy_xla"): ("renamed", "ops/render.py:render_core_plain"),
    ("ops/render.py", "RENDER_CHUNK_VOXELS"): (
        "TPU workaround", "the chunked lax.map render: one pass over the store"),
    # block working sets
    ("ops/blocks.py", "mask_to_block_mask"): ("inlined", "at its callers in the port"),
    ("ops/blocks.py", "gather_rows"): ("dead", "no caller in the JAX package or its tests"),
    ("ops/blocks.py", "scatter_rows"): ("dead", "no caller in the JAX package or its tests"),
    ("ops/blocks.py", "slot_coords"): ("dead", "no caller in the JAX package or its tests"),
    # layout bitcasts of the flat store
    ("state.py", "particles_vk"): ("TPU workaround", "the flat <-> [V, K] layout bitcasts: views"),
    ("state.py", "particles_vk_sized"): ("TPU workaround", "the same, for a slab"),
    ("state.py", "particles_flat"): ("TPU workaround", "the same, back to flat"),
    # the multi-device step
    ("parallel/shard_step.py", "build_shard_map_step"): (
        "renamed", "parallel/shard_step.py:build_shard_step"),
    ("parallel/shard_step.py", "AXIS"): (
        "no torch analog", "the shard_map mesh axis: ranks are torch.distributed processes"),
    ("parallel/shard_step.py", "ici_bytes_per_frame"): ("dead", "no caller"),
    ("parallel/sharding.py", "make_mesh"): (
        "no torch analog", "the auto-SPMD step; parallel/shard_step.py supersedes it"),
    ("parallel/sharding.py", "state_shardings"): (
        "no torch analog", "the auto-SPMD step; parallel/shard_step.py supersedes it"),
    ("parallel/sharding.py", "build_sharded_step"): (
        "no torch analog", "the auto-SPMD step; parallel/shard_step.py supersedes it"),
    ("parallel/distributed.py", "global_mesh"): (
        "no torch analog", "the auto-SPMD step's mesh; parallel/shard_step.py supersedes it"),
    # the profiler's prefixes
    ("profiling.py", "build_prefix_step"): ("renamed", "map.py:build_frame_step"),
}
REASONS = {"renamed", "dead", "inlined", "no torch analog", "TPU workaround"}


def _names(path: Path, public: bool) -> set:
    """Top-level names a module defines (functions, classes, assignments),
    and with ``public`` False also those it imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif not public and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in out if not n.startswith("_")} if public else out


def _port_names(rel: str) -> set:
    path = PORT_PKG / rel
    return _names(path, public=False) if path.exists() else set()


MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("rel", MODULES)
def test_every_public_name_has_a_counterpart(rel):
    missing = sorted(_names(JAX_PKG / rel, public=True) - _port_names(rel)
                     - {name for (mod, name) in NOT_PORTED if mod == rel})
    assert not missing, f"{rel}: no counterpart in the port and not in NOT_PORTED: {missing}"


@pytest.mark.parametrize("key", sorted(NOT_PORTED))
def test_not_ported_entry_is_true(key):
    rel, name = key
    reason, detail = NOT_PORTED[key]
    assert reason in REASONS, reason
    assert name in _names(JAX_PKG / rel, public=True), f"{rel}:{name} is gone from the JAX package"
    assert name not in _port_names(rel), f"{rel}:{name} now has a namesake in the port"
    if reason == "renamed":
        mod, new = detail.split(":")
        assert new in _port_names(mod), f"the port lacks {detail}"


def test_the_last_functions_ported():
    """The functions the port gained last, by their JAX names."""
    want = {"ops/projection.py": {"VisibleSet"},
            "ops/phd.py": {"_rank_in_pixel", "build_pixel_table", "compute_ck_kappa",
                           "phd_weight_update"},
            "ops/birth.py": {"insert_particles", "_insert_core"},
            "objects.py": {"track_lookup_table"},
            "ops/geometry.py": {"point_in_frustum"}}
    for rel, names in want.items():
        assert names <= _port_names(rel), (rel, names - _port_names(rel))
