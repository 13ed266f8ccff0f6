"""Nothing the benchmark runs loads JAX or the JAX package, and its
reference loads nothing of the port: module names compared by their
top-level name (the part before the first dot), whole."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent
JAX_SIDE = {"jax", "jaxlib", "flax", "semantic_dsp_map_tpu"}
PORT = "semantic_dsp_map_tpu_torch"


def loaded_after(code: str) -> set:
    """The top-level names in sys.modules of a fresh interpreter after
    ``code`` has run, from the repository's root."""
    probe = code + "\nimport json, sys\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True,
                         timeout=900, env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2",
                                           "HOME": str(REPO)})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_of_a_cell_loads_neither_jax_nor_the_jax_package():
    names = loaded_after(
        "import torch; torch.set_num_threads(2)\n"
        "from dspbench import harness, control, run\n"
        "from dspbench.tests.small import small_cell\n"
        "cell = small_cell('zed2.walk')\n"
        "out = harness.run_cell(cell, 3, 0.5, False, device='cpu')\n"
        "assert out['correct'], out\n"
        "for name, _ in cell.end_to_end + cell.per_layer: harness.reader(name)\n")
    assert PORT in names  # the run did drive the port
    assert not names & JAX_SIDE, sorted(names & JAX_SIDE)


def test_the_reference_loads_nothing_of_the_port():
    names = loaded_after(
        "import torch, numpy as np\n"
        "from dspbench.reference import Reference\n"
        "from dspbench import traffic\n"
        "from dspbench.tests.small import reduced_map_config\n"
        "import json\n"
        "cfg = json.load(open('dspbench/configs/zed2.json'))\n"
        "m = reduced_map_config(cfg, 'zed2')\n"
        "ref = Reference(m, cfg['filter_params'], 'cpu')\n"
        "ring = traffic.Ring(traffic.load('walk'), traffic.Camera.of(m), 1)\n"
        "st = ref.init_state(1)\n"
        "f = ring.frame(0)\n"
        "st, r, d = ref.frame(st, f.depth, f.masks, f.cam_pos, f.cam_quat, f.time)\n"
        "assert int((r.occ >= 0).sum()) > 0\n")
    assert PORT not in names and not names & JAX_SIDE


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def reference_sources() -> list:
    """The sources of ``dspbench/reference/`` and of every reference module
    a configuration of ``dspbench/configs/`` names (its ``reference``
    key): each ``.py`` file of a package, or the module's own file."""
    names = {"dspbench.reference"}
    for config in (ROOT / "configs").glob("*.json"):
        names.add(json.loads(config.read_text()).get("reference", "dspbench.reference"))
    paths = set()
    for name in names:
        where = REPO.joinpath(*name.split("."))
        paths |= set(where.rglob("*.py")) if where.is_dir() else {where.with_suffix(".py")}
    return sorted(paths)


@pytest.mark.parametrize("path", reference_sources(), ids=lambda p: p.name)
def test_no_reference_module_names_the_port_or_jax(path):
    assert not _imports(path) & (JAX_SIDE | {PORT})


@pytest.mark.parametrize("path", sorted(p for p in ROOT.rglob("*.py") if "tests" not in p.parts),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_benchmark_module_names_jax(path):
    assert not _imports(path) & JAX_SIDE
