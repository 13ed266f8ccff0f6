"""The port's probe kernels' plain versions against the JAX package's TPU
probe kernels run in interpret mode, equal bytes; the wrappers on the CPU;
and the two probe modules at a small size.

The TPU kernels live in scripts that run at import
(benchmarks/prim_bench7.py:28 ``gather_kernel``, benchmarks/prim_bench1.py:63
``k_``), so their bodies are restated here word for word and launched with
``pl.pallas_call(..., interpret=True)`` over the same block structure.
"""

import inspect
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from semantic_dsp_map_tpu_torch.benchmarks import prim_bench1, prim_bench7
from semantic_dsp_map_tpu_torch.ops import cuda_lib
from semantic_dsp_map_tpu_torch.ops.probes import gather_plain, scale2_plain
from semantic_dsp_map_tpu_torch.ops.probes_cuda import gather_cuda, scale2_cuda

torch.set_num_threads(2)


def gather_kernel(depth_ref, rc_ref, out_ref):
    flat = rc_ref[:]                      # i32[BLK] row*W+col
    d = depth_ref[:].reshape(-1)          # f32[H*W]
    out_ref[:] = d[flat]


def k_(x_ref, o_ref):
    o_ref[:] = x_ref[:] * 2.0


@pytest.mark.parametrize("script, body", [
    ("prim_bench7.py", """def gather_kernel(depth_ref, rc_ref, out_ref):
    flat = rc_ref[:]                      # i32[BLK] row*W+col
    d = depth_ref[:].reshape(-1)          # f32[H*W]
    out_ref[:] = d[flat]
"""),
    ("prim_bench1.py", "def k_(x_ref, o_ref):\n    o_ref[:] = x_ref[:] * 2.0\n"),
])
def test_restated_kernels_are_the_scripts(script, body):
    """The kernel bodies above still stand in the JAX package's scripts,
    statement for statement (whitespace and comments aside)."""
    def statements(text):
        lines = (ln.split("#")[0].strip() for ln in text.splitlines())
        return [" ".join(ln.split()) for ln in lines if ln]

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "benchmarks", script)) as f:
        theirs = statements(f.read())
    mine = statements(body)
    starts = [i for i, ln in enumerate(theirs) if ln == mine[0]]
    assert any(theirs[i:i + len(mine)] == mine for i in starts), (script, mine)
    fn = {"prim_bench7.py": gather_kernel, "prim_bench1.py": k_}[script]
    assert statements(inspect.getsource(fn)) == mine


def _pallas_gather(depth, rc, blk):
    h, w = depth.shape
    n = rc.shape[0]
    return pl.pallas_call(
        gather_kernel,
        grid=(n // blk,),
        in_specs=[pl.BlockSpec((h, w), lambda i: (0, 0)), pl.BlockSpec((blk,), lambda i: (i,))],
        out_specs=pl.BlockSpec((blk,), lambda i: (i,)),
        out_shape=jax.ShapeDtypeStruct((n,), jnp.float32),
        interpret=True,
    )(depth, rc)


@pytest.mark.parametrize("h, w, n, blk", [(12, 16, 1024, 256), (24, 32, 4096, 512)])
def test_gather_plain_matches_jax_kernel(h, w, n, blk):
    rng = np.random.RandomState(h)
    depth = (1.0 + 29.0 * rng.rand(h, w)).astype(np.float32)
    rows = rng.randint(0, h, n).astype(np.int32)
    cols = rng.randint(0, w, n).astype(np.int32)
    rc = rows * w + cols
    want = np.asarray(_pallas_gather(depth, rc, blk))
    np.testing.assert_array_equal(want, np.asarray(jnp.asarray(depth).reshape(-1)[rc]))

    before = gather_cuda.launches
    for fn in (gather_plain, gather_cuda):
        got = fn(torch.from_numpy(depth), torch.from_numpy(rc)).numpy()
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), fn.__name__
    assert gather_cuda.launches == before  # no launch is counted on the CPU


def test_scale2_plain_matches_jax_kernel():
    rng = np.random.RandomState(2)
    x = rng.randn(8, 128).astype(np.float32)
    # signed zeros and infinities (no subnormal: XLA's CPU code flushes them)
    x[0, :4] = [0.0, -0.0, np.inf, -np.inf]
    want = np.asarray(pl.pallas_call(
        k_, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32), interpret=True)(x))
    before = scale2_cuda.launches
    for fn in (scale2_plain, scale2_cuda):
        got = fn(torch.from_numpy(x)).numpy()
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), fn.__name__
    assert scale2_cuda.launches == before


def test_probe_wrappers_check_their_arguments():
    depth = torch.zeros((4, 4))
    rc = torch.zeros(8, dtype=torch.int32)
    for fn in (gather_plain, gather_cuda):
        with pytest.raises(ValueError, match="rc"):
            fn(depth, rc.long())
        with pytest.raises(ValueError, match="rc"):
            fn(depth, rc.view(2, 4))
        with pytest.raises(ValueError, match="depth"):
            fn(depth.double(), rc)
    for fn in (scale2_plain, scale2_cuda):
        with pytest.raises(ValueError, match="x"):
            fn(depth.double())


@pytest.mark.parametrize("fault, message", [
    (lambda a: a.double(), "b: expected torch.float32, got torch.float64"),
    (lambda a: a[:3], "b: expected shape (4,), got (3,)"),
    (lambda a: a.view(2, 2), "b: expected shape (4,), got (2, 2)"),
    (lambda a: torch.stack([a, a], -1)[..., 0], "b: expected a contiguous tensor"),
])
def test_pointer_check_names_the_argument(fault, message):
    """The wrappers' one-pass check (``cuda_lib.pointers``) names the
    argument that is wrong and what is wrong with it, whichever of the
    tensors it is; tensors that pass give their data pointers.  On the CPU
    it runs with the CPU's device number, -1."""
    a = torch.arange(4.0)
    good = torch.zeros(4)
    assert cuda_lib.pointers(-1, torch.float32, (4,), (a, good), ("a", "b")) == [
        a.data_ptr(), good.data_ptr()]
    with pytest.raises(ValueError, match=re.escape(message)):
        cuda_lib.pointers(-1, torch.float32, (4,), (a, fault(a)), ("a", "b"))
    with pytest.raises(ValueError, match=re.escape(message.replace("b:", "a:"))):
        cuda_lib.pointers(-1, torch.float32, (4,), (fault(a), good), ("a", "b"))


def test_pointer_check_wants_the_card():
    """A CPU tensor handed to a kernel (device 0) is refused by name."""
    x = torch.zeros((2, 3))
    with pytest.raises(ValueError, match=re.escape("x: expected a CUDA tensor, got cpu")):
        cuda_lib.pointers(0, torch.float32, x.shape, (x,), ("x",))
    assert cuda_lib.pointers(-1, torch.float32, x.shape, (x,), ("x",)) == [x.data_ptr()]


@pytest.mark.parametrize("module, kwargs, n_rows", [
    (prim_bench1, dict(n_big=7 * 4096, n_tab=1000, p=512), 19),
    (prim_bench7, dict(h=12, w=16, n=1000), 4),
])
def test_probe_modules_run_small(module, kwargs, n_rows):
    """Every probe of the module runs (on the CPU, at a small size) and
    reports a time; the entry points default to the card."""
    rows = module.run("cpu", iters=2, **kwargs)
    assert len(rows) == n_rows
    assert len({r["name"] for r in rows}) == n_rows
    assert all(r["device_ms"] > 0 and r["enqueue_ms"] > 0 for r in rows)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            module.main([])
