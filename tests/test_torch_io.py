"""The port's host IO against the JAX package: PCD/PLY round trips and
writer bytes, the template bank read from data/templates, the checkpoint
round trip, and a JAX npz checkpoint's leaves converted into a port
state."""

import json
import sys

import jax
import numpy as np
import pytest
import torch

import semantic_dsp_map_tpu as J
from semantic_dsp_map_tpu import io as jio
from semantic_dsp_map_tpu.checkpoint import save_checkpoint as j_save
from semantic_dsp_map_tpu.ops import templates as jtm

import semantic_dsp_map_tpu_torch as T
from semantic_dsp_map_tpu_torch import io as tio
from semantic_dsp_map_tpu_torch.checkpoint import (
    jax_leaves_to_numpy,
    load_checkpoint,
    save_checkpoint,
)
from semantic_dsp_map_tpu_torch.ops import templates as ttm
from semantic_dsp_map_tpu_torch.state import map_state_from_numpy, map_state_to_numpy

from torch_parity import dynamic_scene, jax_state_to_numpy

torch.set_num_threads(2)

TEMPLATES = "data/templates"


def _cloud(seed=0, n=100):
    rng = np.random.RandomState(seed)
    return rng.randn(n, 3).astype(np.float32), (rng.rand(n, 3) * 255).astype(np.uint8)


def test_pcd_ply_roundtrip(tmp_path):
    xyz, rgb = _cloud()
    tio.write_pcd(str(tmp_path / "a.pcd"), xyz, rgb)
    np.testing.assert_allclose(tio.read_pcd(str(tmp_path / "a.pcd")), xyz, rtol=1e-6)
    tio.write_pcd(str(tmp_path / "b.pcd"), xyz, binary=False)
    np.testing.assert_allclose(tio.read_pcd(str(tmp_path / "b.pcd")), xyz, atol=1e-5)
    tio.write_ply(str(tmp_path / "c.ply"), xyz, rgb)
    bx, brgb = tio.read_ply(str(tmp_path / "c.ply"))
    np.testing.assert_allclose(bx, xyz, rtol=1e-6)
    np.testing.assert_array_equal(brgb, rgb)
    tio.write_ply(str(tmp_path / "d.ply"), xyz)
    bx, brgb = tio.read_ply(str(tmp_path / "d.ply"))
    np.testing.assert_array_equal(bx, xyz)
    assert brgb is None


@pytest.mark.parametrize(
    "writer,kw",
    [("write_pcd", dict(binary=True)), ("write_pcd", dict(binary=False)), ("write_ply", {})],
)
@pytest.mark.parametrize("with_rgb", [False, True])
def test_writers_bytes_equal_jax(tmp_path, writer, kw, with_rgb):
    xyz, rgb = _cloud(1)
    rgb = rgb if with_rgb else None
    getattr(jio, writer)(str(tmp_path / "j.out"), xyz, rgb, **kw)
    getattr(tio, writer)(str(tmp_path / "t.out"), xyz, rgb, **kw)
    assert (tmp_path / "t.out").read_bytes() == (tmp_path / "j.out").read_bytes()


def test_read_committed_template_equal_jax():
    paths = tio.find_files_with_extension(TEMPLATES, ".pcd")
    assert paths == jio.find_files_with_extension(TEMPLATES, ".pcd") and paths
    for p in paths:
        np.testing.assert_array_equal(tio.read_pcd(p), jio.read_pcd(p))
    t, j = tio.read_template_folder(TEMPLATES), jio.read_template_folder(TEMPLATES)
    assert t.keys() == j.keys() == {14}


@pytest.mark.parametrize("max_points", [4096, 512])
def test_template_bank_from_folder_equal_jax(max_points):
    jb = jtm.TemplateBank.from_folder(TEMPLATES, jtm.MatchGridConfig(max_template_points=max_points))
    tb = ttm.TemplateBank.from_folder(TEMPLATES, ttm.MatchGridConfig(max_template_points=max_points))
    for name in ("pts", "valid", "label"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name), err_msg=name)
    assert tb.label.tolist() == [14]
    assert tb.valid[0].sum() == min(max_points, 1760)
    pts, valid = tb.of_label(14)
    live = pts[0][valid[0]]
    np.testing.assert_allclose(live.min(0) + live.max(0), 0, atol=1e-5)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

#: Depth noise with 3 jittered copies: the continuation draws from the
#: restored generator.
CKPT_PARAMS = dict(if_consider_depth_noise=True, nb_ptc_num_per_point=3,
                   depth_noise_model_zero_order=0.2, prediction_stddev=0.05)


def test_checkpoint_roundtrip(tmp_path):
    cfg = T.tiny_test_config()
    dsp = T.SemanticDSPMap(cfg, T.FilterParams(**CKPT_PARAMS), seed=4, device="cpu")
    for t in range(3):
        dsp.update(*dynamic_scene(cfg, t, T.MaskKpts))
    save_checkpoint(str(tmp_path / "ck"), dsp.state, step=3)
    assert json.loads((tmp_path / "ck" / "meta.json").read_text())["step"] == 3

    dsp2 = T.SemanticDSPMap(cfg, T.FilterParams(**CKPT_PARAMS), seed=9, device="cpu")
    dsp2.state = load_checkpoint(str(tmp_path / "ck"), cfg, device="cpu")
    dsp2._time_origin = dsp._time_origin
    a, b = map_state_to_numpy(dsp.state), map_state_to_numpy(dsp2.state)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)

    # Identical continuation, generator included.
    ra, da = dsp.update(*dynamic_scene(cfg, 3, T.MaskKpts))
    rb, db = dsp2.update(*dynamic_scene(cfg, 3, T.MaskKpts))
    assert int(da.born_count) > 0
    for name in ("occ", "label", "track", "weight_sum"):
        assert torch.equal(getattr(ra, name), getattr(rb, name)), name
    np.testing.assert_array_equal(dsp2.state.particles.px.numpy(), dsp.state.particles.px.numpy())

    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(str(tmp_path / "ck"), T.tiny_test_config(voxel_num_axis_z_n=5), device="cpu")


def test_jax_checkpoint_converts(tmp_path, monkeypatch):
    """A JAX npz checkpoint's leaves convert into a port state leaf for
    leaf, and the port continues the JAX run as the JAX map does; a JAX
    checkpoint given to load_checkpoint is refused."""
    cfg_j = J.config.tiny_test_config()
    params = dict(if_consider_depth_noise=True, nb_ptc_num_per_point=1,
                  depth_noise_model_zero_order=0.2, prediction_stddev=0.0)
    jm = J.SemanticDSPMap(cfg_j, J.FilterParams(**params))
    for t in range(3):
        jm.update(*dynamic_scene(cfg_j, t, J.MaskKpts))
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)  # the npz fallback
    j_save(str(tmp_path / "jck"), jm.state, step=3)
    meta = json.loads((tmp_path / "jck" / "meta.json").read_text())
    assert meta["format"] == "npz"

    with np.load(tmp_path / "jck" / "state.npz") as z:
        leaves = [z[f"leaf_{i}"] for i in range(meta["num_leaves"])]
    ts = map_state_from_numpy(jax_leaves_to_numpy(leaves), device="cpu")
    want = jax_state_to_numpy(jm.state)
    got = map_state_to_numpy(ts)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k].astype(got[k].dtype), err_msg=k)
    conv = jax_leaves_to_numpy([np.asarray(x) for x in jax.tree_util.tree_leaves(jm.state)])
    assert conv.keys() == want.keys()

    tm = T.SemanticDSPMap(T.tiny_test_config(), T.FilterParams(**params), device="cpu")
    tm.state, tm._time_origin = ts, jm._time_origin
    jr, jd = jm.update(*dynamic_scene(cfg_j, 3, J.MaskKpts))
    tr, td = tm.update(*dynamic_scene(tm.cfg, 3, T.MaskKpts))
    assert {k: int(v) for k, v in td._asdict().items()} == {k: int(v) for k, v in jd._asdict().items()}
    np.testing.assert_array_equal(tr.occ.numpy(), np.asarray(jr.occ))

    with pytest.raises(ValueError, match="jax_leaves_to_numpy"):
        load_checkpoint(str(tmp_path / "jck"), T.tiny_test_config(), device="cpu")
