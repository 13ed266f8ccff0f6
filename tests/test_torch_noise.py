"""The port's stochastic paths, checked statistically as
tests/test_noise_paths.py checks the JAX package's (same scenes, same
bounds): jittered birth at nb_ptc_num_per_point=3 and the rigid-move jitter
at prediction_stddev=0.1.  Each pools >= 400 samples, so the 15 % std and
4-sigma mean bounds leave > 3x headroom while catching noise wired with the
wrong scale.  Plus: importing every module of the port loads no JAX."""

import os
import subprocess
import sys

import numpy as np
import torch

import semantic_dsp_map_tpu_torch as T
from semantic_dsp_map_tpu_torch.map import _move_and_cleanup
from semantic_dsp_map_tpu_torch.ops import codecs
from semantic_dsp_map_tpu_torch.state import STATUS_REGULAR_BORN, init_map_state, make_generator

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_jittered_birth_distribution():
    """nb_ptc_num_per_point=3 births spread as N(surface, sigma^2) per axis
    (the wall 4 sigma inside the map; a sparse dot grid of valid pixels and
    K = 7, so slot capacity never binds)."""
    cfg = T.tiny_test_config(max_particle_num_per_voxel_n=3)
    sigma = 0.2
    params = T.FilterParams(if_consider_depth_noise=True, nb_ptc_num_per_point=3,
                            depth_noise_model_zero_order=sigma, depth_noise_model_first_order=0.0)
    wall_z = 1.1234
    H, W = cfg.height, cfg.width
    zs, xs = [], []
    for seed in range(6):
        dsp = T.SemanticDSPMap(cfg, params, seed=seed, device="cpu")
        depth = np.zeros((H, W), np.float32)  # 0 < depth_range_min: invalid
        depth[::4, ::4] = wall_z
        masks = [T.MaskKpts(track_id=65535, label="static", mask=np.full((H, W), 6, np.uint8))]
        dsp.update(depth, masks, np.zeros(3, np.float32), np.array([1, 0, 0, 0], np.float32), 0.0)
        p = dsp.state.particles
        born = (p.status == STATUS_REGULAR_BORN).numpy()
        zs.append(p.pz.numpy()[born])
        xs.append(p.px.numpy()[born])
    z = np.concatenate(zs)
    assert z.size >= 400, z.size
    assert abs(z.mean() - wall_z) < 4 * sigma / np.sqrt(z.size)
    assert abs(z.std() - sigma) / sigma < 0.15
    # x is jittered too: backprojected spread plus jitter exceeds sigma.
    assert np.concatenate(xs).std() > sigma


def test_move_prediction_jitter_distribution():
    """Rigid moves add N(0, prediction_stddev^2) per axis: a lattice of
    track-3 particles (spacing 0.8 >> 4 stddev) is moved by a pure
    translation; residuals to the nearest translated lattice point."""
    cfg = T.tiny_test_config()
    stddev = 0.1
    params = T.FilterParams(prediction_stddev=stddev)
    max_movable = T.LabelRegistry.default().max_movable_instance_id
    shift = np.array([0.35113, 0.0, 0.25071], np.float32)
    grid = np.arange(-1.2, 1.21, 0.8, dtype=np.float32)
    gx, gy, gz = np.meshgrid(grid, grid * 0.5, grid + 0.2)
    pos = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], -1)
    K = cfg.slots_per_voxel

    res = []
    for seed in range(8):
        state = init_map_state(cfg, seed=seed, device="cpu")
        p = state.particles
        vox, _, _, _, ok = codecs.global_pos_to_voxel(cfg, state.scroll, torch.from_numpy(pos))
        slot = vox[ok].long() * K  # slot 0 of the voxel (lattice: no collisions)
        for field, val in ((p.px, pos[ok.numpy(), 0]), (p.py, pos[ok.numpy(), 1]),
                           (p.pz, pos[ok.numpy(), 2])):
            field[slot] = torch.from_numpy(val)
        p.status[slot] = STATUS_REGULAR_BORN
        p.track[slot] = 3
        p.weight[slot] = 0.4
        p.stamp[slot] = 1
        o = state.objects
        Tm = torch.eye(4)
        Tm[:3, 3] = torch.from_numpy(shift)
        for name, val in (("valid", True), ("track_id", 3), ("moving", True),
                          ("has_moved_record", True), ("has_tmatrix", True),
                          ("tmatrix", Tm), ("last_obs_step", 2)):
            getattr(o, name)[0] = val
        particles, moved, _ovf = _move_and_cleanup(
            cfg, params, p, state.scroll, o, make_generator(100 + seed, "cpu"), max_movable)
        assert int(moved) > 40

        vax = codecs.axis_stamps_per_voxel(cfg, state.scroll).numpy()
        alive = (particles.status.numpy() != 0) & (particles.stamp.numpy() >= np.repeat(vax, K))
        sel = alive & (particles.track.numpy() == 3)
        new = np.stack([particles.px.numpy()[sel], particles.py.numpy()[sel],
                        particles.pz.numpy()[sel]], -1)
        tgt = pos[None, :, :] + shift[None, None, :]
        j = np.argmin(np.linalg.norm(new[:, None, :] - tgt, axis=-1), axis=1)
        res.append(new - (pos[j] + shift))
    r = np.concatenate(res)
    assert r.shape[0] >= 400, r.shape
    for axis in range(3):
        assert abs(r[:, axis].mean()) < 4 * stddev / np.sqrt(r.shape[0])
        assert abs(r[:, axis].std() - stddev) / stddev < 0.15


def test_port_imports_no_jax():
    """Every module of the port, the template path, the replay entry
    points, the tools and the probes included, imports without loading JAX or
    the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import semantic_dsp_map_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert 'semantic_dsp_map_tpu_torch.template_engine' in sys.modules\n"
        "assert 'semantic_dsp_map_tpu_torch.ops.templates' in sys.modules\n"
        "for n in ('datasets', 'replay', 'profiling', 'timing', 'tools.soak', 'ops.probes',\n"
        "          'ops.probes_cuda', 'benchmarks.prim_bench1', 'benchmarks.prim_bench7',\n"
        "          'benchmarks.scenes', 'benchmarks.bench', 'tools.make_replay_sequence'):\n"
        "    assert 'semantic_dsp_map_tpu_torch.' + n in sys.modules, n\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'semantic_dsp_map_tpu', 'bench'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 39
