"""The analytic multi-view-consistent scene (``ConsistentScene``) and the
FF convergence script of the port, on the CPU:

  * ``render``, ``flow_between`` / ``flow``, ``held_out_cameras``,
    ``vv_c2w`` and the rig poses equal the JAX package's arrays;
  * ``write`` (monocular layout) and ``write_nvidia`` (the 12-camera
    round-robin rig) at 12 frames of 32×48 write the JAX writer's files:
    the same names, decoded PNGs equal (the port's PNG writer filters
    differently), JPEG bytes equal, every npy / npz equal;
  * ``scripts/port_ff_convergence.py --quick`` runs 2 coarse + 2 fine steps
    on the CPU, evaluates the held-out views, writes its JSON, renders and
    snapshots under ``--outdir`` only, and resumes.
"""

import importlib.util
import json
import os
import pathlib

import imageio.v2 as imageio
import numpy as np
import pytest

from dynibar_tpu.data import synthetic_scene as jscene
from dynibar_tpu_torch.data import png, synthetic_scene
from torch_port_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
FRAMES, H, W = 12, 32, 48


def _scenes():
  return (jscene.ConsistentScene(FRAMES, H, W),
          synthetic_scene.ConsistentScene(FRAMES, H, W))


def test_render_and_flows_equal_jax():
  want, got = _scenes()
  for i in (0, 5, 11):
    for a, b in zip(got.render(got.c2w(i), i + 0.25),
                    want.render(want.c2w(i), i + 0.25)):
      np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.vv_c2w(i), want.vv_c2w(i))
    np.testing.assert_array_equal(got.frame_c2w(i), want.frame_c2w(i))
  for i, off in ((4, 1), (4, -3), (10, 2)):
    for a, b in zip(got.flow(i, off), want.flow(i, off)):
      np.testing.assert_array_equal(a, b)
  for a, b in zip(got.flow_between(got.rig_c2w(2), got.rig_c2w(9), 3.0, 5.0),
                  want.flow_between(want.rig_c2w(2), want.rig_c2w(9), 3.0,
                                    5.0)):
    np.testing.assert_array_equal(a, b)
  for (c_got, t_got), (c_want, t_want) in zip(got.held_out_cameras(),
                                              want.held_out_cameras()):
    np.testing.assert_array_equal(c_got, c_want)
    assert t_got == t_want


def _files(root):
  return sorted(str(p.relative_to(root)) for p in pathlib.Path(root).rglob("*")
                if p.is_file())


@pytest.mark.parametrize("layout", ["write", "write_nvidia"])
def test_writers_match_jax(tmp_path, layout):
  want, got = _scenes()
  jroot, proot = tmp_path / "jax", tmp_path / "port"
  getattr(want, layout)(str(jroot), "s")
  getattr(got, layout)(str(proot), "s")
  names = _files(jroot)
  assert names == _files(proot)
  kinds = {os.path.splitext(n)[1] for n in names}
  assert kinds == ({".png", ".npy", ".npz", ".jpg"} if layout ==
                   "write_nvidia" else {".png", ".npy", ".npz"})
  for name in names:
    a, b = proot / name, jroot / name
    if name.endswith(".png"):
      np.testing.assert_array_equal(png.read(str(a)), imageio.imread(b),
                                    err_msg=name)
    elif name.endswith(".jpg"):
      assert a.read_bytes() == b.read_bytes(), name
    elif name.endswith(".npy"):
      np.testing.assert_array_equal(np.load(a), np.load(b), err_msg=name)
    else:
      with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
          np.testing.assert_array_equal(za[k], zb[k], err_msg=name)


def _script():
  spec = importlib.util.spec_from_file_location(
      "port_ff_convergence", ROOT / "scripts" / "port_ff_convergence.py")
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def test_convergence_script_quick(tmp_path):
  script = _script()
  argv = ["--quick", "--coarse_steps", "2", "--fine_steps", "2",
          "--eval_every", "2", "--height", "16", "--width", "24",
          "--n_rand", "64", "--outdir", str(tmp_path)]
  result = script.main(argv)
  assert result["device"] == "cpu"
  assert sorted(os.listdir(tmp_path)) == [
      "ckpt_ff_A", "ckpt_ff_B", "ff_convergence_ff.json", "renders_ff",
      "scene_24x16x24"]
  with open(tmp_path / "ff_convergence_ff.json") as fh:
    saved = json.load(fh)
  assert saved["gate_db"] == 5.0 and isinstance(saved["gate_passed"], bool)
  # phase A init and step 2, phase B init and step 2
  assert [(r["phase"], r["step"]) for r in saved["curve"]] == [
      ("A", 0), ("A", 2), ("B", 0), ("B", 2)]
  keys = [k for k in saved["final"] if k.startswith("psnr_")]
  assert len(keys) >= 4 and all(np.isfinite(saved["final"][k]) for k in keys)
  renders = os.listdir(tmp_path / "renders_ff")
  assert len([r for r in renders if r.endswith("_gt.png")]) == 2
  assert len(renders) == 2 + 2 * 4          # the fine render at each eval
  # resumed with both phases done: no step runs, the same gate figures
  again = script.main(argv + ["--resume"])
  assert again["s_per_step"] == {"A": None, "B": None}
  assert abs(again["fine_rise_db"] - result["fine_rise_db"]) <= 2e-3
  assert again["curve"] == saved["curve"]
