"""The mono convergence run of the port against the JAX script
(``scripts/convergence_run.py``, loaded by path and not edited), on the
CPU:

  * ``final_camera`` and ``mono_eval_views`` equal the script's
    ``final_camera`` and ``make_eval_views`` (1e-6);
  * ``eval_mono`` against the script's ``eval_views`` on the same weights
    (JAX ``MonoModel.init_params``, the motion coefficients made nonzero,
    bridged through ``utils/convert.py``) on an 8-frame 16×24 scene at
    the script's ``--quick`` settings: each view's rgb within 2e-5 and
    every PSNR key within 1e-3 dB.  The JAX script renders once per
    module, one dict of the three views.  The train view is the middle
    frame's camera turned and moved a little: at a frame's own pose the
    writer's cameras (one rotation, translations along one axis) meet an
    f32 tie that either package breaks either way (ROADMAP.md queue 3),
    as the serving tests step around it;
  * ``scripts/port_mono_convergence.py --quick``: the JSON's keys, one
    ``schedule_events`` entry per divisor with its weights,
    ``model_no-vv`` written once at epoch ``init_decay_epoch * 5`` (not
    again by a resumed run that passes that epoch), and ``--resume``
    merging the earlier curve and continuing at the saved step;
  * the gate's arithmetic on hand-made curves (pass, fail, the quick
    run's train-view rule) and the exit code 1 of a failed gate.
"""

import importlib.util
import json
import os
import pathlib

import jax
import numpy as np
import pytest

from dynibar_tpu.config import DynibarConfig as JConfig
from dynibar_tpu.data.monocular import MonocularSceneData as JData
from dynibar_tpu.data.synthetic_scene import ConsistentScene as JScene
from dynibar_tpu.eval import metrics as jmetrics
from dynibar_tpu.models.dynibar import MonoModel as JMonoModel
from dynibar_tpu_torch.config import DynibarConfig
from dynibar_tpu_torch.data.monocular import MonocularSceneData
from dynibar_tpu_torch.data.synthetic_scene import ConsistentScene
from dynibar_tpu_torch.eval import held_out
from dynibar_tpu_torch.models.dynibar import MonoModel
from dynibar_tpu_torch.utils import convert
from torch_port_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
FRAMES, H, W = 8, 16, 24
# the JAX script's --quick configuration (scripts/convergence_run.py:82-88)
# with one 384-ray chunk per view
QUICK = dict(N_rand=32, N_samples=16, N_importance=0, num_source_views=4,
             num_vv=2, num_basis=4, max_range=8, init_decay_epoch=2,
             chunk_size=H * W, compute_dtype="float32", workers=2)


def _load(name, path):
  spec = importlib.util.spec_from_file_location(name, path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


@pytest.fixture(scope="module")
def jscript():
  return _load("convergence_run", ROOT / "scripts" / "convergence_run.py")


@pytest.fixture(scope="module")
def runner():
  return _load("port_mono_convergence",
               ROOT / "scripts" / "port_mono_convergence.py")


def _nudged(c2w):
  """The camera turned by 0.02 / -0.015 rad and moved by a few
  hundredths: off every pose the writer uses."""
  a, b = 0.02, -0.015
  rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]]) @ np.array(
                      [[1, 0, 0], [0, np.cos(b), -np.sin(b)],
                       [0, np.sin(b), np.cos(b)]])
  out = np.array(c2w, np.float64)
  out[:3, :3] = rot @ out[:3, :3]
  out[:3, 3] += [0.03, -0.02, 0.01]
  return out


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
  """The scene on disk (the port's writer, which writes the JAX writer's
  files) and both packages' scene, config and loader over it."""
  root = tmp_path_factory.mktemp("monoconv") / f"scene_{FRAMES}x{H}x{W}"
  scene = ConsistentScene(FRAMES, H, W)
  scene.write(str(root), "consistent")
  common = dict(folder_path=str(root), train_scenes=["consistent"],
                training_height=H, **QUICK)
  jconfig = JConfig(use_remat=False, fused_aggregators=False, **common)
  config = DynibarConfig(**common)
  jdata = JData(jconfig, "consistent")
  data = MonocularSceneData(config, "consistent")
  for c, d in ((jconfig, jdata), (config, data)):
    c.num_frames = d.num_frames
  return (JScene(FRAMES, H, W), jconfig, jdata), (scene, config, data)


def _recording(monkeypatch, module):
  """Record the rgb of each view's whole-frame PSNR (the first call per
  view, its mask all ones) through ``module.masked_psnr``."""
  frames = []
  real = module.masked_psnr

  def psnr(img1, img2, mask):
    if img1.shape == (H, W, 3) and np.all(mask == 1):
      frames.append(np.array(img1, np.float32))
    return real(img1, img2, mask)

  monkeypatch.setattr(module, "masked_psnr", psnr)
  return frames


@pytest.fixture(scope="module")
def evals(scenes, jscript):
  """Both packages' eval on the same weights and views: (views, JAX
  record, JAX rgb per view, port record, port rgb per view)."""
  (jscene, jconfig, jdata), (scene, config, data) = scenes
  jcfg = jconfig.render_settings("mono")
  jmodel = JMonoModel(cfg=jcfg, num_frames=FRAMES)
  params = jax.tree_util.tree_map(
      np.asarray, jax.jit(jmodel.init_params)(jax.random.PRNGKey(0)))
  # nonzero motion, so the dynamic branch's trajectories move
  k = params["motion_mlp"]["coeff_kernel"]
  params["motion_mlp"]["coeff_kernel"] = (
      np.random.RandomState(5).randn(*k.shape) * 0.1).astype(np.float32)
  model = MonoModel(config.render_settings("mono"), FRAMES, device="cpu")
  convert.load_jax_params(model, params)

  views = held_out.mono_eval_views(scene)
  pose, tau = views.pop("train_view")
  views["train_view"] = (_nudged(pose), tau)
  with pytest.MonkeyPatch.context() as mp:
    jrgb = _recording(mp, jmetrics)
    want = jscript.eval_views(jmodel, params, jscene, jdata, jcfg, jconfig,
                              views)
  with pytest.MonkeyPatch.context() as mp:
    rgb = _recording(mp, held_out)
    got = held_out.eval_mono(model, data, scene, config.render_settings(
        "mono"), config.chunk_size, views)
  return (list(views), want, dict(zip(views, jrgb)), got,
          dict(zip(views, rgb)))


def test_views_and_final_camera_equal_jax(scenes, jscript):
  (jscene, _, jdata), (scene, _, data) = scenes
  want = jscript.make_eval_views(jscene)
  got = held_out.mono_eval_views(scene)
  assert list(got) == list(want) == ["train_view", "novel_0", "novel_1"]
  for name in want:
    np.testing.assert_allclose(got[name][0], want[name][0], atol=1e-6,
                               rtol=0)
    assert got[name][1] == want[name][1]
    for pose in (want[name][0], _nudged(want[name][0])):
      np.testing.assert_allclose(
          held_out.final_camera(scene, data, pose),
          jscript.final_camera(jscene, jdata, pose), atol=1e-6, rtol=0)


@pytest.mark.parametrize("view", ["novel_0", "novel_1", "train_view"])
def test_eval_mono_rgb_matches_jax(evals, view):
  names, _, jrgb, _, rgb = evals
  assert len(jrgb) == len(rgb) == len(names)
  assert np.isfinite(rgb[view]).all() and rgb[view].std() > 0
  np.testing.assert_allclose(rgb[view], jrgb[view], atol=2e-5, rtol=0)


def test_eval_mono_psnr_keys_match_jax(evals):
  names, want, _, got, _ = evals
  assert sorted(got) == sorted(want)
  for view in names:
    assert {f"psnr_{view}", f"psnr_{view}_crop3"} <= set(got)
  assert any(k.endswith("_dyn") for k in got)     # the disc is in view
  for k, v in want.items():
    assert abs(got[k] - v) <= 1e-3, (k, got[k], v)


# ---- the runner: --quick ----

# an 8x12 scene of 8 frames; init_decay_epoch 1: no bootstrap epoch, a
# divisor per epoch of 8 steps, model_no-vv at the start of epoch 5
# (after step 40)
QUICK_HW = (8, 12)
QUICK_ARGV = ["--quick", "--frames", str(FRAMES), "--height",
              str(QUICK_HW[0]), "--width", str(QUICK_HW[1]), "--n_rand", "8",
              "--init_decay_epoch", "1"]
NO_VV_STEP = 5 * FRAMES


@pytest.fixture(scope="module")
def quick_runs(runner, tmp_path_factory):
  """Run 1: 44 steps, an eval every 40.  Then the step-44 snapshot is
  taken away (a run cut after its step-40 eval) and run 2 resumes from
  step 40 to 48, passing model_no-vv's epoch start again."""
  outdir = tmp_path_factory.mktemp("quick")
  argv = QUICK_ARGV + ["--outdir", str(outdir), "--eval_every", "40"]
  first = runner.main(argv + ["--steps", "44"])
  ckpt = outdir / "ckpt_default"
  no_vv = ckpt / f"model_no-vv_{NO_VV_STEP:08d}.pt"
  no_vv_mtime = no_vv.stat().st_mtime_ns
  os.remove(ckpt / "model_00000044.pt")
  with open(outdir / "mono_convergence_default.json") as fh:
    saved = json.load(fh)
  second = runner.main(argv + ["--steps", "48", "--resume"])
  return outdir, first, saved, second, no_vv, no_vv_mtime


def test_quick_json_and_outputs(quick_runs):
  outdir, first, saved, _, _, _ = quick_runs
  assert saved == json.loads(json.dumps(first))
  for key in ("tag", "device", "steps", "config", "sec_per_step_mean",
              "final", "init", "novel_psnr_rise_db", "train_view_rise_db",
              "loss_drop", "gate_passed", "schedule_events",
              "no_vv_snapshot", "gate_db", "curve", "full_losses"):
    assert key in first, key
  assert first["device"] == "cpu" and first["gate_db"] == 8.0
  assert first["config"]["routes"] == ["pallas_split", "pallas_split"]
  assert [r["step"] for r in first["curve"]] == [0, 40, 44]
  assert len(first["full_losses"]) == 44
  assert np.isfinite(first["full_losses"]).all()
  for k in ("psnr_novel_0_crop3", "psnr_novel_1_crop3",
            "psnr_train_view_crop3"):
    assert np.isfinite(first["final"][k])
  assert sorted(os.listdir(outdir)) == [
      "ckpt_default", "mono_convergence_default.json", "renders_default",
      f"scene_{FRAMES}x{QUICK_HW[0]}x{QUICK_HW[1]}"]
  renders = os.listdir(outdir / "renders_default")
  assert len([r for r in renders if r.endswith("_gt.png")]) == 3
  # three views at steps 0, 40, 44 and (run 2) 48
  assert len(renders) == 3 + 3 * 4


def test_quick_schedule_events(quick_runs):
  _, first, _, second, _, _ = quick_runs
  events = first["schedule_events"]
  assert [e["divisor"] for e in events] == list(range(6))
  assert [e["step"] for e in events] == [1 + FRAMES * d for d in range(6)]
  for e in events:
    d = e["divisor"]
    assert e["epoch"] == d
    np.testing.assert_allclose([e["w_disp"], e["w_flow"],
                                e["dynamic_rgb_decay"]],
                               [5e-2 / 10 ** d, 5e-3 / 10 ** d, 10.0 ** -d])
    assert e["use_dynamic_mask_rgb"] == (1.0 if d < 1 else 0.0)
    assert e["suppress_dynamic"] == (1.0 if d > 4 else 0.0)
  # the resumed run keeps the earlier events and adds none twice
  assert second["schedule_events"] == events


def test_quick_no_vv_written_once(quick_runs):
  _, first, _, second, no_vv, mtime = quick_runs
  assert first["no_vv_written_at"] == NO_VV_STEP
  assert first["no_vv_snapshot"] == no_vv.name
  # run 2 passed the start of epoch 5 again and kept the snapshot
  assert second["start_step"] == 40 < NO_VV_STEP + 1
  assert second["no_vv_written_at"] is None
  assert second["no_vv_snapshot"] == no_vv.name
  assert no_vv.stat().st_mtime_ns == mtime
  assert [p.name for p in no_vv.parent.glob("model_no-vv_*")] == [no_vv.name]


def test_quick_resume_merges_the_curve(quick_runs):
  outdir, first, _, second, _, _ = quick_runs
  assert second["start_step"] == 40
  assert [r["step"] for r in second["curve"]] == [0, 40, 48]
  assert second["curve"][:2] == first["curve"][:2]
  assert second["init"] == first["init"]
  assert len(second["full_losses"]) == 8
  assert sorted(p.name for p in (outdir / "ckpt_default").glob("model_0*")
                ) == ["model_00000040.pt", "model_00000048.pt"]
  with open(outdir / "mono_convergence_default.json") as fh:
    assert json.load(fh)["curve"] == second["curve"]


# ---- the gate ----

def _curve(train, novel0, novel1):
  return [{"step": 0, "psnr_train_view_crop3": 10.0,
           "psnr_novel_0_crop3": 11.0, "psnr_novel_1_crop3": 12.0,
           "psnr_novel_0": 9.0, "psnr_novel_0_dyn": 1.0},
          {"step": 300, "psnr_train_view_crop3": train,
           "psnr_novel_0_crop3": novel0, "psnr_novel_1_crop3": novel1,
           "psnr_novel_0": 40.0, "psnr_novel_0_dyn": 40.0}]


@pytest.mark.parametrize("novel0,novel1,passed", [
    (19.5, 20.0, True), (19.0, 20.5, True), (18.9, 30.0, False),
    (30.0, 19.9, False)])
def test_gate_on_hand_made_curves(runner, novel0, novel1, passed):
  """The minimum over the novel views' crop-3% rise against 8 dB; the
  whole-frame and disc keys do not count."""
  fig = runner.gate(_curve(25.0, novel0, novel1), [3.0, 2.0], 8.0, False)
  assert fig["novel_psnr_rise_db"] == round(min(novel0 - 11.0,
                                                novel1 - 12.0), 3)
  assert fig["train_view_rise_db"] == 15.0
  assert fig["loss_drop"] == 1.0
  assert fig["gate_passed"] is passed


def test_quick_gate_reads_the_train_view_and_the_loss(runner):
  falling, rising = [4.0, 3.0, 2.0, 1.0], [1.0, 2.0, 3.0, 4.0]
  assert runner.gate(_curve(19.0, 11.0, 12.0), falling, 8.0,
                     True)["gate_passed"]
  assert not runner.gate(_curve(19.0, 11.0, 12.0), rising, 8.0,
                         True)["gate_passed"]
  assert not runner.gate(_curve(17.0, 30.0, 30.0), falling, 8.0,
                         True)["gate_passed"]
  assert runner.gate(_curve(17.0, 30.0, 30.0), [], 8.0, False)["loss_drop"] \
      is None


def test_failed_gate_exits_1(runner, capsys):
  failed = dict(runner.gate(_curve(25.0, 12.0, 30.0), [], 8.0, False),
                gate_db=8.0)
  with pytest.raises(SystemExit) as exc:
    runner.enforce_gate(failed, quick=False)
  assert exc.value.code == 1
  assert "GATE FAILED" in capsys.readouterr().err
  runner.enforce_gate(failed, quick=True)           # reported only
  runner.enforce_gate(dict(failed, gate_passed=True), quick=False)


def test_runner_needs_cuda_unless_cpu(runner, tmp_path):
  import torch
  if torch.cuda.is_available():
    pytest.skip("this host has CUDA")
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    runner.main(["--outdir", str(tmp_path), "--steps", "0"])
