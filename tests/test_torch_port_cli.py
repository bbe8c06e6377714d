"""The port's training CLI (``dynibar_tpu_torch.cli.train``) on the CPU.

  * it runs both phases from an on-disk scene (``--device cpu``), writes
    ``model_<digits>`` snapshots, scalars, per-phase timing records and
    image panels, and a second run resumes at the saved step with the
    saved parameters (recorded as the model loads them), passing over a
    ``model_no-vv`` snapshot that sorts after it;
  * its ``model_no-vv`` snapshot is written once per experiment folder:
    the JAX CLI writes it again when a resume reaches that epoch
    (dynibar_tpu/cli/train.py:210), google/dynibar guards it
    (train.py:503-506).  Both CLIs run the same schedule with their
    train steps replaced by a no-op, so the test is about the loops;
  * a mesh larger than one card raises outside a launcher (torchrun);
    without ``--device cpu`` a host with no CUDA raises.
Scenes: 7 frames of 16×24, the size where every step count is small.
"""

import json
import os
import sys

import jax.numpy as jnp
import pytest
import torch

from dynibar_tpu.cli import train as jtrain
from dynibar_tpu.data import synthetic_scene as jscene
from dynibar_tpu_torch.cli import train
from dynibar_tpu_torch.data import png, synthetic_scene
from dynibar_tpu_torch.models.dynibar import MonoModel
from dynibar_tpu_torch.utils import checkpoints as ckpt

FRAMES = 7


def _args(root, **kw):
  base = dict(folder_path=root, train_scenes="s", rootdir=root,
              training_height=16, N_rand=8, N_samples=8, num_source_views=2,
              num_vv=1, init_decay_epoch=2, n_iters=0, i_img=10,
              i_weights=7, i_print=5, workers=1, chunk_size=96)
  base.update(kw)
  out = []
  for k, v in base.items():
    out += [f"--{k}", str(v)]
  return out


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
  root = str(tmp_path_factory.mktemp("cli"))
  synthetic_scene.write_synthetic_scene(root, "s", num_frames=FRAMES,
                                        height=16, width=24)
  return root


def _phases(logs):
  """The metrics log's scalar records and its phase records, in order."""
  with open(os.path.join(logs, "metrics.jsonl")) as fh:
    recs = [json.loads(line) for line in fh]
  phases = [(k.split("/")[1], r) for r in recs for k in r
            if k.startswith("phase/") and k.endswith("/steps")]
  return recs, phases


def test_cli_trains_both_phases_and_resumes(scene_root, tmp_path,
                                            monkeypatch):
  root = str(tmp_path)
  os.symlink(os.path.join(scene_root, "s"), os.path.join(root, "s"))
  # n_iters counts from the start step, bootstrap steps included: 7 < 8
  # runs one phase-2 epoch
  first = train.main(["--device", "cpu"] + _args(root, n_iters=7))
  assert first["start_step"] == 0
  out = first["out_folder"]
  assert sorted(os.listdir(out)) == ["args.json", "model_00000014.pt"]
  with open(os.path.join(out, "args.json")) as fh:
    assert json.load(fh)["num_frames"] == FRAMES
  logs = os.path.join(root, "logs", os.path.basename(out))
  recs, phases = _phases(logs)
  # scalars at 5 and 10, a phase record at each phase's end (7, 14)
  assert [r["step"] for r in recs] == [5, 7, 10, 14]
  assert "bootstrap/loss" in recs[0] and "train/psnr" in recs[2]
  (b_name, boot), (t_name, tr) = phases
  assert (b_name, boot["phase/bootstrap/steps"]) == ("bootstrap", FRAMES)
  assert (t_name, tr["phase/train/steps"]) == ("train", FRAMES)  # an epoch
  assert tr["phase/train/panels"] == 1 and tr["phase/train/panel_s"] > 0
  assert boot["phase/bootstrap/wait_s"] >= 0
  panels = sorted(os.listdir(os.path.join(logs, "images")))
  assert len(panels) == 22 and all(p.startswith("00000010_train_")
                                   for p in panels)
  assert sum("_rd_flow_" in p for p in panels) == 6
  for name in ("render_rgb_coarse_ref", "occ_weight_map"):
    img = png.read(os.path.join(logs, "images", f"00000010_train_{name}.png"))
    assert img.shape == (16, 24, 3)

  # a no-vv snapshot whose step sorts after every model_ snapshot
  saved = ckpt.load_checkpoint(os.path.join(out, "model_00000014.pt"))
  ckpt.save_checkpoint(out, 99, saved["model"], name="model_no-vv")
  loaded = {}
  load = MonoModel.load_state_dict

  def recording_load(self, state, *a, **kw):
    res = load(self, state, *a, **kw)
    loaded.update({k: v.detach().clone()
                   for k, v in self.state_dict().items()})
    return res

  monkeypatch.setattr(MonoModel, "load_state_dict", recording_load)
  second = train.main(["--device", "cpu"] + _args(root))
  assert second["start_step"] == 14
  (b_name, boot), _ = _phases(logs)[1][2:]
  assert (b_name, boot["phase/bootstrap/steps"]) == ("bootstrap", 0)
  assert boot["step"] == 14
  for k, v in saved["model"].items():
    assert torch.equal(loaded[k], v), k
  assert ckpt.latest_checkpoint(out).endswith("model_00000021.pt")


def _noop_steps(monkeypatch):
  """Both CLIs' train steps become no-ops that count."""
  def port_step(model, opt, rb, weights, cfg, t_cfg, **kw):
    for g in opt.param_groups:
      g["steps_done"] += 1
    return torch.zeros(()), {"loss": torch.zeros(())}, 0

  monkeypatch.setattr(train, "mono_train_step", port_step)

  def create_train_state(model, config, key):
    params = {"w": jnp.zeros((2,), jnp.float32)}
    opt_state = {"m": jnp.zeros((2,), jnp.float32)}
    return jtrain.TrainState(params, opt_state, jnp.int32(0)), None

  def make_train_step(model, tx, cfg, bootstrap, donate):
    def step(state, rb, weights, rng):
      return state, {"loss": jnp.zeros(())}
    return step

  monkeypatch.setattr(jtrain, "create_train_state", create_train_state)
  monkeypatch.setattr(jtrain, "make_train_step", make_train_step)
  from dynibar_tpu.utils import compile_cache
  monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda: None)


def _no_vv(out):
  return sorted(d for d in os.listdir(out) if d.startswith("model_no-vv_"))


def test_no_vv_snapshot_written_once_unlike_the_jax_cli(
    scene_root, tmp_path, monkeypatch):
  """init_decay_epoch 2: one bootstrap epoch, then the no-vv snapshot at
  the end of phase-2 epoch 9 (step 77).  Resuming from step 63 restarts
  phase 2 at epoch 63 // 7 = 9, which reaches that epoch again: the JAX
  CLI writes a second no-vv snapshot, the port keeps the first."""
  _noop_steps(monkeypatch)

  def run(side, root, **kw):
    args = _args(root, i_img=10 ** 6, mesh_shape="1", **kw)
    if side == "jax":
      monkeypatch.setattr(sys, "argv", ["train"] + args)
      jtrain.main()
    else:
      train.main(["--device", "cpu"] + args)
    return os.path.join(root, "out", os.listdir(os.path.join(root, "out"))[0])

  outs = {}
  for side, suffix in (("jax", ""), ("port", ".pt")):
    root = str(tmp_path / side)
    os.makedirs(root)
    if side == "jax":
      jscene.write_synthetic_scene(root, "s", num_frames=FRAMES, height=16,
                                   width=24)
    else:
      os.symlink(os.path.join(scene_root, "s"), os.path.join(root, "s"))
    out = run(side, root, n_iters=70)
    assert _no_vv(out) == [f"model_no-vv_00000077{suffix}"]
    run(side, root, n_iters=0,
        ckpt_path=os.path.join(out, f"model_00000063{suffix}"))
    outs[side] = out
  assert _no_vv(outs["jax"]) == ["model_no-vv_00000070",
                                 "model_no-vv_00000077"]
  assert _no_vv(outs["port"]) == ["model_no-vv_00000077.pt"]


@pytest.mark.parametrize("mesh", ["2", "8"])
def test_larger_mesh_raises(scene_root, mesh):
  with pytest.raises(RuntimeError, match="torchrun"):
    train.main(["--device", "cpu"] + _args(scene_root, mesh_shape=mesh))


def test_default_device_needs_cuda(scene_root):
  if torch.cuda.is_available():
    pytest.skip("this host has CUDA: the default device is valid here")
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    train.main(_args(scene_root))


def test_overrides_and_missing_scene():
  cfg, dev = train.parse_args(["--device", "cpu", "--N_rand", "64",
                               "--inv_uniform", "true", "--lrate_mlp",
                               "1e-4", "--train_scenes", "a b",
                               "--not_a_field", "x"])
  assert (dev, cfg.N_rand, cfg.inv_uniform, cfg.lrate_mlp,
          cfg.train_scenes) == ("cpu", 64, True, 1e-4, ["a", "b"])
  with pytest.raises(SystemExit, match="no training scene"):
    train.main(["--device", "cpu"])
