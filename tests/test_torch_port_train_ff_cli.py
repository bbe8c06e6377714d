"""The port's FF fine-stage training CLI (``cli/train_ff``) on the CPU,
mirroring ``tests/test_train_cli_driver.py:103`` and
``tests/test_ff_train.py:215``:

  * ``main --device cpu`` on a 12-frame 16×24 scene with ``coarse_dir``
    a port run folder: snapshots under ``checkpoints/fine/<expname>``
    with ``args.json``, scalars under ``train_fine/`` and the ``phase/fine``
    record (steps, seconds, pipeline wait) in ``logs/fine_<expname>``; the
    snapshot's coarse groups equal the donor's bit for bit;
  * a second run resumes at the saved step with the saved parameters
    (recorded as the model loads them) and keeps the coarse stage;
  * the coarse stage loads from a reference-format coarse ``.pth`` and
    from a mono run's snapshot; a mis-shaped coarse snapshot raises;
  * no scene raises SystemExit, a mesh larger than one card raises outside
    a launcher (torchrun), and without ``--device cpu`` a host with no
    CUDA raises.
4 + 4 samples (every ray's mask is off: the loop, not the render, is
under test; the losses stay finite).
"""

import json
import os

import numpy as np
import pytest
import torch

from dynibar_tpu_torch.cli import train_ff
from dynibar_tpu_torch.config import DynibarConfig, TrainSettings
from dynibar_tpu_torch.data import synthetic_scene
from dynibar_tpu_torch.models.dynibar import (FF_COARSE_KEYS, FFModel,
                                              MonoModel)
from dynibar_tpu_torch.train import trainer
from dynibar_tpu_torch.utils import checkpoints as ckpt
from torch_port_threads import one_torch_thread  # noqa: F401

FRAMES = 12
SMALL = dict(training_height=16, N_rand=16, N_samples=4, N_importance=4,
             num_basis=4, mask_static=False)


def _args(data_dir, rootdir, coarse_dir, **kw):
  base = dict(folder_path=data_dir, train_scenes="s", rootdir=rootdir,
              n_iters=2, i_print=1, i_weights=2, workers=1,
              coarse_dir=coarse_dir, expname="ff_smoke", **SMALL)
  base.update(kw)
  out = ["--device", "cpu"]
  for k, v in base.items():
    out += [f"--{k}", str(v)]
  return out


def _cfg(**kw):
  return DynibarConfig(**dict(SMALL, **kw)).render_settings("ff_train")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
  root = tmp_path_factory.mktemp("ff_cli")
  synthetic_scene.write_synthetic_scene(str(root / "data"), "s",
                                        num_frames=FRAMES, height=16,
                                        width=24)
  donor = FFModel(_cfg(), FRAMES, device="cpu", seed=7)
  ckpt.save_checkpoint(str(root / "coarse"), 5, donor.state_dict())
  return root, donor.state_dict()


def _coarse(sd):
  return {k: v for k, v in sd.items() if k.split(".")[0] in FF_COARSE_KEYS}


def _assert_coarse_equal(got, want):
  want = _coarse(want)
  assert set(_coarse(got)) == set(want)
  for k, v in want.items():
    assert torch.equal(got[k], v), k


def test_cli_trains_grafts_and_resumes(scene, tmp_path, monkeypatch, capsys):
  root, donor = scene
  args = _args(str(root / "data"), str(tmp_path), str(root / "coarse"))
  first = train_ff.main(args)
  out = first["out_folder"]
  assert first["start_step"] == 0
  assert out == os.path.join(str(tmp_path), "checkpoints", "fine",
                             "ff_smoke")
  # n_iters 2 runs 3 steps (the JAX loop's `<`), a snapshot at 2 and at the
  # end
  assert sorted(os.listdir(out)) == ["args.json", "model_00000002.pt",
                                     "model_00000003.pt"]
  with open(os.path.join(out, "args.json")) as fh:
    assert json.load(fh)["num_frames"] == FRAMES
  saved = ckpt.load_checkpoint(ckpt.latest_checkpoint(out))
  _assert_coarse_equal(saved["model"], donor)
  with open(os.path.join(str(tmp_path), "logs", "fine_ff_smoke",
                         "metrics.jsonl")) as fh:
    recs = [json.loads(line) for line in fh]
  assert [r["step"] for r in recs] == [1, 2, 3, 3]
  assert all(np.isfinite(recs[0][f"train_fine/{k}"])
             for k in ("loss", "psnr", "grad_norm"))
  assert recs[-1]["phase/fine/steps"] == 3
  assert recs[-1]["phase/fine/wait_s"] >= 0.0
  # the fine groups moved
  assert not all(torch.equal(saved["model"][k], v) for k, v in donor.items()
                 if k.startswith("net_fine_dy"))

  loaded = []
  inner = FFModel.load_state_dict
  monkeypatch.setattr(FFModel, "load_state_dict",
                      lambda self, sd, *a, **kw: loaded.append(sd)
                      or inner(self, sd, *a, **kw))
  capsys.readouterr()
  second = train_ff.main(args)
  assert second["start_step"] == 3
  assert "resumed at step 3" in capsys.readouterr().out
  assert len(loaded) == 1
  for k, v in saved["model"].items():
    assert torch.equal(loaded[0][k], v), k
  last = ckpt.load_checkpoint(ckpt.latest_checkpoint(out))
  assert last["step"] == 6
  _assert_coarse_equal(last["model"], donor)


def _reference_coarse(path, sd):
  """A google/dynibar-layout coarse .pth: one state_dict per group
  (net_coarse_st with DataParallel's ``module.``, feature_net with a dead
  layer2 weight the port does not build), the basis as a tensor."""
  payload = {"global_step": 0}
  for group in FF_COARSE_KEYS:
    if group == "traj_basis":
      payload[group] = sd[group].clone()
      continue
    sub = {k[len(group) + 1:]: v.clone() for k, v in sd.items()
           if k.startswith(group + ".")}
    if group == "net_coarse_st":
      sub = {"module." + k: v for k, v in sub.items()}
    if group == "feature_net":
      sub["layer2.0.conv1.weight"] = torch.zeros(128, 64, 3, 3)
    payload[group] = sub
  torch.save(payload, path)


def test_coarse_stage_from_reference_pth(scene, tmp_path):
  root, donor = scene
  pth = str(tmp_path / "coarse.pth")
  _reference_coarse(pth, donor)
  out = train_ff.main(_args(str(root / "data"), str(tmp_path), pth,
                            n_iters=0))["out_folder"]
  saved = ckpt.load_checkpoint(ckpt.latest_checkpoint(out))
  assert saved["step"] == 1
  _assert_coarse_equal(saved["model"], donor)


def test_coarse_stage_from_a_mono_snapshot(tmp_path):
  """A mono run's snapshot carries the same coarse group names and, at the
  same samples, frames and bases, the same shapes."""
  cfg = _cfg()
  mono = MonoModel(DynibarConfig(**SMALL).render_settings("mono"), FRAMES,
                   device="cpu", seed=3)
  ckpt.save_checkpoint(str(tmp_path), 9, mono.state_dict())
  coarse = train_ff.load_coarse_params(str(tmp_path))
  assert {k.split(".")[0] for k in coarse} == set(FF_COARSE_KEYS)
  model, _ = trainer.create_ff_train_state(cfg, TrainSettings(), FRAMES,
                                           device="cpu", coarse=coarse)
  _assert_coarse_equal(model.state_dict(), mono.state_dict())


def test_mis_shaped_coarse_snapshot_raises(scene, tmp_path):
  root, _ = scene
  other = FFModel(_cfg(), FRAMES + 4, device="cpu", seed=1)
  ckpt.save_checkpoint(str(tmp_path / "bad"), 1, other.state_dict())
  with pytest.raises(ValueError, match="traj_basis"):
    train_ff.main(_args(str(root / "data"), str(tmp_path / "run"),
                        str(tmp_path / "bad")))
  with pytest.raises(SystemExit, match="no checkpoint"):
    train_ff.main(_args(str(root / "data"), str(tmp_path / "run"),
                        str(tmp_path / "empty")))


def test_no_scene_and_mesh_and_device():
  with pytest.raises(SystemExit, match="no scene"):
    train_ff.main(["--device", "cpu"])
  with pytest.raises(RuntimeError, match="torchrun"):
    train_ff.main(["--device", "cpu", "--train_scenes", "s", "--mesh_shape",
                   "8"])
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
      train_ff.main(["--train_scenes", "s"])
