"""The port's Nvidia eval CLI (``cli/eval_nvidia``) vs the JAX package's,
on the CPU, mirroring ``tests/test_eval_cli_configs.py``:

  * every ``configs_nvidia/*.txt`` parses to the JAX package's values, and
    ``render_settings("ff")`` / ``("ff_train")`` equal the JAX ones field
    by field on the fields the port has;
  * a reference-layout coarse + fine ``.pth`` pair written here gives the
    port's CLI (``load_reference_ff_checkpoint``) the results the JAX CLI
    gives through ``convert_ff_checkpoint``, on the config as it is
    (``mask_static`` on): every viewpoint's full, dynamic and static PSNR
    within 1e-3 dB and SSIM within 1e-5, the results JSON within the same
    bars, LPIPS NaN in both;
  * the loader skips the reference's dead layers and ``module.``
    prefixes and raises on a missing or mis-shaped key;
  * no ``eval_scenes`` raises SystemExit; without ``--device cpu`` the CLI
    needs CUDA.
Both CLIs evaluate frame 18 of a 24-frame 16x24 scene on generic poses
with the density heads' bias lowered (``test_torch_port_eval``'s module docstring
says why): their ``--max_frames`` starts at frame 3, so each CLI's
``evaluate_scene`` is wrapped to take frame 18 instead.
"""

import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from dynibar_tpu.cli import eval_nvidia as jcli
from dynibar_tpu.config import DynibarConfig as JConfig
from dynibar_tpu.eval import nvidia_eval as jeval
from dynibar_tpu_torch.cli import eval_nvidia as cli
from dynibar_tpu_torch.config import DynibarConfig
from dynibar_tpu_torch.eval import nvidia_eval
from dynibar_tpu_torch.models.dynibar import (FF_COARSE_KEYS, FF_FINE_KEYS,
                                              FFModel)
from dynibar_tpu_torch.utils import convert

from tests.test_torch_port_eval import (EVAL_CONFIG, EVAL_FRAME, EVAL_FRAMES,
                                        SCENE, SMALL, Recorder,
                                        check_metrics, eval_scenes,
                                        jax_ff_params)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs_nvidia").glob("*.txt"))
PSNR_TOL, SSIM_TOL = 1e-3, 1e-5
_ = eval_scenes                              # the module-scoped fixture


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_configs_parse_as_in_jax(path):
  got, want = DynibarConfig.from_file(str(path)), JConfig.from_file(str(path))
  for f in dataclasses.fields(got):
    assert getattr(got, f.name) == getattr(want, f.name), f.name
  assert got.eval_scenes and got.N_importance == 64 and got.inv_uniform
  assert got.mask_static
  for mode in ("ff", "ff_train"):
    rs, jrs = got.render_settings(mode), want.render_settings(mode)
    for f in dataclasses.fields(rs):
      assert getattr(rs, f.name) == getattr(jrs, f.name), (mode, f.name)
  if path.name != "eval_example.txt":        # the per-scene configs
    assert not got.render_settings("ff").mask_rgb


def _reference_pair(folder, model: FFModel):
  """A google/dynibar-layout coarse + fine pair of `model`'s weights: one
  state_dict per group (net_coarse_st saved as DataParallel would, with
  ``module.``), the feature nets with the dead layer2 / decoder weights the
  reference's ResNet also holds, the bases as tensors, and the files'
  other entries."""
  sd = model.state_dict()
  files = {}
  for name, groups in (("coarse", FF_COARSE_KEYS), ("fine", FF_FINE_KEYS)):
    payload = {"global_step": 0, "optimizer": {"state": {}}}
    for group in groups:
      if group.startswith("traj_basis"):
        payload[group] = sd[group].clone()
        continue
      sub = {k[len(group) + 1:]: v.clone() for k, v in sd.items()
             if k.startswith(group + ".")}
      if group == "net_coarse_st":
        sub = {"module." + k: v for k, v in sub.items()}
      if group.startswith("feature_net"):
        sub["layer2.0.conv1.weight"] = torch.zeros(128, 64, 3, 3)
        sub["upconv3.conv.conv.weight"] = torch.zeros(128, 256, 3, 3)
      payload[group] = sub
    files[name] = str(folder / f"{name}.pth")
    torch.save(payload, files[name])
  return files["coarse"], files["fine"]


def _args(root, results):
  return ["--config", EVAL_CONFIG, "--folder_path", str(root), "--rootdir",
          str(root), "--training_height", str(SMALL["training_height"]),
          "--N_samples", str(SMALL["N_samples"]), "--N_importance",
          str(SMALL["N_importance"]), "--chunk_size",
          str(SMALL["chunk_size"]), "--compute_dtype", "float32",
          "--max_frames", "1", "--results_json", str(results)]


def _pin_frame(monkeypatch, module):
  """The CLI module's evaluate_scene, on frame EVAL_FRAME alone."""
  inner = module.evaluate_scene

  def pinned(*a, **kw):
    kw["frame_range"] = range(EVAL_FRAME, EVAL_FRAME + 1)
    return inner(*a, **kw)

  monkeypatch.setattr(module, "evaluate_scene", pinned)


def test_cli_from_reference_pth_matches_jax(eval_scenes, tmp_path, capsys,
                                            monkeypatch):
  jroot, proot = eval_scenes
  jcfg = JConfig.from_file(EVAL_CONFIG, folder_path=str(jroot), **SMALL)
  _, params = jax_ff_params(jcfg.render_settings("ff"))
  cfg = DynibarConfig.from_file(EVAL_CONFIG, **SMALL)
  source = FFModel(cfg.render_settings("ff"), EVAL_FRAMES, device="cpu",
                   seed=7)
  convert.load_jax_params(source, params)
  coarse, fine = _reference_pair(tmp_path, source)
  ckpt = ["--coarse_ckpt", coarse, "--fine_ckpt", fine]

  want = Recorder(monkeypatch, jeval)
  got = Recorder(monkeypatch, nvidia_eval)
  _pin_frame(monkeypatch, jcli)
  _pin_frame(monkeypatch, cli)
  want_json, got_json = tmp_path / "jax.json", tmp_path / "port.json"
  monkeypatch.setattr(sys, "argv", ["eval_nvidia"] + _args(jroot, want_json)
                      + ckpt)
  jcli.main()
  assert "loaded converted torch checkpoints" in capsys.readouterr().out
  results = cli.main(_args(proot, got_json) + ckpt + ["--device", "cpu"])
  out = capsys.readouterr().out
  assert "loaded the reference torch checkpoints" in out
  assert f"frame {EVAL_FRAME}: 11 viewpoints" in out

  check_metrics(got, want)
  with open(got_json) as fh:
    assert json.load(fh) == json.loads(json.dumps(results))
  with open(want_json) as fh:
    want_table = json.load(fh)[SCENE]
  for region in ("full", "dynamic", "static"):
    g, w = results[SCENE][region], want_table[region]
    assert abs(g["psnr"] - w["psnr"]) <= PSNR_TOL, region
    assert abs(g["ssim"] - w["ssim"]) <= SSIM_TOL, region
    assert np.isnan(g["lpips"]) and np.isnan(w["lpips"])


def test_reference_loader_keys(tmp_path):
  cfg = DynibarConfig(N_samples=4, N_importance=4).render_settings("ff")
  source = FFModel(cfg, EVAL_FRAMES, device="cpu", seed=3)
  coarse, fine = _reference_pair(tmp_path, source)
  model = FFModel(cfg, EVAL_FRAMES, device="cpu", seed=4)
  convert.load_reference_ff_checkpoint(model, coarse, fine)
  for k, v in source.state_dict().items():
    assert torch.equal(model.state_dict()[k], v), k
  # a missing key, a mis-shaped key, a missing group
  payload = torch.load(fine, weights_only=False)
  del payload["net_fine_dy"]["rgb_fc.0.weight"]
  torch.save(payload, tmp_path / "missing.pth")
  with pytest.raises(KeyError, match="rgb_fc.0.weight"):
    convert.load_reference_ff_checkpoint(model, coarse,
                                         str(tmp_path / "missing.pth"))
  payload = torch.load(fine, weights_only=False)
  payload["traj_basis_fine"] = torch.zeros(3, 6)
  torch.save(payload, tmp_path / "shape.pth")
  with pytest.raises(ValueError, match="traj_basis_fine"):
    convert.load_reference_ff_checkpoint(model, coarse,
                                         str(tmp_path / "shape.pth"))
  payload = torch.load(fine, weights_only=False)
  del payload["motion_mlp_fine"]
  torch.save(payload, tmp_path / "group.pth")
  with pytest.raises(KeyError, match="motion_mlp_fine"):
    convert.load_reference_ff_checkpoint(model, coarse,
                                         str(tmp_path / "group.pth"))


def test_no_eval_scene_raises():
  with pytest.raises(SystemExit, match="no eval scene"):
    cli.main(["--device", "cpu"])
  with pytest.raises(SystemExit, match="no eval scene"):
    cli.main(["--config", EVAL_CONFIG, "--eval_scenes", "", "--device",
              "cpu"])


def test_default_device_needs_cuda():
  if torch.cuda.is_available():
    pytest.skip("this host has CUDA: the default device is valid here")
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    cli.main(["--config", EVAL_CONFIG])
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    nvidia_eval.evaluate_scene(DynibarConfig.from_file(EVAL_CONFIG), None,
                               SCENE)


@pytest.mark.parametrize("mesh", ["2", "8"])
def test_larger_mesh_raises(mesh):
  with pytest.raises(RuntimeError, match="torchrun"):
    cli.main(["--config", EVAL_CONFIG, "--mesh_shape", mesh, "--device",
              "cpu"])
