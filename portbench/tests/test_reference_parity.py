"""The frozen reference equals the port's plain path (kernels=False) at
tiny sizes on the CPU: a mono train step and an FF eval chunk."""

from __future__ import annotations

import dataclasses

import torch

from dynibar_tpu_torch.config import DynibarConfig, mono_render_settings
from dynibar_tpu_torch.data.ray_batch import (synthetic_ff_batch,
                                              synthetic_mono_batch)
from dynibar_tpu_torch.models.dynibar import FFModel, MonoModel
from dynibar_tpu_torch.render.render_rays import render_rays_mv
from dynibar_tpu_torch.train.losses import schedule_weights
from dynibar_tpu_torch.train.trainer import mono_loss
from dynibar_tpu_torch.utils.device import to_device
from portbench.reference import config as ref_config
from portbench.reference import dynibar as ref_models
from portbench.reference import losses as ref_losses
from portbench.reference.render_rays import render_rays_mv as ref_mv
from portbench.reference.train_step import ReferenceTrainer
from portbench.weights import make_weights

CPU = torch.device("cpu")


def _ref_cfg(cfg):
  return ref_config.RenderSettings(**dataclasses.asdict(cfg))


def test_mono_step_equals_the_plain_path():
  cfg = mono_render_settings(n_samples=16, mask_rgb=True,
                             anti_alias_pooling=False)
  tcfg = DynibarConfig(init_decay_epoch=4).train_settings()
  weights = make_weights(ref_models.MonoModel(_ref_cfg(cfg), 32,
                                              device="cpu"), 5, CPU)
  rb = to_device(synthetic_mono_batch(cfg, 24, h=24, w=40), CPU)
  port = MonoModel(cfg, 32, device="cpu").train_all()
  port.load_state_dict(weights)
  gen = torch.Generator().manual_seed(3)
  loss, _ = mono_loss(port, rb, schedule_weights(tcfg, 6), cfg,
                      kernels=False, generator=gen)
  loss.backward()

  ref = ref_models.MonoModel(_ref_cfg(cfg), 32, device="cpu").train_all()
  ref.load_state_dict(weights)
  trainer = ReferenceTrainer(ref, _ref_cfg(cfg),
                             ref_config.TrainSettings(
                                 **dataclasses.asdict(tcfg)), "mono")
  rl, grads = trainer.step(
      rb, ref_losses.schedule_weights(trainer.tcfg, 6),
      torch.Generator().manual_seed(3))
  loss = float(loss.detach())
  assert abs(rl - loss) <= 1e-6 * abs(loss)
  names = {id(p): n for n, p in ref.named_parameters()}
  port_grads = dict(port.named_parameters())
  for pid, g in grads.items():
    want = port_grads[names[pid]].grad
    if g is None:
      assert want is None or float(want.abs().max()) == 0.0
      continue
    torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-7)


def test_ff_eval_chunk_equals_the_plain_path():
  cfg = DynibarConfig(N_samples=16, N_importance=16, mask_rgb=0,
                      anti_alias_pooling=1).render_settings("ff")
  weights = make_weights(ref_models.FFModel(_ref_cfg(cfg), 48, device="cpu"),
                         7, CPU)
  rb = to_device(synthetic_ff_batch(cfg, 32, h=24, w=40), CPU)
  port = FFModel(cfg, 48, device="cpu")
  port.load_state_dict(weights)
  ref = ref_models.FFModel(_ref_cfg(cfg), 48, device="cpu")
  ref.load_state_dict(weights)
  with torch.no_grad():
    got_fm = port.encode_featmaps(rb["src_rgbs"], rb["static_src_rgbs"])
    want_fm = ref.encode_featmaps(rb["src_rgbs"], rb["static_src_rgbs"])
    got = render_rays_mv(port, rb, *got_fm, cfg, device="cpu",
                         kernels=False)
    want = ref_mv(ref, rb, *want_fm, _ref_cfg(cfg), device="cpu",
                  kernels=False)
  for stage in ("outputs_coarse_ref", "outputs_fine_ref"):
    for key in ("rgb", "depth"):
      torch.testing.assert_close(got[stage][key], want[stage][key],
                                 rtol=0, atol=0)


def test_sliced_reference_step_equals_the_whole():
  """A reference step run over slices of the rays (as the FF train cell's
  check runs it) gives the whole batch's loss and gradients."""
  cfg = DynibarConfig(N_samples=16, N_importance=16, mask_rgb=0,
                      anti_alias_pooling=1).render_settings("ff_train")
  rcfg = _ref_cfg(cfg)
  tcfg = ref_config.TrainSettings(
      **dataclasses.asdict(DynibarConfig().train_settings()))
  weights = make_weights(ref_models.FFModel(rcfg, 48, device="cpu"), 9, CPU)
  rb = to_device(synthetic_ff_batch(cfg, 32, h=24, w=40), CPU)
  out = []
  for chunks in (1, 4):
    model = ref_models.FFModel(rcfg, 48, device="cpu").train_fine()
    model.load_state_dict(weights)
    trainer = ReferenceTrainer(model, rcfg, tcfg, "ff")
    names = {id(p): n for n, p in model.named_parameters()}
    loss, grads = trainer.step(rb, ref_losses.schedule_weights(tcfg, 3),
                               torch.Generator().manual_seed(4),
                               chunks=chunks)
    out.append((loss, {names[k]: g for k, g in grads.items()}))
  (l1, g1), (l4, g4) = out
  assert abs(l1 - l4) <= 1e-5 * abs(l1)
  for name, g in g1.items():
    if g is None:
      assert g4[name] is None
      continue
    torch.testing.assert_close(g4[name], g, rtol=1e-4, atol=1e-7)
