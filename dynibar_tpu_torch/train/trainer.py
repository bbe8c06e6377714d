"""The train steps: the FF fine stage and the mono model.

Port of ``dynibar_tpu.train.trainer``: ``make_ff_optimizer`` and
``make_mono_optimizer`` (Adam param groups with the reference's
per-module learning rates, reference model.py:106-118, :341-351), the
capped StepLR of ``steplr_schedule`` / ``_lr_cap_exponent``
(train.py:469-471), the optional global-norm clip, and the loss closures
with ``make_train_step`` as one eager step each:

  * FF (``ff_train_step``): re-encode the sources through both feature
    nets, render coarse (frozen) -> fine -> anchor with autograd on the
    fine stage, the 8-term loss, backward, clip, Adam.  The coarse groups
    never require grad, so they stay bit-identical across steps;
  * mono (``mono_train_step``): re-encode through both feature nets,
    render the one stage (-> anchor) with autograd, the 8-term loss (or,
    with ``bootstrap=True``, the static-bootstrap loss of phase 1, rendered
    without the anchor branch), backward, clip, Adam over all six groups.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from dynibar_tpu_torch.config import RenderSettings, TrainSettings
from dynibar_tpu_torch.models.dynibar import FFModel, MonoModel
from dynibar_tpu_torch.render.render_rays import (render_rays_mono,
                                                  render_rays_mv)
from dynibar_tpu_torch.train.losses import (LossWeights,
                                            compute_bootstrap_loss,
                                            compute_ff_losses,
                                            compute_mono_losses)
from dynibar_tpu_torch.utils.device import to_device


def lr_cap_exponent(first_group_lr: float, gamma: float,
                    floor: float = 5e-7) -> int:
  """Number of decays after which the reference scheduler freezes (the
  first group's lr <= 5e-7, train.py:469-471)."""
  if first_group_lr <= floor:
    return 0
  return int(math.ceil(math.log(floor / first_group_lr) / math.log(gamma)))


def steplr(base_lr: float, gamma: float, decay_steps: int, cap: int,
           step: int) -> float:
  """StepLR with a hard cap on the number of decays, at update `step`
  (0-based, as optax evaluates a schedule at its update count)."""
  return base_lr * gamma ** min(step // decay_steps, cap)


def _adam(model, cfg: TrainSettings, base, cap_lr: float
          ) -> torch.optim.Adam:
  """Adam with one param group per entry of ``model.param_groups()``,
  each carrying its base lr and the schedule; the decay cap comes from
  ``cap_lr`` (the reference's first group)."""
  gamma = cfg.lrate_decay_factor
  steps = max(1, cfg.lrate_decay_steps)
  cap = lr_cap_exponent(cap_lr, gamma)
  groups = [dict(params=params, name=key, lr=base[key], base_lr=base[key],
                 gamma=gamma, decay_steps=steps, cap=cap, steps_done=0)
            for key, params in model.param_groups().items()]
  return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)


def make_ff_optimizer(model: FFModel, cfg: TrainSettings
                      ) -> torch.optim.Adam:
  """Adam with one param group per fine group; the frozen coarse groups
  are not in it."""
  base = {"net_fine_st": cfg.lrate_mlp * cfg.lr_multipler,
          "net_fine_dy": cfg.lrate_mlp,
          "feature_net_fine": cfg.lrate_feature,
          "motion_mlp_fine": cfg.lrate_mlp,
          "traj_basis_fine": cfg.lrate_mlp * 0.25}
  return _adam(model, cfg, base, cfg.lrate_mlp * cfg.lr_multipler)


def make_mono_optimizer(model: MonoModel, cfg: TrainSettings
                        ) -> torch.optim.Adam:
  """Adam over the six mono groups with the reference multipliers
  (dynibar_tpu/train/trainer.py:63-83); the decay cap comes from the
  first group's lr, lrate_mlp · 0.5."""
  base = {"net_coarse_st": cfg.lrate_mlp * 0.5,
          "feature_net_st": cfg.lrate_feature * 0.5,
          "net_coarse_dy": cfg.lrate_mlp,
          "feature_net": cfg.lrate_feature,
          "motion_mlp": cfg.lrate_mlp,
          "traj_basis": cfg.lrate_mlp * 0.25}
  return _adam(model, cfg, base, cfg.lrate_mlp * 0.5)


def set_lr(opt: torch.optim.Optimizer) -> None:
  """Each group's lr for its next update."""
  for g in opt.param_groups:
    g["lr"] = steplr(g["base_lr"], g["gamma"], g["decay_steps"], g["cap"],
                     g["steps_done"])


def ff_loss(model: FFModel, rb: Dict[str, Any], weights: LossWeights,
            cfg: RenderSettings, *, det: bool = False,
            generator: Optional[torch.Generator] = None,
            kernels: bool = True) -> Tuple[torch.Tensor, Dict[str, Any]]:
  """The step's loss closure (make_ff_loss_fn): featmaps -> render ->
  compute_ff_losses.  rb must already be on the model's device."""
  coarse_fm, fine_fm = model.encode_featmaps(
      rb["src_rgbs"], rb["static_src_rgbs"], rb["anchor_src_rgbs"])
  ret = render_rays_mv(model, rb, coarse_fm, fine_fm, cfg,
                       device=model.device, kernels=kernels, is_train=True,
                       det=det, generator=generator)
  metrics = compute_ff_losses(ret, rb, weights)
  mse = torch.mean((ret["outputs_fine_ref"]["rgb"] - rb["rgb"]) ** 2)
  metrics["psnr"] = -10.0 * torch.log10(mse + 1e-8)
  return metrics["loss"], metrics


def mono_loss(model: MonoModel, rb: Dict[str, Any], weights: LossWeights,
              cfg: RenderSettings, *, bootstrap: bool = False,
              det: bool = False,
              generator: Optional[torch.Generator] = None,
              kernels: bool = True) -> Tuple[torch.Tensor, Dict[str, Any]]:
  """The mono step's loss closure (make_mono_loss_fn, dynibar_tpu/train/
  trainer.py:144-165): featmaps -> render -> compute_mono_losses, or with
  ``bootstrap`` the static-bootstrap loss of a render without the anchor
  branch.  rb must already be on the model's device."""
  featmaps = model.encode_featmaps(
      rb["src_rgbs"], rb["static_src_rgbs"],
      None if bootstrap else rb["anchor_src_rgbs"])
  ret = render_rays_mono(model, rb, featmaps, cfg, device=model.device,
                         kernels=kernels, is_train=not bootstrap, det=det,
                         generator=generator, needs_grad=True)
  if bootstrap:
    loss = compute_bootstrap_loss(ret, rb)
    metrics = {"loss": loss, "static_loss": loss}
  else:
    metrics = compute_mono_losses(ret, rb, weights)
  mse = torch.mean((ret["outputs_coarse_ref"]["rgb"] - rb["rgb"]) ** 2)
  metrics["psnr"] = -10.0 * torch.log10(mse + 1e-8)
  return metrics["loss"], metrics


def _update(opt: torch.optim.Optimizer, loss: torch.Tensor,
            metrics: Dict[str, torch.Tensor], train_cfg: TrainSettings
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], int]:
  """Backward, the global gradient norm, clip, Adam at the scheduled lr."""
  loss.backward()
  params = [p for g in opt.param_groups for p in g["params"]]
  grads = [p.grad for p in params if p.grad is not None]
  metrics["grad_norm"] = torch.sqrt(sum(torch.sum(g * g) for g in grads))
  if train_cfg.clip_grad_norm > 0:
    torch.nn.utils.clip_grad_norm_(params, train_cfg.clip_grad_norm)
  set_lr(opt)
  opt.step()
  for g in opt.param_groups:
    g["steps_done"] += 1
  metrics = {k: v.detach() for k, v in metrics.items()}
  return loss.detach(), metrics, opt.param_groups[0]["steps_done"]


def ff_train_step(model: FFModel, opt: torch.optim.Optimizer,
                  rb: Dict[str, Any], weights: LossWeights,
                  cfg: RenderSettings, train_cfg: TrainSettings, *,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], int]:
  """One fine-stage step: loss, backward, clip, Adam update, with
  stochastic sample placement from ``generator`` and the kernels.

  Returns the loss, the metrics (every loss term, psnr, grad_norm: the
  global norm before clipping) and the number of updates done so far; the
  model and the optimizer are stepped in place."""
  rb = to_device(rb, model.device)
  opt.zero_grad(set_to_none=True)
  loss, metrics = ff_loss(model, rb, weights, cfg, generator=generator)
  return _update(opt, loss, metrics, train_cfg)


def mono_train_step(model: MonoModel, opt: torch.optim.Optimizer,
                    rb: Dict[str, Any], weights: LossWeights,
                    cfg: RenderSettings, train_cfg: TrainSettings, *,
                    bootstrap: bool = False,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], int]:
  """One mono step (make_train_step, dynibar_tpu/train/trainer.py:168-186):
  the full loss, or the static-bootstrap loss with ``bootstrap``, then
  backward, clip and the Adam update of all six groups, with stochastic
  sample placement from ``generator`` and the kernels.  Returns as
  ``ff_train_step``."""
  rb = to_device(rb, model.device)
  opt.zero_grad(set_to_none=True)
  loss, metrics = mono_loss(model, rb, weights, cfg, bootstrap=bootstrap,
                            generator=generator)
  return _update(opt, loss, metrics, train_cfg)
