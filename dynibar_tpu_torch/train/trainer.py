"""The fine-stage train step of the forward-facing model.

Port of ``dynibar_tpu.train.trainer``'s FF pieces: ``make_ff_optimizer``
(Adam param groups with the reference's per-module learning rates,
reference model.py:106-118), the capped StepLR of ``steplr_schedule`` /
``_lr_cap_exponent`` (train.py:469-471), the optional global-norm clip, and
``make_ff_loss_fn`` + ``make_ff_train_step`` as one eager step:
re-encode the sources through both feature nets, render coarse (frozen)
-> fine -> anchor with autograd on the fine stage, the 8-term loss,
backward, clip, Adam.  The coarse groups never require grad, so they stay
bit-identical across steps.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from dynibar_tpu_torch.config import RenderSettings, TrainSettings
from dynibar_tpu_torch.models.dynibar import FFModel
from dynibar_tpu_torch.render.render_rays import render_rays_mv
from dynibar_tpu_torch.train.losses import LossWeights, compute_ff_losses
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


def make_ff_optimizer(model: FFModel, cfg: TrainSettings
                      ) -> torch.optim.Adam:
  """Adam with one param group per fine group; the frozen coarse groups
  are not in it.  Each group carries its base lr and the schedule."""
  gamma = cfg.lrate_decay_factor
  steps = max(1, cfg.lrate_decay_steps)
  cap = lr_cap_exponent(cfg.lrate_mlp * cfg.lr_multipler, gamma)
  base = {"net_fine_st": cfg.lrate_mlp * cfg.lr_multipler,
          "net_fine_dy": cfg.lrate_mlp,
          "feature_net_fine": cfg.lrate_feature,
          "motion_mlp_fine": cfg.lrate_mlp,
          "traj_basis_fine": cfg.lrate_mlp * 0.25}
  groups = [dict(params=params, name=key, lr=base[key], base_lr=base[key],
                 gamma=gamma, decay_steps=steps, cap=cap, steps_done=0)
            for key, params in model.param_groups().items()]
  return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)


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
