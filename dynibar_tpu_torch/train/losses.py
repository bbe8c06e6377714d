"""The training losses (port of ``dynibar_tpu.train.losses``).

The 8-term assembly of the reference train loop (train.py:300-456) with
its criterion helpers (ibrnet/criterion.py:21-85, utils.py:32-39), applied
to the fine outputs of ``render_rays_mv(is_train=True)`` (FF) or to the
outputs of ``render_rays_mono(is_train=True)`` (mono), and the mono
static-bootstrap loss (train.py:187-196).  The
epoch-dependent decay factors come from :func:`schedule_weights` on the
host.  Every term is f32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from dynibar_tpu_torch.config import TrainSettings
from dynibar_tpu_torch.ops.distortion import eff_distloss

EPSILON = 1e-3
TINY = 1e-6


@dataclasses.dataclass(frozen=True)
class LossWeights:
  """Per-step effective loss weights."""

  w_disp: float
  w_flow: float
  w_cycle: float
  w_reg: float
  w_skew_entropy: float
  w_distortion: float
  dynamic_rgb_decay: float     # 1 / 10**divisor
  use_dynamic_mask_rgb: float  # 1 while epoch < init_decay_epoch, else 0
  suppress_dynamic: float      # 1 once divisor > 4, else 0


def schedule_weights(cfg: TrainSettings, epoch: int) -> LossWeights:
  """Host-side decay schedule (reference train.py:302-445)."""
  divisor = epoch // cfg.init_decay_epoch
  if cfg.anneal_cycle:
    w_cycle = min(0.5, cfg.w_cycle + divisor * cfg.cycle_factor)
  else:
    w_cycle = cfg.w_cycle
  return LossWeights(
      w_disp=cfg.w_disp / (cfg.decay_rate ** divisor),
      w_flow=cfg.w_flow / (cfg.decay_rate ** divisor),
      w_cycle=w_cycle,
      w_reg=cfg.w_reg,
      w_skew_entropy=cfg.w_skew_entropy,
      w_distortion=cfg.w_distortion,
      dynamic_rgb_decay=1.0 / (10.0 ** divisor),
      use_dynamic_mask_rgb=1.0 if epoch < cfg.init_decay_epoch else 0.0,
      suppress_dynamic=1.0 if divisor > 4 else 0.0,
  )


def charbonnier_rgb(pred_rgb, gt_rgb, mask):
  """Masked Charbonnier (utils.py:32-39 img2charbonier)."""
  err = torch.sqrt((pred_rgb - gt_rgb) ** 2 + EPSILON ** 2)
  return (torch.sum(err * mask[..., None])
          / (torch.sum(mask) * pred_rgb.shape[-1] + TINY))


def temporal_rgb_loss(outputs, gt_rgb, motion_mask=None):
  """Occlusion-weighted cross-time RGB loss (criterion.py:42-56)."""
  pred = outputs["rgb"]
  w = outputs["mask"].to(pred.dtype) * outputs["occ_weight_map"]
  if motion_mask is not None:
    w = w * motion_mask
  err = torch.sqrt((pred - gt_rgb) ** 2 + EPSILON ** 2)
  return torch.sum(w[..., None] * err) / (3.0 * torch.sum(w) + 1e-8)


def flow_loss(render_flow, gt_flow, gt_mask):
  """Masked L1 flow loss (criterion.py:83-85)."""
  m = gt_mask.expand(gt_flow.shape[:-1] + (1,))
  m2 = torch.cat([m, m], dim=-1)
  return (torch.sum(torch.abs(render_flow - gt_flow) * m2)
          / (torch.sum(m2) + 1e-8))


def compute_mono_losses(ret: Dict[str, Any], rb: Dict[str, Any],
                        w: LossWeights) -> Dict[str, torch.Tensor]:
  """Full 8-term mono loss (train.py:300-456).  Returns each term and the
  total."""
  return _assemble_losses(
      ret["outputs_coarse_ref"], ret["outputs_coarse_ref_dy"],
      ret["outputs_coarse_anchor"], ret["outputs_coarse_anchor_dy"], rb, w)


def compute_bootstrap_loss(ret: Dict[str, Any], rb: Dict[str, Any]
                           ) -> torch.Tensor:
  """Static-bootstrap phase loss (reference train.py:187-196): the static
  render on the static pixels."""
  mask = ((1.0 - rb["static_mask"].float())
          * ret["outputs_coarse_ref"]["mask"].float())
  return charbonnier_rgb(ret["outputs_coarse_st"]["rgb"], rb["rgb"], mask)


def compute_ff_losses(ret: Dict[str, Any], rb: Dict[str, Any],
                      w: LossWeights) -> Dict[str, torch.Tensor]:
  """Fine-stage loss of forward-facing training: the mono term structure
  on the fine outputs (the coarse stage is frozen).  Returns each term and
  the total."""
  return _assemble_losses(
      ret["outputs_fine_ref"], ret["outputs_fine_ref_dy"],
      ret["outputs_fine_anchor"], ret["outputs_fine_anchor_dy"], rb, w)


def _assemble_losses(out_ref, out_ref_dy, out_anchor, out_anchor_dy,
                     rb: Dict[str, Any], w: LossWeights
                     ) -> Dict[str, torch.Tensor]:
  gt_rgb = rb["rgb"]
  motion_mask = rb["motion_mask"].float()

  # --- RGB terms ---
  pred_mask = out_ref["mask"].float()
  rgb_loss = charbonnier_rgb(out_ref["rgb"], gt_rgb, pred_mask)
  rgb_loss = rgb_loss + temporal_rgb_loss(out_anchor, gt_rgb)
  # early-phase dynamic-region supervision of the composite render
  dyn_mask = pred_mask * motion_mask
  rgb_loss = rgb_loss + w.use_dynamic_mask_rgb * charbonnier_rgb(
      out_ref["rgb_dy"], gt_rgb, dyn_mask)
  # decayed dynamic-only terms
  rgb_loss = rgb_loss + w.dynamic_rgb_decay * charbonnier_rgb(
      out_ref_dy["rgb"], gt_rgb, out_ref_dy["mask"].float() * motion_mask)
  rgb_loss = rgb_loss + w.dynamic_rgb_decay * temporal_rgb_loss(
      out_anchor_dy, gt_rgb, motion_mask)

  # --- disparity ---
  pred_disp = 1.0 / torch.clamp(out_ref["depth"], min=1e-2)
  disp_loss = w.w_disp * (torch.sum(torch.abs(pred_disp - rb["disp"])
                                    * pred_mask)
                          / (torch.sum(pred_mask) + 1e-8))

  # --- flow (the supervision may cover fewer views than are rendered) ---
  n_flow = rb["flows"].shape[0]
  fmask = pred_mask[None, :, None] * rb["flow_masks"]
  fl = w.w_flow * flow_loss(out_ref["render_flows"][:n_flow], rb["flows"],
                            fmask)

  # --- cycle consistency (pair-masked; reference train.py:354-371) ---
  occ_w = out_anchor["occ_weights"]                           # [R, S]
  pair_valid = out_anchor["pair_valid"].float()               # [Va]
  occ_w4 = occ_w[None, :, :, None] * pair_valid[:, None, None, None]
  occ_w4 = occ_w4.expand(out_anchor["pts_traj_ref"].shape)
  cycle = w.w_cycle * (
      torch.sum(torch.abs(out_anchor["pts_traj_ref"]
                          - out_anchor["pts_traj_anchor"]) * occ_w4)
      / (torch.sum(occ_w4) + 1e-8))

  # --- trajectory regularization (train.py:374-397) ---
  sf = out_anchor["sf_seq"]                                   # [6, R, S, 3]
  reg = w.w_reg * torch.mean(torch.abs(sf))
  reg = reg + w.w_reg * 0.5 * torch.mean((sf[:-1] - sf[1:]) ** 2)
  reg = reg + w.w_reg * torch.mean(torch.abs(sf[:, :, 1:, :]
                                             - sf[:, :, :-1, :]))

  # --- skew entropy on the dynamic/static weight ratio (train.py:399-413)
  rw_dy = torch.sum(out_ref["weights_dy"], dim=-1)
  rw_st = torch.sum(out_ref["weights_st"], dim=-1)
  ratio = rw_dy / torch.clamp(rw_dy + rw_st, min=1e-9)
  # clamp before the logs: at ratio == 1 exactly (no static weight, common
  # in FF scenes) (1-r) log(1-r) must stay 0, not NaN
  r_ent = torch.clamp(ratio, 1e-9, 1.0 - 1e-7)
  ent = -(r_ent * torch.log(r_ent) + (1.0 - r_ent) * torch.log(1.0 - r_ent))
  entropy = w.w_skew_entropy * torch.mean(ent)

  # --- distortion (train.py:416-423) ---
  s_vals = out_ref["s_vals"]
  mid = (s_vals[:, 1:] + s_vals[:, :-1]) * 0.5
  interval = s_vals[:, 1:] - s_vals[:, :-1]
  distortion = w.w_distortion * eff_distloss(out_ref["weights"][:, :-1],
                                             mid, interval)

  # --- adaptive static loss (train.py:426-445) ---
  st_mask = ((1.0 - rb["static_mask"].float()) * pred_mask
             * (1.0 - ratio).detach())
  static_loss = charbonnier_rgb(out_ref["rgb_static"], gt_rgb, st_mask)
  sfm2 = (st_mask * (ratio < 0.1).float()).detach()
  static_loss = static_loss + w.suppress_dynamic * (
      0.1 * torch.sum(torch.abs(rw_dy * sfm2)) / torch.sum(sfm2 + 1e-8))

  total = (rgb_loss + cycle + fl + disp_loss + reg + entropy + distortion
           + static_loss)
  return {
      "loss": total,
      "rgb_loss": rgb_loss,
      "disp_loss": disp_loss,
      "flow_loss": fl,
      "cycle_loss": cycle,
      "reg_loss": reg,
      "entropy_loss": entropy,
      "distortion_loss": distortion,
      "static_loss": static_loss,
  }
