"""The training losses (port of ``dynibar_tpu.train.losses``).

The 8-term assembly of the reference train loop (train.py:300-456) with
its criterion helpers (ibrnet/criterion.py:21-85, utils.py:32-39), applied
to the fine outputs of ``render_rays_mv(is_train=True)`` (FF) or to the
outputs of ``render_rays_mono(is_train=True)`` (mono), and the mono
static-bootstrap loss (train.py:187-196).  The
epoch-dependent decay factors come from :func:`schedule_weights` on the
host.  Every term is f32.

Under a mesh (``parallel/mesh.py``) each rank holds its rows of the
step's rays.  Every ratio term becomes this rank's numerator over the
global denominator, from one ``all_reduce`` of the stacked, detached
denominators (none of them carries a gradient: masks, the detached
occlusion and static weights), and every mean over rays divides by the
global count.  The ranks' losses then sum to the one-card loss, and so do
their gradients.  Without a mesh nothing is reduced.
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


def _global_sums(sums, mesh):
  """The denominators' sums over the mesh's rays: one all-reduce of the
  stacked, detached local sums; without a mesh, ``sums`` as they are."""
  if mesh is None:
    return list(sums)
  total = mesh.all_reduce(torch.stack([s.detach().float() for s in sums]))
  return list(total.unbind())


def _mean(x, mesh):
  """Mean over the mesh's rays: every rank holds as many."""
  m = torch.mean(x)
  return m if mesh is None else m / mesh.world


def charbonnier_rgb(pred_rgb, gt_rgb, mask, mask_sum):
  """Masked Charbonnier (utils.py:32-39 img2charbonier) over the
  denominator's mask sum ``mask_sum``."""
  err = torch.sqrt((pred_rgb - gt_rgb) ** 2 + EPSILON ** 2)
  return (torch.sum(err * mask[..., None])
          / (mask_sum * pred_rgb.shape[-1] + TINY))


def temporal_weight(outputs, motion_mask=None):
  """The per-ray weight of the cross-time RGB loss."""
  w = outputs["mask"].to(outputs["rgb"].dtype) * outputs["occ_weight_map"]
  return w if motion_mask is None else w * motion_mask


def temporal_rgb_loss(pred_rgb, gt_rgb, w, w_sum):
  """Occlusion-weighted cross-time RGB loss (criterion.py:42-56): the
  per-ray weights ``w`` (:func:`temporal_weight`) over their sum
  ``w_sum``."""
  err = torch.sqrt((pred_rgb - gt_rgb) ** 2 + EPSILON ** 2)
  return torch.sum(w[..., None] * err) / (3.0 * w_sum + 1e-8)


def flow_mask(gt_flow, gt_mask):
  """The flow loss's mask, one entry per flow component."""
  m = gt_mask.expand(gt_flow.shape[:-1] + (1,))
  return torch.cat([m, m], dim=-1)


def flow_loss(render_flow, gt_flow, m2, m2_sum):
  """Masked L1 flow loss (criterion.py:83-85): the mask ``m2``
  (:func:`flow_mask`) over its sum ``m2_sum``."""
  return torch.sum(torch.abs(render_flow - gt_flow) * m2) / (m2_sum + 1e-8)


def compute_mono_losses(ret: Dict[str, Any], rb: Dict[str, Any],
                        w: LossWeights, mesh=None
                        ) -> Dict[str, torch.Tensor]:
  """Full 8-term mono loss (train.py:300-456).  Returns each term and the
  total (this rank's shares under a mesh)."""
  return _assemble_losses(
      ret["outputs_coarse_ref"], ret["outputs_coarse_ref_dy"],
      ret["outputs_coarse_anchor"], ret["outputs_coarse_anchor_dy"], rb, w,
      mesh)


def compute_bootstrap_loss(ret: Dict[str, Any], rb: Dict[str, Any],
                           mesh=None) -> torch.Tensor:
  """Static-bootstrap phase loss (reference train.py:187-196): the static
  render on the static pixels."""
  mask = ((1.0 - rb["static_mask"].float())
          * ret["outputs_coarse_ref"]["mask"].float())
  (mask_sum,) = _global_sums([torch.sum(mask)], mesh)
  return charbonnier_rgb(ret["outputs_coarse_st"]["rgb"], rb["rgb"], mask,
                         mask_sum)


def compute_ff_losses(ret: Dict[str, Any], rb: Dict[str, Any],
                      w: LossWeights, mesh=None) -> Dict[str, torch.Tensor]:
  """Fine-stage loss of forward-facing training: the mono term structure
  on the fine outputs (the coarse stage is frozen).  Returns each term and
  the total (this rank's shares under a mesh)."""
  return _assemble_losses(
      ret["outputs_fine_ref"], ret["outputs_fine_ref_dy"],
      ret["outputs_fine_anchor"], ret["outputs_fine_anchor_dy"], rb, w,
      mesh)


def _assemble_losses(out_ref, out_ref_dy, out_anchor, out_anchor_dy,
                     rb: Dict[str, Any], w: LossWeights, mesh=None
                     ) -> Dict[str, torch.Tensor]:
  gt_rgb = rb["rgb"]
  motion_mask = rb["motion_mask"].float()

  # --- the ratio terms' masks and weights (none carries a gradient) ---
  pred_mask = out_ref["mask"].float()
  # early-phase dynamic-region supervision of the composite render
  dyn_mask = pred_mask * motion_mask
  dy_mask = out_ref_dy["mask"].float() * motion_mask
  w_anchor = temporal_weight(out_anchor)
  w_anchor_dy = temporal_weight(out_anchor_dy, motion_mask)
  # the flow supervision may cover fewer views than are rendered
  n_flow = rb["flows"].shape[0]
  fmask = pred_mask[None, :, None] * rb["flow_masks"]
  m2 = flow_mask(rb["flows"], fmask)
  # cycle consistency's pair-masked weights (reference train.py:354-371)
  occ_w = out_anchor["occ_weights"]                           # [R, S]
  pair_valid = out_anchor["pair_valid"].float()               # [Va]
  occ_w4 = occ_w[None, :, :, None] * pair_valid[:, None, None, None]
  occ_w4 = occ_w4.expand(out_anchor["pts_traj_ref"].shape)
  # the dynamic/static weight ratio (train.py:399-413)
  rw_dy = torch.sum(out_ref["weights_dy"], dim=-1)
  rw_st = torch.sum(out_ref["weights_st"], dim=-1)
  ratio = rw_dy / torch.clamp(rw_dy + rw_st, min=1e-9)
  # the adaptive static loss's masks (train.py:426-445)
  st_mask = ((1.0 - rb["static_mask"].float()) * pred_mask
             * (1.0 - ratio).detach())
  sfm2 = (st_mask * (ratio < 0.1).float()).detach()
  (n_ref, n_anchor, n_dyn, n_dy, n_anchor_dy, n_m2, n_occ, n_st,
   n_sfm2) = _global_sums(
       [torch.sum(pred_mask), torch.sum(w_anchor), torch.sum(dyn_mask),
        torch.sum(dy_mask), torch.sum(w_anchor_dy), torch.sum(m2),
        torch.sum(occ_w4), torch.sum(st_mask), torch.sum(sfm2 + 1e-8)],
       mesh)

  # --- RGB terms ---
  rgb_loss = charbonnier_rgb(out_ref["rgb"], gt_rgb, pred_mask, n_ref)
  rgb_loss = rgb_loss + temporal_rgb_loss(out_anchor["rgb"], gt_rgb,
                                          w_anchor, n_anchor)
  rgb_loss = rgb_loss + w.use_dynamic_mask_rgb * charbonnier_rgb(
      out_ref["rgb_dy"], gt_rgb, dyn_mask, n_dyn)
  # decayed dynamic-only terms
  rgb_loss = rgb_loss + w.dynamic_rgb_decay * charbonnier_rgb(
      out_ref_dy["rgb"], gt_rgb, dy_mask, n_dy)
  rgb_loss = rgb_loss + w.dynamic_rgb_decay * temporal_rgb_loss(
      out_anchor_dy["rgb"], gt_rgb, w_anchor_dy, n_anchor_dy)

  # --- disparity (the Nvidia scenes' batches carry none) ---
  if "disp" in rb:
    pred_disp = 1.0 / torch.clamp(out_ref["depth"], min=1e-2)
    disp_loss = w.w_disp * (torch.sum(torch.abs(pred_disp - rb["disp"])
                                      * pred_mask)
                            / (n_ref + 1e-8))
  else:
    disp_loss = torch.zeros((), device=gt_rgb.device)

  # --- flow ---
  fl = w.w_flow * flow_loss(out_ref["render_flows"][:n_flow], rb["flows"],
                            m2, n_m2)

  # --- cycle consistency ---
  cycle = w.w_cycle * (
      torch.sum(torch.abs(out_anchor["pts_traj_ref"]
                          - out_anchor["pts_traj_anchor"]) * occ_w4)
      / (n_occ + 1e-8))

  # --- trajectory regularization (train.py:374-397) ---
  sf = out_anchor["sf_seq"]                                   # [6, R, S, 3]
  reg = w.w_reg * _mean(torch.abs(sf), mesh)
  reg = reg + w.w_reg * 0.5 * _mean((sf[:-1] - sf[1:]) ** 2, mesh)
  reg = reg + w.w_reg * _mean(torch.abs(sf[:, :, 1:, :]
                                        - sf[:, :, :-1, :]), mesh)

  # --- skew entropy on the dynamic/static weight ratio ---
  # clamp before the logs: at ratio == 1 exactly (no static weight, common
  # in FF scenes) (1-r) log(1-r) must stay 0, not NaN
  r_ent = torch.clamp(ratio, 1e-9, 1.0 - 1e-7)
  ent = -(r_ent * torch.log(r_ent) + (1.0 - r_ent) * torch.log(1.0 - r_ent))
  entropy = w.w_skew_entropy * _mean(ent, mesh)

  # --- distortion (train.py:416-423) ---
  s_vals = out_ref["s_vals"]
  mid = (s_vals[:, 1:] + s_vals[:, :-1]) * 0.5
  interval = s_vals[:, 1:] - s_vals[:, :-1]
  distortion = w.w_distortion * eff_distloss(out_ref["weights"][:, :-1],
                                             mid, interval, mesh)

  # --- adaptive static loss ---
  static_loss = charbonnier_rgb(out_ref["rgb_static"], gt_rgb, st_mask, n_st)
  static_loss = static_loss + w.suppress_dynamic * (
      0.1 * torch.sum(torch.abs(rw_dy * sfm2)) / n_sfm2)

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
