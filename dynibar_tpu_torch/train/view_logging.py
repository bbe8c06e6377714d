"""Full-frame image panels during training.

Port of ``dynibar_tpu.train.view_logging.log_train_view`` (the
reference's ``log_view_to_tb``, train.py:576-762): every ``i_img`` steps
the current training view renders at full resolution in train mode
(cross-time anchor branch included) through ``render_image_mono``, and the
panels go to the logger: rgb (composite, static, dynamic, cross-time), the
static model's rgb, depth, the occlusion-weight map, the expected scene
flow's magnitude, the ground-truth rgb and disparity, and rendered and
ground-truth optical-flow wheels.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from dynibar_tpu_torch.config import RenderSettings
from dynibar_tpu_torch.render.render_image import (full_image_ray_batch,
                                                   render_image_mono)
from dynibar_tpu_torch.utils.logging import MetricsLogger
from dynibar_tpu_torch.utils.viz import colorize_np, flow_to_image


def log_train_view(logger: MetricsLogger, step: int, model,
                   rb: Dict[str, Any], cfg: RenderSettings, chunk_size: int,
                   gt_image: np.ndarray, gt_disp: np.ndarray,
                   gt_flows: Optional[np.ndarray] = None,
                   prefix: str = "train/") -> Dict[str, Dict[str, np.ndarray]]:
  """Render the full current training view and write its panels.

  rb: the training ray batch (numpy or tensors); gt_image [H, W, 3];
  gt_disp [H, W]; gt_flows optional [V<=6, H, W, 2].  Returns the render."""
  h, w = gt_image.shape[:2]
  dev = model.device
  full_rb = full_image_ray_batch(rb, rb["camera"], device=dev)
  with torch.no_grad():
    featmaps = model.encode_featmaps(full_rb["src_rgbs"],
                                     full_rb["static_src_rgbs"],
                                     full_rb["anchor_src_rgbs"])
  ret = render_image_mono(model, full_rb, featmaps, cfg,
                          chunk_size=chunk_size, height=h, width=w,
                          train_view=True, device=dev)

  out = ret["outputs_coarse_ref"]
  anchor = ret["outputs_coarse_anchor"]
  logger.image(step, prefix + "render_rgb_coarse_ref",
               np.clip(out["rgb"], 0, 1))
  logger.image(step, prefix + "render_rgb_coarse_anchor",
               np.clip(anchor["rgb"], 0, 1))
  if "rgb_static" in out:
    logger.image(step, prefix + "render_rgb_static",
                 np.clip(out["rgb_static"], 0, 1))
    logger.image(step, prefix + "render_rgb_dynamic",
                 np.clip(out["rgb_dy"], 0, 1))
  logger.image(step, prefix + "st_rgb_pred",
               np.clip(ret["outputs_coarse_st"]["rgb"], 0, 1))

  def _2d(x):
    return x[..., 0] if x.ndim == 3 else x

  logger.image(step, prefix + "render_depth_coarse",
               colorize_np(_2d(out["depth"]), cmap_name="jet"))
  logger.image(step, prefix + "occ_weight_map",
               colorize_np(_2d(anchor["occ_weight_map"]), cmap_name="gray"))
  logger.image(step, prefix + "exp_sf_mag",
               colorize_np(np.linalg.norm(out["exp_sf"], axis=-1),
                           cmap_name="gray"))
  logger.image(step, prefix + "gt_rgb_coarse", gt_image)
  logger.image(step, prefix + "gt_disp_coarse",
               colorize_np(gt_disp, cmap_name="jet"))

  # rendered-vs-GT flow wheels (reference train.py:729-759)
  flows = np.moveaxis(out["render_flows"], 2, 0)             # [V, H, W, 2]
  for ii in range(min(6, flows.shape[0])):
    logger.image(step, prefix + f"rd_flow_{ii}",
                 flow_to_image(flows[ii]) / 255.0)
  if gt_flows is not None:
    for ii in range(min(6, gt_flows.shape[0])):
      logger.image(step, prefix + f"gt_flow_{ii}",
                   flow_to_image(np.asarray(gt_flows[ii])) / 255.0)
  return ret
