"""Held-out novel views of the analytic Nvidia-layout scene.

Port of ``held_out_views`` and ``eval_ff`` of
``scripts/ff_convergence_run.py`` (:113-175), the measurement of the FF
convergence gate: (viewpoint, time) pairs whose rig camera did not capture
that frame, with exact ground truth from ``ConsistentScene.render``,
rendered through ``render_image_ff`` and scored by PSNR over the frame
less a 3% border, per stage, and (fine stage) over the moving disc.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dynibar_tpu_torch.config import RenderSettings
from dynibar_tpu_torch.core.cameras import make_camera
from dynibar_tpu_torch.data import png
from dynibar_tpu_torch.eval.metrics import masked_psnr
from dynibar_tpu_torch.render.render_image import (full_image_ray_batch,
                                                   render_image_ff)

View = Tuple[str, np.ndarray, int, np.ndarray, np.ndarray]


def held_out_views(scene, data) -> List[View]:
  """Two (viewpoint, frame) pairs near the middle of the sequence whose rig
  camera did not capture that frame: [(name, camera [34], frame, gt rgb
  [H,W,3], moving-disc mask [H,W]), ...].  The camera is the loader-world
  pose of the same rig slot's nearest frame."""
  views = []
  mid = scene.num_frames // 2
  for frame, vp in ((mid, (mid + 5) % 12), (mid + 1, (mid + 1 + 6) % 12)):
    j = min(range(vp, scene.num_frames, 12), key=lambda j: abs(j - frame))
    cam = make_camera(scene.h, scene.w, data.intrinsics[j], data.c2w[j])
    gt, _, dyn = scene.render(scene.rig_c2w(vp), float(frame))
    views.append((f"f{frame}_cam{vp}", cam, frame, gt, dyn))
  return views


def eval_ff(model, data, cfg: RenderSettings, chunk_size: int,
            views: List[View], outdir: Optional[str] = None,
            step: Optional[int] = None, tag: str = "") -> Dict[str, float]:
  """Render each held-out view with both stages and score it:
  ``psnr_<view>_<stage>_crop3`` and, where the disc is in view,
  ``psnr_<view>_fine_dyn``.  With ``outdir`` the fine render goes to
  ``<view>_<tag>_step<step>.png`` and the ground truth, once, to
  ``<view>_gt.png``."""
  rec = {}
  dev = model.device
  for name, cam, frame, gt, dyn in views:
    template = data.eval_batch(frame, 0)
    template.pop("static_src_masks")
    rb = full_image_ray_batch(template, cam, device=dev)
    with torch.no_grad():
      coarse, fine = model.encode_featmaps(rb["src_rgbs"],
                                           rb["static_src_rgbs"])
    h, w = gt.shape[:2]
    ret = render_image_ff(model, rb, coarse, fine, cfg, chunk_size, h, w,
                          device=dev)
    ch, cw = max(1, round(0.03 * h)), max(1, round(0.03 * w))
    crop = np.s_[ch:h - ch, cw:w - cw]
    for stage in ("coarse", "fine"):
      rgb = ret[f"outputs_{stage}_ref"]["rgb"].astype(np.float32)
      rec[f"psnr_{name}_{stage}_crop3"] = masked_psnr(
          rgb[crop], gt[crop], np.ones_like(gt[crop]))
      if stage == "fine" and dyn.any():
        dyn3 = np.repeat(dyn[..., None].astype(np.float32), 3, axis=-1)
        rec[f"psnr_{name}_fine_dyn"] = masked_psnr(rgb, gt, dyn3)
      if outdir is not None and stage == "fine":
        png.write(os.path.join(outdir, f"{name}_{tag}_step{step:06d}.png"),
                  (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
    if outdir is not None:
      gt_path = os.path.join(outdir, f"{name}_gt.png")
      if not os.path.exists(gt_path):
        png.write(gt_path, (np.clip(gt, 0, 1) * 255).astype(np.uint8))
  return rec
