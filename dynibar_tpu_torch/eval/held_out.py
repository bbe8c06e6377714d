"""Held-out novel views of the analytic scene, the measurement of both
convergence gates.

FF (port of ``held_out_views`` and ``eval_ff`` of
``scripts/ff_convergence_run.py``, :113-175): on the Nvidia-layout scene,
(viewpoint, time) pairs whose rig camera did not capture that frame,
rendered through ``render_image_ff`` and scored per stage.

Mono (port of ``final_camera``, ``make_eval_views`` and ``eval_views`` of
``scripts/convergence_run.py``, :103-164): on the monocular scene, the
middle frame's own camera and ``ConsistentScene.held_out_cameras()``,
cameras that training never sees, rendered through ``render_image_mono``.

Either way the ground truth is exact (``ConsistentScene.render``) and the
score is the PSNR over the frame less a 3% border per side (the
reference's output protocol, render_monocular_bt.py), and over the moving
disc where it is in view.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dynibar_tpu_torch.cli.render_monocular import render_batch_template
from dynibar_tpu_torch.config import RenderSettings
from dynibar_tpu_torch.core.cameras import make_camera
from dynibar_tpu_torch.data import png
from dynibar_tpu_torch.eval.metrics import masked_psnr
from dynibar_tpu_torch.render.render_image import (full_image_ray_batch,
                                                   render_image_ff,
                                                   render_image_mono)

View = Tuple[str, np.ndarray, int, np.ndarray, np.ndarray]
# a mono view: (disk-frame OpenCV camera-to-world 4x4, frame time)
MonoView = Tuple[np.ndarray, float]


def _crop3(h: int, w: int):
  """The frame less 3% of each side (at least one pixel)."""
  ch, cw = max(1, round(0.03 * h)), max(1, round(0.03 * w))
  return np.s_[ch:h - ch, cw:w - cw]


def _write_png(path: str, img: np.ndarray) -> None:
  png.write(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))


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
    crop = _crop3(h, w)
    for stage in ("coarse", "fine"):
      rgb = ret[f"outputs_{stage}_ref"]["rgb"].astype(np.float32)
      rec[f"psnr_{name}_{stage}_crop3"] = masked_psnr(
          rgb[crop], gt[crop], np.ones_like(gt[crop]))
      if stage == "fine" and dyn.any():
        dyn3 = np.repeat(dyn[..., None].astype(np.float32), 3, axis=-1)
        rec[f"psnr_{name}_fine_dyn"] = masked_psnr(rgb, gt, dyn3)
      if outdir is not None and stage == "fine":
        _write_png(os.path.join(outdir, f"{name}_{tag}_step{step:06d}.png"),
                   rgb)
    if outdir is not None:
      gt_path = os.path.join(outdir, f"{name}_gt.png")
      if not os.path.exists(gt_path):
        _write_png(gt_path, gt)
  return rec


def final_camera(scene, data, c2w_disk: np.ndarray) -> np.ndarray:
  """A disk-frame OpenCV camera in the loader's (scaled, recentred) world,
  through the constant rigid transform M = final @ inv(scaled disk) of
  frame 0, in f64; returned in f32."""
  cs = scene.c2w(0).astype(np.float64)
  cs[:3, 3] *= data.scale
  m = data.c2w[0].astype(np.float64) @ np.linalg.inv(cs)
  cq = c2w_disk.astype(np.float64).copy()
  cq[:3, 3] *= data.scale
  return (m @ cq).astype(np.float32)


def mono_eval_views(scene) -> Dict[str, MonoView]:
  """The mono gate's views: ``train_view`` (the middle frame's own
  camera), ``novel_0`` and ``novel_1`` (``scene.held_out_cameras()``)."""
  mid = scene.num_frames // 2
  views = {"train_view": (scene.c2w(mid), float(mid))}
  for k, (pose, tau) in enumerate(scene.held_out_cameras()):
    views[f"novel_{k}"] = (pose, tau)
  return views


def eval_mono(model, data, scene, cfg: RenderSettings, chunk_size: int,
              views: Dict[str, MonoView], outdir: Optional[str] = None,
              step: Optional[int] = None) -> Dict[str, float]:
  """Render each view at its frame's source stacks and score it:
  ``psnr_<view>`` (whole frame), ``psnr_<view>_crop3`` (the gate's) and,
  where the disc is in view, ``psnr_<view>_dyn``.  The virtual views of
  the template are drawn from ``RandomState(0)`` for every view.  With
  ``outdir`` the render goes to ``<view>_step<step>.png`` and the ground
  truth, once, to ``<view>_gt.png``."""
  rec = {}
  dev = model.device
  h, w = scene.h, scene.w
  crop = _crop3(h, w)
  for name, (c2w_disk, tau) in views.items():
    gt, _, dyn = scene.render(c2w_disk, tau)
    idx = int(round(tau))
    template = render_batch_template(data, idx, data.config.num_source_views,
                                     data.num_vv, np.random.RandomState(0))
    cam = make_camera(h, w, data.intrinsics[idx],
                      final_camera(scene, data, c2w_disk))
    rb = full_image_ray_batch(template, cam, device=dev)
    with torch.no_grad():
      featmaps = model.encode_featmaps(rb["src_rgbs"], rb["static_src_rgbs"])
    ret = render_image_mono(model, rb, featmaps, cfg, chunk_size, h, w,
                            device=dev)
    rgb = ret["outputs_coarse_ref"]["rgb"].astype(np.float32)
    rec[f"psnr_{name}"] = masked_psnr(rgb, gt, np.ones_like(gt))
    rec[f"psnr_{name}_crop3"] = masked_psnr(rgb[crop], gt[crop],
                                            np.ones_like(gt[crop]))
    if dyn.any():
      dyn3 = np.repeat(dyn[..., None].astype(np.float32), 3, axis=-1)
      rec[f"psnr_{name}_dyn"] = masked_psnr(rgb, gt, dyn3)
    if outdir is not None:
      _write_png(os.path.join(outdir, f"{name}_step{step:06d}.png"), rgb)
      gt_path = os.path.join(outdir, f"{name}_gt.png")
      if not os.path.exists(gt_path):
        _write_png(gt_path, gt)
  return rec
