"""Nvidia Dynamic Scenes benchmark evaluation.

Port of ``dynibar_tpu.eval.nvidia_eval`` (reference eval_nvidia.py:266-481):
frames 3..N-3 × the 11 of 12 round-robin viewpoints that are not the
frame's own, masked PSNR/SSIM/LPIPS over the full image, the dynamic
region (mv_masks) and its static complement, with running and final
averages.  The ground truth and masks are read with OpenCV's semantics
(``data/resize.py``), without OpenCV.  Under a mesh every rank renders its
share of each viewpoint's rays (``render_image_ff(mesh=...)``); rank 0
gathers the frame, computes the metrics, LPIPS and the tables, and logs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from dynibar_tpu_torch.config import DynibarConfig
from dynibar_tpu_torch.data.monocular import resize_nearest
from dynibar_tpu_torch.data.nvidia import NUM_VIEWPOINTS, NvidiaSceneData
from dynibar_tpu_torch.data.resize import imread_color, resize_area
from dynibar_tpu_torch.eval.lpips import LPIPSMetric
from dynibar_tpu_torch.eval.metrics import masked_psnr, masked_ssim
from dynibar_tpu_torch.models.dynibar import FFModel
from dynibar_tpu_torch.render.render_image import (full_image_ray_batch,
                                                   render_image_ff)
from dynibar_tpu_torch.utils.device import DeviceLike, resolve_device


def imread_resized(path: str, h: int, w: int) -> np.ndarray:
  """``cv2.resize(cv2.imread(path)[:, :, ::-1], (w, h), INTER_AREA) / 255``
  as float32."""
  return np.float32(resize_area(imread_color(path), h, w)) / 255.0


def mask_resized(path: str, h: int, w: int) -> np.ndarray:
  """``cv2.resize(np.float32(cv2.imread(path) > 1e-3), (w, h),
  INTER_NEAREST)``: a 3-channel 0/1 mask, in cv2.imread's BGR order."""
  bgr = imread_color(path)[:, :, ::-1]
  return resize_nearest(np.float32(bgr > 1e-3), h, w)


@dataclasses.dataclass
class MetricAccumulator:
  psnr: List[float] = dataclasses.field(default_factory=list)
  ssim: List[float] = dataclasses.field(default_factory=list)
  lpips: List[float] = dataclasses.field(default_factory=list)

  def add(self, psnr, ssim, lpips):
    self.psnr.append(psnr)
    self.ssim.append(ssim)
    if lpips is not None:
      self.lpips.append(lpips)

  def means(self) -> Dict[str, float]:
    out = {"psnr": float(np.mean(self.psnr)) if self.psnr else float("nan"),
           "ssim": float(np.mean(self.ssim)) if self.ssim else float("nan")}
    out["lpips"] = float(np.mean(self.lpips)) if self.lpips else float("nan")
    return out


def evaluate_scene(
    config: DynibarConfig,
    model: FFModel,
    scene: str,
    lpips_weights_dir: Optional[str] = None,
    frame_range: Optional[range] = None,
    log_fn: Callable[[str], None] = print,
    device: DeviceLike = None,
    mesh=None,
) -> Optional[Dict[str, Dict[str, float]]]:
  """Run the whole benchmark protocol on one scene with `model`'s
  weights; returns the full / dynamic / static metric tables (under
  ``mesh``, None on ranks other than 0).  `device` None means the CUDA
  card."""
  dev = resolve_device(device)
  is_main = mesh is None or mesh.is_main
  if not is_main:
    log_fn = _quiet
  data = NvidiaSceneData(config, scene, height=config.training_height)
  cfg = model.cfg
  lpips = LPIPSMetric(lpips_weights_dir if is_main else None, device=dev)
  full = MetricAccumulator()
  dyn = MetricAccumulator()
  stat = MetricAccumulator()

  frames = frame_range or range(3, data.num_frames - 3)
  for img_i in frames:
    t_frame = time.perf_counter()
    template = data.eval_batch(img_i, 0)
    # feature maps are per frame: encoded once for all 11 viewpoints; the
    # coarse stage sees the static sources whole, the fine stage with the
    # moving regions masked out when mask_static is set
    src = torch.as_tensor(template["src_rgbs"], device=dev)
    st_src = torch.as_tensor(template["static_src_rgbs"], device=dev)
    st_masked = st_src
    if config.mask_static:
      st_masked = st_src * torch.as_tensor(template["static_src_masks"],
                                           device=dev)[..., None]
    with torch.no_grad():
      coarse, fine = model.encode_featmaps(src, st_src,
                                           fine_static_src_rgbs=st_masked)
    rendered = 0
    for cam_i in range(NUM_VIEWPOINTS):
      if img_i % NUM_VIEWPOINTS == cam_i:
        continue  # skip the time-aligned viewpoint (eval_nvidia.py:317)
      t0 = time.perf_counter()
      batch = data.eval_batch(img_i, cam_i)
      rb = {k: v for k, v in batch.items() if k != "static_src_masks"}
      rb = full_image_ray_batch(rb, rb["camera"], device=dev)
      h = int(batch["camera"][0])
      w = int(batch["camera"][1])
      ret = render_image_ff(model, rb, coarse, fine, cfg, config.chunk_size,
                            h, w, device=dev, mesh=mesh)
      if ret is None:             # rank 0 scores the frame
        continue
      pred = ret["outputs_fine_ref"]["rgb"]

      valid = np.float32(pred.sum(-1, keepdims=True) > 1e-3)
      valid = np.tile(valid, (1, 1, 3))
      # The reference zeroes GT where the prediction is dark
      # (eval_nvidia.py:388-390), kept for parity; a mostly-dark
      # prediction (an unconverged or random-init model) would inflate
      # PSNR, so that case is logged
      invalid_frac = 1.0 - float(valid.mean())
      if invalid_frac > 0.05:
        log_fn(f"WARNING: frame {img_i} cam {cam_i}: valid-mask drops "
               f"{invalid_frac:.1%} of pixels (dark prediction); "
               "full/static/dynamic metrics are inflated for this frame")
      gt = imread_resized(data.gt_image_path(img_i, cam_i), h, w) * valid
      pred = pred * valid

      full.add(masked_psnr(gt, pred, valid), masked_ssim(gt, pred, valid),
               lpips(gt, pred, valid) if lpips.available else None)

      dmask = mask_resized(data.mask_path(img_i, cam_i), h, w)
      dyn.add(masked_psnr(gt, pred, dmask), masked_ssim(gt, pred, dmask),
              lpips(gt, pred, dmask) if lpips.available else None)
      smask = 1.0 - dmask
      stat.add(masked_psnr(gt, pred, smask), masked_ssim(gt, pred, smask),
               lpips(gt, pred, smask) if lpips.available else None)
      rendered += 1
      log_fn(f"frame {img_i} cam {cam_i}: "
             f"psnr={full.psnr[-1]:.2f} ssim={full.ssim[-1]:.4f} "
             f"({time.perf_counter() - t0:.3f}s)")

    log_fn(f"frame {img_i}: {rendered} viewpoints in "
           f"{time.perf_counter() - t_frame:.3f}s")
    log_fn(f"MOVING full={full.means()} dynamic={dyn.means()} "
           f"static={stat.means()}")

  if not is_main:
    return None
  result = {"full": full.means(), "dynamic": dyn.means(),
            "static": stat.means()}
  log_fn(f"FINAL {result}")
  return result


def _quiet(_: str) -> None:
  """The log of ranks other than 0."""
