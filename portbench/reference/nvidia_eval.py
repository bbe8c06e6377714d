"""The reference's Nvidia-protocol viewpoint: batch, render, scores.

Written for the benchmark after dynibar_tpu_torch/data/nvidia.py
(``NvidiaSceneData.eval_batch``, ``nvidia_static_pose_ids``) and
dynibar_tpu_torch/eval/nvidia_eval.py (``evaluate_scene``'s per-viewpoint
body) at commit a749e58.  It reads nothing from disk: the frames, masks,
poses and ground-truth bytes come from the benchmark's scene object.
"""

from __future__ import annotations

import collections
from typing import Any, Dict

import numpy as np
import torch

from portbench.reference import llff
from portbench.reference.cameras import make_camera
from portbench.reference.jpeg_decode import decode as jpeg_decode
from portbench.reference.metrics import masked_psnr, masked_ssim
from portbench.reference.render_image import (full_image_ray_batch,
                                              render_image_ff)

NUM_VIEWPOINTS = 12
FF_SRC_OFFSETS = (-3, -2, -1, 0, 1, 2, 3)


def nvidia_static_pose_ids(render_idx: int, num_frames: int) -> np.ndarray:
  """Closest same-viewpoint frames, skipping the render viewpoint
  (reference eval_nvidia.py:100-119)."""
  groups = collections.defaultdict(list)
  for i in range(num_frames):
    if i % NUM_VIEWPOINTS == render_idx % NUM_VIEWPOINTS:
      continue
    groups[i % NUM_VIEWPOINTS].append(i)
  ids = []
  for key in groups:
    arr = np.array(groups[key])
    ids.append(int(arr[np.argmin(np.abs(arr - render_idx))]))
  return np.sort(np.array(ids))


class SceneGeometry:
  """Cameras and depth range of the scene, from its poses array."""

  def __init__(self, scene, height: int):
    meta = llff.load_scene_poses(scene.poses_bounds(), (scene.h, scene.w),
                                 height=height, with_vv=False,
                                 num_avg_imgs=NUM_VIEWPOINTS)
    bds = meta["bds"]
    near, far = float(np.min(bds)), float(np.max(bds)) + 15.0
    self.depth_range = np.array([near * 0.9, far * 1.5], np.float32)
    self.intrinsics, self.c2w = llff.batch_parse_llff_poses(meta["poses"])
    self.num_frames = scene.n
    self.shape = (scene.h, scene.w)

  def camera(self, idx: int) -> np.ndarray:
    return make_camera(self.shape[0], self.shape[1], self.intrinsics[idx],
                       self.c2w[idx])


def eval_template(scene, geo: SceneGeometry, render_idx: int, viewpoint: int,
                  num_views_static: int, mask_static: bool
                  ) -> Dict[str, Any]:
  """The viewpoint's view stack and target camera."""
  def frame(i):
    return scene.view8(i, i % NUM_VIEWPOINTS).astype(np.float32) / 255.0

  src = [frame(render_idx + o) for o in FF_SRC_OFFSETS]
  st_ids = nvidia_static_pose_ids(render_idx, geo.num_frames)
  st, st_masks = [], []
  for i in st_ids[:num_views_static]:
    i = int(i)
    st.append(frame(i))
    if mask_static and 3 <= i < geo.num_frames - 3:
      st_masks.append((255 - scene.dyn8(i, i % NUM_VIEWPOINTS))
                      .astype(np.float32) / 255.0)
    else:
      st_masks.append(np.ones(geo.shape, np.float32))
  st_valid = [1.0] * len(st)
  while len(st) < num_views_static:
    st.append(np.zeros_like(st[0]))
    st_masks.append(np.ones_like(st_masks[0]))
    st_ids = np.concatenate([st_ids, st_ids[:1]])
    st_valid.append(0.0)
  st_cams = [geo.camera(int(i)) for i in st_ids[:num_views_static]]
  return {
      "camera": geo.camera(viewpoint),
      "depth_range": geo.depth_range,
      "ref_time": np.float32(render_idx / geo.num_frames),
      "anchor_time": np.float32(0.0),
      "ref_frame_idx": np.int32(render_idx),
      "anchor_frame_idx": np.int32(render_idx),
      "src_rgbs": np.stack(src),
      "src_cameras": np.stack([geo.camera(render_idx + o)
                               for o in FF_SRC_OFFSETS]),
      "src_offset_idx": np.array([o + 3 for o in FF_SRC_OFFSETS], np.int32),
      "src_valid": np.ones(len(src), np.float32),
      "static_src_rgbs": np.stack(st),
      "static_src_cameras": np.stack(st_cams),
      "static_src_masks": np.stack(st_masks),
      "static_valid": np.array(st_valid, np.float32),
  }


def featmaps(model, template, mask_static: bool, device):
  src = torch.as_tensor(template["src_rgbs"], device=device)
  st = torch.as_tensor(template["static_src_rgbs"], device=device)
  st_masked = st
  if mask_static:
    st_masked = st * torch.as_tensor(template["static_src_masks"],
                                     device=device)[..., None]
  with torch.no_grad():
    return model.encode_featmaps(src, st, fine_static_src_rgbs=st_masked)


def render(model, cfg, template, coarse, fine, chunk: int, device
           ) -> np.ndarray:
  """The viewpoint's fine rgb [H, W, 3]."""
  rb = {k: v for k, v in template.items() if k != "static_src_masks"}
  rb = full_image_ray_batch(rb, rb["camera"], device=device)
  h, w = int(template["camera"][0]), int(template["camera"][1])
  ret = render_image_ff(model, rb, coarse, fine, cfg, chunk, h, w,
                        device=device, kernels=False)
  return ret["outputs_fine_ref"]["rgb"]


def scores(pred: np.ndarray, gt_jpeg: bytes, dyn_mask8: np.ndarray
           ) -> Dict[str, float]:
  """Full-image PSNR and SSIM of ``pred`` as the protocol scores it: the
  ground truth zeroed where the prediction is dark."""
  valid = np.tile(np.float32(pred.sum(-1, keepdims=True) > 1e-3), (1, 1, 3))
  gt = np.float32(jpeg_decode(gt_jpeg)[..., :3]) / 255.0 * valid
  pred = pred * valid
  out = {"psnr": masked_psnr(gt, pred, valid),
         "ssim": masked_ssim(gt, pred, valid)}
  dmask = np.repeat(np.float32(dyn_mask8 > 1e-3)[..., None], 3, axis=-1)
  out["psnr_dynamic"] = masked_psnr(gt, pred, dmask)
  return out
