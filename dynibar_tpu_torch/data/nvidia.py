"""Nvidia Dynamic Scenes benchmark dataset (host side).

Port of ``dynibar_tpu.data.nvidia`` (reference eval_nvidia.py:24-198):
the benchmark interleaves 12 fixed viewpoints in a round-robin over time;
for a render frame it selects the 7 temporal source views (offsets
-3..3) for the dynamic model and, for the static model, the
per-viewpoint frame closest in time, skipping the viewpoint that
coincides with the render index (11 static views).  The same draws from
the same ``RandomState`` give the same arrays.  Images and masks are read
by ``llff.read_image`` (the C++ host decoder, byte for byte as
``data/png.py`` and ``data/jpeg.py``) and the masks'
``cv2.INTER_NEAREST`` resize is ``monocular.resize_nearest``.
"""

from __future__ import annotations

import collections
import os
from typing import Dict, Optional

import numpy as np

from dynibar_tpu_torch.config import DynibarConfig, RenderSettings
from dynibar_tpu_torch.core.cameras import make_camera
from dynibar_tpu_torch.data import llff
from dynibar_tpu_torch.data.monocular import _imread_float, resize_nearest
from dynibar_tpu_torch.data.ray_batch import FF_SRC_OFFSETS

NUM_VIEWPOINTS = 12


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


class NvidiaSceneData:
  """Scene-level benchmark data: per-(frame, viewpoint) eval batches, and
  the FF fine stage's training batches."""

  def __init__(self, config: DynibarConfig, scene: str,
               cfg: Optional[RenderSettings] = None, height: int = 288):
    self.config = config
    self.cfg = cfg or config.render_settings("ff")
    self.scene_path = os.path.join(config.folder_path, scene, "dense")
    meta = llff.load_scene_poses(self.scene_path, height=height,
                                 with_vv=False, num_avg_imgs=NUM_VIEWPOINTS)
    self.rgb_files = meta["imgfiles"]
    self.num_frames = len(self.rgb_files)
    bds = meta["bds"]
    near = float(np.min(bds))
    far = float(np.max(bds)) + 15.0  # cover far content (eval_nvidia.py:48)
    self.depth_range = np.array([near * 0.9, far * 1.5], np.float32)
    self.intrinsics, self.c2w = llff.batch_parse_llff_poses(meta["poses"])

  def _camera(self, idx: int, shape) -> np.ndarray:
    return make_camera(shape[0], shape[1], self.intrinsics[idx],
                       self.c2w[idx])

  def gt_image_path(self, render_idx: int, viewpoint: int) -> str:
    return os.path.join(self.scene_path, "mv_images", f"{render_idx:05d}",
                        f"cam{viewpoint + 1:02d}.jpg")

  def mask_path(self, render_idx: int, viewpoint: int) -> str:
    return os.path.join(self.scene_path, "mv_masks", f"{render_idx:05d}",
                        f"cam{viewpoint + 1:02d}.png")

  def coarse_mask(self, idx: int, shape) -> np.ndarray:
    """Motion mask used to hide dynamic content from the static sources
    (reference eval_nvidia.py:156-169)."""
    if not (self.config.mask_static and 3 <= idx < self.num_frames - 3):
      return np.ones(shape[:2], np.float32)
    path = os.path.join(os.path.dirname(os.path.dirname(self.rgb_files[idx])),
                        "coarse_masks", f"{idx:05d}.png")
    return resize_nearest(_imread_float(path), shape[0], shape[1])

  # -------------------------------------------------------------- train --

  def set_epoch(self, epoch: int) -> None:
    """Pipeline-protocol hook; the FF sampler has no curriculum."""
    self.current_epoch = epoch

  def _motion_mask(self, idx: int, shape) -> np.ndarray:
    """Dynamic-region indicator from coarse_masks (1 = moving), ones
    when the scene ships no masks."""
    path = os.path.join(self.scene_path, "coarse_masks", f"{idx:05d}.png")
    if not os.path.isfile(path):
      return np.ones(shape[:2], np.float32)
    m = resize_nearest(_imread_float(path), shape[0], shape[1])
    return (1.0 - m).astype(np.float32)  # mask files are 1 = static

  def _try_flow(self, idx: int, offset: int, shape):
    """Monocular-layout flow files if the scene provides them, else zeros
    with a zero mask (the flow term vanishes)."""
    tag = "fwd" if offset > 0 else "bwd"
    path = os.path.join(self.scene_path, f"flow_i{abs(offset)}",
                        f"{idx:05d}_{tag}.npz")
    if os.path.isfile(path):
      data = np.load(path)
      return (data["flow"],
              np.asarray(data["mask"], np.float32).reshape(
                  shape[0], shape[1], 1))
    return (np.zeros(shape[:2] + (2,), np.float32),
            np.zeros(shape[:2] + (1,), np.float32))

  def sample_batch(self, rng: np.random.RandomState, n_rays: int,
                   sample_mode: str = "uniform",
                   pixel_rng: Optional[np.random.RandomState] = None
                   ) -> Dict[str, np.ndarray]:
    """Fixed-shape FF training ray batch: target rays from a sequence
    frame, 7 temporal sources (offsets -3..3, the frame itself included,
    eval_nvidia.py:92), per-viewpoint static sources and mono-style anchor
    views for the cross-time branch.  ``pixel_rng``, when given, draws the
    ray positions alone; the view-level draws stay on ``rng``."""
    del sample_mode
    cfg = self.cfg
    prng = rng if pixel_rng is None else pixel_rng
    idx = int(rng.randint(3, self.num_frames - 3))
    rgb = _imread_float(self.rgb_files[idx])[..., :3]
    h, w = rgb.shape[:2]
    motion_mask = self._motion_mask(idx, (h, w))

    sel = prng.choice(h * w, size=n_rays, replace=False)
    py, px = np.divmod(sel, w)
    uv = np.stack([px, py], axis=-1).astype(np.float32)
    kinv = np.linalg.inv(self.intrinsics[idx][:3, :3])
    pix = np.concatenate([uv, np.ones_like(uv[:, :1])], axis=-1)
    ray_d = (self.c2w[idx][:3, :3] @ (kinv @ pix.T)).T.astype(np.float32)
    ray_o = np.broadcast_to(self.c2w[idx][:3, 3],
                            ray_d.shape).astype(np.float32).copy()

    anchor_idx = idx + int(rng.choice([-1, 1]))

    src_rgbs, src_cams, src_off = [], [], []
    for o in FF_SRC_OFFSETS:
      img = _imread_float(self.rgb_files[idx + o])[..., :3]
      src_rgbs.append(img)
      src_cams.append(self._camera(idx + o, img.shape))
      src_off.append(o + 3)

    anchor_ids = [anchor_idx + o for o in FF_SRC_OFFSETS
                  if 0 <= anchor_idx + o < self.num_frames
                  and anchor_idx + o != idx]
    a_rgbs, a_cams, a_off, a_valid = [], [], [], []
    for i in anchor_ids[:cfg.num_views_anchor]:
      img = _imread_float(self.rgb_files[i])[..., :3]
      a_rgbs.append(img)
      a_cams.append(self._camera(i, img.shape))
      a_off.append(int(np.clip(i - anchor_idx + 3, 0, 6)))
      a_valid.append(1.0)
    while len(a_rgbs) < cfg.num_views_anchor:
      a_rgbs.append(np.zeros_like(rgb))
      a_cams.append(a_cams[0])
      a_off.append(3)
      a_valid.append(0.0)

    st_ids = nvidia_static_pose_ids(idx, self.num_frames)
    st_rgbs, st_cams, st_valid = [], [], []
    for i in st_ids[:cfg.num_views_static]:
      img = _imread_float(self.rgb_files[int(i)])[..., :3]
      st_rgbs.append(img * self.coarse_mask(int(i), img.shape)[..., None])
      st_cams.append(self._camera(int(i), img.shape))
      st_valid.append(1.0)
    while len(st_rgbs) < cfg.num_views_static:
      st_rgbs.append(np.zeros_like(rgb))
      st_cams.append(st_cams[0])
      st_valid.append(0.0)

    # flow GT in source-view order (FF_SRC_OFFSETS): render_flows[v] is
    # the rendered flow toward source view v; offset 0 (the frame itself)
    # is never supervised
    flows, fmasks = [], []
    for o in FF_SRC_OFFSETS:
      if o == 0:
        fl = np.zeros((h, w, 2), np.float32)
        fm = np.zeros((h, w, 1), np.float32)
      else:
        fl, fm = self._try_flow(idx, o, (h, w))
      flows.append(fl.reshape(-1, 2)[sel])
      fmasks.append(fm.reshape(-1, 1)[sel])

    return {
        "ray_o": ray_o, "ray_d": ray_d,
        "depth_range": self.depth_range,
        "camera": self._camera(idx, (h, w)), "uv_grid": uv,
        "ref_time": np.float32(idx / self.num_frames),
        "anchor_time": np.float32(anchor_idx / self.num_frames),
        "ref_frame_idx": np.int32(idx),
        "anchor_frame_idx": np.int32(anchor_idx),
        "src_rgbs": np.stack(src_rgbs),
        "src_cameras": np.stack(src_cams),
        "src_offset_idx": np.array(src_off, np.int32),
        "src_valid": np.ones(len(src_rgbs), np.float32),
        "anchor_src_rgbs": np.stack(a_rgbs),
        "anchor_src_cameras": np.stack(a_cams),
        "anchor_offset_idx": np.array(a_off, np.int32),
        "anchor_valid": np.array(a_valid, np.float32),
        "anchor_is_vv": np.zeros(len(a_rgbs), np.float32),
        "static_src_rgbs": np.stack(st_rgbs),
        "static_src_cameras": np.stack(st_cams),
        "static_valid": np.array(st_valid, np.float32),
        "rgb": rgb.reshape(-1, 3)[sel],
        "motion_mask": motion_mask.reshape(-1)[sel],
        "static_mask": motion_mask.reshape(-1)[sel],
        "flows": np.stack(flows).astype(np.float32),
        "flow_masks": np.stack(fmasks).astype(np.float32),
    }

  def eval_batch(self, render_idx: int, viewpoint: int
                 ) -> Dict[str, np.ndarray]:
    """View-stack template and target camera of one benchmark render;
    ``render_image.full_image_ray_batch`` adds the per-ray fields."""
    src_rgbs, src_cams, off_idx = [], [], []
    for o in FF_SRC_OFFSETS:
      i = render_idx + o
      img = _imread_float(self.rgb_files[i])[..., :3]
      src_rgbs.append(img)
      src_cams.append(self._camera(i, img.shape))
      off_idx.append(o + 3)

    st_ids = nvidia_static_pose_ids(render_idx, self.num_frames)
    st_rgbs, st_cams, st_masks, st_valid = [], [], [], []
    for i in st_ids[: self.cfg.num_views_static]:
      img = _imread_float(self.rgb_files[int(i)])[..., :3]
      st_rgbs.append(img)
      st_cams.append(self._camera(int(i), img.shape))
      st_masks.append(self.coarse_mask(int(i), img.shape))
      st_valid.append(1.0)
    while len(st_rgbs) < self.cfg.num_views_static:
      st_rgbs.append(np.zeros_like(st_rgbs[0]))
      st_cams.append(st_cams[0])
      st_masks.append(np.ones_like(st_masks[0]))
      st_valid.append(0.0)

    h, w = src_rgbs[0].shape[:2]
    return {
        "camera": self._camera(viewpoint, (h, w)),
        "depth_range": self.depth_range,
        "ref_time": np.float32(render_idx / self.num_frames),
        "anchor_time": np.float32(0.0),
        "ref_frame_idx": np.int32(render_idx),
        "anchor_frame_idx": np.int32(render_idx),
        "src_rgbs": np.stack(src_rgbs),
        "src_cameras": np.stack(src_cams),
        "src_offset_idx": np.array(off_idx, np.int32),
        "src_valid": np.ones(len(src_rgbs), np.float32),
        "static_src_rgbs": np.stack(st_rgbs),
        "static_src_cameras": np.stack(st_cams),
        "static_src_masks": np.stack(st_masks),
        "static_valid": np.array(st_valid, np.float32),
    }
