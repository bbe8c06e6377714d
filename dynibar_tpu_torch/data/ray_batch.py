"""The ray-batch contract + synthetic scene generator (numpy).

A copy of ``dynibar_tpu.data.ray_batch``'s generators, so the port and
``chip_smoke.py`` get their inputs without the JAX package.  Keys (R rays;
Vd/Vs padded view counts):

  ray_o, ray_d [R,3]; depth_range [2] (near, far); camera [34];
  uv_grid [R,2]; ref_time scalar; ref_frame_idx scalar int;
  src_rgbs [Vd,H,W,3], src_cameras [Vd,34], src_offset_idx [Vd] (offset+3),
  src_valid [Vd]; static_src_rgbs [Vs,H,W,3], static_src_cameras [Vs,34],
  static_valid [Vs]; plus anchor stacks and supervision fields.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from dynibar_tpu_torch.config import RenderSettings
from dynibar_tpu_torch.core.cameras import intrinsics_from_hwf, make_camera

MONO_SRC_OFFSETS = (1, 2, 3, -1, -2, -3)       # reference monocular.py:216
ANCHOR_CAND_OFFSETS = (3, 2, 1, 0, -1, -2, -3)  # reference monocular.py:231
FF_SRC_OFFSETS = (-3, -2, -1, 0, 1, 2, 3)       # reference eval_nvidia.py:92


def synthetic_poses(num: int, seed: int = 0) -> np.ndarray:
  """Smooth forward-facing camera path, c2w [N, 4, 4]."""
  rng = np.random.RandomState(seed)
  t = np.linspace(0, 1, num)
  c2ws = []
  for i in range(num):
    pos = np.array([0.5 * np.sin(2 * np.pi * t[i]), 0.1 * t[i], -0.2 * t[i]])
    angle = 0.05 * np.sin(2 * np.pi * t[i] + rng.uniform(0, 0.1))
    ca, sa = np.cos(angle), np.sin(angle)
    c2w = np.eye(4)
    c2w[:3, :3] = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]])
    c2w[:3, 3] = pos
    c2ws.append(c2w)
  return np.stack(c2ws).astype(np.float32)


def _textured_image(h: int, w: int, seed: int) -> np.ndarray:
  rng = np.random.RandomState(seed)
  yy, xx = np.meshgrid(np.linspace(0, 4, h), np.linspace(0, 4, w),
                       indexing="ij")
  img = np.stack([
      0.5 + 0.5 * np.sin(2 * np.pi * (xx * rng.uniform(0.5, 1.5)
                                      + rng.uniform())),
      0.5 + 0.5 * np.sin(2 * np.pi * (yy * rng.uniform(0.5, 1.5)
                                      + rng.uniform())),
      0.5 + 0.5 * np.sin(2 * np.pi * ((xx + yy) * rng.uniform(0.3, 0.8))),
  ], axis=-1)
  return img.astype(np.float32)


def synthetic_mono_batch(n_rays: int, h: int = 64, w: int = 96,
                         num_frames: int = 32, ref_idx: int = 10,
                         anchor_delta: int = 1, seed: int = 0,
                         num_views_dy: int = 9, num_views_anchor: int = 10,
                         num_views_static: int = 14, num_vv: int = 3,
                         scanline: bool = False) -> Dict[str, np.ndarray]:
  """Fixed-shape monocular ray batch on a synthetic scene.  scanline=True
  takes a contiguous pixel block (the layout a frame render feeds)."""
  rng = np.random.RandomState(seed)
  anchor_idx = ref_idx + anchor_delta
  poses = synthetic_poses(num_frames, seed)
  k = intrinsics_from_hwf(h, w, 0.9 * w)

  def camera_of(i):
    return make_camera(h, w, k, poses[i])

  if scanline:
    start = int(rng.randint(0, max(h * w - n_rays, 1)))
    sel = (start + np.arange(n_rays)) % (h * w)
  else:
    sel = rng.choice(h * w, size=n_rays, replace=n_rays > h * w)
  vv, uu = np.divmod(sel, w)
  uv = np.stack([uu, vv], axis=-1).astype(np.float32)
  pix = np.concatenate([uv, np.ones_like(uv[:, :1])], axis=-1)
  kinv = np.linalg.inv(k[:3, :3])
  c2w = poses[ref_idx]
  ray_d = (c2w[:3, :3] @ (kinv @ pix.T)).T.astype(np.float32)
  ray_o = np.broadcast_to(c2w[:3, 3], ray_d.shape).astype(np.float32).copy()

  def view_stack(ids, n_pad, offsets=None, vv_count=0, base_idx=None):
    rgbs, cams, off_idx, valid, is_vv = [], [], [], [], []
    for i in ids:
      rgbs.append(_textured_image(h, w, seed * 131 + i))
      cams.append(camera_of(i))
      off = 0 if offsets is None else (i - base_idx)
      off_idx.append(np.clip(off + 3, 0, 6))
      valid.append(1.0)
      is_vv.append(0.0)
    for _ in range(vv_count):
      rgbs.append(_textured_image(h, w, seed * 977 + len(rgbs)))
      cams.append(camera_of(base_idx if base_idx is not None else ids[0]))
      off_idx.append(3)
      valid.append(1.0)
      is_vv.append(1.0)
    while len(rgbs) < n_pad:
      rgbs.append(np.zeros((h, w, 3), np.float32))
      cams.append(camera_of(ids[0]))
      off_idx.append(3)
      valid.append(0.0)
      is_vv.append(0.0)
    return (np.stack(rgbs), np.stack(cams), np.array(off_idx, np.int32),
            np.array(valid, np.float32), np.array(is_vv, np.float32))

  src = view_stack([ref_idx + o for o in MONO_SRC_OFFSETS], num_views_dy,
                   offsets=True, vv_count=num_vv, base_idx=ref_idx)
  anchor_ids = sorted(anchor_idx + o for o in ANCHOR_CAND_OFFSETS
                      if 0 <= anchor_idx + o < num_frames
                      and anchor_idx + o != ref_idx)
  anchor = view_stack(anchor_ids, num_views_anchor, offsets=True,
                      vv_count=num_vv, base_idx=anchor_idx)
  stride = max(2, num_frames // (2 * 7))
  static_ids = [i for i in range(0, num_frames, stride) if i != ref_idx]
  static = view_stack(static_ids[:num_views_static], num_views_static)

  return {
      "ray_o": ray_o,
      "ray_d": ray_d,
      "depth_range": np.array([2.0 * 0.9, 20.0 * 1.5], np.float32),
      "camera": camera_of(ref_idx),
      "uv_grid": uv,
      "ref_time": np.float32(ref_idx / num_frames),
      "anchor_time": np.float32(anchor_idx / num_frames),
      "ref_frame_idx": np.int32(ref_idx),
      "anchor_frame_idx": np.int32(anchor_idx),
      "src_rgbs": src[0], "src_cameras": src[1],
      "src_offset_idx": src[2], "src_valid": src[3],
      "anchor_src_rgbs": anchor[0], "anchor_src_cameras": anchor[1],
      "anchor_offset_idx": anchor[2], "anchor_valid": anchor[3],
      "anchor_is_vv": anchor[4],
      "static_src_rgbs": static[0], "static_src_cameras": static[1],
      "static_valid": static[3],
      "rgb": rng.rand(n_rays, 3).astype(np.float32),
      "disp": rng.rand(n_rays).astype(np.float32),
      "motion_mask": (rng.rand(n_rays) > 0.5).astype(np.float32),
      "static_mask": (rng.rand(n_rays) > 0.5).astype(np.float32),
      "flows": rng.randn(6, n_rays, 2).astype(np.float32),
      "flow_masks": np.ones((6, n_rays, 1), np.float32),
  }


def synthetic_ff_batch(cfg: RenderSettings, n_rays: int, h: int = 64,
                       w: int = 96, num_frames: int = 48, ref_idx: int = 10,
                       seed: int = 0, scanline: bool = False
                       ) -> Dict[str, np.ndarray]:
  """Fixed-shape forward-facing (Nvidia-benchmark style) eval ray batch:
  7 temporal source views (offsets -3..3, no virtual views)."""
  mono = synthetic_mono_batch(
      n_rays, h, w, num_frames, ref_idx, anchor_delta=1, seed=seed,
      num_views_dy=7, num_views_anchor=0,
      num_views_static=cfg.num_views_static, num_vv=0, scanline=scanline)
  poses = synthetic_poses(num_frames, seed)
  k = intrinsics_from_hwf(h, w, 0.9 * w)
  rgbs, cams, off_idx = [], [], []
  for o in FF_SRC_OFFSETS:
    i = ref_idx + o
    rgbs.append(_textured_image(h, w, seed * 131 + i))
    cams.append(make_camera(h, w, k, poses[i]))
    off_idx.append(o + 3)
  rng = np.random.RandomState(seed + 7)
  # flow supervision in source-view order; offset 0 is never supervised
  flow_masks = np.ones((7, n_rays, 1), np.float32)
  flow_masks[3] = 0.0
  mono.update({
      "src_rgbs": np.stack(rgbs), "src_cameras": np.stack(cams),
      "src_offset_idx": np.array(off_idx, np.int32),
      "src_valid": np.ones(7, np.float32),
      "flows": rng.randn(7, n_rays, 2).astype(np.float32),
      "flow_masks": flow_masks,
  })
  return mono
