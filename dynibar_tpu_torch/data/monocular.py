"""Monocular-video training dataset (host side).

Port of ``dynibar_tpu.data.monocular``: the same draws from the same
``RandomState`` give the same arrays.  The machine with the card has no
image library, so images and masks are read by ``data/png.py`` (frames
also by ``data/jpeg.py``, by their magic bytes: ``llff.read_image``) and the
two OpenCV calls become numpy / scipy with the same results: the
nearest-neighbour resize takes source index ``floor(dst * src / dst)``
with OpenCV's rounding of the factor (``cv2.INTER_NEAREST``) and the
erosion is
``scipy.ndimage.binary_erosion`` with ``border_value=1`` (``cv2.erode``'s
default border never erodes).  A camera's image size comes from its PNG
or JPEG header instead of a decode.

Rebuild of the reference ``MonocularDataset``
(ibrnet/data_loaders/monocular.py:17-426) emitting the *fixed-shape* ray
batches of data/ray_batch.py: the curriculum, view selection, flow/mask
loading and virtual-view logic all run here on the host so the jitted train
step stays pure (SURVEY.md §7 "Python-side randomness/curriculum").

Key behaviors preserved:
  * frames sampled uniformly from [3, N-3) each step (monocular.py:148);
  * temporal source views at offsets ±{1,2,3} + num_vv random virtual views;
  * epoch curriculum for the anchor pool:
    max_step = min(3, epoch // init_decay_epoch + 1) (monocular.py:217-222);
  * 0.5% chance to include the reference frame among anchor sources
    (monocular.py:241-242);
  * randomized-interval static view selection with pose-distance fill-in
    (monocular.py:276-298);
  * motion-mask erosion with a disk kernel (monocular.py:193-204);
  * depth range margins near*0.9 / far*1.5 (monocular.py:396-398).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
from scipy import ndimage

from dynibar_tpu_torch.config import DynibarConfig, RenderSettings
from dynibar_tpu_torch.core.cameras import make_camera
from dynibar_tpu_torch.data import llff
from dynibar_tpu_torch.data.ray_batch import (ANCHOR_CAND_OFFSETS,
                                              MONO_SRC_OFFSETS)
from dynibar_tpu_torch.data.view_selection import mono_static_pose_ids


def _imread_float(path: str) -> np.ndarray:
  return llff.read_image(path).astype(np.float32) / 255.0


def resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
  """``cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)``: output
  pixel (y, x) takes source (floor(y * H / h), floor(x * W / w)), the
  factor computed as OpenCV does, 1 / (h / H) in double precision (it
  differs from H / h in the last bit, and so does the floor)."""
  sh, sw = img.shape[:2]
  rows = np.minimum(np.floor(np.arange(h) * (1.0 / (h / sh))).astype(int),
                    sh - 1)
  cols = np.minimum(np.floor(np.arange(w) * (1.0 / (w / sw))).astype(int),
                    sw - 1)
  return img[rows][:, cols]


def erode(mask: np.ndarray, kernel: np.ndarray) -> np.ndarray:
  """``cv2.erode(mask, kernel)`` of a 0/1 float mask: the border counts as
  set, so nothing erodes from the image edge."""
  return ndimage.binary_erosion(mask > 0, structure=kernel.astype(bool),
                                border_value=1).astype(np.float32)


def _disk_kernel(radius: int) -> np.ndarray:
  """skimage.morphology.disk equivalent."""
  y, x = np.ogrid[-radius:radius + 1, -radius:radius + 1]
  return (x * x + y * y <= radius * radius).astype(np.uint8)


class MonocularSceneData:
  """Loads scene-level metadata once; emits per-step ray batches."""

  def __init__(self, config: DynibarConfig, scene: str,
               cfg: Optional[RenderSettings] = None):
    self.config = config
    self.scene_path = os.path.join(config.folder_path, scene, "dense")
    self.cfg = cfg or config.render_settings("mono")
    self.num_vv = config.num_vv
    self.erosion_radius = config.erosion_radius
    self.num_frames_sample = config.num_source_views
    self.max_range = config.max_range
    self.current_epoch = 0

    scene_meta = llff.load_scene_poses(
        self.scene_path, height=config.training_height, with_vv=True,
        render_idx=config.render_idx)
    poses = scene_meta["poses"]
    bds = scene_meta["bds"]
    self.scale = scene_meta["scale"]
    self.rgb_files = scene_meta["imgfiles"]
    self.render_poses = scene_meta["render_poses"]

    near = float(np.min(bds))
    # keep far scenes at >= 15 so the static model can explain
    # view-dependent effects (monocular.py:68-73)
    if np.max(bds) < 10:
      far = min(20.0, float(np.max(bds)) + 15.0)
    else:
      far = min(50.0, max(20.0, float(np.max(bds))))
    self.depth_range = np.array([near * 0.9, far * 1.5], np.float32)

    self.intrinsics, self.c2w = llff.batch_parse_llff_poses(poses)
    self.src_vv_c2w = llff.batch_parse_vv_poses(scene_meta["src_vv_poses"])
    self.num_frames = len(self.rgb_files)
    assert self.num_frames == poses.shape[0]
    self._rgb8: Dict[int, np.ndarray] = {}   # decoded frames, uint8

  def set_epoch(self, epoch: int):
    self.current_epoch = epoch

  # ------------------------------------------------------------------ IO --
  def _load_rgb(self, idx: int) -> np.ndarray:
    # each frame is decoded once: data/jpeg.py decodes in Python, and a
    # step reads 10-15 frames
    img = self._rgb8.get(idx)
    if img is None:
      img = self._rgb8.setdefault(idx,
                                  llff.read_image(self.rgb_files[idx]))
    return img[..., :3].astype(np.float32) / 255.0

  def _camera(self, idx: int) -> np.ndarray:
    h, w = llff.read_image_shape(self.rgb_files[idx])[:2]
    return make_camera(h, w, self.intrinsics[idx], self.c2w[idx])

  def _load_disp(self, idx: int) -> np.ndarray:
    name = os.path.basename(self.rgb_files[idx])[:-4] + ".npy"
    return np.load(os.path.join(self.scene_path, "disp", name)) / self.scale

  def _load_mask(self, idx: int, kind: str, shape) -> np.ndarray:
    path = os.path.join(os.path.dirname(os.path.dirname(self.rgb_files[idx])),
                        f"{kind}_masks", f"{idx}.png")
    m = 1.0 - _imread_float(path)
    if m.ndim == 3:
      m = m[..., 0]
    if kind == "dynamic":
      # erode at a canonical 288-height resolution (monocular.py:184-201)
      inter = resize_nearest(m, 288, int(round(288.0 * shape[1] / shape[0])))
      eroded = erode((inter > 1e-3).astype(np.float32),
                     _disk_kernel(self.erosion_radius))
      return np.float32(resize_nearest(eroded, shape[0], shape[1]))
    m = resize_nearest(m, shape[0], shape[1])
    return np.float32(m > 1e-3)

  def _load_flow(self, idx: int, offset: int):
    interval = abs(offset)
    tag = "fwd" if offset > 0 else "bwd"
    path = os.path.join(self.scene_path, f"flow_i{interval}",
                        f"{idx:05d}_{tag}.npz")
    data = np.load(path)
    return data["flow"], np.float32(data["mask"])

  def _load_vv(self, frame_idx: int, vv_idx: int):
    vv_dir = os.path.dirname(
        self.rgb_files[frame_idx].replace("images", "source_virtual_views"))
    path = os.path.join(vv_dir, f"{frame_idx:05d}", f"{vv_idx:02d}.png")
    rgb = _imread_float(path)[..., :3]
    h, w = rgb.shape[:2]
    cam = make_camera(h, w, self.intrinsics[frame_idx],
                      self.src_vv_c2w[frame_idx, vv_idx])
    return rgb, cam

  def _masked_src(self, idx: int) -> np.ndarray:
    rgb = self._load_rgb(idx)
    if not self.config.mask_src_view:
      return rgb
    path = os.path.join(os.path.dirname(os.path.dirname(self.rgb_files[idx])),
                        "dynamic_masks", f"{idx}.png")
    m = _imread_float(path)
    m = resize_nearest(m, rgb.shape[0], rgb.shape[1])
    if m.ndim == 2:
      m = m[..., None]
    return rgb * m

  # -------------------------------------------------------------- batch --
  def sample_batch(self, rng: np.random.RandomState, n_rays: int,
                   sample_mode: str = "uniform", center_ratio: float = 0.8,
                   pixel_rng: np.random.RandomState | None = None,
                   epoch: int | None = None) -> Dict[str, np.ndarray]:
    """One fixed-shape training ray batch.

    `epoch` sets the anchor curriculum's epoch (default: set_epoch's).  A
    prefetching caller passes the epoch its batch index falls in, so a
    batch does not depend on when its loader thread drew it.

    `pixel_rng`, when given, drives ONLY the pixel (ray-position) draws;
    every view-level draw (target frame, anchors, vv picks, static ids)
    stays on `rng`.  Multi-host data-parallel passes a per-process
    pixel_rng and a process-shared rng so replicated batch keys are
    bit-identical across hosts (the jax.make_array_from_process_local_data
    contract) while the globally-sharded ray axis carries disjoint pixels.
    """
    cfg = self.cfg
    prng = rng if pixel_rng is None else pixel_rng
    idx = rng.randint(3, self.num_frames - 3)
    rgb = self._load_rgb(idx)
    h, w = rgb.shape[:2]
    disp = self._load_disp(idx)
    motion_mask = self._load_mask(idx, "dynamic", (h, w))
    static_mask = self._load_mask(idx, "static", (h, w))

    # --- pixel selection (reference sample_ray.py:237-260) ---
    if sample_mode == "center":
      bh = int(h * (1 - center_ratio) / 2.0)
      bw = int(w * (1 - center_ratio) / 2.0)
      uu, vv = np.meshgrid(np.arange(bw, w - bw), np.arange(bh, h - bh))
      flat = (vv.reshape(-1) * w + uu.reshape(-1))
      sel = flat[prng.choice(flat.shape[0], size=n_rays, replace=False)]
    else:
      # uniform pixels, like the reference.  (A scanline-coherent
      # `coherent_ray_segment` mode lived here until round 4; it was
      # removed with strip_train after coherent batches alone measured a
      # ~10 dB novel-view convergence penalty at matched steps —
      # CONVERGENCE.md, DESIGN.md §3.)
      sel = prng.choice(h * w, size=n_rays, replace=False)
    py, px = np.divmod(sel, w)
    uv = np.stack([px, py], axis=-1).astype(np.float32)

    kinv = np.linalg.inv(self.intrinsics[idx][:3, :3])
    pix = np.concatenate([uv, np.ones_like(uv[:, :1])], axis=-1)
    ray_d = (self.c2w[idx][:3, :3] @ (kinv @ pix.T)).T.astype(np.float32)
    ray_o = np.broadcast_to(self.c2w[idx][:3, 3],
                            ray_d.shape).astype(np.float32).copy()

    # --- curriculum anchor selection ---
    epoch = self.current_epoch if epoch is None else epoch
    max_step = min(3, epoch // self.config.init_decay_epoch + 1)
    pool = list(range(1, max_step + 1)) + [-i for i in range(1, max_step + 1)]
    anchor_idx = idx + pool[rng.choice(len(pool))]

    # --- dynamic source views: temporal ±{1,2,3} + virtual views ---
    src_rgbs, src_cams, src_off, src_valid = [], [], [], []
    for o in MONO_SRC_OFFSETS:
      src_rgbs.append(self._load_rgb(idx + o))
      src_cams.append(self._camera(idx + o))
      src_off.append(o + 3)
      src_valid.append(1.0)
    for vv_i in rng.choice(8, size=self.num_vv, replace=False):
      r, c = self._load_vv(idx, int(vv_i))
      src_rgbs.append(r)
      src_cams.append(c)
      src_off.append(3)
      src_valid.append(1.0)

    # --- anchor source views ---
    anchor_ids = [anchor_idx + o for o in ANCHOR_CAND_OFFSETS
                  if 0 <= anchor_idx + o < self.num_frames
                  and anchor_idx + o != idx]
    if rng.choice([0, 1], p=[0.995, 0.005]):
      anchor_ids.append(idx)
    anchor_ids = list(np.sort(anchor_ids))
    a_rgbs, a_cams, a_off, a_valid, a_is_vv = [], [], [], [], []
    for i in anchor_ids:
      a_rgbs.append(self._load_rgb(i))
      a_cams.append(self._camera(i))
      a_off.append(int(np.clip(i - anchor_idx + 3, 0, 6)))
      a_valid.append(1.0)
      a_is_vv.append(0.0)
    for vv_i in rng.choice(8, size=self.num_vv, replace=False):
      r, c = self._load_vv(anchor_idx, int(vv_i))
      a_rgbs.append(r)
      a_cams.append(c)
      a_off.append(3)
      a_valid.append(1.0)
      a_is_vv.append(1.0)
    while len(a_rgbs) < cfg.num_views_anchor:
      a_rgbs.append(np.zeros_like(rgb))
      a_cams.append(a_cams[0])
      a_off.append(3)
      a_valid.append(0.0)
      a_is_vv.append(0.0)

    # --- static source views ---
    st_ids = mono_static_pose_ids(idx, self.num_frames,
                                  self.num_frames_sample, self.max_range,
                                  self.c2w[idx], self.c2w, rng)
    st_rgbs, st_cams, st_valid = [], [], []
    for i in st_ids[:cfg.num_views_static]:
      st_rgbs.append(self._masked_src(int(i)))
      st_cams.append(self._camera(int(i)))
      st_valid.append(1.0)
    while len(st_rgbs) < cfg.num_views_static:
      st_rgbs.append(np.zeros_like(rgb))
      st_cams.append(st_cams[0])
      st_valid.append(0.0)

    # --- flow supervision ---
    flows, fmasks = [], []
    for o in MONO_SRC_OFFSETS:
      fl, fm = self._load_flow(idx, o)
      flows.append(fl.reshape(-1, 2)[sel])
      fmasks.append(fm.reshape(-1, 1)[sel])

    return {
        "ray_o": ray_o, "ray_d": ray_d,
        "depth_range": self.depth_range,
        "camera": self._camera(idx), "uv_grid": uv,
        "ref_time": np.float32(idx / self.num_frames),
        "anchor_time": np.float32(anchor_idx / self.num_frames),
        "ref_frame_idx": np.int32(idx),
        "anchor_frame_idx": np.int32(anchor_idx),
        "src_rgbs": np.stack(src_rgbs),
        "src_cameras": np.stack(src_cams),
        "src_offset_idx": np.array(src_off, np.int32),
        "src_valid": np.array(src_valid, np.float32),
        "anchor_src_rgbs": np.stack(a_rgbs),
        "anchor_src_cameras": np.stack(a_cams),
        "anchor_offset_idx": np.array(a_off, np.int32),
        "anchor_valid": np.array(a_valid, np.float32),
        "anchor_is_vv": np.array(a_is_vv, np.float32),
        "static_src_rgbs": np.stack(st_rgbs),
        "static_src_cameras": np.stack(st_cams),
        "static_valid": np.array(st_valid, np.float32),
        "rgb": rgb.reshape(-1, 3)[sel],
        "disp": disp.reshape(-1)[sel].astype(np.float32),
        "motion_mask": motion_mask.reshape(-1)[sel],
        "static_mask": static_mask.reshape(-1)[sel],
        "flows": np.stack(flows).astype(np.float32),
        "flow_masks": np.stack(fmasks).astype(np.float32),
    }
