"""A seeded monocular scene on disk, in the layout the port's data path reads.

Frozen, seeded copy of ``write_synthetic_scene`` in
dynibar_tpu_torch/data/synthetic_scene.py (commit a749e58), with the PNG
encoder of dynibar_tpu_torch/data/png.py: ``poses_bounds_cvd.npy``,
``images/``, ``images_WxH/``, ``disp/``, ``flow_i{1,2,3}/`` (uncompressed
``.npz``, as google/dynibar's preprocessing writes them),
``dynamic_masks/``, ``static_masks/``, ``source_virtual_views_WxH/`` and
``source_vv_poses.npy``.  What the seed changes: the background texture,
the moving blob's path and colour, the camera path, the virtual views'
offsets and the flows.  What it never changes: every size (frames,
height, width, views, files), so every seed does the same work.  PNGs are
written at zlib level 1 (the decoder reads any level) on a few threads,
to keep the set-up short.
"""

from __future__ import annotations

import concurrent.futures
import os
import struct
import zlib
from typing import Dict

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, body: bytes) -> bytes:
  return (struct.pack(">I", len(body)) + kind + body
          + struct.pack(">I", zlib.crc32(kind + body)))


def png_encode(img: np.ndarray, level: int = 1) -> bytes:
  """uint8 [H, W] or [H, W, 3] -> PNG bytes (filter 0)."""
  img = np.asarray(img, np.uint8)
  if img.ndim == 2:
    img = img[..., None]
  h, w, c = img.shape
  color = {1: 0, 3: 2, 4: 6}[c]
  rows = np.concatenate([np.zeros((h, 1), np.uint8),
                         np.ascontiguousarray(img).reshape(h, w * c)], 1)
  return (_SIGNATURE
          + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
          + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
          + _chunk(b"IEND", b""))


def png_write(path: str, img: np.ndarray) -> int:
  data = png_encode(img)
  with open(path, "wb") as fh:
    fh.write(data)
  return len(data)


class MonoScene:
  """The arrays of one seeded scene; ``write`` puts them on disk."""

  def __init__(self, seed: int, num_frames: int, height: int, width: int,
               focal: float, near: float = 2.0, far: float = 12.0):
    self.seed, self.n, self.h, self.w = seed, num_frames, height, width
    self.focal, self.near, self.far = focal, near, far
    rng = np.random.RandomState(seed % (2 ** 32))
    yy, xx = np.meshgrid(np.arange(height, dtype=np.float64),
                         np.arange(width, dtype=np.float64), indexing="ij")
    self._yy, self._xx = yy, xx
    freq = rng.uniform(0.03, 0.2, size=(3, 2))
    phase = rng.uniform(0, 2 * np.pi, size=3)
    self.bg = np.stack([0.5 + 0.4 * np.sin(freq[c, 0] * xx + freq[c, 1] * yy
                                           + phase[c]) for c in range(3)],
                       axis=-1)
    self.blob_rgb = rng.uniform(-0.4, 0.4, size=3)
    self.blob_y = rng.uniform(0.3, 0.7)
    self.blob_x0, self.blob_dx = rng.uniform(0.2, 0.4), rng.uniform(0.2, 0.4)
    self.cam_step = rng.uniform(0.04, 0.1, size=3) * np.array([1, 0.3, 0.1])
    self.vv_step = rng.uniform(0.01, 0.03)

  def blob(self, i: int) -> np.ndarray:
    cx = self.w * (self.blob_x0 + self.blob_dx * i / self.n)
    cy = self.h * self.blob_y
    r2 = (self.h * 0.08) ** 2
    return np.exp(-((self._xx - cx) ** 2 + (self._yy - cy) ** 2) / r2)

  def image8(self, i: int) -> np.ndarray:
    img = np.clip(self.bg + self.blob(i)[..., None] * self.blob_rgb, 0, 1)
    return (img * 255).astype(np.uint8)

  def frame8(self, i: int) -> np.ndarray:
    """Video frame i as written to ``images_WxH/``."""
    return self.image8(i)

  def pose(self, i: int) -> np.ndarray:
    p = np.zeros((3, 5))
    p[:3, :3] = np.eye(3)
    p[:, 3] = self.cam_step * i
    p[:, 4] = [self.h, self.w, self.focal]
    return p

  def poses_bounds(self) -> np.ndarray:
    """poses_bounds_cvd.npy: [N, 17] LLFF poses and (near, far)."""
    return np.stack([np.concatenate([self.pose(i).reshape(-1),
                                     [self.near, self.far]])
                     for i in range(self.n)])

  def vv_poses(self) -> np.ndarray:
    """source_vv_poses.npy: [8, 3, 4, N] virtual-view poses."""
    out = []
    for i in range(self.n):
      frame_vv = []
      for k in range(8):
        vpose = self.pose(i)[:, :4].copy()
        vpose[1, 3] += self.vv_step * (k + 1)
        frame_vv.append(vpose)
      out.append(np.stack(frame_vv))
    return np.moveaxis(np.stack(out), 0, -1).astype(np.float32)

  def flow(self, i: int, interval: int, sign: float) -> np.ndarray:
    """Frame i's optical flow to frame i + sign * interval [H, W, 2]."""
    flow = np.zeros((self.h, self.w, 2), np.float32)
    flow[..., 0] = sign * interval * self.blob_dx * self.w / self.n \
        * self.blob(i)
    return flow

  def write(self, root: str, scene: str, workers: int = 4) -> Dict[str, int]:
    """Write the scene under ``root/scene/dense``; returns the bytes and
    files written."""
    h, w, n = self.h, self.w, self.n
    dense = os.path.join(root, scene, "dense")
    subs = ("images", f"images_{w}x{h}", "disp", "flow_i1", "flow_i2",
            "flow_i3", "dynamic_masks", "static_masks")
    for sub in subs:
      os.makedirs(os.path.join(dense, sub), exist_ok=True)
    vv_dir = os.path.join(dense, f"source_virtual_views_{w}x{h}")
    os.makedirs(vv_dir, exist_ok=True)

    def frame(i: int) -> int:
      nbytes = 0
      img8 = self.image8(i)
      blob = self.blob(i)
      nbytes += png_write(os.path.join(dense, "images", f"{i:05d}.png"), img8)
      nbytes += png_write(os.path.join(dense, f"images_{w}x{h}",
                                       f"{i:05d}.png"), img8)
      disp_path = os.path.join(dense, "disp", f"{i:05d}.npy")
      np.save(disp_path, (0.1 + 0.2 * blob).astype(np.float32))
      nbytes += os.path.getsize(disp_path)
      dyn = (blob > 0.2).astype(np.uint8) * 255
      nbytes += png_write(os.path.join(dense, "dynamic_masks", f"{i}.png"),
                          dyn)
      nbytes += png_write(os.path.join(dense, "static_masks", f"{i}.png"),
                          255 - dyn)
      ones = np.ones((h, w), np.float32)
      for interval in (1, 2, 3):
        for tag, sign in (("fwd", 1.0), ("bwd", -1.0)):
          flow = self.flow(i, interval, sign)
          path = os.path.join(dense, f"flow_i{interval}",
                              f"{i:05d}_{tag}.npz")
          np.savez(path, flow=flow, mask=ones)
          nbytes += os.path.getsize(path)
      frame_dir = os.path.join(vv_dir, f"{i:05d}")
      os.makedirs(frame_dir, exist_ok=True)
      for k in range(8):
        shifted = np.roll(img8, shift=(k + 1) * 3, axis=1)
        nbytes += png_write(os.path.join(frame_dir, f"{k:02d}.png"), shifted)
      return nbytes

    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
      total = sum(pool.map(frame, range(n)))

    for name, arr in (("poses_bounds_cvd.npy", self.poses_bounds()),
                      ("source_vv_poses.npy", self.vv_poses())):
      path = os.path.join(dense, name)
      np.save(path, arr)
      total += os.path.getsize(path)
    return {"bytes": int(total), "files": n * (5 + 6 + 8) + 2}
