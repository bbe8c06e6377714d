"""A seeded Nvidia Dynamic Scenes layout on disk, as the port's eval reads it.

Frozen, seeded copy of ``write_synthetic_nvidia_scene`` in
dynibar_tpu_torch/data/synthetic_scene.py (commit a749e58): the video
frames (``images/``, ``images_WxH/``, ``poses_bounds_cvd.npy``), frame i
taken by rig camera ``i % 12`` as the benchmark's round-robin capture
does, ``coarse_masks/`` (1 = static), and for each scored frame of the
protocol (3 .. N-4) the ground truth of the 11 other viewpoints,
``mv_images/<idx>/camXX.jpg`` (baseline JPEG, quality 75, through the
frozen encoder in ``jpeg_encode.py``) and ``mv_masks/<idx>/camXX.png``.
The seed changes the textures, the blob's path and colour and the rig's
offsets; never a size or a file count.
"""

from __future__ import annotations

import concurrent.futures
import os
from typing import Dict

import numpy as np

from portbench.scenes import jpeg_encode
from portbench.scenes.mono import MonoScene, png_write

NUM_VIEWPOINTS = 12


class NvidiaScene(MonoScene):
  """The arrays of one seeded rig scene; ``write`` puts them on disk."""

  def __init__(self, seed: int, num_frames: int, height: int, width: int,
               focal: float, near: float = 2.0, far: float = 12.0):
    super().__init__(seed, num_frames, height, width, focal, near, far)
    rng = np.random.RandomState((seed + 17) % (2 ** 32))
    grid = np.array([(x, y) for y in range(3) for x in range(4)], np.float64)
    self.rig = np.concatenate(
        [0.06 * (grid - grid.mean(0)) + rng.uniform(-0.005, 0.005, (12, 2)),
         np.zeros((12, 1))], axis=1)                               # [12, 3]

  def shift(self, cam: int) -> int:
    """The viewpoint's horizontal parallax at mid depth, in pixels."""
    return int(round(self.rig[cam, 0] * self.focal / 4.0))

  def view8(self, i: int, cam: int) -> np.ndarray:
    return np.roll(self.image8(i), self.shift(cam), axis=1)

  def frame8(self, i: int) -> np.ndarray:
    return self.view8(i, i % NUM_VIEWPOINTS)

  def dyn8(self, i: int, cam: int) -> np.ndarray:
    return np.roll((self.blob(i) > 0.2).astype(np.uint8) * 255,
                   self.shift(cam), axis=1)

  def pose(self, i: int) -> np.ndarray:
    p = np.zeros((3, 5))
    p[:3, :3] = np.eye(3)
    p[:, 3] = self.rig[i % NUM_VIEWPOINTS]
    p[:, 4] = [self.h, self.w, self.focal]
    return p

  def poses_bounds(self) -> np.ndarray:
    return np.stack([np.concatenate([self.pose(i).reshape(-1),
                                     [self.near, self.far]])
                     for i in range(self.n)])

  def scored(self):
    """(frame, viewpoint) pairs of the protocol, in its order."""
    return [(i, c) for i in range(3, self.n - 3)
            for c in range(NUM_VIEWPOINTS) if c != i % NUM_VIEWPOINTS]

  def write(self, root: str, scene: str, workers: int = 8) -> Dict[str, int]:
    h, w, n = self.h, self.w, self.n
    dense = os.path.join(root, scene, "dense")
    for sub in ("images", f"images_{w}x{h}", "coarse_masks"):
      os.makedirs(os.path.join(dense, sub), exist_ok=True)
    for i in range(3, n - 3):
      os.makedirs(os.path.join(dense, "mv_images", f"{i:05d}"), exist_ok=True)
      os.makedirs(os.path.join(dense, "mv_masks", f"{i:05d}"), exist_ok=True)

    def frame(i: int) -> int:
      img8 = self.view8(i, i % NUM_VIEWPOINTS)
      nbytes = png_write(os.path.join(dense, "images", f"{i:05d}.png"), img8)
      nbytes += png_write(os.path.join(dense, f"images_{w}x{h}",
                                       f"{i:05d}.png"), img8)
      nbytes += png_write(os.path.join(dense, "coarse_masks", f"{i:05d}.png"),
                          255 - self.dyn8(i, i % NUM_VIEWPOINTS))
      return nbytes

    def truth(pair) -> int:
      i, c = pair
      path = os.path.join(dense, "mv_images", f"{i:05d}", f"cam{c + 1:02d}.jpg")
      data = jpeg_encode.encode(self.view8(i, c))
      with open(path, "wb") as fh:
        fh.write(data)
      return len(data) + png_write(
          os.path.join(dense, "mv_masks", f"{i:05d}", f"cam{c + 1:02d}.png"),
          self.dyn8(i, c))

    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
      total = sum(pool.map(frame, range(n)))
      total += sum(pool.map(truth, self.scored()))
    path = os.path.join(dense, "poses_bounds_cvd.npy")
    np.save(path, self.poses_bounds())
    total += os.path.getsize(path)
    return {"bytes": int(total), "files": 3 * n + 2 * len(self.scored()) + 1}
