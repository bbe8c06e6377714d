"""Synthetic on-disk scene in the reference dataset layout.

Port of ``dynibar_tpu.data.synthetic_scene.write_synthetic_scene``: the
same arrays, with the PNGs written by ``data/png.py`` (8-bit, filter 0).
It writes ``poses_bounds_cvd.npy``, ``images/``, ``images_WxH/``,
``disp/``, ``flow_i{1,2,3}/``, ``dynamic_masks/``, ``static_masks/``,
``source_virtual_views_WxH/`` and ``source_vv_poses.npy``, so the training
CLI runs from disk without downloaded data.  The scene paints the same
image for every camera pose: it drives the data path, not novel-view
quality.  ``write_synthetic_nvidia_scene`` adds the Nvidia benchmark's
ground truth on top, its JPEGs written by ``data/jpeg.py`` (the bytes
imageio writes).
"""

from __future__ import annotations

import os

import numpy as np

from dynibar_tpu_torch.data import jpeg, png


def write_synthetic_scene(root: str, scene: str = "synthetic",
                          num_frames: int = 12, height: int = 32,
                          width: int = 48, focal: float = 40.0,
                          seed: int = 0) -> str:
  """Create <root>/<scene>/dense/... ; returns the scene name.  ``seed``
  is accepted for the JAX writer's signature; the scene is analytic."""
  dense = os.path.join(root, scene, "dense")
  for sub in ("images", f"images_{width}x{height}", "disp", "flow_i1",
              "flow_i2", "flow_i3", "dynamic_masks", "static_masks"):
    os.makedirs(os.path.join(dense, sub), exist_ok=True)
  vv_dir = os.path.join(dense, f"source_virtual_views_{width}x{height}")
  os.makedirs(vv_dir, exist_ok=True)

  # a smooth moving blob over textured background gives the losses signal
  yy, xx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
  bg = np.stack([0.5 + 0.4 * np.sin(xx / 7.0), 0.5 + 0.4 * np.cos(yy / 5.0),
                 0.5 + 0.4 * np.sin((xx + yy) / 9.0)], axis=-1)

  rows, vv_poses = [], []
  for i in range(num_frames):
    cx = width * (0.3 + 0.4 * i / num_frames)
    cy = height * 0.5
    blob = np.exp(-(((xx - cx) ** 2) + (yy - cy) ** 2) / 20.0)
    img = np.clip(bg + blob[..., None] * np.array([0.5, -0.2, 0.1]), 0, 1)
    img8 = (img * 255).astype(np.uint8)
    png.write(os.path.join(dense, "images", f"{i:05d}.png"), img8)
    png.write(os.path.join(dense, f"images_{width}x{height}",
                                 f"{i:05d}.png"), img8)
    np.save(os.path.join(dense, "disp", f"{i:05d}.npy"),
            (0.1 + 0.2 * blob).astype(np.float32))
    dyn = (blob > 0.2).astype(np.uint8) * 255
    png.write(os.path.join(dense, "dynamic_masks", f"{i}.png"), dyn)
    png.write(os.path.join(dense, "static_masks", f"{i}.png"),
                    255 - dyn)
    for interval in (1, 2, 3):
      for tag, sign in (("fwd", 1.0), ("bwd", -1.0)):
        flow = np.zeros((height, width, 2), np.float32)
        flow[..., 0] = sign * interval * 0.4 * width / num_frames * blob
        np.savez(os.path.join(dense, f"flow_i{interval}",
                              f"{i:05d}_{tag}.npz"),
                 flow=flow, mask=np.ones((height, width), np.float32))

    pose = np.zeros((3, 5))
    pose[:3, :3] = np.eye(3)
    pose[0, 3] = 0.08 * i
    pose[:, 4] = [height, width, focal]
    rows.append(np.concatenate([pose.reshape(-1), [2.0, 12.0]]))

    frame_dir = os.path.join(vv_dir, f"{i:05d}")
    os.makedirs(frame_dir, exist_ok=True)
    frame_vv = []
    for k in range(8):
      png.write(os.path.join(frame_dir, f"{k:02d}.png"), img8)
      vpose = pose[:, :4].copy()
      vpose[1, 3] += 0.02 * k
      frame_vv.append(vpose)
    vv_poses.append(np.stack(frame_vv))

  np.save(os.path.join(dense, "poses_bounds_cvd.npy"), np.stack(rows))
  np.save(os.path.join(dense, "source_vv_poses.npy"),
          np.moveaxis(np.stack(vv_poses), 0, -1).astype(np.float32))
  return scene


def write_synthetic_nvidia_scene(root: str, scene: str = "Balloon1",
                                 num_frames: int = 12, height: int = 32,
                                 width: int = 48, seed: int = 0) -> str:
  """The Nvidia Dynamic Scenes benchmark layout on top of the monocular
  scene: ``mv_images/<idx>/camXX.jpg`` and ``mv_masks/<idx>/camXX.png``
  ground truth for the 12 round-robin viewpoints and ``coarse_masks/``
  (reference eval_nvidia.py:100-169 read paths), so the whole eval
  protocol runs.  Port of the JAX writer of the same name."""
  write_synthetic_scene(root, scene, num_frames=num_frames, height=height,
                        width=width, seed=seed)
  dense = os.path.join(root, scene, "dense")
  os.makedirs(os.path.join(dense, "coarse_masks"), exist_ok=True)
  yy, xx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
  for idx in range(num_frames):
    mv_img_dir = os.path.join(dense, "mv_images", f"{idx:05d}")
    mv_mask_dir = os.path.join(dense, "mv_masks", f"{idx:05d}")
    os.makedirs(mv_img_dir, exist_ok=True)
    os.makedirs(mv_mask_dir, exist_ok=True)
    cx = width * (0.3 + 0.4 * idx / num_frames)
    blob = np.exp(-(((xx - cx) ** 2) + (yy - height * 0.5) ** 2) / 20.0)
    dyn = (blob > 0.2).astype(np.uint8) * 255
    png.write(os.path.join(dense, "coarse_masks", f"{idx:05d}.png"),
              255 - dyn)  # 1 = static
    for cam in range(12):
      img = np.clip(0.5 + 0.3 * np.sin((xx + yy + cam + idx) / 9.0), 0, 1)
      img8 = (np.stack([img] * 3, axis=-1) * 255).astype(np.uint8)
      jpeg.write(os.path.join(mv_img_dir, f"cam{cam + 1:02d}.jpg"), img8)
      png.write(os.path.join(mv_mask_dir, f"cam{cam + 1:02d}.png"), dyn)
  return scene
