"""Camera/depth preprocessing for monocular videos.

Port of ``dynibar_tpu.cli.save_monocular_cameras`` (reference
save_monocular_cameras.py:1-149): converts dynamic-video-depth optimizer
output (``.npz`` per frame with K, c2w, depth) into the training layout —
resized images, ``disp/*.npy`` disparity, and an LLFF-style
``poses_bounds_cvd.npy`` with bounds at the 5/95 depth percentiles and
the LLFF axis permutation.  Without OpenCV or imageio: frames are read
through ``llff.read_image`` (PNG or JPEG, by magic bytes), resized with
``data/resize.py`` (``INTER_AREA`` either way, ``INTER_LINEAR`` for the
disparity) and written through ``data/png.py``.  All of it runs on the
host, as the JAX CLI's does.

Usage: python -m dynibar_tpu_torch.cli.save_monocular_cameras \
    --data_path <scene>/dense --cvd_path <dynamic_video_depth_out>
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import Any, Dict, List, Optional

import numpy as np

from dynibar_tpu_torch.data import llff, png
from dynibar_tpu_torch.data.resize import resize_area, resize_linear


def llff_from_opencv(c2w: np.ndarray) -> np.ndarray:
  """OpenCV c2w [3/4,4] -> LLFF 3x4 (inverse of parse_llff_pose's swap).

  parse_llff_pose does: llff [r, u, -b] columns -> negate cols 1:3; the
  saver applies the forward permutation [−u | r | b | t] row-swap used by
  the reference (save_monocular_cameras.py:133-143).
  """
  r = c2w[:3, :4]
  return np.concatenate(
      [r[:, 1:2], r[:, 0:1], -r[:, 2:3], r[:, 3:4]], axis=1)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
  """Run the CLI; returns the output image folder and the frame count."""
  ap = argparse.ArgumentParser()
  ap.add_argument("--data_path", required=True,
                  help="<scene>/dense directory to write into")
  ap.add_argument("--cvd_path", required=True,
                  help="dynamic-video-depth output dir with *.npz frames")
  ap.add_argument("--height", type=int, default=288)
  args = ap.parse_args(argv)

  npz_files = sorted(glob.glob(os.path.join(args.cvd_path, "*.npz")))
  if not npz_files:
    raise SystemExit(f"error: no npz files in {args.cvd_path}")

  img_files = sorted(glob.glob(os.path.join(args.data_path, "images", "*")))
  h0, w0 = llff.read_image_shape(img_files[0])[:2]
  height = args.height
  width = int(round(w0 * height / h0))

  out_img_dir = os.path.join(args.data_path, f"images_{width}x{height}")
  disp_dir = os.path.join(args.data_path, "disp")
  os.makedirs(out_img_dir, exist_ok=True)
  os.makedirs(disp_dir, exist_ok=True)

  poses_rows = []
  for i, (npz_path, img_path) in enumerate(zip(npz_files, img_files)):
    data = np.load(npz_path)
    k = np.asarray(data["K"] if "K" in data else data["intrinsics"],
                   np.float64)
    c2w = np.asarray(data["cam_c2w"] if "cam_c2w" in data
                     else data["pose_c2w"])
    while c2w.ndim > 2:
      c2w = c2w[0]
    depth = np.squeeze(np.asarray(data["depth"]))

    # intrinsics: accept [fx, fy, cx, cy] vectors or (possibly batched)
    # 3x3 matrices; the dynamic-video-depth optimizer stores K TRANSPOSED
    # (the reference un-transposes it, save_monocular_cameras.py:73) —
    # detect that by where the principal point landed
    if k.ndim == 1:
      k = np.array([[k[0], 0, k[2]], [0, k[1], k[3]], [0, 0, 1]])
    while k.ndim > 2:
      k = k[0]
    if np.any(k[2, :2] != 0) and not np.any(k[:2, 2] != 0):
      k = k.T
    # scale to the output resolution (row 0 by width, row 1 by height)
    src_h, src_w = depth.shape[:2]
    k = k.copy()
    k[0, :] *= width / src_w
    k[1, :] *= height / src_h
    fx, fy = float(k[0, 0]), float(k[1, 1])
    # the LLFF format carries ONE focal; the reference averages the two
    # (fx ~= fy asserted, save_monocular_cameras.py:81-83,123)
    if not abs(fx - fy) / (fx + fy) < 0.005:
      raise ValueError(f"{npz_path}: anisotropic focal unsupported "
                       f"(fx {fx}, fy {fy})")
    focal = (fx + fy) / 2.0

    img = llff.read_image(img_path)
    img_r = resize_area(img, height, width)
    name = os.path.splitext(os.path.basename(img_path))[0]
    png.write(os.path.join(out_img_dir, f"{name}.png"), img_r)

    disp = 1.0 / np.maximum(depth, 1e-6)
    disp_r = resize_linear(disp, height, width)
    np.save(os.path.join(disp_dir, f"{name}.npy"),
            disp_r.astype(np.float32))

    pose_llff = llff_from_opencv(np.asarray(c2w))
    hwf = np.array([[height], [width], [focal]])
    row = np.concatenate([pose_llff, hwf], axis=1).reshape(-1)

    near = np.percentile(depth, 5)
    far = np.percentile(depth, 95)
    poses_rows.append(np.concatenate([row, [near, far]]))
    print(f"[{i}] {name}: near={near:.3f} far={far:.3f}")

  np.save(os.path.join(args.data_path, "poses_bounds_cvd.npy"),
          np.stack(poses_rows).astype(np.float64))
  print(f"wrote {len(poses_rows)} poses to poses_bounds_cvd.npy")
  return {"image_dir": out_img_dir, "frames": len(poses_rows)}


if __name__ == "__main__":
  main(sys.argv[1:])
