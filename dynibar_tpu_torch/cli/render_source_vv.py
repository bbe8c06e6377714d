"""Virtual source-view preprocessing.

Port of ``dynibar_tpu.cli.render_source_vv`` (reference
render_source_vv.py:1-330): for every video frame, forward-splat the RGBD
frame (``ops/splat.softmax_splat``, on the card) to 8 poses drawn from
two "wander" cycles around the frame's camera
(``data/llff.render_vv_wander_paths``), write
``source_virtual_views_WxH/<frame>/<k>.png`` and ``source_vv_poses.npy``.

Faithful to the reference recipe:
  * pose amplitude scales with bd_scale = 0.75 * min over frames of the
    5th-percentile depth (the near bound saved by save_monocular_cameras);
  * splat importance is the TARGET-view disparity 1/z', min-max normalized
    to [-10, 10] (render_source_vv.py:63-68);
  * a Sobel soft alpha on depth/10 with beta=0.5 rides as the payload's
    4th channel (:118-128, :297-303); the rendered alpha is thresholded at
    0.5 and eroded with a radius-1 disk before masking the RGB (:321-326).

The Sobel filter (``cv2.Sobel``, BORDER_REFLECT_101) and the erosion
(``cv2.erode``, 3x3 cross, BORDER_REPLICATE) are numpy here; the
unprojection, transform and flow stay in f64 numpy on the host, and the
payload, flow and weights go to the device for the splat.

One knowing divergence, kept from the JAX CLI: the reference warps with
the optimizer's true (scaled) intrinsics from the npz; this CLI
reconstructs K from the saved focal with a centered principal point — the
only intrinsics the processed scene layout carries (the downstream loader
assumes the same).

    python -m dynibar_tpu_torch.cli.render_source_vv --data_path <dense>
    python -m dynibar_tpu_torch.cli.render_source_vv --data_path <dense> \
        --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from dynibar_tpu_torch.cli.save_monocular_cameras import llff_from_opencv
from dynibar_tpu_torch.data import llff, png
from dynibar_tpu_torch.ops.splat import softmax_splat
from dynibar_tpu_torch.utils.device import DeviceLike, resolve_device
from dynibar_tpu_torch.utils.profiling import PhaseTimer, annotate


def _sobel(img: np.ndarray, dx: int) -> np.ndarray:
  """``cv2.Sobel(img, cv2.CV_32F, dx, 1 - dx, ksize=3)`` with the default
  border (BORDER_REFLECT_101): the row filter, then the column filter, in
  f32."""
  p = np.pad(img.astype(np.float32), 1, mode="reflect")
  if dx:
    rows = p[:, 2:] - p[:, :-2]                              # [-1, 0, 1]
    return (rows[:-2] + rows[2:]) + rows[1:-1] * np.float32(2)
  rows = (p[:, :-2] + p[:, 2:]) + p[:, 1:-1] * np.float32(2)  # [1, 2, 1]
  return rows[2:] - rows[:-2]


def sobel_alpha(depth_over_10: np.ndarray, beta: float = 0.5) -> np.ndarray:
  """Soft alpha that fades depth edges (reference :118-128, beta=0.5 and
  depth/10 input per :297-303)."""
  gx = _sobel(depth_over_10, 1)
  gy = _sobel(depth_over_10, 0)
  grad = np.sqrt(gx ** 2 + gy ** 2)
  return np.exp(-beta * grad)


def splat_inputs(rgb255: np.ndarray, alpha: np.ndarray, disp: np.ndarray,
                 k: np.ndarray, c2w_src: np.ndarray, c2w_dst: np.ndarray):
  """RGBD point cloud -> the splat's (payload [H, W, 4], flow [H, W, 2],
  importance [H, W]), f32, from f64 geometry on the host.

  Mirrors reference render_forward_splat (render_source_vv.py:15-66):
  payload [rgb*255 | alpha], importance = min-max-normalized target-view
  disparity scaled to [-10, 10].
  """
  h, w = disp.shape
  yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
  depth = 1.0 / np.maximum(disp, 1e-8)
  pix = np.stack([xx, yy, np.ones_like(xx)], axis=-1).astype(np.float64)
  kinv = np.linalg.inv(k[:3, :3])
  pts_cam = (pix @ kinv.T) * depth[..., None]
  pts_w = pts_cam @ c2w_src[:3, :3].T + c2w_src[:3, 3]
  w2c = np.linalg.inv(np.vstack([c2w_dst[:3], [0, 0, 0, 1]]))
  pts_dst = pts_w @ w2c[:3, :3].T + w2c[:3, 3]
  new_z = np.clip(pts_dst[..., 2], 1e-8, None)
  uv = pts_dst @ k[:3, :3].T
  uv = uv[..., :2] / np.clip(uv[..., 2:3], 1e-8, None)
  flow = (uv - pix[..., :2]).astype(np.float32)

  importance = (1.0 / new_z).astype(np.float32)
  imp_min, imp_max = importance.min(), importance.max()
  weights = (importance - imp_min) / (imp_max - imp_min + 1e-6) * 20.0 - 10.0

  payload = np.concatenate(
      [rgb255.astype(np.float32), alpha[..., None]], axis=-1)
  return payload, flow, weights


def forward_warp_rgbd(rgb255: np.ndarray, alpha: np.ndarray,
                      disp: np.ndarray, k: np.ndarray,
                      c2w_src: np.ndarray, c2w_dst: np.ndarray,
                      device: DeviceLike = None,
                      timer: Optional[PhaseTimer] = None):
  """RGBD point cloud -> flow to dst view + softmax splat on `device`.

  `timer` gets the phases "geometry" (``splat_inputs`` on the host) and
  "splat" (to the device, the splat, back to the host).  Returns (rgb
  [H, W, 3], alpha [H, W]) as f32 numpy arrays.
  """
  dev = resolve_device(device)
  timer = timer or PhaseTimer()
  with timer.phase("geometry"):
    payload, flow, weights = splat_inputs(rgb255, alpha, disp, k, c2w_src,
                                          c2w_dst)
  with timer.phase("splat"), annotate("softmax_splat"):
    out = softmax_splat(torch.from_numpy(payload).to(dev),
                        torch.from_numpy(flow).to(dev),
                        torch.from_numpy(weights).to(dev)).cpu().numpy()
  return out[..., :3], out[..., 3]


def _disk1_erosion(mask: np.ndarray) -> np.ndarray:
  """skimage.morphology.erosion(mask, disk(1)) equivalent (reference :321):
  ``cv2.erode`` with the 3x3 cross and BORDER_REPLICATE."""
  p = np.pad(mask.astype(bool), 1, mode="edge")
  return (p[1:-1, 1:-1] & p[:-2, 1:-1] & p[2:, 1:-1]
          & p[1:-1, :-2] & p[1:-1, 2:])


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
  """Run the CLI.  Returns the output folder, the frame and view counts,
  the seconds, and the PhaseTimer of the per-view work ("read",
  "filters", "geometry", "splat", "erode", "write")."""
  ap = argparse.ArgumentParser()
  ap.add_argument("--data_path", required=True, help="<scene>/dense dir")
  ap.add_argument("--height", type=int, default=288)
  ap.add_argument("--num_vv", type=int, default=8,
                  help="total virtual views (split over the two cycles)")
  ap.add_argument("--device", type=str, default=None,
                  help="'cpu' for the splat on the CPU; default the CUDA "
                       "card")
  args = ap.parse_args(argv)
  dev = resolve_device(args.device)
  t_start = time.perf_counter()
  # the splat phase ends in a host copy, which waits for the card
  timer = PhaseTimer()

  rows = np.load(os.path.join(args.data_path, "poses_bounds_cvd.npy"))
  poses = rows[:, :-2].reshape(-1, 3, 5)          # raw LLFF rows
  bounds = rows[:, -2:]
  num_frames = poses.shape[0]
  height = int(poses[0, 0, 4])
  width = int(poses[0, 1, 4])

  img_dir = os.path.join(args.data_path, f"images_{width}x{height}")
  img_files = sorted(os.listdir(img_dir))
  out_root = os.path.join(args.data_path,
                          f"source_virtual_views_{width}x{height}")
  os.makedirs(out_root, exist_ok=True)

  # amplitude scale: min over frames of the near (5th-percentile) depth
  # bound (reference render_source_vv.py:195-200)
  bd_scale = float(bounds[:, 0].min()) * 0.75
  num_samples = args.num_vv // 2

  all_vv_poses = np.zeros((num_frames, 2 * num_samples, 3, 4))
  for idx in range(num_frames):
    with timer.phase("read"):
      name = os.path.splitext(img_files[idx])[0]
      rgb = llff.read_image(os.path.join(img_dir, img_files[idx]))
      rgb255 = rgb[..., :3].astype(np.float32)
      if rgb.dtype != np.uint8:                   # floats arrive as [0,1]
        rgb255 = rgb255 * 255.0
      disp = np.load(os.path.join(args.data_path, "disp", name + ".npy"))

    focal = poses[idx, 2, 4]
    k = np.array([[focal, 0, width / 2.0],
                  [0, focal, height / 2.0],
                  [0, 0, 1.0]])

    vv = llff.render_vv_wander_paths(poses[idx], bd_scale,
                                     num_samples=num_samples)  # [2S,3,4]
    all_vv_poses[idx] = vv

    # LLFF -> OpenCV for warping (reference :243-251): the column
    # permutation [c1 | c0 | -c2 | t] is its own inverse
    c2w_src_cv = llff_from_opencv(poses[idx, :, :4])
    with timer.phase("filters"):
      alpha = sobel_alpha(((1.0 / np.maximum(disp, 1e-8)) / 10.0
                           ).astype(np.float32))

    frame_dir = os.path.join(out_root, f"{idx:05d}")
    os.makedirs(frame_dir, exist_ok=True)
    for vi in range(2 * num_samples):
      rgb_out, a_out = forward_warp_rgbd(
          rgb255, alpha, disp, k, c2w_src_cv, llff_from_opencv(vv[vi]),
          device=dev, timer=timer)
      with timer.phase("erode"):
        mask = _disk1_erosion(a_out > 0.5)
      with timer.phase("write"):
        rgb_final = np.clip(rgb_out / 255.0, 0.0, 1.0) * mask[..., None]
        png.write(os.path.join(frame_dir, f"{vi:02d}.png"),
                  (np.clip(rgb_final, 0, 1) * 255).astype(np.uint8))
    print(f"frame {idx}: wrote {2 * num_samples} virtual views")

  # reference file layout: [num_vv, 3, 4, num_frames], raw LLFF convention
  # (render_source_vv.py:237-241 saves the wander poses directly)
  np.save(os.path.join(args.data_path, "source_vv_poses.npy"),
          np.moveaxis(all_vv_poses, 0, -1).astype(np.float32))
  print("wrote source_vv_poses.npy")
  return {"out_dir": out_root, "frames": num_frames,
          "views": 2 * num_samples, "seconds": time.perf_counter() - t_start,
          "timer": timer}


if __name__ == "__main__":
  main(sys.argv[1:])
