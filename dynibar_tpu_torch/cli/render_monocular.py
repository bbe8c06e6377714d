"""Space-time (bullet-time / stabilized) video rendering CLI.

Port of ``dynibar_tpu.cli.render_monocular`` (reference
render_monocular_bt.py): renders every frame of the video along a
smoothed (stabilization) camera path, or a circular wander path around
``--render_idx``, with interval-based static source selection
(render_monocular_bt.py:120-155), and writes PNG frames with a 3% border
crop to ``<out_folder>/render_stab`` or ``render_wander``.

    python -m dynibar_tpu_torch.cli.render_monocular \\
        --config configs/test_kid-running.txt --train_scenes <scene> \\
        [--render_idx -1] [--video_out ""] [--device cpu]

The weights are the newest snapshot of the training CLI in the experiment
folder, or ``--ckpt_path``.  ``video_out`` "auto" also writes
``video.mp4`` beside the frames (cv2; without it the CLI stops before it
renders), "" writes PNG frames only.  Every other ``--key value`` sets
that field of ``DynibarConfig``; ``--device cpu`` runs the plain PyTorch
twins on the CPU, and without it the CLI needs the CUDA card.  Under
``torchrun`` (one process per card, ``parallel/mesh.py``) every rank
renders its share of each frame's rays; rank 0 writes the PNGs and the
mp4, and the other ranks return no frames.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from dynibar_tpu_torch.cli.train import parse_args
from dynibar_tpu_torch.core.cameras import make_camera
from dynibar_tpu_torch.data import png
from dynibar_tpu_torch.data.llff import parse_llff_pose
from dynibar_tpu_torch.data.monocular import MonocularSceneData
from dynibar_tpu_torch.data.ray_batch import MONO_SRC_OFFSETS
from dynibar_tpu_torch.data.view_selection import get_interval_pose_ids
from dynibar_tpu_torch.models.dynibar import MonoModel
from dynibar_tpu_torch.parallel.mesh import replicate, training_mesh
from dynibar_tpu_torch.render.render_image import (full_image_ray_batch,
                                                   render_image_mono)
from dynibar_tpu_torch.utils import checkpoints as ckpt_lib
from dynibar_tpu_torch.utils.device import resolve_device

NO_SCENE = ("error: no scene: pass --config <file> with "
            "`train_scenes = <scene>` or --train_scenes <scene>")


def render_batch_template(data: MonocularSceneData, idx: int,
                          num_source_views: int, num_vv: int,
                          rng: np.random.RandomState,
                          vv_ids=None) -> Dict[str, Any]:
  """Source stacks for rendering frame `idx` (no supervision fields); the
  virtual views are ``vv_ids`` when given, else drawn from ``rng``."""
  cfg = data.cfg
  src_rgbs, src_cams, src_off, src_valid = [], [], [], []
  for o in MONO_SRC_OFFSETS:
    i = int(np.clip(idx + o, 0, data.num_frames - 1))
    src_rgbs.append(data._load_rgb(i))
    src_cams.append(data._camera(i))
    src_off.append(o + 3)
    src_valid.append(1.0)
  if vv_ids is None:
    vv_ids = rng.choice(8, size=num_vv, replace=False)
  for vv_i in vv_ids:
    r, c = data._load_vv(idx, int(vv_i))
    src_rgbs.append(r)
    src_cams.append(c)
    src_off.append(3)
    src_valid.append(1.0)

  # interval-based static selection (render_monocular_bt.py:120-155)
  st_ids = get_interval_pose_ids(data.c2w[idx], data.c2w, tar_id=idx,
                                 interval=10)
  st_ids = np.sort(st_ids[: 2 * num_source_views])
  st_rgbs, st_cams, st_valid = [], [], []
  for i in st_ids[: cfg.num_views_static]:
    st_rgbs.append(data._masked_src(int(i)))
    st_cams.append(data._camera(int(i)))
    st_valid.append(1.0)
  while len(st_rgbs) < cfg.num_views_static:
    st_rgbs.append(np.zeros_like(st_rgbs[0]))
    st_cams.append(st_cams[0])
    st_valid.append(0.0)

  return {
      "depth_range": data.depth_range,
      "ref_time": np.float32(idx / data.num_frames),
      "anchor_time": np.float32(idx / data.num_frames),
      "ref_frame_idx": np.int32(idx),
      "anchor_frame_idx": np.int32(idx),
      "src_rgbs": np.stack(src_rgbs),
      "src_cameras": np.stack(src_cams),
      "src_offset_idx": np.array(src_off, np.int32),
      "src_valid": np.array(src_valid, np.float32),
      "static_src_rgbs": np.stack(st_rgbs),
      "static_src_cameras": np.stack(st_cams),
      "static_valid": np.array(st_valid, np.float32),
  }


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
  """Run the CLI; returns the output folder, the frames' paths and
  seconds, the video's path (or None) and the checkpoint's step (under a
  mesh, no frames and no video on ranks other than 0)."""
  # serve/ imports this module (its session builds templates here)
  from dynibar_tpu_torch.serve import video as video_lib
  config, device = parse_args(argv)
  if not config.train_scenes:
    raise SystemExit(NO_SCENE)
  mesh = training_mesh(config, device)
  is_main = mesh is None or mesh.is_main
  if config.video_out:
    video_lib.require_cv2()      # fail before rendering, not after the path
  dev = mesh.device if mesh is not None else resolve_device(device)
  data = MonocularSceneData(config, config.train_scenes[0])
  config.num_frames = data.num_frames
  cfg = config.render_settings("mono")

  payload, step = ckpt_lib.resume_from(config.out_folder(), config.ckpt_path,
                                       map_location=dev)
  if payload is None:
    raise SystemExit(f"no checkpoint in {config.out_folder()}")
  model = MonoModel(cfg, num_frames=data.num_frames, device=dev)
  model.load_state_dict(payload["model"])
  if mesh is not None:
    replicate(mesh, model)
  if is_main:
    print(f"rendering with checkpoint step {step}", flush=True)

  out_dir = os.path.join(
      config.out_folder(),
      f"render_{'wander' if config.render_idx >= 0 else 'stab'}")
  if is_main:
    os.makedirs(out_dir, exist_ok=True)
  rng = np.random.RandomState(0)

  render_poses = data.render_poses
  paths, seconds, video_frames = [], [], []
  for out_i in range(len(render_poses)):
    t0 = time.perf_counter()
    # wander path orbits one frame; stabilization tracks the video
    idx = config.render_idx if config.render_idx >= 0 else out_i
    idx = int(np.clip(idx, 3, data.num_frames - 4))
    template = render_batch_template(data, idx, config.num_source_views,
                                     config.num_vv, rng)
    hwf = render_poses[out_i][:, 4]
    h, w = int(hwf[0]), int(hwf[1])
    intr, c2w = parse_llff_pose(render_poses[out_i])
    rb = full_image_ray_batch(template, make_camera(h, w, intr, c2w),
                              device=dev)
    with torch.no_grad():
      featmaps = model.encode_featmaps(rb["src_rgbs"], rb["static_src_rgbs"])
    ret = render_image_mono(model, rb, featmaps, cfg, config.chunk_size, h,
                            w, device=dev, mesh=mesh)
    if ret is None:               # rank 0 writes the frame
      continue
    rgb = ret["outputs_coarse_ref"]["rgb"]
    # 3% border crop (render_monocular_bt.py:349-356)
    ch, cw = int(h * 0.03), int(w * 0.03)
    rgb = rgb[ch:h - ch, cw:w - cw]
    path = os.path.join(out_dir, f"{out_i:05d}.png")
    png.write(path, (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
    seconds.append(time.perf_counter() - t0)
    paths.append(path)
    print(f"wrote {path} ({seconds[-1]:.3f}s)", flush=True)
    if config.video_out:
      video_frames.append(rgb)

  vpath = None
  if config.video_out and video_frames:
    vpath = (os.path.join(out_dir, "video.mp4")
             if config.video_out == "auto" else config.video_out)
    video_lib.write_mp4(vpath, video_frames, fps=config.video_fps)
    print(f"wrote {vpath}", flush=True)
  return {"out_dir": out_dir, "frames": paths, "seconds": seconds,
          "video": vpath, "step": step}


if __name__ == "__main__":
  main(sys.argv[1:])
