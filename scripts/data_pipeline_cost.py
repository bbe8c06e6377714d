"""Host cost of the monocular data path: frame decode and pipeline wait.

    python3 scripts/data_pipeline_cost.py --make DIR [--frames FRAMES]
    python3 scripts/data_pipeline_cost.py DIR [--steps 30] [--step-s 0.34]

``--make`` writes the 48-frame 288x512 synthetic scene
(data/synthetic_scene.py) twice under DIR, its frames given sensor-like
noise (sigma 6 of 255, seeded) so that they compress like photographs:
``png/`` keeps them as PNG, ``jpeg/`` re-encodes them as JPEG (quality 95,
4:2:0, as cameras and ffmpeg write them) with PIL, keeping the JPEGs in
``--frames``.  Where PIL is missing (the card's machine), ``--make`` takes
the JPEGs from ``--frames`` instead, as an earlier ``--make`` wrote them.

The measurement needs no card.  For each scene it prints the decode time
per frame (``llff.read_image``: data/png.py or data/jpeg.py) with the
file's size, then runs the training CLI's input pipeline
(``PrefetchPipeline`` over ``sample_batch``, 4 worker threads, N_rand
3072, the CLI's mono settings) against a consumer that sleeps ``--step-s``
per step (the mono step on the card) and prints the consumer's wait per
step: over the first 10 steps (frames still being decoded) and the rest,
with decoded frames kept (``MonocularSceneData``) and with every frame
decoded on every read.  The last line is the numbers as JSON.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dynibar_tpu_torch.cli.train import parse_args  # noqa: E402
from dynibar_tpu_torch.data import llff, png  # noqa: E402
from dynibar_tpu_torch.data.factory import create_training_dataset  # noqa
from dynibar_tpu_torch.data.pipeline import PrefetchPipeline  # noqa: E402
from dynibar_tpu_torch.data.synthetic_scene import (  # noqa: E402
    write_synthetic_scene)

FRAMES, H, W = 48, 288, 512
COLD = 10


def make(root: str, frames: str) -> None:
  try:
    from PIL import Image
  except ImportError:            # the card's machine: frames encoded before
    Image = None
  rng = np.random.RandomState(0)
  for kind in ("png", "jpeg"):
    shutil.rmtree(os.path.join(root, kind), ignore_errors=True)
    write_synthetic_scene(os.path.join(root, kind), "scene",
                          num_frames=FRAMES, height=H, width=W)
  os.makedirs(frames, exist_ok=True)
  for path in sorted(glob.glob(os.path.join(root, "png", "scene", "dense",
                                            "images*", "*.png"))):
    img = llff.read_image(path).astype(np.float64)
    img = np.clip(img + rng.normal(0.0, 6.0, img.shape), 0, 255)
    img = np.round(img).astype(np.uint8)
    png.write(path, img)
    twin = path.replace(os.sep + "png" + os.sep, os.sep + "jpeg" + os.sep)
    os.remove(twin)
    name = os.path.join(frames, os.path.basename(os.path.dirname(path)) + "_"
                        + os.path.basename(path)[:-4] + ".jpg")
    if Image is not None:
      Image.fromarray(img).save(name, format="JPEG", quality=95,
                                subsampling=2)
    shutil.copy(name, twin[:-4] + ".jpg")


def _data(scene_root: str):
  config = parse_args(["--folder_path", scene_root, "--train_scenes",
                       "scene", "--training_height", str(H), "--N_rand",
                       "3072", "--N_samples", "64", "--num_source_views",
                       "7", "--num_vv", "3", "--workers", "4"])[0]
  return config, create_training_dataset(config)


def _pipeline_wait(scene_root: str, steps: int, step_s: float,
                   keep: bool):
  config, data = _data(scene_root)
  if not keep:
    for provider in data.providers:
      load = provider._load_rgb

      def load_fresh(idx, provider=provider, load=load):
        provider._rgb8.pop(idx, None)
        return load(idx)
      provider._load_rgb = load_fresh
  waits = []
  pipe = PrefetchPipeline(
      lambda rng: data.sample_batch(rng, config.N_rand, config.sample_mode),
      num_workers=config.workers, seed=0)
  try:
    for _ in range(steps):
      before = pipe.wait_s
      next(pipe)
      waits.append(pipe.wait_s - before)
      time.sleep(step_s)
  finally:
    pipe.close()
  return {"first_steps_s": float(np.mean(waits[:COLD])),
          "later_steps_s": float(np.mean(waits[COLD:]))}


def measure(root: str, steps: int, step_s: float) -> dict:
  out = {}
  for kind in ("png", "jpeg"):
    scene_root = os.path.join(root, kind)
    files = llff.load_scene_poses(os.path.join(scene_root, "scene", "dense"),
                                  height=H)["imgfiles"]
    t0 = time.perf_counter()
    for f in files:
      llff.read_image(f)
    ms = (time.perf_counter() - t0) / len(files) * 1e3
    kb = np.mean([os.path.getsize(f) for f in files]) / 1024
    print(f"{kind}: decode {ms:.2f} ms per {H}x{W} frame "
          f"({kb:.1f} KB per file, {len(files)} files)", flush=True)
    rec = {"decode_ms": ms, "file_kb": float(kb)}
    for keep in (True, False):
      w = _pipeline_wait(scene_root, steps, step_s, keep)
      tag = "kept" if keep else "decoded on every read"
      print(f"{kind} ({tag}): pipeline wait per step {w['first_steps_s']:.4f}"
            f" s over the first {COLD} steps, {w['later_steps_s']:.4f} s over"
            f" the next {steps - COLD} (consumer step {step_s} s)",
            flush=True)
      rec["kept" if keep else "every_read"] = w
    out[kind] = rec
  return out


def main() -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument("root")
  ap.add_argument("--make", action="store_true")
  ap.add_argument("--frames", default=None,
                  help="where --make keeps the JPEG frames (default "
                  "ROOT/jpeg_frames); without PIL it reads them from there")
  ap.add_argument("--steps", type=int, default=30)
  ap.add_argument("--step-s", type=float, default=0.34)
  args = ap.parse_args()
  if args.make:
    make(args.root, args.frames or os.path.join(args.root, "jpeg_frames"))
    return 0
  res = measure(args.root, args.steps, args.step_s)
  print(json.dumps({"data_pipeline": res, "cpus": os.cpu_count(),
                    "step_s": args.step_s}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
