"""Host cost of the monocular data path: frame decode and pipeline wait.

    python3 scripts/data_pipeline_cost.py --make DIR [--frames FRAMES]
    python3 scripts/data_pipeline_cost.py DIR [--steps 30] [--step-s 0.34]

``--make`` writes the 48-frame 288x512 synthetic scene
(data/synthetic_scene.py) twice under DIR, its frames given sensor-like
noise (sigma 6 of 255, seeded) so that they compress like photographs:
``png/`` keeps them as PNG, ``jpeg/`` re-encodes them as JPEG (quality 95,
4:2:0, as cameras and ffmpeg write them) with PIL, keeping the JPEGs in
``--frames``.  It also writes the first 8 frames at 576x1024 (each pixel
repeated 2x2, then noise of their own) under ``big/png`` and ``big/jpeg``,
the size ``cli/save_monocular_cameras`` reads.  Where PIL is missing (the
card's machine), ``--make`` takes the JPEGs from ``--frames`` instead, as
an earlier ``--make`` wrote them.

The measurement needs no card.  For each format it prints the decode time
per frame of ``llff.read_image`` with each decoder (the C++ host decoder,
"native", and its numpy twins data/png.py / data/jpeg.py) at both sizes,
on 1 and on 4 threads of a pool that calls it (the input pipeline's way);
the native batch entry (``NativeImageLoader.decode``, float32 out) on a
pool of 1 and of 4 C++ threads; then it runs the training CLI's input
pipeline (``PrefetchPipeline`` over ``sample_batch``, 4 worker threads,
N_rand 3072, the CLI's mono settings) with each decoder under it against
a consumer that sleeps ``--step-s`` per step (the mono step on the card)
and prints the consumer's wait per step: over the first 10 steps (frames
still being decoded) and the rest, with decoded frames kept
(``MonocularSceneData``) and with every frame decoded on every read.
Every line carries the host's core count; the card's nvidia-smi line is
printed where there is one.  The last line is the numbers as JSON.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import functools
import glob
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dynibar_tpu_torch.cli.train import parse_args  # noqa: E402
from dynibar_tpu_torch.data import llff, native_loader, png  # noqa: E402
from dynibar_tpu_torch.data.factory import create_training_dataset  # noqa
from dynibar_tpu_torch.data.pipeline import PrefetchPipeline  # noqa: E402
from dynibar_tpu_torch.data.synthetic_scene import (  # noqa: E402
    write_synthetic_scene)

FRAMES, H, W = 48, 288, 512
BIG_FRAMES = 8
COLD = 10
THREADS = (1, 4)
CORES = len(os.sched_getaffinity(0))


def _card() -> str:
  try:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
  except (OSError, subprocess.CalledProcessError):
    return "no card"


def _write_jpeg(image_cls, img, name: str, twin: str) -> None:
  if image_cls is not None:
    image_cls.fromarray(img).save(name, format="JPEG", quality=95,
                                  subsampling=2)
  shutil.copy(name, twin)


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
  for kind in ("png", "jpeg"):
    shutil.rmtree(os.path.join(root, "big", kind), ignore_errors=True)
    os.makedirs(os.path.join(root, "big", kind))
  os.makedirs(frames, exist_ok=True)
  for path in sorted(glob.glob(os.path.join(root, "png", "scene", "dense",
                                            "images*", "*.png"))):
    img = llff.read_image(path).astype(np.float64)
    img = np.clip(img + rng.normal(0.0, 6.0, img.shape), 0, 255)
    img = np.round(img).astype(np.uint8)
    png.write(path, img)
    twin = path.replace(os.sep + "png" + os.sep, os.sep + "jpeg" + os.sep)
    os.remove(twin)
    folder = os.path.basename(os.path.dirname(path))
    stem = os.path.basename(path)[:-4]
    _write_jpeg(Image, img, os.path.join(frames, f"{folder}_{stem}.jpg"),
                twin[:-4] + ".jpg")
    if folder == "images" and int(stem) < BIG_FRAMES:
      big = img.repeat(2, 0).repeat(2, 1).astype(np.float64)
      big = np.clip(big + rng.normal(0.0, 6.0, big.shape), 0, 255)
      big = np.round(big).astype(np.uint8)
      png.write(os.path.join(root, "big", "png", stem + ".png"), big)
      _write_jpeg(Image, big, os.path.join(frames, f"big_{stem}.jpg"),
                  os.path.join(root, "big", "jpeg", stem + ".jpg"))


@contextlib.contextmanager
def _decoder(name: str):
  """llff.read_image / read_image_shape on `name` for every caller."""
  read, shape = llff.read_image, llff.read_image_shape
  llff.read_image = functools.partial(read, decoder=name)
  llff.read_image_shape = functools.partial(shape, decoder=name)
  try:
    yield
  finally:
    llff.read_image, llff.read_image_shape = read, shape


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
      lambda rng, _: data.sample_batch(rng, config.N_rand,
                                       config.sample_mode),
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


def decode_ms(files, decoder: str, threads: int) -> float:
  """ms per frame of llff.read_image on a pool of `threads`."""
  t0 = time.perf_counter()
  with concurrent.futures.ThreadPoolExecutor(threads) as pool:
    list(pool.map(functools.partial(llff.read_image, decoder=decoder),
                  files))
  return (time.perf_counter() - t0) / len(files) * 1e3


def batch_ms(files, threads: int) -> float:
  """ms per frame of the native batch entry on `threads` C++ threads."""
  loader = native_loader.NativeImageLoader(threads)
  try:
    t0 = time.perf_counter()
    loader.decode(files)
    return (time.perf_counter() - t0) / len(files) * 1e3
  finally:
    loader.close()


def measure(root: str, steps: int, step_s: float) -> dict:
  out = {}
  native_loader.decode_file(os.path.join(root, "big", "png", "00000.png"))
  for kind in ("png", "jpeg"):
    scene_root = os.path.join(root, kind)
    sets = {f"{H}x{W}": llff.load_scene_poses(
        os.path.join(scene_root, "scene", "dense"), height=H)["imgfiles"],
            f"{2 * H}x{2 * W}": sorted(glob.glob(os.path.join(
                root, "big", kind, "*")))}
    rec = {}
    for size, files in sets.items():
      kb = float(np.mean([os.path.getsize(f) for f in files]) / 1024)
      row = {"file_kb": kb, "files": len(files)}
      for decoder in llff.DECODERS:
        for threads in THREADS:
          ms = decode_ms(files, decoder, threads)
          row[f"{decoder}_{threads}t_ms"] = ms
          print(f"{kind} {size}: {decoder} decode {ms:.3f} ms per frame on "
                f"{threads} thread(s) ({kb:.1f} KB per file, {len(files)} "
                f"files; {CORES} cores)", flush=True)
      for threads in THREADS:
        ms = batch_ms(files, threads)
        row[f"batch_{threads}t_ms"] = ms
        print(f"{kind} {size}: native batch {ms:.3f} ms per frame on "
              f"{threads} C++ thread(s), {1e3 / ms:.1f} frames/s "
              f"({CORES} cores)", flush=True)
      rec[size] = row
    for decoder in llff.DECODERS:
      with _decoder(decoder):
        for keep in (True, False):
          w = _pipeline_wait(scene_root, steps, step_s, keep)
          tag = "kept" if keep else "decoded on every read"
          print(f"{kind} ({decoder}, {tag}): pipeline wait per step "
                f"{w['first_steps_s']:.4f} s over the first {COLD} steps, "
                f"{w['later_steps_s']:.4f} s over the next {steps - COLD} "
                f"(consumer step {step_s} s; {CORES} cores)", flush=True)
          rec[f"{decoder}_{'kept' if keep else 'every_read'}"] = w
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
  card = _card()
  print(f"card: {card}; host cores: {CORES} of {os.cpu_count()}",
        flush=True)
  res = measure(args.root, args.steps, args.step_s)
  print(json.dumps({"data_pipeline": res, "cpus": CORES,
                    "cpu_count": os.cpu_count(), "card": card,
                    "step_s": args.step_s}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
