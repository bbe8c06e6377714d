"""Run the whole Nvidia-benchmark eval protocol on a trained FF snapshot of
the PyTorch port, one rung of the speed-mode ladder per call.

The port's counterpart of ``scripts/eval_ff_synthetic.py``.
``scripts/port_ff_convergence.py`` trains the FF model on the analytic
Nvidia-layout scene and keeps a phase-B snapshot; this drives
``eval/nvidia_eval.evaluate_scene`` (frames 3..N-3 x the 11 viewpoints
that are not the frame's own, masked full / dynamic / static PSNR, SSIM
and LPIPS, reference eval_nvidia.py:305-481) with those weights, so every
line of the eval path runs on a model that renders the scene.  The
``--mode`` ladder changes one lever per rung and prices it in dB:

  exact_f32   f32 sampling, the plain f32 aggregators         (gold)
  exact_bf16  bf16 sampling, the aggregators' bf16 twin       (prices bf16)
  fused_bf16  bf16 sampling, the CUDA kernels K1-K3           (prices the
              kernels; the eval CLI's path, the default)

The JAX script's ``production`` and ``fused_rgb`` rungs are TPU modes
(the strip sampler with the channel-major handoff, featmap-resolution
RGB); they raise NotImplementedError.  Every rung renders at one chunk
(the JAX script halved exact_f32's to fit a v5e's memory).

    python scripts/port_eval_ff_synthetic.py [--ckpt build/ffconv/ckpt_ff_B] \\
        [--root build/ffconv/scene_48x96x144] [--frames N] \\
        [--mode exact_bf16] [--device cpu]

``--device cpu`` runs on the CPU (the kernels' plain versions for
fused_bf16); without it the script needs the CUDA card.  The last line is
the JSON of the JAX script with the card's name and power limit and the
mean seconds per viewpoint frame.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from dynibar_tpu_torch.config import DynibarConfig  # noqa: E402
from dynibar_tpu_torch.eval.nvidia_eval import evaluate_scene  # noqa: E402
from dynibar_tpu_torch.models.dynibar import BF16_TWIN, FFModel  # noqa: E402
from dynibar_tpu_torch.utils.checkpoints import (  # noqa: E402
    latest_checkpoint, load_checkpoint)
from dynibar_tpu_torch.utils.device import resolve_device  # noqa: E402

# mode -> (compute_dtype, render_image_ff's kernels)
RUNGS = {"exact_f32": ("float32", False),
         "exact_bf16": ("bfloat16", BF16_TWIN),
         "fused_bf16": ("bfloat16", True)}
TPU_MODES = {
    "production": "the Pallas strip sampler and the channel-major handoff",
    "fused_rgb": "the featmap-resolution RGB lookup"}
CHUNK = 4608
# the JAX script's samples, coarse and fine each, and the protocol's first
# eval frame
SAMPLES, FIRST_FRAME = 64, 3
_SECONDS = re.compile(r"^frame \d+ cam \d+: .*\(([0-9.]+)s\)$")


def parse_args(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument("--ckpt", default="build/ffconv/ckpt_ff_B")
  ap.add_argument("--root", default="build/ffconv/scene_48x96x144")
  ap.add_argument("--scene", default="consistent_nvidia")
  ap.add_argument("--height", type=int, default=96)
  ap.add_argument("--frames", type=int, default=0,
                  help="limit to the first N eval frames (0 = the "
                       "protocol's full range 3..N-3)")
  ap.add_argument("--mode", default="fused_bf16",
                  choices=list(RUNGS) + list(TPU_MODES),
                  help="speed-mode ladder (see the module docstring)")
  ap.add_argument("--device", default=None,
                  help="cpu runs on the CPU; default the CUDA card")
  return ap.parse_args(argv)


def card_line(dev) -> str:
  """The card's name and power limit as nvidia-smi gives them, or cpu."""
  if dev.type != "cuda":
    return "cpu"
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  return out.stdout.strip().splitlines()[0]


def load(args):
  """The rung's config, the model with the snapshot's weights and the
  snapshot's path."""
  if args.mode in TPU_MODES:
    raise NotImplementedError(
        f"--mode {args.mode}: a TPU mode of the JAX package "
        f"({TPU_MODES[args.mode]}); the port has no counterpart (ROADMAP.md, "
        "'Not ported')")
  dev = resolve_device(args.device)
  path = latest_checkpoint(args.ckpt)
  if path is None:
    raise SystemExit(f"no checkpoint under {args.ckpt}")
  state = load_checkpoint(path, map_location=dev)["model"]
  # the DCT basis is [frames, bases]: the snapshot's scene length and its
  # bases (the JAX script's 6 for a full run)
  num_frames, num_basis = state["traj_basis"].shape
  config = DynibarConfig(
      folder_path=args.root, eval_scenes=[args.scene],
      training_height=args.height, N_samples=SAMPLES,
      N_importance=SAMPLES, num_source_views=7, num_basis=num_basis,
      mask_static=False, chunk_size=CHUNK,
      compute_dtype=RUNGS[args.mode][0])
  model = FFModel(config.render_settings("ff"), num_frames=num_frames,
                  device=dev)
  model.load_state_dict(state)
  return config, model, path


def run(args) -> dict:
  """One rung of ``args`` (``parse_args``): the tables unrounded, with the
  viewpoints rendered and their mean seconds."""
  config, model, path = load(args)
  dev = model.device
  card = card_line(dev)
  print(f"device={card} ckpt={path} mode={args.mode}", flush=True)

  seconds = []

  def log(line):
    print(line, flush=True)
    m = _SECONDS.match(line)
    if m:
      seconds.append(float(m.group(1)))

  frame_range = range(FIRST_FRAME, FIRST_FRAME + args.frames if args.frames
                      else model.num_frames - 3)
  t0 = time.perf_counter()
  tables = evaluate_scene(config, model, args.scene, frame_range=frame_range,
                          log_fn=log, device=dev,
                          kernels=RUNGS[args.mode][1])
  return {"scene": args.scene, "mode": args.mode,
          "eval_seconds": time.perf_counter() - t0, **tables,
          "viewpoints": len(seconds),
          "s_per_viewpoint": float(np.mean(seconds)) if seconds else None,
          "card": card}


def main(argv=None) -> dict:
  result = run(parse_args(argv))
  out = {k: ({m: round(x, 4) for m, x in v.items()} if isinstance(v, dict)
             else v) for k, v in result.items()}
  out["eval_seconds"] = round(result["eval_seconds"], 1)
  if result["s_per_viewpoint"] is not None:
    out["s_per_viewpoint"] = round(result["s_per_viewpoint"], 4)
  print(json.dumps(out), flush=True)
  return result


if __name__ == "__main__":
  main()
