"""Where the port's FF eval chunk spends its device time.

    python3 scripts/port_profile.py [--chunk 1024] [--iters 3]

Renders one chunk (64+64 samples, 7+11 views, 288x512 sources, bf16,
random weights from a seed) through the kernel path on the CUDA card under
torch.profiler, and prints the device time per kernel name (summed over
the profiled iterations, divided by them), the chunk's wall time and the
device's busy share of it.  Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dynibar_tpu_torch.config import RenderSettings  # noqa: E402
from dynibar_tpu_torch.data.ray_batch import synthetic_ff_batch  # noqa: E402
from dynibar_tpu_torch.models.dynibar import FFModel  # noqa: E402
from dynibar_tpu_torch.ops import build  # noqa: E402
from dynibar_tpu_torch.render.render_rays import render_rays_mv  # noqa: E402
from dynibar_tpu_torch.utils.device import (resolve_device,  # noqa: E402
                                            to_device)


def main() -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument("--chunk", type=int, default=1024)
  ap.add_argument("--iters", type=int, default=3)
  args = ap.parse_args()
  dev = resolve_device(None)
  card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"], capture_output=True,
                        text=True, check=True).stdout.strip()
  build.build()
  cfg = RenderSettings(n_samples=64, n_importance=64, num_views_dy=7,
                       num_views_static=11, num_basis=6, inv_uniform=True,
                       compute_dtype="bfloat16")
  model = FFModel(cfg, num_frames=48, seed=0)
  rb = to_device(synthetic_ff_batch(cfg, n_rays=args.chunk, h=288, w=512,
                                    num_frames=48, scanline=True), dev)
  with torch.no_grad():
    coarse, fine = model.encode_featmaps(rb["src_rgbs"], rb["static_src_rgbs"])
  for _ in range(2):
    render_rays_mv(model, rb, coarse, fine, cfg)
  torch.cuda.synchronize()
  acts = [torch.profiler.ProfilerActivity.CPU,
          torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=acts) as prof:
    t0 = time.perf_counter()
    for _ in range(args.iters):
      render_rays_mv(model, rb, coarse, fine, cfg)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / args.iters
  rows = []
  for ev in prof.key_averages():
    if not str(ev.device_type).endswith("CUDA"):
      continue                    # host ops: their kernels are listed too
    dev_us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
    if dev_us > 0:
      rows.append((dev_us / args.iters / 1e3, ev.count // args.iters,
                   ev.key))
  rows.sort(reverse=True)
  busy = sum(r[0] for r in rows)
  print(f"card: {card}")
  print(f"chunk {args.chunk}: wall {wall * 1e3:.2f} ms, device busy "
        f"{busy:.2f} ms ({100 * busy / (wall * 1e3):.1f}%)")
  for ms, n, name in rows[:25]:
    print(f"{ms:9.3f} ms  x{n:<4d} {name[:90]}")
  print(json.dumps({"chunk": args.chunk, "wall_ms": wall * 1e3,
                    "device_busy_ms": busy, "card": card,
                    "top": [[name[:60], ms] for ms, _, name in rows[:10]]}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
