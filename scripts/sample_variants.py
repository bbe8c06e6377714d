"""The sampler K1 (csrc/sample.cu) against variants of its launch shape and
store path, built side by side from the same source.

    python3 scripts/sample_variants.py [--iters 30]

Each variant is csrc/sample.cu with one edit: "occupancy 1" (at most two
512-thread blocks an SM, the bound before three), "256 threads" (blocks of
half the rows, six an SM) and "no tile" (every chunk stored straight to its
row, no shared-memory tile).  Each builds with nvcc into
build/sample_variants/ and loads through ctypes.  At the FF eval chunk's
four K1 calls (1024 rays, S 64 and 128, 7 and 11 views, 288x512 RGB and
72x128x32 feature maps, bf16, grids along epipolar segments from a seed)
it times the fused entry and the single-map entry on each map (CUDA
events, after warm-up) and checks every output equal, bit for bit, to the
unedited kernel's.  Needs one card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from dynibar_tpu_torch.ops import build  # noqa: E402

SOURCE = ROOT / "dynibar_tpu_torch" / "csrc" / "sample.cu"
OUT = ROOT / "build" / "sample_variants"
BOUNDS = "__launch_bounds__(512, 3)"
# name -> [(text in sample.cu, replacement)]
VARIANTS = {
    "committed": [],
    "occupancy 1": [(BOUNDS, "__launch_bounds__(512, 1)")],
    "256 threads": [(BOUNDS, "__launch_bounds__(256, 6)"),
                    ("a.rows = (512 / chunks) & ~7;",
                     "a.rows = (256 / chunks) & ~7;"),
                    ("a.rows * chunks > 512", "a.rows * chunks > 256")],
    "no tile": [("T* dst = tile + row * rl;", "T* dst = a.out + q * rl;"),
                ("if (a.direct) return;", "return;")],
}
_P, _I = ctypes.c_void_p, ctypes.c_int


def _build(name: str, edits) -> ctypes.CDLL:
  text = SOURCE.read_text()
  for old, new in edits:
    if text.count(old) != 1:
      raise RuntimeError(f"{name}: {old!r} is not in sample.cu once")
    text = text.replace(old, new)
  OUT.mkdir(parents=True, exist_ok=True)
  stem = OUT / name.replace(" ", "_")
  src = stem.with_suffix(".cu")
  src.write_text(text)
  subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o",
                  str(stem.with_suffix(".so")), str(src)], check=True,
                 stdout=open(stem.with_suffix(".log"), "w"),
                 stderr=subprocess.STDOUT)
  lib = ctypes.CDLL(str(stem.with_suffix(".so")))
  lib.dyn_sample_pair.argtypes = ([_P] + [_I] * 3 + [_P] + [_I] * 3 +
                                  [_P] * 2 + [_I] * 3 + [_P])
  lib.dyn_sample_views.argtypes = [_P] * 3 + [_I] * 6 + [_P]
  lib.dyn_sample_pair.restype = lib.dyn_sample_views.restype = _I
  return lib


def _time_ms(fn, iters: int) -> float:
  for _ in range(3):
    fn()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda.synchronize()
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / iters


def main() -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument("--iters", type=int, default=30)
  args = ap.parse_args()
  if not torch.cuda.is_available():
    print("sample_variants: needs a CUDA card", file=sys.stderr)
    return 1
  dev = torch.device("cuda")
  card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"], capture_output=True,
                        text=True, check=True).stdout.strip()
  libs = {name: _build(name, edits) for name, edits in VARIANTS.items()}
  stream = torch.cuda.current_stream(dev).cuda_stream
  gen = torch.Generator(device=dev).manual_seed(0)
  r = 1024
  print(f"card: {card}")
  for s, v in ((64, 7), (64, 11), (128, 7), (128, 11)):
    rgbs = torch.rand(v, 288, 512, 3, generator=gen, device=dev).to(
        torch.bfloat16)
    feats = torch.randn(v, 72, 128, 32, generator=gen, device=dev).to(
        torch.bfloat16)
    start = torch.rand(v, r, 1, 2, generator=gen, device=dev) * 0.25 - 0.125
    step = torch.rand(v, 1, 1, 2, generator=gen, device=dev) * 1.6 - 0.8
    t = torch.linspace(0.0, 1.0, s, device=dev).view(1, 1, s, 1)
    grid = (start + t * step).contiguous()
    n = r * s
    ref, line = None, f"S {s} V {v}:"
    for name, lib in libs.items():
      pair = torch.empty((r, s, v, 35), dtype=torch.bfloat16, device=dev)
      calls = [(pair, lambda lib=lib, o=pair: lib.dyn_sample_pair(
          rgbs.data_ptr(), 288, 512, 3, feats.data_ptr(), 72, 128, 32,
          grid.data_ptr(), o.data_ptr(), v, n, 1, stream))]
      for m in (feats, rgbs):
        o = torch.empty((v, r, s, m.shape[-1]), dtype=torch.bfloat16,
                        device=dev)
        calls.append((o, lambda lib=lib, m=m, o=o: lib.dyn_sample_views(
            m.data_ptr(), grid.data_ptr(), o.data_ptr(), v, m.shape[1],
            m.shape[2], m.shape[3], n, 1, stream)))
      for out, fn in calls:
        build.check(fn(), name)
      torch.cuda.synchronize()
      outs = [out.clone() for out, _ in calls]
      if ref is None:
        ref = outs
      same = all(torch.equal(a, b) for a, b in zip(outs, ref))
      ms = [_time_ms(fn, args.iters) for _, fn in calls]
      line += (f"  {name}: fused {ms[0]:.4f}, features {ms[1]:.4f}, rgb "
               f"{ms[2]:.4f} ms" + ("" if same else " (OUTPUT DIFFERS)"))
      if not same:
        print(line, flush=True)
        return 1
    print(line, flush=True)
  for name in VARIANTS:
    log = (OUT / name.replace(" ", "_")).with_suffix(".log").read_text()
    regs = [l.split(":", 1)[1].strip() for l in log.splitlines()
            if "registers" in l]
    print(f"{name}: {regs}")
  return 0


if __name__ == "__main__":
  sys.exit(main())
