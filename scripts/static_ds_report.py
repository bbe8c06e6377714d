"""How the static kernels' anti-alias gradient d_s compares with the twins'.

    python3 scripts/static_ds_report.py [--seeds 8]

For the shapes of tests/test_torch_port_cuda.py's static backward cases
and weight seeds 0..n-1 (inputs as the tests make them), runs K2r + K5a +
K5b, the f32 module and the bf16 twin (utils/kernel_check.py) and prints,
per case, for the kernel and for the bf16 twin against the f32 module:

  sum_max   |error of sum d_s| / |f32 sum|  (the ratio of a plain tensor)
  sum_l1    |error of sum d_s| / sum_p |f32 per-point d_s|
  point     max_p |error of per-point d_s| / max_p |f32 per-point d_s|
  coherent  |sum_p error_p| / sum_p |error_p|: 1 when the per-point errors
            share one sign, about 1/sqrt(n) when they cancel

and a last JSON line with every row.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dynibar_tpu_torch.models.aggregators import StaticAggregator  # noqa: E402
from dynibar_tpu_torch.utils import kernel_check as kc  # noqa: E402
from dynibar_tpu_torch.utils.device import resolve_device  # noqa: E402

SHAPES = ((6, 16, 4), (64, 16, 11), (6, 128, 11))


def main() -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument("--seeds", type=int, default=8)
  args = ap.parse_args()
  dev = resolve_device(None)
  card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"], capture_output=True,
                        text=True, check=True).stdout.strip()
  print(f"card: {card}")
  rows = []
  for r, s, v in SHAPES:
    d = kc.random_inputs(dev, r, s, v, seed=7 * s + v)
    ins = [d[k] for k in kc.STATIC_INPUTS]
    cot = torch.randn(r, s, 4, generator=torch.Generator().manual_seed(r + s))
    cot = cot.to(dev)
    for seed in range(args.seeds):
      torch.manual_seed(seed)
      net = StaticAggregator(32, s).to(dev)
      _, _, g_k, g_f, g_b = kc.all_grads(net, True, ins, cot)
      f_sum, f_pp = float(g_f["s"]), g_f["s.per_point"]
      l1, mx = float(f_pp.abs().sum()), float(f_pp.abs().max())
      row = dict(r=r, s=s, v=v, seed=seed, f32_sum=f_sum, f32_l1=l1)
      for tag, g in (("kernel", g_k), ("twin", g_b)):
        e_sum = abs(float(g["s"]) - f_sum)
        row[tag] = dict(
            sum_max=e_sum / abs(f_sum), sum_l1=e_sum / l1,
            point=float((g["s.per_point"] - f_pp).abs().max()) / mx,
            coherent=kc.error_coherence(g["s.per_point"], f_pp))
      rows.append(row)
      print(f"R={r} S={s} V={v} seed {seed}: f32 sum {f_sum:.4g}, "
            f"l1 {l1:.4g}; " + "; ".join(
                f"{t} " + " ".join(f"{k} {x:.3g}" for k, x in row[t].items())
                for t in ("kernel", "twin")), flush=True)
  print(json.dumps({"card": card, "rows": rows}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
