"""The readings that a cell's limits are set from (not run by the benchmark).

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...] \
        [--faults] [--no-control] [--twin]

For each seed: the cell's set-up as a run makes it (scene, weights, the
program's check steps or a short window), then each number that decides
``correct`` for the program against the reference (the lower reading),
for the control (the reference one precision below the configuration's,
fp8 for its bf16, put in the program's place) against the reference (the
upper reading), and with ``--faults`` for each planted fault of the
program that the cell can have and that needs a run to read.  Each side
is judged against the workload file's limits as a run judges, and its
``correct`` printed beside its readings: the program's has to come out
true, the control's and each fault's false.  With ``--twin`` (eval) the
sampled viewpoints are also rendered through the aggregators' bf16 twin,
a second witness for the program's outlying pixels.  One JSON line per
seed and side.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import sys
import tempfile
from typing import Any, Callable, Dict, List, Optional

import torch

from portbench import run as harness


@contextlib.contextmanager
def planted(obj, name: str, value):
  """``obj.name`` replaced by ``value`` for the block."""
  saved = getattr(obj, name)
  setattr(obj, name, value)
  try:
    yield
  finally:
    setattr(obj, name, saved)


def half_batch(step: Callable) -> Callable:
  """Fault: half of the batch's rays left out, the mean taken over the
  rest."""
  from portbench.reference.render_image import (RAY_SHARDED_AXIS1_KEYS,
                                                RAY_SHARDED_KEYS)

  def faulty(model, opt, rb, *args, **kw):
    n = rb["ray_o"].shape[0] // 2
    rb = {k: (v[:n] if k in RAY_SHARDED_KEYS
              else v[:, :n] if k in RAY_SHARDED_AXIS1_KEYS else v)
          for k, v in rb.items()}
    return step(model, opt, rb, *args, **kw)
  return faulty


def unchanged_state(step: Callable) -> Callable:
  """Fault: a step that returns the model and optimizer as they were."""
  def faulty(model, opt, rb, *args, **kw):
    params = [p.detach().clone() for p in model.parameters()]
    opt_state = {k: {n: (t.clone() if torch.is_tensor(t) else t)
                     for n, t in v.items()} for k, v in opt.state.items()}
    out = step(model, opt, rb, *args, **kw)
    with torch.no_grad():
      for p, q in zip(model.parameters(), params):
        p.copy_(q)
    for k, v in opt_state.items():
      opt.state[k] = v
    for k in list(opt.state):
      if k not in opt_state:
        del opt.state[k]
    return out
  return faulty


def _step_fault(make: Callable):
  def plant(ctx, driver):
    return planted(driver, "STEP", make(driver.default_step(ctx)))
  return plant


@contextlib.contextmanager
def _scoring(ctx, driver):
  """Fault: the protocol's scoring rewritten wrongly, as a move of the
  host's PSNR / SSIM elsewhere could: the PSNR's mask taken on one
  channel (its mean square error over a third of the values it sums),
  the SSIM's data range taken as 1 instead of the protocol's 2."""
  from dynibar_tpu_torch.eval import nvidia_eval as ev
  psnr, ssim = ev.masked_psnr, ev.masked_ssim
  with planted(ev, "masked_psnr", lambda a, b, m: psnr(a, b, m[..., :1])), \
      planted(ev, "masked_ssim", lambda a, b, m: ssim(a, b, m,
                                                      data_range=1.0)):
    yield


# each fault by name: how to plant it in the program
FAULTS = {"half_batch": _step_fault(half_batch),
          "unchanged_state": _step_fault(unchanged_state),
          "scoring": _scoring}

# the faults read on the card for each driver (a state left unchanged
# reads 1 by the training measure and needs no run)
RUN_FAULTS = {"train_loop": ("half_batch",), "nvidia_eval": ("scoring",),
              "session_render": ()}


def sides(out: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
  """The flat readings of each side (program, control) of a driver's
  ``control_readings``.  A number of the inputs both sides are fed (the
  batch, the session's template) is read once and shared."""
  from portbench.checks.render import flat
  res = {side: flat(out[side]) for side in ("program", "control")
         if side in out}
  for key in ("batch_max_abs", "template_max_abs"):
    value = out.get(key, res["program"].get(key))
    if value is not None:
      for side in res.values():
        side.setdefault(key, value)
  return res


def verdict(ctx, readings: Dict[str, Any]) -> Dict[str, Any]:
  """The side judged as a run judges it."""
  from portbench.checks.train import judged
  checks = judged(ctx, readings)
  return {"correct": bool(checks) and all(c["ok"] for c in checks),
          "checks": {c["name"]: [c["value"], c["limit"]] for c in checks}}


def readings_for(cell_name: str, seed: int, device, *, fault: Optional[str]
                 = None, control: bool = False, twin: bool = False,
                 adjust=None) -> Dict:
  """One seed's numbers: the program (or a fault of it) against the
  reference, and with ``control`` also the control against it; each
  side with its verdict under the cell's limits."""
  cell = harness.Cell(cell_name)
  if adjust is not None:
    adjust(cell)
  driver = cell.driver
  scratch = tempfile.mkdtemp(prefix=f"portbench-ctl-{cell_name}-",
                             dir=os.environ.get("TMPDIR"))
  ctx = harness.Context(cell, seed, device, scratch)
  kw = {"twin": True} if twin else {}
  try:
    with (FAULTS[fault](ctx, driver) if fault is not None
          else contextlib.nullcontext()):
      state = driver.setup(ctx)
      out = driver.control_readings(state, ctx, control=control, **kw)
  finally:
    shutil.rmtree(scratch, ignore_errors=True)
    gc.collect()
    if device.type == "cuda":
      torch.cuda.empty_cache()
  for side, flat_readings in sides(out).items():
    out[side]["verdict"] = verdict(ctx, flat_readings)
  return out


def main(argv: Optional[List[str]] = None) -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seeds", type=int, nargs="+", required=True)
  ap.add_argument("--faults", action="store_true")
  ap.add_argument("--no-control", action="store_true")
  ap.add_argument("--twin", action="store_true")
  args = ap.parse_args(argv)
  harness._cache_env()
  if not torch.cuda.is_available():
    return 2
  dev = torch.device("cuda", 0)
  driver = harness.Cell(args.workload).traffic["driver"]
  for seed in args.seeds:
    r = readings_for(args.workload, seed, dev, control=not args.no_control,
                     twin=args.twin)
    print(json.dumps({"workload": args.workload, "seed": seed, **r}),
          flush=True)
    if args.faults:
      for name in RUN_FAULTS[driver]:
        r = readings_for(args.workload, seed, dev, fault=name)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": name, **r}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
