"""Run one benchmark cell of dynibar_tpu_torch once and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell needs is found by name: ``portbench/workloads/<cell>.json``
names its configuration (``portbench/configs/<config>.json``) and its
traffic (``portbench/traffic/<traffic>.json``), which names the driver
(``portbench/drivers/<driver>.py``) and its parameters.  A per-layer
metric of ``BENCHMARK.json`` is read by ``portbench/metrics/<metric>.py``.

A run: set-up (imports, the scene written from the seed, weights made on
the card from the seed, the program's objects, warm-up) -> the measured
window -> the peak memory read -> the program's state freed -> the
comparison with the plain reference that decides ``correct``.  With
``--trace 0`` the window lasts ``--seconds`` and the result carries the
cell's end-to-end metrics; with ``--trace 1`` the window is the traffic's
``trace_units`` steps or frames under ``torch.profiler`` and the result
carries the cell's per-layer metrics, the device's busy and window
seconds and a breakdown.  The last line on standard output is one JSON
object; the numbers compared, each beside its limit, are the last lines
on standard error.  No CUDA card, or fewer than the cell asks for: exit
code 2 and no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

# pylint: disable=wrong-import-position
import argparse
import contextlib
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "dynibar_tpu")


def _cache_env() -> None:
  """Every build and kernel cache at a fixed path inside the checkout;
  the program's own libraries build under ``build/kernels`` and
  ``build/host`` there."""
  for key, sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[key] = str(ROOT / "build" / sub)
  os.environ["USE_FLAX"] = "0"


def load_json(path: Path) -> Dict[str, Any]:
  with open(path) as fh:
    return json.load(fh)


def load_file_module(path: Path, name: str):
  spec = importlib.util.spec_from_file_location(name, path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def forbidden_modules() -> List[str]:
  """Loaded modules whose top-level name is JAX's, flax's or the JAX
  package's, compared whole."""
  return sorted({m.split(".")[0] for m in list(sys.modules)
                 if m.split(".")[0] in FORBIDDEN})


class Cell:
  """A cell's files, found by name."""

  def __init__(self, name: str):
    self.bench = load_json(ROOT / "BENCHMARK.json")
    self.name = name
    self.workload = load_json(HERE / "workloads" / f"{name}.json")
    self.config = load_json(HERE / "configs"
                            / f"{self.workload['config']}.json")
    self.traffic = load_json(HERE / "traffic"
                             / f"{self.workload['traffic']}.json")
    self.driver = importlib.import_module(
        f"portbench.drivers.{self.traffic['driver']}")
    self.end_to_end = [m for m in self.bench["end_to_end"]
                       if self._reports(m)]
    self.per_layer = [m for m in self.bench["per_layer"]
                      if self._reports_layer(m)]

  def _reports(self, metric) -> bool:
    return "workloads" not in metric or self.name in metric["workloads"]

  def _reports_layer(self, metric) -> bool:
    if "workloads" in metric:
      return self.name in metric["workloads"]
    return any(m["name"] == metric["moves"] for m in self.end_to_end)


class Context:
  """What a driver gets: the cell, the run's arguments, the device, a
  scratch directory, host spans (also profiler annotations), and
  ``unit_done`` to call after each step or frame of a window."""

  def __init__(self, cell: Cell, seed: int, device, scratch: str):
    self.cell, self.seed, self.device, self.scratch = cell, seed, device, scratch
    self.params = dict(cell.traffic.get("params", {}))
    self.spans: List[tuple] = []
    self._on_unit: Optional[Callable[[], None]] = None

  @contextlib.contextmanager
  def span(self, name: str):
    import torch
    t0 = time.perf_counter()
    with torch.profiler.record_function(f"bench/{name}"):
      yield
    self.spans.append((name, t0, time.perf_counter()))

  def unit_done(self) -> None:
    if self._on_unit is not None:
      self._on_unit()

  def note(self, line: str) -> None:
    """A line for standard error, printed at once."""
    print(line, file=sys.stderr, flush=True)


def _power_limit() -> Optional[str]:
  try:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=20)
    return out.stdout.strip().splitlines()[0] if out.stdout else None
  except (OSError, subprocess.SubprocessError, IndexError):
    return None


def _traced_window(ctx: Context, state) -> Dict[str, Any]:
  """The driver's window of ``trace_units`` units under the profiler,
  the first unit as the profiler's warm-up; returns the window's result
  with the profiler's events."""
  import torch
  from portbench import trace as tr
  from portbench import workcount
  units = int(ctx.params["trace_units"])
  sched = torch.profiler.schedule(wait=0, warmup=1, active=units, repeat=1)
  acts = [torch.profiler.ProfilerActivity.CPU]
  if torch.cuda.is_available():
    acts.append(torch.profiler.ProfilerActivity.CUDA)
  with torch.profiler.profile(activities=acts, schedule=sched) as prof:
    ctx._on_unit = prof.step
    res = ctx.cell.driver.window(state, ctx, seconds=None, units=units + 1)
    ctx._on_unit = None
  res["trace"] = tr.read_profile(prof)
  res["traced_units"] = units
  res["work"] = workcount.unit_work(ctx.cell.driver.work(ctx, state))
  return res


def run(argv: Optional[List[str]] = None, *, require_cuda: bool = True,
        device: Optional[str] = None,
        adjust: Optional[Callable[[Cell], None]] = None) -> Dict[str, Any]:
  """One run; returns the result object (printed by ``main``).  Tests
  pass ``require_cuda=False``, a CPU ``device`` and ``adjust``, which
  shrinks the cell in memory to a size the CPU holds."""
  ap = argparse.ArgumentParser()
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seed", type=int, required=True)
  ap.add_argument("--seconds", type=float, required=True)
  ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
  args = ap.parse_args(argv)
  _cache_env()

  import torch
  cell = Cell(args.workload)
  if adjust is not None:
    adjust(cell)
  chips = int(cell.workload.get("chips", 1))
  if require_cuda:
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
      raise SystemExit(2)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
  else:
    dev = torch.device(device or "cpu")

  scratch = tempfile.mkdtemp(prefix=f"portbench-{cell.name}-",
                             dir=os.environ.get("TMPDIR"))
  ctx = Context(cell, args.seed, dev, scratch)
  state = None
  try:
    state = cell.driver.setup(ctx)
    if dev.type == "cuda":
      torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - T_START
    metrics: Dict[str, Dict[str, Any]] = {}
    extra: Dict[str, Any] = {}
    if args.trace:
      res = _traced_window(ctx, state)
      from portbench import trace as tr
      summary = tr.summarize(res["trace"])
      extra["breakdown"] = summary["breakdown"]
      power = _power_limit()
      for m in cell.per_layer:
        reader = load_file_module(HERE / "metrics" / f"{m['name']}.py",
                                  f"portbench_metric_{m['name']}")
        val = reader.read(ctx, res, summary)
        if val is not None:
          metrics[m["name"]] = {"value": val, "unit": m["unit"]}
      ctx.note(f"traced window: {res['traced_units']} units, busy "
               f"{summary['busy_s']} s of {summary['window_s']} s; card "
               f"{power}")
    else:
      res = cell.driver.window(state, ctx, seconds=args.seconds, units=None)
      for m in cell.end_to_end:
        if m["name"] == "setup_s":
          metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
        elif m["name"] in res:
          metrics[m["name"]] = {"value": res[m["name"]], "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": chips,
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                         if dev.type == "cuda" else 0)}
    if args.trace:
      device_info["busy_s"] = summary["busy_s"]
      device_info["window_s"] = summary["window_s"]
    ctx.note(f"window: {res['units']} units in {res['seconds']} s; "
             f"setup_s {setup_s}")
    checks = cell.driver.check(state, ctx)
    state = None
    correct = bool(checks) and all(c["ok"] for c in checks)
    bad = forbidden_modules()
    if bad:
      ctx.note(f"forbidden modules loaded: {bad}")
      raise SystemExit(3)
    for c in checks:
      print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    result = {"correct": correct, "attempted": res["units"],
              "failed": res.get("failed", 0), "metrics": metrics,
              "device": device_info}
    result.update(extra)
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    return result
  finally:
    closer = getattr(cell.driver, "close", None)
    if state is not None and closer is not None:
      closer(state)
    shutil.rmtree(scratch, ignore_errors=True)


def main(argv: Optional[List[str]] = None) -> int:
  result = run(argv)
  sys.stderr.flush()
  print(json.dumps(result), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
