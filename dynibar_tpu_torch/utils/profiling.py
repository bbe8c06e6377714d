"""Tracing / profiling hooks.

Port of ``dynibar_tpu.utils.profiling``:

  * :func:`trace` — context manager around a ``torch.profiler`` capture
    of the CPU and the CUDA card, written as a Chrome trace into
    ``log_dir`` (TensorBoard's profile tab or chrome://tracing read it);
  * :class:`PhaseTimer` — named-phase wall timers with a device-sync
    option, for per-phase breakdowns;
  * :func:`annotate` — ``torch.profiler.record_function``, so host-side
    phases show up inside device traces.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Dict, Iterator

import torch

from dynibar_tpu_torch.utils.device import DeviceLike, resolve_device


@contextlib.contextmanager
def trace(log_dir: str, device: DeviceLike = None
          ) -> Iterator[torch.profiler.profile]:
  """Capture a torch.profiler trace of the enclosed region into
  ``log_dir``: the CPU and the CUDA card, or (``device="cpu"``) the CPU
  only.  Without CUDA the default device raises."""
  dev = resolve_device(device)
  activities = [torch.profiler.ProfilerActivity.CPU]
  if dev.type == "cuda":
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  os.makedirs(log_dir, exist_ok=True)
  with torch.profiler.profile(
      activities=activities,
      on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)
  ) as prof:
    yield prof
    if dev.type == "cuda":                # the region's kernels in the trace
      torch.cuda.synchronize(dev)


def annotate(name: str):
  """Named region that appears in profiler timelines."""
  return torch.profiler.record_function(name)


class PhaseTimer:
  """Accumulates wall time per named phase.

  CUDA launches return before the card finishes: pass a tensor the phase
  produced as ``sync_value`` and use ``sync='ready'`` (synchronize its
  device) or ``sync='value'`` (copy it to the host) to end the phase when
  the card has.
  """

  def __init__(self, sync: str = "none"):
    if sync not in ("none", "ready", "value"):
      raise ValueError(f"sync must be none, ready or value, got {sync!r}")
    self._sync = sync
    self.totals: Dict[str, float] = collections.defaultdict(float)
    self.counts: Dict[str, int] = collections.defaultdict(int)

  @contextlib.contextmanager
  def phase(self, name: str, sync_value=None) -> Iterator[None]:
    t0 = time.perf_counter()
    yield
    if sync_value is not None:
      if self._sync == "value":
        sync_value.cpu()
      elif self._sync == "ready" and sync_value.device.type == "cuda":
        torch.cuda.synchronize(sync_value.device)
    self.totals[name] += time.perf_counter() - t0
    self.counts[name] += 1

  def summary(self) -> Dict[str, float]:
    return {k: self.totals[k] / max(1, self.counts[k]) for k in self.totals}

  def reset(self):
    self.totals.clear()
    self.counts.clear()
