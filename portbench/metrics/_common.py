"""Helpers the per-layer metric readers share."""

from __future__ import annotations

import re
from typing import Iterable

from portbench.workcount import PEAK_BF16_FLOPS


def kernel_seconds(summary, names: Iterable[str]) -> float:
  """Device seconds of the kernels whose name holds one of ``names`` as a
  whole identifier."""
  pat = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(map(re.escape, names))
                   + r")(?![A-Za-z0-9_])")
  return sum(s for n, s in summary["kernels_s"].items() if pat.search(n))


def roofline_pct(res, summary, names, key: str = "agg_least_s"):
  """The least time of the traced units' work over the named kernels'
  device time, in percent; None where no such kernel ran."""
  t = kernel_seconds(summary, names)
  if t <= 0:
    return None
  return 100.0 * res["work"][key] * res["traced_units"] / t


def mfu_pct(res, summary):
  if summary["window_s"] <= 0:
    return None
  return (100.0 * res["work"]["model_flops"] * res["traced_units"]
          / (summary["window_s"] * PEAK_BF16_FLOPS))


def idle_pct(summary):
  if summary["window_s"] <= 0 or summary["busy_s"] <= 0:
    return None
  return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
