"""Metrics and image logging of the training CLI.

Port of ``dynibar_tpu.utils.logging.MetricsLogger`` (the reference's
SummaryWriter usage, train.py:106-108, 458-472, 576-762).  TensorBoard is
not used: the machine with the card has none.  Scalars go to
``<log_dir>/metrics.jsonl`` as the JAX logger writes them (one JSON object
per call: ``step``, ``time`` and each ``<prefix><name>``); image panels go
to ``<log_dir>/images/<step:08d>_<tag with / as _>.png`` through
``data/png.py``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np

from dynibar_tpu_torch.data import png


class MetricsLogger:
  """enabled=False makes every method a no-op that touches no file."""

  def __init__(self, log_dir: str, enabled: bool = True):
    self.enabled = enabled
    self._log_dir = log_dir
    self._jsonl = None
    if enabled:
      os.makedirs(log_dir, exist_ok=True)
      self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

  def scalars(self, step: int, values: Dict[str, float], prefix: str = ""):
    if not self.enabled:
      return
    rec = {"step": step, "time": time.time()}
    rec.update({prefix + k: float(v) for k, v in values.items()})
    self._jsonl.write(json.dumps(rec) + "\n")
    self._jsonl.flush()

  def image(self, step: int, tag: str, img_hwc: np.ndarray):
    """img_hwc float [H, W, 3] in [0, 1], written as an 8-bit PNG."""
    if not self.enabled:
      return
    img_dir = os.path.join(self._log_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    img8 = (np.clip(img_hwc, 0, 1) * 255).astype(np.uint8)
    png.write(os.path.join(img_dir, f"{step:08d}_{tag.replace('/', '_')}.png"),
              img8)

  def close(self):
    if self._jsonl is not None:
      self._jsonl.close()
      self._jsonl = None
