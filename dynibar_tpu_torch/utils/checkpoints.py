"""Checkpoint save / auto-resume.

Port of ``dynibar_tpu.utils.checkpoints`` (reference model.py:424-500):
periodic snapshots of the model and optimizer state and the step,
auto-reload of the newest snapshot in the experiment folder, an explicit
path that overrides it, and ``no_reload``.  A snapshot is one
``torch.save`` file, ``<out_folder>/<name>_<step:08d>.pt``, holding
``{"model": state_dict, "optimizer": state_dict, "step": int}``.  Snapshot
names are matched exactly, ``<name>_<digits>``: ``model_`` is a prefix of
``model_no-vv_``, and prefix matching would let the one-shot no-vv
snapshot shadow the newest ``model`` snapshot and rewind auto-resume.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

_SUFFIX = ".pt"


def _abs(path: str) -> str:
  return os.path.abspath(os.path.expanduser(path))


def save_checkpoint(out_folder: str, step: int, model_state: Dict[str, Any],
                    opt_state: Optional[Dict[str, Any]] = None,
                    keep: int = 3, name: str = "model") -> str:
  """Write out_folder/<name>_<step:08d>.pt; keep the newest `keep`
  snapshots of this name."""
  out_folder = _abs(out_folder)
  os.makedirs(out_folder, exist_ok=True)
  path = os.path.join(out_folder, f"{name}_{step:08d}{_SUFFIX}")
  payload = {"model": model_state, "step": int(step)}
  if opt_state is not None:
    payload["optimizer"] = opt_state
  tmp = path + ".tmp"
  torch.save(payload, tmp)
  os.replace(tmp, path)            # a reader never sees half a snapshot
  for stale in _snapshots(out_folder, name)[:-keep]:
    os.remove(os.path.join(out_folder, stale))
  return path


def _snapshots(out_folder: str, name: str) -> list:
  """Snapshot files named exactly <name>_<digits>.pt, sorted by step."""
  pat = re.compile(re.escape(name) + r"_(\d+)" + re.escape(_SUFFIX) + "$")
  return sorted((d for d in os.listdir(out_folder) if pat.match(d)),
                key=lambda d: int(pat.match(d).group(1)))


def latest_checkpoint(out_folder: str, name: str = "model") -> Optional[str]:
  out_folder = _abs(out_folder)
  if not os.path.isdir(out_folder):
    return None
  snaps = _snapshots(out_folder, name)
  return os.path.join(out_folder, snaps[-1]) if snaps else None


def load_checkpoint(path: str, map_location=None) -> Dict[str, Any]:
  """Snapshots are written by this module: plain tensors and containers,
  read with ``weights_only=True``."""
  return torch.load(_abs(path), map_location=map_location, weights_only=True)


def resume_from(out_folder: str, ckpt_path: str = "",
                no_reload: bool = False, name: str = "model",
                map_location=None) -> Tuple[Optional[Dict[str, Any]], int]:
  """Explicit path wins, else the newest snapshot in out_folder
  (reference model.py:468-500); returns (payload or None, start step)."""
  if no_reload:
    return None, 0
  path = ckpt_path if ckpt_path and os.path.exists(_abs(ckpt_path)) else (
      latest_checkpoint(out_folder, name))
  if path is None:
    return None, 0
  payload = load_checkpoint(path, map_location)
  return payload, int(payload["step"])
