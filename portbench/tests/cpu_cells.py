"""Shrinking a cell to a size the CPU holds, for the CPU tests."""

from __future__ import annotations


def tiny(cell) -> None:
  """Few frames, small images, few rays and samples; every other setting
  as the cell has it."""
  frames = 24 if cell.config["model"] == "ff" else 10
  cell.config["scene"].update(frames=frames, height=24, width=40, focal=30.0)
  s = cell.config["settings"]
  s.update(N_rand=32, N_samples=16, chunk_size=256, workers=1,
           training_height=24)
  if s.get("N_importance"):
    s["N_importance"] = 8
  cell.traffic["params"].update(workers=1, warm_steps=1, trace_units=2,
                                reference_chunk=256)
