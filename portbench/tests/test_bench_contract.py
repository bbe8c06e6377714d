"""BENCHMARK.json's names and units, and every cell's files found by name."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
  assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
  assert 1 <= BENCH["run_seconds"] <= 51
  assert BENCH["paths"] == ["portbench"]
  assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names(entry):
  assert NAME.match(entry["name"])
  for key in ("config", "traffic"):
    if key in entry:
      assert NAME.match(entry[key])
  for key in entry.get("reduced", ()):
    assert NAME.match(key)
  if "unit" in entry:
    assert UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher")
  for key in ("why", "layer", "source"):
    if key in entry:
      assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_found_by_name(cell):
  wl = json.loads((ROOT / "portbench" / "workloads"
                   / f"{cell['name']}.json").read_text())
  assert wl["config"] == cell["config"] and wl["traffic"] == cell["traffic"]
  conf = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
  assert (ROOT / conf["file"]).is_file()
  traffic = json.loads((ROOT / "portbench" / "traffic"
                        / f"{cell['traffic']}.json").read_text())
  assert (ROOT / "portbench" / "drivers"
          / f"{traffic['driver']}.py").is_file()
  assert wl["chips"] == cell["chips"] == 1


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_metric(metric):
  assert (ROOT / "portbench" / "metrics" / f"{metric['name']}.py").is_file()
  moves = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
  for cell in metric["workloads"]:
    assert "workloads" not in moves or cell in moves["workloads"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_every_cell_reports(cell):
  e2e = [m for m in BENCH["end_to_end"]
         if "workloads" not in m or cell["name"] in m["workloads"]]
  assert {"setup_s"} < {m["name"] for m in e2e}
  assert any(cell["name"] in m.get("workloads", [cell["name"]])
             for m in BENCH["per_layer"])
  for m in e2e:
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
