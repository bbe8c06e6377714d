"""Each cell end to end on the CPU at a tiny size (the harness's look for
a card skipped): a sound run comes out correct, a run with the timed path
broken underneath comes out not correct, and the control (the reference
in fp8 put in the program's place) reads well above the program and,
judged against the cell's limits as a run judges, comes out not
correct."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from portbench import control, run
from portbench.tests.cpu_cells import tiny

CPU = torch.device("cpu")
ARGS = ["--seconds", "1", "--trace", "0"]


def _run(cell: str, seed: int):
  return run.run(["--workload", cell, "--seed", str(seed)] + ARGS,
                 require_cuda=False, device="cpu", adjust=tiny)


@contextlib.contextmanager
def _planted(module, name: str, make):
  saved = getattr(module, name)
  setattr(module, name, make(saved))
  try:
    yield
  finally:
    setattr(module, name, saved)


def _altered(render):
  """Fault: the rendered answer altered where it is produced."""
  def faulty(*args, **kw):
    ret = render(*args, **kw)
    for out in ret.values():
      out["rgb"] = np.clip(out["rgb"] + 0.25, 0.0, 1.0)
    return ret
  return faulty


@pytest.mark.parametrize("cell", ["mono-train", "ff-eval", "mono-render"])
def test_sound_run_is_correct(cell):
  res = _run(cell, 2 ** 31 + 11)
  assert res["correct"], res["checks"]
  assert res["attempted"] >= 1 and res["failed"] == 0
  assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_train_faults_are_caught(fault):
  from portbench.drivers import train_loop
  make = getattr(control, fault)
  with _planted(train_loop, "STEP",
                lambda _: make(train_loop.default_step())):
    res = _run("mono-train", 2 ** 31 + 12)
  assert not res["correct"], res["checks"]


def _batch_fault(field):
  """Fault: one field of every batch the pipeline hands out altered."""
  def alter(rb):
    v = rb[field]
    if field == "anchor_frame_idx":
      rb[field] = v + 1
    elif field == "src_cameras":
      rb[field] = v.clone()
      rb[field][-1] = v[-2]
    else:
      rb[field] = v * 1.01 + 1e-3
    return rb

  def make(nxt):
    return lambda self: alter(nxt(self))
  return make


@pytest.mark.parametrize("field", ["disp", "flows", "static_src_rgbs",
                                   "src_cameras", "anchor_frame_idx"])
def test_train_batch_faults_are_caught(field):
  from dynibar_tpu_torch.data import pipeline
  with _planted(pipeline.PrefetchPipeline, "__next__", _batch_fault(field)):
    res = _run("mono-train", 2 ** 31 + 16)
  assert not res["correct"], res["checks"]
  assert res["checks"]["batch_max_abs"]["value"] > 0


def test_eval_scoring_fault_is_caught():
  r = control.readings_for("ff-eval", 2 ** 31 + 17, CPU, fault="scoring",
                           adjust=tiny)
  assert not r["program"]["verdict"]["correct"], r["program"]["verdict"]
  assert r["program"]["psnr_gap"] > 1.0 and r["program"]["ssim_gap"] > 3e-3


def test_eval_altered_answer_is_caught():
  from dynibar_tpu_torch.eval import nvidia_eval
  with _planted(nvidia_eval, "render_image_ff", _altered):
    res = _run("ff-eval", 2 ** 31 + 13)
  assert not res["correct"], res["checks"]


def test_render_altered_answer_is_caught():
  from dynibar_tpu_torch.serve import session
  with _planted(session, "render_image_mono", _altered):
    res = _run("mono-render", 2 ** 31 + 14)
  assert not res["correct"], res["checks"]


def _flat(side):
  out = {k: v for k, v in side.items() if k != "rgb"}
  out.update({f"rgb_{k}": v for k, v in side.get("rgb", {}).items()})
  return out


@pytest.mark.parametrize("cell,keys", [
    ("mono-train", ("loss_rel", "grad_median", "update_median")),
    ("ff-train", ("loss_rel", "grad_median", "update_median")),
    ("ff-eval", ("rgb_mean",)),
    ("mono-render", ("rgb_max_abs", "depth_rel"))])
def test_control_reads_above_the_program(cell, keys):
  r = control.readings_for(cell, 2 ** 31 + 15, CPU, control=True,
                           adjust=tiny)
  prog, ctrl = _flat(r["program"]), _flat(r["control"])
  assert any(ctrl[k] >= 3 * prog[k] for k in keys), r


@pytest.mark.parametrize("cell", ["mono-train", "ff-eval", "mono-render"])
def test_control_is_not_correct(cell):
  r = control.readings_for(cell, 2 ** 31 + 18, CPU, control=True,
                           adjust=tiny)
  assert not r["control"]["verdict"]["correct"], r["control"]["verdict"]
