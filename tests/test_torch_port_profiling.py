"""The port's profiling hooks (``utils/profiling.py``) on the CPU:

  * ``PhaseTimer`` keeps the JAX one's record over the same sequence of
    phases: the keys, the counts and ``summary()``'s shape, with each sync
    mode;
  * ``trace(..., device="cpu")`` writes a Chrome trace into its folder
    that names an ``annotate`` region;
  * ``trace()`` with no device raises on a host without CUDA.
"""

import glob
import json
import os

import jax.numpy as jnp
import pytest
import torch

from dynibar_tpu.utils import profiling as jprof
from dynibar_tpu_torch.utils import profiling as pprof
from torch_port_threads import one_torch_thread  # noqa: F401

PHASES = ("load", "splat", "load", "write", "splat", "splat")


@pytest.mark.parametrize("sync", ["none", "ready", "value"])
def test_phase_timer_matches_jax(sync):
  timers = []
  for mod, value in ((jprof, jnp.ones(3)), (pprof, torch.ones(3))):
    timer = mod.PhaseTimer(sync=sync)
    for name in PHASES:
      with timer.phase(name, sync_value=value if name == "splat" else None):
        pass
    timers.append(timer)
  want, got = timers
  assert list(got.totals) == list(want.totals) == ["load", "splat", "write"]
  assert dict(got.counts) == dict(want.counts) == {"load": 2, "splat": 3,
                                                   "write": 1}
  summary = got.summary()
  assert list(summary) == list(want.summary())
  assert all(summary[k] == got.totals[k] / got.counts[k] >= 0
             for k in summary)
  got.reset()
  want.reset()
  assert (got.summary(), dict(got.counts)) == (want.summary(), {})


def test_phase_timer_rejects_unknown_sync():
  with pytest.raises(ValueError, match="sync"):
    pprof.PhaseTimer(sync="block")


def test_trace_on_cpu_names_the_region(tmp_path):
  with pprof.trace(str(tmp_path), device="cpu") as prof:
    with pprof.annotate("softmax_splat"):
      torch.ones(64, 64) @ torch.ones(64, 64)
  files = glob.glob(os.path.join(str(tmp_path), "*.json"))
  assert len(files) == 1
  with open(files[0]) as fh:
    events = json.load(fh)["traceEvents"]
  assert any(e.get("name") == "softmax_splat" for e in events)
  assert any(e.key == "softmax_splat" for e in prof.key_averages())


def test_trace_needs_cuda_or_cpu(tmp_path):
  if torch.cuda.is_available():
    pytest.skip("this host has CUDA: the default device is valid here")
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    with pprof.trace(str(tmp_path / "t")):
      pass
  assert not (tmp_path / "t").exists()
