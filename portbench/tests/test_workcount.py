"""The frozen flop counts equal the port's today."""

from __future__ import annotations

import pytest

from dynibar_tpu_torch.ops import agg
from portbench import workcount

SHAPES = [(True, 3072, 64, 14, 35), (False, 3072, 64, 9, 35),
          (False, 3072, 64, 10, 35), (True, 8192, 128, 11, 35),
          (False, 8192, 64, 7, 35)]


@pytest.mark.parametrize("shape", SHAPES)
def test_flop_parts_equal_the_port(shape):
  assert workcount.aggregator_flop_parts(*shape) == agg.aggregator_flop_parts(
      *shape)
  assert workcount.static_inmlp_flops(*shape[1:]) == agg.static_inmlp_flops(
      *shape[1:])


def test_unit_work_counts():
  step = workcount.unit_work({
      "agg": list(workcount.mono_agg_calls(3072, 64, 9, 14, 10, 35, True)),
      "featnet": [(9, 288, 512, True)], "motion": [(3072 * 64, True)]})
  fwd = sum(agg.aggregator_flops(s, r, n, v, c)
            for s, r, n, v, c, _ in workcount.mono_agg_calls(
                3072, 64, 9, 14, 10, 35, True))
  assert step["agg_flops"] == 3 * fwd
  assert step["agg_least_s"] > 0
  assert step["model_flops"] > step["agg_flops"]
