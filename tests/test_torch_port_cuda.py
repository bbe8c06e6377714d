"""The CUDA kernels vs their plain twins, on the card.

Marked ``cuda``: on a host without a card every test skips.  On the card
(no JAX there, so the repository's conftest is bypassed):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py -q

Tolerances as chip_smoke.py states them: K1 within one bf16 ulp, K2/K3
(bf16 operands, f32 accumulation) vs the f32 modules at the bars the JAX
package holds its Pallas kernels to (tests/test_pallas_agg.py:80,90).
The backward kernels K4a/K4b and K5a/K5b through the autograd Functions vs
the f32 modules under autograd, per tensor within twice the bf16 twin's
error plus 0.02 (tests/test_pallas_agg.py:370-377); R = 64 with S = 16
spreads the rays over many blocks, so the weight gradients are summed
across block slabs.  The static anti-alias scalar is held per point and as
a sum scaled by its terms' magnitudes (utils/kernel_check.py), and every
shape runs with several weight seeds.
"""

import numpy as np
import pytest
import torch

from dynibar_tpu_torch.models.aggregators import (DynamicAggregator,
                                                  StaticAggregator)
from dynibar_tpu_torch.ops import agg
from dynibar_tpu_torch.ops.agg import (fused_dynamic_aggregator,
                                       fused_static_aggregator)
from dynibar_tpu_torch.ops.sample import sample_views, sample_views_plain
from dynibar_tpu_torch.utils.kernel_check import (aggregator_grads,
                                                  all_grads,
                                                  check_grad_errors,
                                                  grad_errors, random_inputs)

pytestmark = pytest.mark.cuda
R, F = 6, 32
WEIGHT_SEEDS = range(4)


@pytest.fixture
def dev():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [3, 32])
def test_sampler_kernel(dev, dtype, c):
  g = torch.Generator().manual_seed(c)
  maps = torch.randn(3, 37, 53, c, generator=g).to(dev, dtype)
  grid = (torch.rand(3, 17, 9, 2, generator=g) * 2.4 - 1.2).to(dev)
  grid[0, 0, :4] = torch.tensor([[-1.0, -1.0], [1.0, 1.0], [-1e6, 0.0],
                                 [1.0, -1.0]], device=dev)
  before = sample_views.launches
  got = sample_views(maps, grid).float()
  assert sample_views.launches == before + 1
  want = sample_views_plain(maps, grid).float()
  ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -20
  assert bool(((got - want).abs()
               <= ulp * torch.maximum(got.abs(), want.abs()) + 1e-6).all())


def _inputs(dev, s, v, seed, R=R):
  return random_inputs(dev, R, s, v, seed, c=F + 3)


def _compare(got, want, atol):
  fill = want[..., 3] <= -1e8
  assert torch.equal(got[..., 3] <= -1e8, fill)
  g = torch.cat([got[..., :3].reshape(-1), got[..., 3][~fill]])
  w = torch.cat([want[..., :3].reshape(-1), want[..., 3][~fill]])
  assert bool(((g - w).abs() <= atol + 2e-2 * w.abs()).all())


@pytest.mark.parametrize("s,v", [(16, 4), (64, 11), (40, 11)])
def test_static_kernel(dev, s, v):
  d = _inputs(dev, s, v, seed=s + v)
  net = StaticAggregator(F, s).to(dev).eval()
  args = [d[k] for k in ("pts", "ref_pl", "src_pl", "rgb_feat", "ray_diff",
                         "mask")]
  with torch.no_grad():
    _compare(fused_static_aggregator(net, *args), net(*args), 2e-2)


@pytest.mark.parametrize("s,v", [(16, 3), (128, 7), (40, 7)])
def test_dynamic_kernel(dev, s, v):
  d = _inputs(dev, s, v, seed=s + v)
  net = DynamicAggregator(F, s, shift=0.0).to(dev).eval()
  args = [d[k] for k in ("pts", "rgb_feat", "ray_dir", "mask", "time")]
  with torch.no_grad():
    got = fused_dynamic_aggregator(net, *args)
    _compare(got, net(*args), 1e-2)
  np.testing.assert_array_equal(got[0, :, :3].cpu().numpy(), 0.0)


def _check_backward(dev, net, static, args, r, s):
  cot = torch.randn(r, s, 4, generator=torch.Generator().manual_seed(r + s))
  cot = cot.to(dev)
  counters = ((agg.static_backward_ray, agg.static_backward_trunk) if static
              else (agg.dynamic_backward_ray, agg.dynamic_backward_trunk))
  before = [f.launches for f in counters]
  aggregator_grads(net, static, args, cot, "kernel")
  torch.cuda.synchronize()
  assert [f.launches for f in counters] == [b + 1 for b in before]
  out_k, out_f, g_k, g_f, g_b = all_grads(net, static, args, cot)
  _compare(out_k, out_f, 2e-2 if static else 1e-2)
  assert set(g_k) == set(g_f)
  check_grad_errors(grad_errors(g_k, g_f, g_b), "backward")


@pytest.mark.parametrize("seed", WEIGHT_SEEDS)
@pytest.mark.parametrize("r,s,v", [(6, 16, 4), (64, 16, 11), (6, 128, 11)])
def test_static_backward_kernels(dev, r, s, v, seed):
  d = _inputs(dev, s, v, seed=7 * s + v, R=r)
  torch.manual_seed(seed)
  net = StaticAggregator(F, s).to(dev)
  args = [d[k] for k in ("pts", "ref_pl", "src_pl", "rgb_feat", "ray_diff",
                         "mask")]
  _check_backward(dev, net, True, args, r, s)


@pytest.mark.parametrize("seed", WEIGHT_SEEDS)
@pytest.mark.parametrize("r,s,v", [(6, 16, 3), (64, 16, 7), (6, 128, 6)])
def test_dynamic_backward_kernels(dev, r, s, v, seed):
  d = _inputs(dev, s, v, seed=7 * s + v, R=r)
  torch.manual_seed(seed)
  net = DynamicAggregator(F, s, shift=0.0).to(dev)
  args = [d[k] for k in ("pts", "rgb_feat", "ray_dir", "mask", "time")]
  _check_backward(dev, net, False, args, r, s)
