"""The CUDA kernels vs their plain twins, on the card.

Marked ``cuda``: on a host without a card every test skips.  On the card
(no JAX there, so the repository's conftest is bypassed):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py -q

Tolerances as chip_smoke.py states them: K1 within one bf16 ulp, K2/K3
(bf16 operands, f32 accumulation) vs the f32 modules at the bars the JAX
package holds its Pallas kernels to (tests/test_pallas_agg.py:80,90).
The backward kernels K4a/K4b, K5a/K5b, (route "pallas_split3")
K5a/K5c/K5d and (route "pallas") K3p + K4s through the autograd Functions
vs the f32 modules under autograd, per tensor within twice the bf16 twin's error plus 0.02
(tests/test_pallas_agg.py:370-377); R = 64 with S = 16 spreads the rays
over many blocks, so the weight gradients are summed across block slabs.
The static anti-alias scalar is held per point and as a sum scaled by its
terms' magnitudes (utils/kernel_check.py), and every shape runs with
several weight seeds.  The shapes cover the FF views (11 static, 7 and 6
dynamic) and the mono ones (14 static, 9 and 10 dynamic); the two static
routes agree with each other, so do the two dynamic ones, and 15 views
raise.
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


@pytest.mark.parametrize("s,v", [(16, 4), (64, 11), (40, 11), (64, 14),
                                 (16, 14)])
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


_COUNTERS = {
    "pallas_split": (agg.static_backward_ray, agg.static_backward_trunk),
    "pallas_split3": (agg.static_backward_ray, agg.static_backward_trunk3,
                      agg.static_backward_inmlp),
    "dynamic": (agg.dynamic_backward_ray, agg.dynamic_backward_trunk),
    "pallas": (agg.dynamic_forward_primal, agg.dynamic_backward_single)}


def _check_backward(dev, net, static, args, r, s, bwd="pallas_split"):
  cot = torch.randn(r, s, 4, generator=torch.Generator().manual_seed(r + s))
  cot = cot.to(dev)
  counters = _COUNTERS[bwd if static or bwd == "pallas" else "dynamic"]
  others = [f for k, fs in _COUNTERS.items() for f in fs if f not in counters]
  before = [f.launches for f in counters + tuple(others)]
  aggregator_grads(net, static, args, cot, "kernel", bwd=bwd)
  torch.cuda.synchronize()
  # each kernel of the route once, no kernel of another route
  assert [f.launches for f in counters + tuple(others)] == (
      [b + 1 for b in before[:len(counters)]] + before[len(counters):])
  out_k, out_f, g_k, g_f, g_b = all_grads(net, static, args, cot, bwd=bwd)
  _compare(out_k, out_f, 2e-2 if static else 1e-2)
  assert set(g_k) == set(g_f)
  check_grad_errors(grad_errors(g_k, g_f, g_b), f"backward ({bwd})")
  return cot, g_k, g_f


@pytest.mark.parametrize("seed", WEIGHT_SEEDS)
@pytest.mark.parametrize("r,s,v,anti_alias,mask_rgb", [
    (6, 16, 4, True, True), (64, 16, 11, True, True),
    (6, 128, 11, True, True), (6, 64, 14, True, True),
    # K5a/K5b's edges: P not a multiple of 64 (80, 144 and 336 points),
    # one view, 48 samples (a row tile under 64), 128 samples with 14
    # views (both warpgroups on every weight slab), anti-alias pooling and
    # the rgb mask off; rays 0 and 1 have no and one valid view
    (5, 16, 1, True, True), (3, 48, 11, True, True),
    (7, 48, 14, False, False), (3, 128, 14, True, False),
    (5, 64, 11, False, True), (21, 16, 14, True, True)])
def test_static_backward_kernels(dev, r, s, v, anti_alias, mask_rgb, seed):
  d = _inputs(dev, s, v, seed=7 * s + v, R=r)
  torch.manual_seed(seed)
  net = StaticAggregator(F, s, anti_alias_pooling=anti_alias,
                         mask_rgb=mask_rgb).to(dev)
  args = [d[k] for k in ("pts", "ref_pl", "src_pl", "rgb_feat", "ray_diff",
                         "mask")]
  _check_backward(dev, net, True, args, r, s)


@pytest.mark.parametrize("seed", WEIGHT_SEEDS)
@pytest.mark.parametrize("r,s,v", [(64, 16, 14), (6, 64, 14), (64, 16, 11),
                                   (6, 128, 11)])
def test_static_split3_backward_kernels(dev, r, s, v, seed):
  """K5a + K5c + K5d vs the twins, and against K5a + K5b on the same
  inputs: the same bf16 products summed in another order, so every
  gradient within 1e-3 of its f32 scale (``s``: the sum of its per-point
  terms' magnitudes)."""
  d = _inputs(dev, s, v, seed=7 * s + v, R=r)
  torch.manual_seed(seed)
  net = StaticAggregator(F, s).to(dev)
  args = [d[k] for k in ("pts", "ref_pl", "src_pl", "rgb_feat", "ray_diff",
                         "mask")]
  cot, g3, g_f = _check_backward(dev, net, True, args, r, s, "pallas_split3")
  _, g2 = aggregator_grads(net, True, args, cot, "kernel")
  for name, want in g2.items():
    scale = (float(g_f["s.per_point"].abs().sum()) if name == "s"
             else float(g_f[name].abs().max()))
    err = float((g3[name] - want).abs().max())
    assert err <= 1e-3 * scale + 1e-7, (name, err, scale)


@pytest.mark.parametrize("static", [True, False])
def test_views_past_the_limit_raise(dev, static):
  """15 views: the wrapper refuses, and so does the library's own check
  when the wrapper's is bypassed; nothing falls back to the twin."""
  d = _inputs(dev, 16, 15, seed=3)
  if static:
    net = StaticAggregator(F, 16).to(dev).eval()
    args = [d[k] for k in ("pts", "ref_pl", "src_pl", "rgb_feat",
                           "ray_diff", "mask")]
    fn = fused_static_aggregator
  else:
    net = DynamicAggregator(F, 16).to(dev).eval()
    args = [d[k] for k in ("pts", "rgb_feat", "ray_dir", "mask", "time")]
    fn = fused_dynamic_aggregator
  with torch.no_grad():
    with pytest.raises(ValueError, match="V<=14"):
      fn(net, *args)
    check = agg._check_dims
    agg._check_dims = lambda *a: None
    try:
      with pytest.raises(RuntimeError, match="CUDA error"):
        fn(net, *args)
    finally:
      agg._check_dims = check


@pytest.mark.parametrize("seed", WEIGHT_SEEDS)
@pytest.mark.parametrize("r,s,v", [(6, 16, 3), (64, 16, 7), (6, 128, 6),
                                   (64, 16, 10), (6, 64, 9)])
def test_dynamic_backward_kernels(dev, r, s, v, seed):
  d = _inputs(dev, s, v, seed=7 * s + v, R=r)
  torch.manual_seed(seed)
  net = DynamicAggregator(F, s, shift=0.0).to(dev)
  args = [d[k] for k in ("pts", "rgb_feat", "ray_dir", "mask", "time")]
  _check_backward(dev, net, False, args, r, s)


@pytest.mark.parametrize("seed", WEIGHT_SEEDS)
@pytest.mark.parametrize("r,s,v", [(6, 64, 9), (6, 64, 10), (6, 128, 7),
                                   (6, 128, 6), (300, 64, 10)])
def test_dynamic_single_backward_kernel(dev, r, s, v, seed):
  """K3p + K4s (route "pallas") vs the twins, and against K3r + K4a + K4b
  on the same inputs: the same bf16 products, the weight gradients summed
  in another order, so every gradient within 1e-3 of its f32 scale.  300
  rays put more than one ray on a block."""
  d = _inputs(dev, s, v, seed=7 * s + v, R=r)
  torch.manual_seed(seed)
  net = DynamicAggregator(F, s, shift=5.0).to(dev)
  args = [d[k] for k in ("pts", "rgb_feat", "ray_dir", "mask", "time")]
  cot, g1, g_f = _check_backward(dev, net, False, args, r, s, "pallas")
  _, g2 = aggregator_grads(net, False, args, cot, "kernel")
  assert set(g1) == set(g2)
  for name, want in g2.items():
    err = float((g1[name] - want).abs().max())
    assert err <= 1e-3 * float(g_f[name].abs().max()) + 1e-7, (name, err)


def test_single_backward_refuses_odd_sample_counts(dev):
  """K4s runs whole 64-point trunk blocks per ray: S = 40 raises."""
  d = _inputs(dev, 40, 7, seed=5)
  net = DynamicAggregator(F, 40).to(dev)
  args = [d[k] for k in ("pts", "rgb_feat", "ray_dir", "mask", "time")]
  with pytest.raises(ValueError, match="multiple of 64"):
    fused_dynamic_aggregator(net, *args, bwd="pallas")
