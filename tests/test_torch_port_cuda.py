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
from dynibar_tpu_torch.ops.sample import (sample_views, sample_views_pair,
                                          sample_views_pair_plain,
                                          sample_views_plain)
from dynibar_tpu_torch.utils.kernel_check import (ATTN_FIELDS,
                                                  aggregator_grads,
                                                  all_grads,
                                                  attention_inputs,
                                                  check_grad_errors,
                                                  grad_errors, random_inputs,
                                                  ray_attention,
                                                  ray_attention_plain)
from torch_port_threads import one_torch_thread  # noqa: F401

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
@pytest.mark.parametrize("entry,v,c", [
    ("one map", 3, 3), ("one map", 3, 32),
    # the fused entry: RGB and features into [R,S,V,3+C]; 17 x 9 points,
    # so the last tile of rows is ragged at every V
    ("pair", 1, 32), ("pair", 7, 32), ("pair", 11, 32), ("pair", 14, 32),
    ("pair", 7, 8), ("pair", 11, 5)])
def test_sampler_kernel(dev, dtype, entry, v, c):
  """K1 within one ulp of its twin (one bf16 ulp, 2^-20 in f32: the same
  f32 interpolation, summed in another order), points outside the maps and
  on their corners included."""
  g = torch.Generator().manual_seed(10 * v + c)
  maps = torch.randn(v, 37, 53, c, generator=g).to(dev, dtype)
  rgbs = torch.rand(v, 111, 157, 3, generator=g).to(dev, dtype)
  grid = (torch.rand(v, 17, 9, 2, generator=g) * 2.4 - 1.2).to(dev)
  grid[0, 0, :4] = torch.tensor([[-1.0, -1.0], [1.0, 1.0], [-1e6, 0.0],
                                 [1.0, -1.0]], device=dev)
  before = sample_views.launches
  if entry == "pair":
    got = sample_views_pair(rgbs, maps, grid)
    assert got.shape == (17, 9, v, 3 + c) and got.is_contiguous()
    want = sample_views_pair_plain(rgbs, maps, grid)
  else:
    got = sample_views(maps, grid)
    want = sample_views_plain(maps, grid)
  assert sample_views.launches == before + 1
  assert got.dtype == dtype
  got, want = got.float(), want.float()
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


# the forward's edges: S = 40, 48, 64 and 128 (ragged 16-row attention
# tiles and 64-row head chunks), V = 1 to 14; random_inputs gives ray 0 no
# valid view and ray 1 exactly one.  The Nvidia eval configs run K2 with
# mask_rgb = 0 (configs_nvidia/eval_*_long.txt): at its coarse and fine
# shapes (V = 11, S = 64 and 128) and a ragged S = 40, with the anti-alias
# pooling on (as there) and off.  The kid-running render config
# (configs/test_kid-running.txt) runs it with the anti-alias pooling off
# and mask_rgb = 1 at V = 14, S = 64
@pytest.mark.parametrize("s,v,anti_alias,mask_rgb", [
    (16, 4, True, True), (64, 11, True, True), (40, 11, True, True),
    (64, 14, True, True), (16, 14, True, True), (48, 7, True, True),
    (128, 11, True, True), (128, 14, True, True), (64, 1, True, True),
    (128, 1, True, True), (40, 14, True, True),
    (64, 11, True, False), (128, 11, True, False), (40, 11, True, False),
    (64, 11, False, False), (128, 11, False, False), (40, 11, False, False),
    (64, 14, False, True), (40, 14, False, True)])
def test_static_kernel(dev, s, v, anti_alias, mask_rgb):
  d = _inputs(dev, s, v, seed=s + v)
  net = StaticAggregator(F, s, anti_alias_pooling=anti_alias,
                         mask_rgb=mask_rgb).to(dev).eval()
  if not mask_rgb:
    # black source pixels, which the rgb mask would drop, so that the
    # branch changes the output
    g = torch.Generator().manual_seed(s * v)
    keep = (torch.rand(R, s, v, 1, generator=g) > 0.25).float().to(dev)
    d["rgb_feat"] = torch.cat([d["rgb_feat"][..., :3] * keep,
                               d["rgb_feat"][..., 3:]], -1)
  args = [d[k] for k in ("pts", "ref_pl", "src_pl", "rgb_feat", "ray_diff",
                         "mask")]
  with torch.no_grad():
    want = net(*args)
    _compare(fused_static_aggregator(net, *args), want, 2e-2)
    if not mask_rgb:
      net.mask_rgb = True
      assert not torch.allclose(net(*args), want)


@pytest.mark.parametrize("s,v", [(16, 3), (128, 7), (40, 7), (48, 11),
                                 (64, 9), (64, 10), (128, 14), (64, 1),
                                 (48, 1), (128, 6)])
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
                                   (6, 128, 11), (5, 48, 14)])
def test_static_split3_backward_kernels(dev, r, s, v, seed):
  """K5a + K5c + K5d vs the twins, and against K5a + K5b on the same
  inputs: the same bf16 products summed in another order, so every
  gradient within 1e-3 of its f32 scale (``s``: the sum of its per-point
  terms' magnitudes).  5 x 48 points end in a ragged 64-point block."""
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


@pytest.mark.parametrize("seed", WEIGHT_SEEDS)
def test_static_split3_inmlp_many_blocks(dev, seed):
  """K5d with several 64-point blocks per persistent block: 150 rays at the
  mono step's S = 64 and V = 14 are 150 blocks, more than the card's
  persistent blocks, so K5d's gradients kept in shared memory add up over
  blocks before their flush.  Every gradient vs the twins, as
  test_static_split3_backward_kernels holds them; K5d's own (ray_dir_fc,
  ref_feature_fc and the input cotangents) within 1e-3 of their f32
  scale of K5a + K5b's.  K5c's one-column biases are left to the twins'
  bars at this size: their f32 sums over 134,400 terms cancel to about
  1e-4, where the two routes' summation orders alone differ by about
  1e-3 of it (PERF.md section 7)."""
  r, s, v = 150, 64, 14
  d = _inputs(dev, s, v, seed=7 * s + v, R=r)
  torch.manual_seed(seed)
  net = StaticAggregator(F, s).to(dev)
  args = [d[k] for k in ("pts", "ref_pl", "src_pl", "rgb_feat", "ray_diff",
                         "mask")]
  cot, g3, g_f = _check_backward(dev, net, True, args, r, s, "pallas_split3")
  _, g2 = aggregator_grads(net, True, args, cot, "kernel")
  mine = [n for n in g2
          if n.startswith(("input.", "ray_dir_fc.", "ref_feature_fc."))]
  assert len(mine) == 11
  for name in mine:
    err = float((g3[name] - g2[name]).abs().max())
    scale = float(g_f[name].abs().max())
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
@pytest.mark.parametrize("r,s,v", [
    (6, 16, 3), (64, 16, 7), (6, 128, 6), (64, 16, 10), (6, 64, 9),
    # K4a/K4b's edges: P not a multiple of 64 (144, 336 and 336 points),
    # 48 samples (a row tile under 64), 128 samples with 10 views (both
    # warpgroups on every weight slab); rays 0 and 1 have no and one
    # valid view (one view: test_dynamic_backward_one_view); 14 views, the
    # largest shared-memory footprint (VMAX)
    (3, 48, 9), (7, 48, 10), (3, 128, 10), (21, 16, 7), (6, 64, 14),
    (5, 48, 14)])
def test_dynamic_backward_kernels(dev, r, s, v, seed):
  d = _inputs(dev, s, v, seed=7 * s + v, R=r)
  torch.manual_seed(seed)
  net = DynamicAggregator(F, s, shift=0.0).to(dev)
  args = [d[k] for k in ("pts", "rgb_feat", "ray_dir", "mask", "time")]
  _check_backward(dev, net, False, args, r, s)


@pytest.mark.parametrize("seed", WEIGHT_SEEDS)
def test_dynamic_backward_one_view(dev, seed):
  """K4a/K4b at V = 1 and P = 80 (not a multiple of 64).  With one view
  pooling-2's weight is vis / (vis + 1e-8), whose derivative is
  1e-8 / (vis + 1e-8)^2: d_vis is the difference of two terms equal to
  f32 rounding, so vis_fc2's gradients (about 1e-9 of the others') are
  rounding noise in every implementation, the f32 twin's included (it
  differs from a float64 run by 100% there).  Every other gradient is
  held at the bar; vis_fc2's to 1e-4 of the largest other gradient, both
  the kernel's and the twin's (at V = 2 they are 1e-3 of it and exact)."""
  r, s = 5, 16
  d = _inputs(dev, s, 1, seed=7 * s + 1, R=r)
  torch.manual_seed(seed)
  net = DynamicAggregator(F, s, shift=0.0).to(dev)
  args = [d[k] for k in ("pts", "rgb_feat", "ray_dir", "mask", "time")]
  cot = torch.randn(r, s, 4, generator=torch.Generator().manual_seed(r + s))
  cot = cot.to(dev)
  out_k, out_f, g_k, g_f, g_b = all_grads(net, False, args, cot)
  _compare(out_k, out_f, 1e-2)
  noise = [n for n in g_f if n.startswith("vis_fc2.")]
  assert len(noise) == 4
  held = [n for n in g_f if n not in noise]
  check_grad_errors(grad_errors({n: g_k[n] for n in held},
                                {n: g_f[n] for n in held}, g_b),
                    "backward at V = 1")
  scale = max(float(g.abs().max()) for n, g in g_f.items()
              if n not in noise)
  for n in noise:
    assert float(g_k[n].abs().max()) <= 1e-4 * scale, n
    assert float(g_f[n].abs().max()) <= 1e-4 * scale, n


@pytest.mark.parametrize("seed", WEIGHT_SEEDS)
@pytest.mark.parametrize("r,s,v", [(6, 64, 9), (6, 64, 10), (6, 128, 7),
                                   (6, 128, 6), (300, 64, 10), (6, 64, 14),
                                   (6, 128, 14)])
def test_dynamic_single_backward_kernel(dev, r, s, v, seed):
  """K3p + K4s (route "pallas") vs the twins, and against K3r + K4a + K4b
  on the same inputs: the same bf16 products, the weight gradients summed
  in another order, so every gradient within 1e-3 of its f32 scale.  300
  rays put more than one ray on a block; 14 views are the largest
  shared-memory footprint."""
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


@pytest.mark.parametrize("s", [40, 48])
def test_single_backward_any_sample_count(dev, s):
  """S not a multiple of 64 on route "pallas": K3p + K4s (whose last trunk
  block of a ray is masked at the ray's end) vs the twins, and against
  K3r + K4a + K4b within 1e-3 of each gradient's f32 scale, as
  test_dynamic_single_backward_kernel holds them."""
  r, v = 6, 7
  d = _inputs(dev, s, v, seed=5, R=r)
  torch.manual_seed(0)
  net = DynamicAggregator(F, s, shift=5.0).to(dev)
  args = [d[k] for k in ("pts", "rgb_feat", "ray_dir", "mask", "time")]
  cot, g1, g_f = _check_backward(dev, net, False, args, r, s, "pallas")
  _, g2 = aggregator_grads(net, False, args, cot, "kernel")
  for name, want in g2.items():
    err = float((g1[name] - want).abs().max())
    assert err <= 1e-3 * float(g_f[name].abs().max()) + 1e-7, (name, err)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("r,s", [(5, 48), (5, 64), (3, 128), (4, 40)])
def test_ray_attention_kernel(dev, r, s, seed):
  """K4a's attention (csrc/attn_mma.cuh, which K5a and K4s run as well, so
  the cross-check of K4s against K4a + K4b does not test it) launched
  alone, against the plain attention that rounds at the same points
  (utils/kernel_check.py ray_attention_plain; tests/test_torch_port_attention.py
  holds that against float64).  Only f32 summation order and exp differ,
  so a bf16 output may round the other way: each output within two bf16
  ulps of its tensor's largest magnitude (2^-6 of it) and on average
  within 2^-12 of its mean magnitude; the row statistics within 1e-5.
  Ray 0 has no valid view, ray 1 one; S = 40 pads a row tile."""
  ins = attention_inputs(dev, r, s, seed)
  got = ray_attention(*ins)
  want = ray_attention_plain(*ins)
  for name in ATTN_FIELDS:
    g, w = got[name].float(), want[name].float()
    assert g.shape == w.shape, name
    err = (g - w).abs()
    if name in ("m", "l"):
      assert float(err.max()) <= 1e-5 * float(w.abs().max()), name
      continue
    assert float(err.max()) <= 2.0 ** -6 * float(w.abs().max()), name
    assert float(err.mean()) <= 2.0 ** -12 * float(w.abs().mean()), name
  for name in ("dq", "dk"):
    assert float(got[name][:2].float().abs().max()) == 0.0, name
