"""The weight layouts the aggregator kernels read, and the gradient slab
they write, on the CPU (ops/agg.py).

``tile_weights`` (the layout of the Hopper kernels K5a/K5b,
csrc/sm90_common.cuh) holds every parameter of every slot exactly, at the
index the CUDA header documents, and so do ``pack_frag`` (the forwards'
and the trunk backwards' B fragments, csrc/agg_common.cuh) and
``pack_frag_t`` (the same of the transposes); ``unpack_grads`` maps a slab laid out as
the kernels write it (padded row-major weights, then the biases) back onto
each parameter's gradient: the slab is filled from the f32 twin's autograd
gradients and compared exactly.
"""

import re

import numpy as np
import pytest
import torch

from dynibar_tpu_torch.models.aggregators import (DynamicAggregator,
                                                  StaticAggregator)
from dynibar_tpu_torch.ops import agg
from dynibar_tpu_torch.utils.kernel_check import random_inputs
from torch_port_threads import one_torch_thread  # noqa: F401


def _net(static: bool, anti_alias: bool, seed: int):
  torch.manual_seed(seed)
  if static:
    return StaticAggregator(32, 16, anti_alias_pooling=anti_alias)
  return DynamicAggregator(32, 16, shift=1.0)


def _index(w_off: int, kp: int, np_: int, n: int, k: int) -> int:
  """Where csrc/sm90_common.cuh finds W[n, k]: blocks of at most 64 x 64
  one after the other, core matrices (n8, k8) row-major inside a block."""
  bn, bk = min(64, np_ - (n & ~63)), min(64, kp - (k & ~63))
  return (w_off + (n & ~63) * kp + bn * (k & ~63)
          + (((n & 63) >> 3) * (bk // 8) + ((k & 63) >> 3)) * 64
          + (n & 7) * 8 + (k & 7))


@pytest.mark.parametrize("static,anti_alias",
                         [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize("seed", [0, 1])
def test_tiled_weights_round_trip(static, anti_alias, seed):
  net = _net(static, anti_alias, seed)
  w, _, meta = agg.pack_weights(net, static)
  tiled = agg.tile_weights(w, meta)
  assert torch.equal(agg.pack_tiled(net, static), tiled)
  assert tiled.dtype == torch.bfloat16 and tiled.shape == w.shape
  for i, slot in enumerate(agg._layer_list(net, static)):
    if slot is None or isinstance(slot[0], str):
      continue
    w_off, _, kp, np_ = (int(x) for x in meta[i])
    n, k = slot[0].shape
    nn, kk = np.meshgrid(np.arange(np_), np.arange(kp), indexing="ij")
    idx = np.vectorize(lambda a, b: _index(w_off, kp, np_, a, b))(nn, kk)
    back = tiled[torch.from_numpy(idx)]
    assert torch.equal(back[:n, :k], slot[0].detach().to(torch.bfloat16))
    assert not back[n:].any() and not back[:, k:].any()
    # every element of the layer once: the layout is a permutation
    assert sorted(idx.reshape(-1).tolist()) == list(
        range(w_off, w_off + np_ * kp))
  # a second call returns the cached layout until a parameter changes
  assert agg.pack_tiled(net, static) is agg.pack_tiled(net, static)
  first = agg.pack_tiled(net, static)
  with torch.no_grad():
    next(net.parameters()).add_(1.0)
  assert agg.pack_tiled(net, static) is not first


@pytest.mark.parametrize("static,anti_alias",
                         [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize("seed", [0, 1])
def test_fragment_weights_hold_each_lanes_b_fragments(static, anti_alias,
                                                       seed):
  """``pack_frag``, the layout of the forwards' products
  (csrc/agg_common.cuh dense_deep): lane l's 16 bytes for 16x16 tile
  (nt, kk) of a layer are the bf16 pairs its mma.sync B fragments take
  from the row-major layer, rows nt*16 + g (+ 8), columns kk*16 + 2t (+ 8)
  and the next, g = l / 4 and t = l % 4, in that order."""
  net = _net(static, anti_alias, seed)
  w, _, meta = agg.pack_weights(net, static)
  frag = agg.pack_frag(net, static)
  assert frag.dtype == torch.bfloat16 and frag.shape == w.shape
  seen = 0
  for i, slot in enumerate(agg._layer_list(net, static)):
    if slot is None or isinstance(slot[0], str):
      continue
    w_off, _, kp, np_ = (int(x) for x in meta[i])
    layer = w[w_off:w_off + np_ * kp].view(np_, kp)
    got = frag[w_off:w_off + np_ * kp].view(np_ // 16, kp // 16, 32, 8)
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    for nt in range(np_ // 16):
      for kk in range(kp // 16):
        rows = nt * 16 + g
        cols = kk * 16 + 2 * t
        want = torch.stack([layer[rows, cols], layer[rows, cols + 1],
                            layer[rows, cols + 8], layer[rows, cols + 9],
                            layer[rows + 8, cols], layer[rows + 8, cols + 1],
                            layer[rows + 8, cols + 8],
                            layer[rows + 8, cols + 9]], 1)
        assert torch.equal(got[nt, kk], want), (i, nt, kk)
    # every element of the layer once: the layout is a permutation
    assert sorted(agg._frag_order(np_, kp).tolist()) == list(
        range(np_ * kp))
    seen += 1
  assert seen >= 15
  assert agg.pack_frag(net, static) is agg.pack_frag(net, static)
  first = agg.pack_frag(net, static)
  with torch.no_grad():
    next(net.parameters()).add_(1.0)
  assert agg.pack_frag(net, static) is not first


@pytest.mark.parametrize("static,anti_alias",
                         [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize("seed", [0, 1])
def test_transposed_fragment_weights_hold_each_lanes_b_fragments(
    static, anti_alias, seed):
  """``pack_frag_t``, the layout of the trunk backwards' transposed products
  (csrc/trunk_bwd.cuh, dense_deep on W^T): lane l's 16 bytes for 16x16
  tile (nt, kk) of a layer's padded transpose W^T [K, N] are the bf16
  pairs its mma.sync B fragments take from W^T, rows nt*16 + g (+ 8),
  columns kk*16 + 2t (+ 8) and the next, g = l / 4 and t = l % 4, in that
  order: W[kk*16 + 2t, nt*16 + g] and W[kk*16 + 2t + 1, nt*16 + g] first."""
  net = _net(static, anti_alias, seed)
  w, _, meta = agg.pack_weights(net, static)
  frag_t = agg.pack_frag_t(net, static)
  assert frag_t.dtype == torch.bfloat16 and frag_t.shape == w.shape
  seen = 0
  for i, slot in enumerate(agg._layer_list(net, static)):
    if slot is None or isinstance(slot[0], str):
      continue
    w_off, _, kp, np_ = (int(x) for x in meta[i])
    wt = w[w_off:w_off + np_ * kp].view(np_, kp).t()     # [K, N]
    got = frag_t[w_off:w_off + np_ * kp].view(kp // 16, np_ // 16, 32, 8)
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    for nt in range(kp // 16):
      for kk in range(np_ // 16):
        rows = nt * 16 + g
        cols = kk * 16 + 2 * t
        want = torch.stack([wt[rows, cols], wt[rows, cols + 1],
                            wt[rows, cols + 8], wt[rows, cols + 9],
                            wt[rows + 8, cols], wt[rows + 8, cols + 1],
                            wt[rows + 8, cols + 8],
                            wt[rows + 8, cols + 9]], 1)
        assert torch.equal(got[nt, kk], want), (i, nt, kk)
    # the layer's values once each, only moved
    assert torch.equal(frag_t[w_off:w_off + np_ * kp].sort().values,
                       w[w_off:w_off + np_ * kp].sort().values)
    seen += 1
  assert seen >= 15
  assert agg.pack_frag_t(net, static) is agg.pack_frag_t(net, static)
  first = agg.pack_frag_t(net, static)
  with torch.no_grad():
    next(net.parameters()).add_(1.0)
  assert agg.pack_frag_t(net, static) is not first


@pytest.mark.parametrize("static,anti_alias",
                         [(True, True), (True, False), (False, False)])
def test_unpack_grads_maps_the_slab_onto_each_parameter(static, anti_alias):
  net = _net(static, anti_alias, 3)
  d = random_inputs(torch.device("cpu"), 2, 16, 5, seed=4)
  names = (("pts", "ref_pl", "src_pl", "rgb_feat", "ray_diff", "mask")
           if static else ("pts", "rgb_feat", "ray_dir", "mask", "time"))
  cot = torch.randn(2, 16, 4, generator=torch.Generator().manual_seed(5))
  (net(*[d[k] for k in names]) * cot).sum().backward()
  w, b, meta = agg.pack_weights(net, static)
  w_total = w.numel()
  slab = torch.full((w_total + b.numel(),), float("nan"))
  params = agg.kernel_params(net, static)
  for i, slot in enumerate(agg._layer_list(net, static)):
    if slot is None:
      continue
    w_off, b_off, kp, np_ = (int(x) for x in meta[i])
    if i == agg._AA_S:
      continue                      # d_s comes summed beside the slab
    if i == agg._LN:
      slab[w_total + b_off:w_total + b_off + 128] = slot[1].grad
      slab[w_total + b_off + 128:w_total + b_off + 256] = slot[2].grad
      continue
    wgt, bias = slot
    n, k = wgt.shape
    g = torch.zeros(np_, kp)
    g[:n, :k] = wgt.grad
    slab[w_off:w_off + np_ * kp] = g.reshape(-1)
    slab[w_total + b_off:w_total + b_off + np_] = 0.0
    if bias is not None:
      slab[w_total + b_off:w_total + b_off + n] = bias.grad
  d_s = net.s.grad if static and anti_alias else None
  got = agg.unpack_grads(net, static, meta, slab, w_total, d_s)
  assert len(got) == len(params)
  for g, p in zip(got, params):
    assert g.shape == p.shape
    assert torch.equal(g, p.grad)


def _ring_segments():
  """Every weight-ring segment of the Hopper kernels, parsed from their
  headers: (header, name, [(slot, transposed)])."""
  csrc = agg.build.CSRC
  names = re.search(r"enum Layer \{(.*?)\};",
                    (csrc / "agg_common.cuh").read_text(), re.S).group(1)
  slot = {n.strip(): i for i, n in enumerate(
      re.sub(r"//[^\n]*", "", names).replace("\n", " ").split(","))
          if n.strip()}
  out = []
  for header in ("ray_bwd_sm90.cuh", "trunk_bwd_sm90.cuh"):
    text = (csrc / header).read_text()
    for name, body in re.findall(r"const WOp (k\w+)\[\d+\] = \{(.*?)\};",
                                 text, re.S):
      ops = [(slot[l], int(t)) for l, t in
             re.findall(r"\{(\w+), ([01])\}", body)]
      out.append((header, name, ops))
  return out


def _ring_limits():
  text = (agg.build.CSRC / "sm90_common.cuh").read_text()
  return tuple(int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
               for k in ("kRingOps", "kRingSlabs"))


@pytest.mark.parametrize("static", [True, False])
@pytest.mark.parametrize("both", [False, True])
def test_ring_slabs_are_the_tiled_blocks(static, both):
  """Each slab the ring's begin() copies for a segment (csrc/sm90_common.cuh
  OpGeom::block, the copy's source offset and bytes) is exactly the 64 x
  64 block of W that the product expects, in the tiled pack; every
  segment of the kernels that read this net's pack fits the ring's op and
  slab tables (begin() traps past them)."""
  net = _net(static, True, 0)
  w, _, meta = agg.pack_weights(net, static)
  tiled = agg.tile_weights(w, meta)
  max_ops, max_slabs = _ring_limits()
  # the dynamic net's pack serves K4a (ray_bwd_sm90.cuh) and its own
  # heads' segment; the static net's, K5a and K5b
  segments = [seg for seg in _ring_segments()
              if (seg[1] != "kHeads") == static
              or (not static and seg[0] == "ray_bwd_sm90.cuh"
                  and seg[1] in ("kA", "kC", "kD"))]
  assert any(name == ("kView" if static else "kHeads")
             for _, name, _ in segments)
  for hdr, name, ops in segments:
    assert len(ops) <= max_ops, (hdr, name)
    slabs = 0
    for layer, trans in ops:
      w_off, _, kp, np_ = (int(x) for x in meta[layer])
      assert np_ > 0, (hdr, name, layer)
      wo, wr = (kp, np_) if trans else (np_, kp)
      ncb, nkb = -(-wo // 64), -(-wr // 64)
      blocks = []
      for s in range(ncb * nkb):       # OpGeom::block
        np2 = ncb >> 1
        if both:
          cb, kb = s // nkb, s % nkb
        elif s < np2 * 2 * nkb:
          rem = s % (2 * nkb)
          cb, kb = 2 * (s // (2 * nkb)) + (rem & 1), rem >> 1
        else:
          cb, kb = ncb - 1, s - np2 * 2 * nkb
        blocks.append((cb, kb))
      assert sorted(blocks) == [(c, k) for c in range(ncb)
                                for k in range(nkb)]
      layer_w = w[w_off:w_off + np_ * kp].view(np_, kp)
      for cb, kb in blocks:
        bw, bk = min(64, wo - 64 * cb), min(64, wr - 64 * kb)
        n0, bn = (64 * kb, bk) if trans else (64 * cb, bw)
        k0, bkk = (64 * cb, bw) if trans else (64 * kb, bk)
        src, count = w_off + n0 * kp + bn * k0, bn * bkk
        got = tiled[src:src + count].view(bn // 8, bkk // 8, 8, 8)
        want = layer_w[n0:n0 + bn, k0:k0 + bkk].reshape(
            bn // 8, 8, bkk // 8, 8).permute(0, 2, 1, 3)
        assert torch.equal(got, want), (hdr, name, layer, cb, kb)
        assert 2 * count <= 64 * 64 * 2
      slabs += ncb * nkb
    assert slabs <= max_slabs, (hdr, name, slabs)
