// K2: the whole static aggregator (reference DynibarStatic,
// ibrnet/mlp_network.py:319-527).
//
// Replaces dynibar_tpu/ops/pallas_agg.py:225 _static_kernel (launched by
// fused_static_aggregator, pallas_agg.py:783).  Per point: Plücker and
// point encodings -> ray_dir_fc x ref feature; mask_rgb masking; the
// anti-alias pooling weights exp(|s|(dot-1)) minus the per-point minimum
// over views; mean/var pooling; the base/vis/vis2 trunk; re-pooling;
// geometry_fc.  Per ray: the 4-head ray transformer over the ray's own
// samples, the sigma head (-1e9 where no view is valid), and the per-view
// blend-logit RGB head (-1e9 where the view is masked) with a softmax over
// views.
//
// What bounds it on the H100: operations.  About 5 MFLOP per point at
// V=11 (the per-view MLPs), against ~0.8 KB of input per point; it sits far
// above the card's ~295 flop/byte ridge, so only tensor-core rate matters.
//
// Design (agg_common.cuh): bf16 mma.sync tiles with f32 accumulation for every
// dense layer, f32 reductions; 64-point trunk blocks (two per SM) keep one
// view's activations in shared memory and stash the per-view trunk output
// in a global workspace (L2-resident while the block re-reads it); one
// block per ray runs attention and the heads.  Simple and correct first:
// no wgmma, no TMA.

#include "agg_common.cuh"

extern "C" int dyn_static_agg(
    const void* W, const void* B, const void* meta, const void* pts,
    const void* reffeat, const void* rgbfeat, const void* raydiff,
    const void* mask, const void* srcpl, int anti_alias,
    int mask_rgb, void* ws_rf, void* ws_x, void* ws_vis, void* ws_m,
    void* ws_gf, void* ws_nv, void* out, int R, int S, int V, int C,
    void* stream) {
  using namespace agg;
  TrunkArgs ta{};
  ta.W = (const bf16*)W;
  ta.B = (const float*)B;
  ta.net = load_net((const int*)meta);
  ta.rgbfeat = (const bf16*)rgbfeat;
  ta.mask = (const float*)mask;
  ta.P = R * S;
  ta.S = S;
  ta.V = V;
  ta.C = C;
  ta.pts = (const float*)pts;
  ta.reffeat = (const float*)reffeat;
  ta.raydiff = (const float*)raydiff;
  ta.srcpl = (const float*)srcpl;
  ta.anti_alias = anti_alias;
  ta.mask_rgb = mask_rgb;
  ta.ws_rf = (bf16*)ws_rf;
  ta.ws_x = (bf16*)ws_x;
  ta.ws_vis = (float*)ws_vis;
  ta.ws_m = (float*)ws_m;
  ta.ws_gf = (float*)ws_gf;
  ta.ws_nv = (float*)ws_nv;

  RayArgs ra{};
  ra.W = ta.W;
  ra.B = ta.B;
  ra.net = ta.net;
  ra.gf = ta.ws_gf;
  ra.nv = ta.ws_nv;
  ra.P = ta.P;
  ra.S = S;
  ra.V = V;
  ra.C = C;
  ra.ws_x = ta.ws_x;
  ra.ws_vis = ta.ws_vis;
  ra.ws_m = ta.ws_m;
  ra.raydiff = ta.raydiff;
  ra.rgbfeat = ta.rgbfeat;
  ra.out = (float*)out;
  return launch<true>(ta, ra, R, (cudaStream_t)stream);
}
