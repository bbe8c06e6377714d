// K3: the whole dynamic aggregator (reference DynibarDynamic,
// ibrnet/mlp_network.py:129-316).
//
// Replaces dynibar_tpu/ops/pallas_agg.py:325 _dynamic_kernel (launched by
// fused_dynamic_aggregator, pallas_agg.py:1148).  Per point: the time-PE
// direction feature added to every view's features; mask mean/var
// pooling; the base/vis/vis2 trunk; re-pooling; geometry_fc.  Per ray: the
// sample-axis encoding, the 4-head ray transformer over the ray's own
// samples, ref_pts_fc with the point encoding, sigma - shift (-1e9 where no
// view is valid) and the sigmoid RGB MLP on the direction encoding (0
// where no view is valid).
//
// What bounds it on the H100: operations.  About 2 MFLOP per point at V=7,
// far above the card's ~295 flop/byte ridge.
//
// Design: agg_fwd.cuh (the Hopper forward: mma.sync on fragment-major
// weights, the trunk's weights prefetched eight k-steps ahead, the
// attention on tensor cores) over agg_common.cuh's trunk_block.

#include "agg_fwd.cuh"

extern "C" int dyn_dynamic_agg(
    const void* W, const void* B, const void* meta, const void* pts,
    const void* dirfeat, const void* dirpe, const void* posenc,
    const void* rgbfeat, const void* mask, float shift, void* ws_x,
    void* ws_vis, void* ws_m, void* ws_gf, void* ws_nv, void* out, int R,
    int S, int V, int C, void* stream) {
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
  ta.dirfeat = (const float*)dirfeat;
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
  ra.posenc = (const float*)posenc;
  ra.pts = (const float*)pts;
  ra.dirpe = (const float*)dirpe;
  ra.shift = shift;
  ra.out = (float*)out;
  return launch<false>(ta, ra, R, (cudaStream_t)stream);
}

// The two kernels' footprints at V views and the blocks an SM holds:
// out = {trunk bytes, trunk blocks, ray bytes, ray blocks}.
extern "C" int dyn_occupancy(int V, int* out) {
  using namespace agg;
  out[0] = (int)trunk_smem(V);
  out[1] = blocks_per_sm(trunk_kernel<false>, trunk_smem(V));
  out[2] = (int)kRaySmem;
  out[3] = blocks_per_sm(ray_kernel<false>, kRaySmem);
  return (int)cudaGetLastError();
}
