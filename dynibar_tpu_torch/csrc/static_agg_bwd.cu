// K5a / K5b: the split backward of the static aggregator (reference
// DynibarStatic, ibrnet/mlp_network.py:319-527), for Hopper.
//
// K5a replaces dynibar_tpu/ops/pallas_agg_bwd.py:879 static_bwd_ray_kernel
// (launched by pallas_agg.py:640): pooling-2 -> geometry_fc -> attention ->
// sigma head and the per-view blend-logit rgb head with its softmax over
// views, transposed; 20 weight gradients, d_x (bf16) and d_misc (d_vis,
// d_rgb, d_ray_diff).  K5b replaces :1109 static_bwd_trunk_kernel
// (pallas_agg.py:749): per-view input MLP ray_dir_fc, the anti-alias
// pooling weights, pooling-1 and the trunk, transposed; 16 weight
// gradients, d_rgb_feat, d_ray_diff (incl. d_dot through exp(|s|(dot-1))
// minus its per-point minimum), d_src_pl, d_pts, d_reffeat and d_s per
// point.  Both read the residuals of K2r (static_agg.cu with its
// workspaces kept): x, vis / mask, rf [V, P, 2C] and the geometry feature.
//
// What bounds them on the H100: operations (about 5 MFLOP per point at V
// = 11 in the forward, roughly three times that here).
//
// Design: ray_bwd_sm90.cuh and trunk_bwd_sm90.cuh, on sm90_common.cuh:
// wgmma products on weight slabs that bulk copies stage in shared memory
// from the tiled pack (ops/agg.py pack_tiled).  The three-kernel route
// (K5a, then K5c + K5d) is static_agg_bwd3.cu.

#include "ray_bwd_sm90.cuh"
#include "trunk_bwd_sm90.cuh"

namespace agg {

__global__ void __launch_bounds__(NT, 1)
    static_ray_bwd_kernel(RayBwd90Args a) {
  ray_bwd90_rays<true>(a);
}

}  // namespace agg

using namespace agg;

extern "C" int dyn_static_agg_bwd_ray(
    const void* Wt, const void* B, const void* meta, const void* gf,
    const void* ws_x, const void* ws_vis, const void* ws_m, const void* cot,
    const void* raydiff, const void* rgbfeat, void* dx, void* dmisc,
    void* scratch, void* stats, void* slabs, int slab_len, int w_total,
    int R, int S, int V, int C, int nblocks, void* stream) {
  RayBwd90Args a{};
  a.net = load_net((const int*)meta);
  if (V > VMAX || S > SMAX || C > CMAX || V < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  a.Wt = (const bf16*)Wt;
  a.B = (const float*)B;
  a.gf = (const float*)gf;
  a.ws_x = (const bf16*)ws_x;
  a.ws_vis = (const float*)ws_vis;
  a.ws_m = (const float*)ws_m;
  a.cot = (const float*)cot;
  a.P = R * S;
  a.S = S;
  a.V = V;
  a.C = C;
  a.R = R;
  a.raydiff = (const float*)raydiff;
  a.rgbfeat = (const bf16*)rgbfeat;
  a.dx = (bf16*)dx;
  a.dmisc = (float*)dmisc;
  a.scratch = (float*)scratch;
  a.stats = (float*)stats;
  a.slabs = (float*)slabs;
  a.slab_len = slab_len;
  a.w_total = w_total;
  return launch_persistent(static_ray_bwd_kernel, kStaticRayBwdSmem, a, R,
                           nblocks, (cudaStream_t)stream);
}

extern "C" int dyn_static_agg_bwd_trunk(
    const void* Wt, const void* B, const void* meta, const void* rgbfeat,
    const void* mask, const void* pts, const void* reffeat,
    const void* raydiff, const void* srcpl, const void* ws_rf,
    int anti_alias, int mask_rgb, const void* dx, const void* dmisc,
    void* drf, void* ws_dgf, void* d_rgbfeat, void* d_raydiff,
    void* d_srcpl, void* d_pts, void* d_reffeat, void* d_s, void* slabs,
    int slab_len, int w_total, int R, int S, int V, int C, int nblocks,
    void* stream) {
  StaticTrunkBwdArgs a{};
  a.net = load_net((const int*)meta);
  if (V > VMAX || S > SMAX || 2 * C > kTrunkCrMax || V < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  a.Wt = (const bf16*)Wt;
  a.B = (const float*)B;
  a.rgbfeat = (const bf16*)rgbfeat;
  a.mask = (const float*)mask;
  a.P = R * S;
  a.S = S;
  a.V = V;
  a.C = C;
  a.pts = (const float*)pts;
  a.reffeat = (const float*)reffeat;
  a.raydiff = (const float*)raydiff;
  a.srcpl = (const float*)srcpl;
  a.anti_alias = anti_alias;
  a.mask_rgb = mask_rgb;
  a.ws_rf = (const bf16*)ws_rf;
  a.dx = (const bf16*)dx;
  a.dmisc = (const float*)dmisc;
  a.drf = (float*)drf;
  a.ws_dgf = (float*)ws_dgf;
  a.d_rgbfeat = (float*)d_rgbfeat;
  a.d_raydiff = (float*)d_raydiff;
  a.d_srcpl = (float*)d_srcpl;
  a.d_pts = (float*)d_pts;
  a.d_reffeat = (float*)d_reffeat;
  a.d_s = (float*)d_s;
  a.slabs = (float*)slabs;
  a.slab_len = slab_len;
  a.w_total = w_total;
  return launch_persistent(static_trunk_bwd_kernel, static_trunk_bwd_smem(V),
                           a, (a.P + PT - 1) / PT, nblocks,
                           (cudaStream_t)stream);
}

extern "C" int dyn_agg_reduce(const void* slabs, int nslab, int len,
                              void* out, void* stream) {
  return launch_reduce((const float*)slabs, nslab, len, (float*)out,
                       (cudaStream_t)stream);
}

// The kernels' footprints at V views and the blocks an SM holds:
// out = {ray bytes, ray blocks, trunk bytes, trunk blocks}.
extern "C" int dyn_occupancy(int V, int* out) {
  out[0] = (int)kStaticRayBwdSmem;
  out[1] = blocks_per_sm(static_ray_bwd_kernel, kStaticRayBwdSmem);
  out[2] = (int)static_trunk_bwd_smem(V);
  out[3] = blocks_per_sm(static_trunk_bwd_kernel, static_trunk_bwd_smem(V));
  return (int)cudaGetLastError();
}
