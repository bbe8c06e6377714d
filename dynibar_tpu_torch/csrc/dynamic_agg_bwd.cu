// K4a / K4b: the split backward of the dynamic aggregator (reference
// DynibarDynamic, ibrnet/mlp_network.py:129-316).
//
// K4a replaces dynibar_tpu/ops/pallas_agg_bwd.py:514 dynamic_bwd_ray_kernel
// (launched by pallas_agg.py:1089): pooling-2 -> geometry_fc -> attention
// -> ref_pts_fc -> sigma / rgb heads, transposed; 24 weight gradients,
// d_x (bf16), d_vis, d_pts and d_dirpe.  K4b replaces :733
// dynamic_bwd_trunk_kernel (pallas_agg.py:1119): pooling-1 and the per-view
// trunk, transposed; 12 weight gradients, d_rgb_feat and d_dirfeat.  Both
// read the residuals K3r (dynamic_agg.cu with its workspaces kept) left:
// x [V, P, 128] bf16, vis / mask [V, P], the geometry feature [P, 128].
//
// What bounds them on the H100: operations.  About three times the
// forward's matmul flops per point (trunk recompute, dX, dW), far above the
// card's ~295 flop/byte ridge.
//
// Design: ray_bwd.cuh and trunk_bwd.cuh (bf16 mma.sync, f32 accumulation
// and reductions, persistent blocks with private weight-gradient slabs
// summed by reduce_slabs).  Simple and correct first: no wgmma, no TMA.

#include "ray_bwd.cuh"
#include "trunk_bwd.cuh"

using namespace agg;

extern "C" int dyn_dynamic_agg_bwd_ray(
    const void* W, const void* WT, const void* B, const void* Z,
    const void* meta, const void* gf, const void* ws_x, const void* ws_vis,
    const void* ws_m, const void* cot, const void* posenc, const void* pts,
    const void* dirpe, void* dx, void* dmisc, void* d_pts, void* d_dirpe,
    void* scratch, void* slabs, int slab_len, int w_total, int R, int S,
    int V, int C, int nblocks, void* stream) {
  if (V > VMAX || S > SMAX || C > CMAX || V < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  RayBwdArgs a{};
  a.W = (const bf16*)W;
  a.WT = (const bf16*)WT;
  a.B = (const float*)B;
  a.Z = (const float*)Z;
  a.net = load_net((const int*)meta);
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
  a.posenc = (const float*)posenc;
  a.pts = (const float*)pts;
  a.dirpe = (const float*)dirpe;
  a.dx = (bf16*)dx;
  a.dmisc = (float*)dmisc;
  a.d_pts = (float*)d_pts;
  a.d_dirpe = (float*)d_dirpe;
  a.scratch = (float*)scratch;
  a.slabs = (float*)slabs;
  a.slab_len = slab_len;
  a.w_total = w_total;
  return launch_persistent(ray_bwd_kernel, kRayBwdSmem, a, R, nblocks,
                           (cudaStream_t)stream);
}

extern "C" int dyn_dynamic_agg_bwd_trunk(
    const void* W, const void* WT, const void* B, const void* Z,
    const void* meta, const void* rgbfeat, const void* mask,
    const void* dirfeat, const void* dx, const void* dmisc, void* drf,
    void* d_rgbfeat, void* d_dirfeat, void* slabs, int slab_len, int w_total,
    int R, int S, int V, int C, int nblocks, void* stream) {
  if (V > VMAX || S > SMAX || C > CRMAX || V < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  TrunkBwdArgs a{};
  a.W = (const bf16*)W;
  a.WT = (const bf16*)WT;
  a.B = (const float*)B;
  a.Z = (const float*)Z;
  a.net = load_net((const int*)meta);
  a.rgbfeat = (const bf16*)rgbfeat;
  a.mask = (const float*)mask;
  a.P = R * S;
  a.S = S;
  a.V = V;
  a.C = C;
  a.dirfeat = (const float*)dirfeat;
  a.dx = (const bf16*)dx;
  a.dmisc = (const float*)dmisc;
  a.drf = (float*)drf;
  a.d_rgbfeat = (float*)d_rgbfeat;
  a.d_dirfeat = (float*)d_dirfeat;
  a.slabs = (float*)slabs;
  a.slab_len = slab_len;
  a.w_total = w_total;
  return launch_persistent(trunk_bwd_kernel<false>,
                           trunk_bwd_smem(V), a,
                           (a.P + PT - 1) / PT, nblocks,
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
  out[0] = (int)kRayBwdSmem;
  out[1] = blocks_per_sm(ray_bwd_kernel, kRayBwdSmem);
  out[2] = (int)trunk_bwd_smem(V);
  out[3] = blocks_per_sm(trunk_bwd_kernel<false>,
                         trunk_bwd_smem(V));
  return (int)cudaGetLastError();
}
