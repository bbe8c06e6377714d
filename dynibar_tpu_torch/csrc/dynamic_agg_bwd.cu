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
// Design: K4a is ray_bwd_sm90.cuh (K5a's body, with STATIC false), on
// sm90_common.cuh: every layer product on wgmma from weight slabs that bulk
// copies stage in shared memory from the tiled pack (ops/agg.py
// pack_tiled), the attention on mma.sync (attn_mma.cuh).  K4b is
// trunk_bwd.cuh: bf16 mma.sync with the weights and their transposes read
// fragment-major from L2 (ops/agg.py pack_frag, pack_frag_t) eight k-steps
// ahead, 512 threads per block (a weight ring on wgmma was not faster,
// PERF.md).  Both add weight gradients on mma.sync into per-block slabs
// summed by reduce_slabs.

#include "ray_bwd_sm90.cuh"
#include "trunk_bwd.cuh"

namespace agg {

__global__ void __launch_bounds__(NT, 1)
    dynamic_ray_bwd_kernel(RayBwd90Args a) {
  ray_bwd90_rays<false>(a);
}

// K4a's attention alone (attn_mma.cuh, with the buffers' strides of
// ray_bwd_sm90.cuh), for holding it against a plain attention on the card
// (utils/kernel_check.py ray_attention): one ray per block, q / k / v /
// d_o [R, S, 128] bf16 and each query's count of valid views [R, S] in;
// o, d_q, d_k, d_v [R, S, 128] bf16 and the row statistics [R, 12, SMAX]
// (max, sum, D) out.
struct AttnCheckArgs {
  const bf16 *q, *k, *v, *d_o;
  const float* nvalid;
  bf16 *o, *dq, *dk, *dv;
  float* stats;
  int S;
};

constexpr size_t kAttnCheckSmem =
    (size_t)SMAX * (3 * 128 + 3 * LDG) * 2 + SMAX * 4;

__global__ void __launch_bounds__(NT, 1)
    attn_check_kernel(AttnCheckArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Q = (bf16*)smem;
  bf16* K = Q + SMAX * 128;
  bf16* Vv = K + SMAX * 128;
  bf16* O = Vv + SMAX * 128;                   // [SMAX][LDG] each
  bf16* DO = O + SMAX * LDG;
  bf16* DQ = DO + SMAX * LDG;
  float* snv = (float*)(DQ + SMAX * LDG);
  const int S = a.S, Sp = (S + 15) & ~15;
  const size_t p0 = (size_t)blockIdx.x * S;
  for (int e = threadIdx.x; e < Sp * 128; e += NT) {
    const int r = e >> 7, c = e & 127;
    const size_t g = (p0 + r) * 128 + c;
    const bf16 z = __float2bfloat16(0.f);
    Q[e] = r < S ? a.q[g] : z;
    K[e] = r < S ? a.k[g] : z;
    Vv[e] = r < S ? a.v[g] : z;
    DO[r * LDG + c] = r < S ? a.d_o[g] : z;
  }
  for (int i = threadIdx.x; i < Sp; i += NT)
    snv[i] = i < S ? a.nvalid[p0 + i] : 0.f;
  __syncthreads();
  float* st_m = a.stats + (size_t)blockIdx.x * 12 * SMAX;
  attn_fwd_mma(Q, K, Vv, O, snv, S, Sp, st_m, st_m + 4 * SMAX);
  __syncthreads();
  attn_bwd_mma(Q, K, Vv, DO, DQ, snv, S, Sp, st_m, st_m + 4 * SMAX,
               st_m + 8 * SMAX);
  for (int e = threadIdx.x; e < S * 128; e += NT) {
    const int r = e >> 7, c = e & 127;
    const size_t g = (p0 + r) * 128 + c;
    a.o[g] = O[r * LDG + c];
    a.dq[g] = DQ[r * LDG + c];
    a.dk[g] = K[e];
    a.dv[g] = Vv[e];
  }
}

}  // namespace agg

using namespace agg;

extern "C" int dyn_dynamic_agg_bwd_ray(
    const void* Wt, const void* B, const void* meta, const void* gf,
    const void* ws_x, const void* ws_vis, const void* ws_m, const void* cot,
    const void* posenc, const void* pts, const void* dirpe, void* dx,
    void* dmisc, void* d_pts, void* d_dirpe, void* scratch, void* stats,
    void* slabs, int slab_len, int w_total, int R, int S, int V, int C,
    int nblocks, void* stream) {
  if (V > VMAX || S > SMAX || C > CMAX || V < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  RayBwd90Args a{};
  a.Wt = (const bf16*)Wt;
  a.B = (const float*)B;
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
  a.stats = (float*)stats;
  a.slabs = (float*)slabs;
  a.slab_len = slab_len;
  a.w_total = w_total;
  return launch_persistent(dynamic_ray_bwd_kernel, kDynRayBwdSmem, a, R,
                           nblocks, (cudaStream_t)stream);
}

extern "C" int dyn_attention_check(const void* q, const void* k,
                                   const void* v, const void* d_o,
                                   const void* nvalid, void* o, void* dq,
                                   void* dk, void* dv, void* stats, int R,
                                   int S, void* stream) {
  if (S > SMAX || S < 1) return (int)cudaErrorInvalidValue;
  AttnCheckArgs a{(const bf16*)q, (const bf16*)k, (const bf16*)v,
                  (const bf16*)d_o, (const float*)nvalid, (bf16*)o,
                  (bf16*)dq, (bf16*)dk, (bf16*)dv, (float*)stats, S};
  return launch_persistent(attn_check_kernel, kAttnCheckSmem, a, R, R,
                           (cudaStream_t)stream);
}

extern "C" int dyn_dynamic_agg_bwd_trunk(
    const void* WF, const void* WTF, const void* B,
    const void* meta, const void* rgbfeat, const void* mask,
    const void* dirfeat, const void* dx, const void* dmisc, void* drf,
    void* d_rgbfeat, void* d_dirfeat, void* slabs, int slab_len, int w_total,
    int R, int S, int V, int C, int nblocks, void* stream) {
  if (V > VMAX || S > SMAX || C > CRMAX || V < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  TrunkBwdArgs a{};
  a.WF = (const bf16*)WF;
  a.WTF = (const bf16*)WTF;
  a.B = (const float*)B;
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
  return launch_persistent(trunk_bwd_kernel<false>, trunk_bwd_smem(V), a,
                           (a.P + PT - 1) / PT, nblocks,
                           (cudaStream_t)stream, kTrunkBwdThreads);
}

extern "C" int dyn_agg_reduce(const void* slabs, int nslab, int len,
                              void* out, void* stream) {
  return launch_reduce((const float*)slabs, nslab, len, (float*)out,
                       (cudaStream_t)stream);
}

// The kernels' footprints at V views and the blocks an SM holds:
// out = {ray bytes, ray blocks, trunk bytes, trunk blocks}.
extern "C" int dyn_occupancy(int V, int* out) {
  out[0] = (int)kDynRayBwdSmem;
  out[1] = blocks_per_sm(dynamic_ray_bwd_kernel, kDynRayBwdSmem);
  out[2] = (int)trunk_bwd_smem(V);
  out[3] = blocks_per_sm(trunk_bwd_kernel<false>, trunk_bwd_smem(V),
                         kTrunkBwdThreads);
  return (int)cudaGetLastError();
}
