// K4s: the whole dynamic-aggregator backward in one launch (reference
// DynibarDynamic, ibrnet/mlp_network.py:129-316).
//
// Replaces dynibar_tpu/ops/pallas_agg_bwd.py:163 dynamic_bwd_kernel
// (launched by pallas_agg.py:981, route fused_bwd_impl = "pallas"): from
// the primal inputs alone (K3p, the K3 forward, keeps no residuals) it
// recomputes pooling-1, the trunk, pooling-2 and geometry_fc for a ray,
// then transposes the ray side (heads, sigma - shift, ref_pts_fc,
// attention, pooling-2, geometry_fc) and the trunk side (the per-view
// trunk, pooling-1): d_pts, d_dirpe, d_rgb_feat, d_dirfeat and the 36
// weight gradients, added into the 16 L2-resident slabs that the one
// reduce sums afterwards.
//
// What bounds it on the H100: operations.  The forward trunk it recomputes
// plus about three times the forward's matmul flops (the split's K4a and
// K4b recompute and transpose the same layers), far above the card's ~295
// flop/byte ridge.
//
// Design: persistent blocks, one ray at a time per block, three phases
// that are the split route's device code: the K3 trunk (agg_common.cuh
// trunk_block), K4a's Hopper ray body (ray_bwd_sm90.cuh ray_bwd90_ray:
// every layer product on wgmma from the weight ring, the attention on
// mma.sync, attn_mma.cuh) and K4b's trunk body (trunk_bwd.cuh
// trunk_bwd_block at 256 threads), back to back with a block barrier
// between them, so K4s computes the split's arithmetic.  The recomputed
// x [V, S, 128] bf16 (163,840 B at V = 10, S = 64) does not fit beside the
// ray phase's shared memory, so the phases hand one ray's workspaces (x,
// vis, mask, the geometry feature, d_x, d_misc, d_rf) over in a per-block
// global scratch the wrapper allocates: the split's hand-off inside one
// launch, at nblocks rays' worth of memory instead of every ray's.  The
// phases share one dynamic shared-memory buffer sized to the largest of
// them; the ring's slabs are its first 24 KB, which the trunk phases
// overwrite (the ring is empty between rays: every slab a ray phase
// issues, it consumes), and the ring's mbarriers sit past every phase's
// buffer, so they live across rays.  A ray of S = 128 samples is two
// 64-point trunk blocks; at any other S its last trunk block is masked at
// the ray's end (the trunk phases' point limit is the ray's last point),
// so the samples are never padded, which would change the ray's
// attention.  In the phase-clock build thread 0 adds up the phases'
// cycles and its waits at the barriers between them (SinglePhase).

#include "ray_bwd_sm90.cuh"
#include "trunk_bwd.cuh"

using namespace agg;

namespace {

struct SingleBwdArgs {
  TrunkArgs f;           // forward trunk (its workspace pointers: scratch)
  RayBwd90Args r;
  TrunkBwdArgs t;
  int R, S, V, C;
  int ring_off;          // the ring's bookkeeping: single_ring_off(V)
  // per-block scratch, one ray's rows each
  bf16* sx;              // [nblocks, V, S, 128] trunk output x
  bf16* sdx;             // [nblocks, V, S, 128] its cotangent
  float* svm;            // [nblocks, 2, V, S] vis | effective mask
  float* sgf;            // [nblocks, S, 128] geometry feature
  float* snv;            // [nblocks, S] valid views
  float* sdmisc;         // [nblocks, V, S, 8] d_vis in slot 0
  float* sdrf;           // [nblocks, V, S, C] per-view d_rf
};

__host__ __device__ constexpr size_t cmax(size_t a, size_t b) {
  return a > b ? a : b;
}

// the ring's bookkeeping, past every phase's buffer
constexpr size_t single_ring_off(int V) {
  return cmax(cmax(trunk_smem(V), kDynRayBwdSmem), trunk_bwd_smem(V));
}
constexpr size_t single_smem(int V) {
  return single_ring_off(V) + kRingSmemBytes;
}
static_assert(single_smem(VMAX) <= 232448, "one K4s block fits an SM");

// The forward trunk as a call, the two backward phases inlined: as calls
// they read their arguments (and the ray phase its ring) from local memory
// and spilled, and K4s ran 6-8% slower; inlining the trunk too gained
// 0-2% more for a build half as long again (PERF.md).
__device__ __noinline__ void phase_trunk(const TrunkArgs& f, int p0,
                                         const WsMap ws) {
  trunk_block<false>(f, p0, ws);
}

__global__ void __launch_bounds__(NT, 1)
    dynamic_bwd_single_kernel(SingleBwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = a.S, V = a.V;
  const size_t b = blockIdx.x, vs = (size_t)V * S;
  TrunkArgs f = a.f;
  RayBwd90Args r = a.r;
  TrunkBwdArgs t = a.t;
  f.ws_x = a.sx + b * vs * 128;
  f.ws_vis = a.svm + b * 2 * vs;
  f.ws_m = f.ws_vis + vs;
  f.ws_gf = a.sgf + b * S * 128;
  f.ws_nv = a.snv + b * S;
  r.gf = f.ws_gf;
  r.ws_x = f.ws_x;
  r.ws_vis = f.ws_vis;
  r.ws_m = f.ws_m;
  r.dx = a.sdx + b * vs * 128;
  r.dmisc = a.sdmisc + b * vs * 8;
  t.dx = r.dx;
  t.dmisc = r.dmisc;
  t.drf = a.sdrf + b * vs * a.C;
  WRing<kRayStages> ring;
  ring.init((RingSmem*)(smem + a.ring_off), smem, r.Wt, &r.net,
            RP_RING_WAIT);
  __syncthreads();
  PhaseClock clk;
  for (int ray = blockIdx.x; ray < a.R; ray += gridDim.x) {
    const int first = ray * S;
    const WsMap ws{S, first};
    f.P = t.P = first + S;           // the ray's last trunk block is masked
    for (int p0 = first; p0 < first + S; p0 += PT) {
      phase_trunk(f, p0, ws);
      clk(SP_TRUNK);
      __syncthreads();
      clk(SP_HANDOFF);
    }
    ray_bwd90_ray<false>(r, ray, ring, smem + kRayRing, ws);
    clk(SP_RAY);
    __syncthreads();
    clk(SP_HANDOFF);
    for (int p0 = first; p0 < first + S; p0 += PT) {
      trunk_bwd_block<false, NT>(t, p0, ws);
      clk(SP_TRUNK_BWD);
      __syncthreads();
      clk(SP_HANDOFF);
    }
  }
}

}  // namespace

extern "C" int dyn_dynamic_agg_bwd_single(
    const void* Wt, const void* WF, const void* WTF, const void* B,
    const void* meta, const void* pts, const void* dirfeat,
    const void* dirpe, const void* posenc, const void* rgbfeat,
    const void* mask, const void* cot, void* sx, void* sdx, void* svm,
    void* sgf, void* snv, void* sdmisc, void* sdrf, void* ray_scratch,
    void* stats, void* d_pts, void* d_dirpe, void* d_rgbfeat,
    void* d_dirfeat, void* slabs, int slab_len, int w_total, int R, int S,
    int V, int C, int nblocks, void* stream) {
  if (V > VMAX || S > SMAX || C > CMAX || C > CRMAX || V < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  SingleBwdArgs a{};
  a.R = R;
  a.S = S;
  a.V = V;
  a.C = C;
  a.ring_off = (int)single_ring_off(V);
  const Net net = load_net((const int*)meta);
  TrunkArgs& f = a.f;
  f.W = (const bf16*)WF;          // the forward trunk's fragment-major pack
  f.B = (const float*)B;
  f.net = net;
  f.rgbfeat = (const bf16*)rgbfeat;
  f.mask = (const float*)mask;
  f.P = R * S;
  f.S = S;
  f.V = V;
  f.C = C;
  f.dirfeat = (const float*)dirfeat;
  RayBwd90Args& r = a.r;
  r.Wt = (const bf16*)Wt;
  r.B = f.B;
  r.net = net;
  r.cot = (const float*)cot;
  r.P = f.P;
  r.S = S;
  r.V = V;
  r.C = C;
  r.R = R;
  r.posenc = (const float*)posenc;
  r.pts = (const float*)pts;
  r.dirpe = (const float*)dirpe;
  r.d_pts = (float*)d_pts;
  r.d_dirpe = (float*)d_dirpe;
  r.scratch = (float*)ray_scratch;
  r.stats = (float*)stats;
  r.slabs = (float*)slabs;
  r.slab_len = slab_len;
  r.w_total = w_total;
  TrunkBwdArgs& t = a.t;
  t.WF = f.W;
  t.WTF = (const bf16*)WTF;
  t.B = f.B;
  t.net = net;
  t.rgbfeat = f.rgbfeat;
  t.mask = f.mask;
  t.P = f.P;
  t.S = S;
  t.V = V;
  t.C = C;
  t.dirfeat = f.dirfeat;
  t.d_rgbfeat = (float*)d_rgbfeat;
  t.d_dirfeat = (float*)d_dirfeat;
  t.slabs = r.slabs;
  t.slab_len = slab_len;
  t.w_total = w_total;
  a.sx = (bf16*)sx;
  a.sdx = (bf16*)sdx;
  a.svm = (float*)svm;
  a.sgf = (float*)sgf;
  a.snv = (float*)snv;
  a.sdmisc = (float*)sdmisc;
  a.sdrf = (float*)sdrf;
  return launch_persistent(dynamic_bwd_single_kernel, single_smem(V), a, R,
                           nblocks, (cudaStream_t)stream);
}

extern "C" int dyn_agg_reduce(const void* slabs, int nslab, int len,
                              void* out, void* stream) {
  return launch_reduce((const float*)slabs, nslab, len, (float*)out,
                       (cudaStream_t)stream);
}

// K4s's footprint at V views and the blocks an SM holds: out = {bytes,
// blocks}.
extern "C" int dyn_occupancy(int V, int* out) {
  out[0] = (int)single_smem(V);
  out[1] = blocks_per_sm(dynamic_bwd_single_kernel, single_smem(V));
  return (int)cudaGetLastError();
}
