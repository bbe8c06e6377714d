// K1: exact bilinear lookup of per-view maps at normalized points.
//
// Replaces dynibar_tpu/ops/pallas_sample.py:60 _sample_kernel (launched by
// pallas_bilinear_sample_views).  Semantics: grid_sample(align_corners=True,
// padding_mode='zeros'): x = (gx + 1)/2 * (W - 1); the four integer corners
// around (x, y) contribute with bilinear weights when they lie inside the
// map, zero otherwise.  Interpolation runs in f32 and rounds once.
//
// Two entries, one kernel:
//   dyn_sample_pair  the eval path's lookup: a view set's full-resolution
//                    RGB [V,H,W,3] and feature maps [V,Hf,Wf,C] at the same
//                    normalized points, written as rgb_feat [N,V,3+C] (the
//                    aggregators' [R,S,V,3+C]) in one launch;
//   dyn_sample_views one map [V,H,W,C] -> [V,N,C].
//
// What bounds it on the H100: bytes.  It does ~8 flops per output value and
// moves the maps (about 16 MB of bf16 RGB and feature maps at the FF eval
// shape), the f32 points and the output (101 MB of bf16 rgb_feat for the
// fine stage's static views).  The maps fit the 50 MB L2, so the corner
// reads hit L2 and the kernel streams points in and rows out.
//
// Design: the output is a sequence of rows, one per (point, view) (3 + C
// values; pair: point-major, view-minor; one map: view-major).  A block
// owns a tile of rows (a multiple of 8, so that every tile starts 16-byte
// aligned) and a thread one chunk of a row: the RGB map's 3 channels, or 8
// bf16 (4 f32) feature channels read as 16-byte loads (4 scalar channels
// when C is not a multiple of that).  The RGB chunks' threads come first
// (at the main path's shapes whole warps of them).  Each thread finds its row's point and view with one division,
// computes the corners and weights, loads its four corners before the
// multiply-adds (read-only loads; 32-bit offsets, checked by the wrapper)
// and writes its values into the tile in shared memory; the block then
// writes the tile out as one contiguous range with 16-byte streaming
// stores (evict-first, so the rows do not push the maps out of the L2).
// One map whose rows are whole 16-byte chunks (the feature maps) needs no
// tile: each thread stores its chunk straight to its row.
// The TPU kernel's 32-row window, coverage mask and one-hot matmul
// interpolation have no counterpart: every sample is exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

template <typename T>
struct SampleArgs {
  const T* map_a;        // [V, HA, WA, CA]; CA = 0: none
  const T* map_b;        // [V, HB, WB, CB]
  const float* grid;     // [V, N, 2]
  T* out;                // rows of CA + CB
  int HA, WA, CA, HB, WB, CB;
  int V, N;
  int point_major;       // row q = n V + v (1) or v N + n (0)
  int na, nb, bvec;      // chunks per row of each map; B 16-byte chunks
  int direct;            // one map of 16-byte rows: chunks stored directly
  int rows;              // rows per block's tile (a multiple of 8)
};

// The four corners of normalized point g in an H x W map: pixel offsets
// (-1 outside the map) and bilinear weights, in grid_sample's order.
__device__ __forceinline__ void corners(float2 g, int H, int W,
                                        int (&pix)[4], float (&wt)[4]) {
  const float x = (g.x + 1.f) * 0.5f * (float)(W - 1);
  const float y = (g.y + 1.f) * 0.5f * (float)(H - 1);
  const float x0 = floorf(x), y0 = floorf(y);
  const float wx1 = x - x0, wy1 = y - y0;
  const float xs[2] = {x0, x0 + 1.f}, ys[2] = {y0, y0 + 1.f};
  const float wxs[2] = {1.f - wx1, wx1}, wys[2] = {1.f - wy1, wy1};
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float xc = xs[a], yc = ys[b];
      const bool in = xc >= 0.f && xc <= (float)(W - 1) && yc >= 0.f &&
                      yc <= (float)(H - 1);
      pix[2 * b + a] = in ? (int)yc * W + (int)xc : -1;
      wt[2 * b + a] = wxs[a] * wys[b];
    }
}

// k <= 4 channels from c0 of map m (one view, C channels), scalar loads.
template <typename T>
__device__ __forceinline__ void gather_scalar(const T* m, int H, int W, int C,
                                              int c0, int k, float2 g,
                                              T* dst) {
  int pix[4];
  float wt[4], val[4][4], acc[4] = {0.f, 0.f, 0.f, 0.f};
  corners(g, H, W, pix, wt);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      val[i][j] = pix[i] >= 0 && j < k ? to_f(__ldg(m + pix[i] * C + c0 + j))
                                       : 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (pix[i] >= 0)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += wt[i] * val[i][j];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < k) dst[j] = from_f<T>(acc[j]);
}

// 16 / sizeof(T) channels from c0 (a multiple of that, as C), 16-byte loads.
template <typename T>
__device__ __forceinline__ void gather_vec(const T* m, int H, int W, int C,
                                           int c0, float2 g, T* dst) {
  constexpr int VEC = 16 / sizeof(T);
  int pix[4];
  float wt[4], acc[VEC];
  uint4 raw[4];
  corners(g, H, W, pix, wt);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    raw[i] = pix[i] >= 0
                 ? __ldg(reinterpret_cast<const uint4*>(m + pix[i] * C + c0))
                 : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (pix[i] < 0) continue;
    const T* vals = reinterpret_cast<const T*>(&raw[i]);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] += wt[i] * to_f(vals[j]);
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) dst[j] = from_f<T>(acc[j]);
}

// at most 512 threads a block and three blocks an SM: 40 registers, 48
// warps in flight for the gathers' latency
template <typename T>
__global__ void __launch_bounds__(512, 3) sample_kernel(SampleArgs<T> a) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const int rl = a.CA + a.CB, t = threadIdx.x;
  // this thread's row in the tile and chunk: A chunks fill the first
  // warps, B chunks the others
  const bool is_a = t < a.rows * a.na;
  const int u = is_a ? t : t - a.rows * a.na, per = is_a ? a.na : a.nb;
  const int row = u / per, j = u - row * per;
  const int q0 = blockIdx.x * a.rows, nrows = min(a.rows, a.V * a.N - q0);
  if (row < nrows) {
    const int q = q0 + row;
    int n, v;
    if (a.point_major) {
      n = q / a.V;
      v = q - n * a.V;
    } else {
      v = q / a.N;
      n = q - v * a.N;
    }
    const float2 g =
        __ldg(reinterpret_cast<const float2*>(a.grid) + v * a.N + n);
    T* dst = tile + row * rl;
    if (a.direct) {        // straight to the row, no tile
      int4 vals;
      gather_vec(a.map_b + v * a.HB * a.WB * a.CB, a.HB, a.WB, a.CB,
                 VEC * j, g, reinterpret_cast<T*>(&vals));
      __stcs(reinterpret_cast<int4*>(a.out + q * rl + VEC * j), vals);
    } else if (is_a) {
      gather_scalar(a.map_a + v * a.HA * a.WA * a.CA, a.HA, a.WA, a.CA,
                    4 * j, min(4, a.CA - 4 * j), g, dst + 4 * j);
    } else {
      const T* m = a.map_b + v * a.HB * a.WB * a.CB;
      if (a.bvec)
        gather_vec(m, a.HB, a.WB, a.CB, VEC * j, g, dst + a.CA + VEC * j);
      else
        gather_scalar(m, a.HB, a.WB, a.CB, 4 * j, min(4, a.CB - 4 * j), g,
                      dst + a.CA + 4 * j);
    }
  }
  if (a.direct) return;
  __syncthreads();
  // the tile is one contiguous range of the output, 16-byte aligned
  const int ne = nrows * rl, n16 = ne * (int)sizeof(T) / 16;
  int4* o = reinterpret_cast<int4*>(a.out + q0 * rl);
  for (int e = t; e < n16; e += blockDim.x)
    __stcs(o + e, reinterpret_cast<const int4*>(tile)[e]);
  for (int e = n16 * (16 / (int)sizeof(T)) + t; e < ne; e += blockDim.x)
    a.out[q0 * rl + e] = tile[e];
}

template <typename T>
int launch(const void* map_a, int ha, int wa, int ca, const void* map_b,
           int hb, int wb, int cb, const void* grid, void* out, int V, int N,
           int point_major, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  SampleArgs<T> a{};
  a.map_a = (const T*)map_a;
  a.map_b = (const T*)map_b;
  a.grid = (const float*)grid;
  a.out = (T*)out;
  a.HA = ha;
  a.WA = wa;
  a.CA = ca;
  a.HB = hb;
  a.WB = wb;
  a.CB = cb;
  a.V = V;
  a.N = N;
  a.point_major = point_major;
  a.bvec = cb % VEC == 0;
  a.direct = ca == 0 && a.bvec;
  a.na = (ca + 3) / 4;
  a.nb = a.bvec ? cb / VEC : (cb + 3) / 4;
  const int chunks = a.na + a.nb;
  a.rows = (512 / chunks) & ~7;
  if (a.rows < 8) a.rows = 8;
  if (cb < 1 || a.rows * chunks > 512) return (int)cudaErrorInvalidValue;
  const long long nq = (long long)V * N;
  if (nq == 0) return 0;
  const int blocks = (int)((nq + a.rows - 1) / a.rows);
  const size_t smem = (size_t)a.rows * (ca + cb) * sizeof(T);
  sample_kernel<T><<<blocks, a.rows * chunks, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// maps [V,H,W,C], grid [V,N,2] -> out [V,N,C]
extern "C" int dyn_sample_views(const void* maps, const void* grid, void* out,
                                int V, int H, int W, int C, int N,
                                int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(nullptr, 0, 0, 0, maps, H, W, C,
                                         grid, out, V, N, 0, s)
                 : launch<float>(nullptr, 0, 0, 0, maps, H, W, C, grid, out,
                                 V, N, 0, s);
}

// rgb [V,HA,WA,CA] and feat [V,HB,WB,CB] (one dtype), grid [V,N,2] ->
// out [N,V,CA+CB]
extern "C" int dyn_sample_pair(const void* rgb, int HA, int WA, int CA,
                               const void* feat, int HB, int WB, int CB,
                               const void* grid, void* out, int V, int N,
                               int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(rgb, HA, WA, CA, feat, HB, WB, CB,
                                         grid, out, V, N, 1, s)
                 : launch<float>(rgb, HA, WA, CA, feat, HB, WB, CB, grid,
                                 out, V, N, 1, s);
}
