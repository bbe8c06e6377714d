// Shared device code of the aggregator backwards K4a/K4b (dynamic_agg_bwd.cu)
// and K5a/K5b (static_agg_bwd.cu): the transposed dense layer, the
// weight-gradient product and the per-block gradient slabs.
//
// Math from dynibar_tpu/ops/pallas_agg_bwd.py (module docstring :12-37):
//   y = W x + b  =>  dX = W^T dY, dW += dY^T X, db += sum_rows dY;
//   ELU'(pre) from the post-activation y: 1 if y > 0 else y + 1.
// dX reuses the forward product routine dense_deep on a fragment-major
// copy of the transposes (ops/agg.py pack_frag_t: W^T at W's offset), or
// (K5a, K5b, K4a) wgmma on the tiled slabs, so every product is bf16 with
// f32 accumulation.  dW runs on mma.sync with both operands read
// transposed by ldmatrix.trans from shared memory.
//
// Weight gradients: the persistent blocks add every tile they compute into
// one of kSlabs f32 slabs of the whole packed layout ([weights | biases]),
// block b into slab b % kSlabs, with vector reductions (red.global.add on
// float2; float4 in the trunk backward's grad_layer_wide) that the L2
// performs: the warp does not wait for them, and 16
// slabs of the largest layout (1.7 MB each) stay in the 50 MB L2.  A small
// reduce kernel sums the slabs afterwards.  No library GEMM.
#pragma once

#include "agg_common.cuh"

namespace agg {

constexpr int LDS = 24;             // row stride of 16-column cotangents
constexpr int kSlabs = 16;          // weight-gradient slabs (ops/agg.py)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// ELU' recovered from the post-activation (pallas_agg_bwd.py:61)
__device__ __forceinline__ float elu_d(float y) { return y > 0.f ? 1.f : y + 1.f; }

// The slot of W^T: same offset in the transposed pack, in/out swapped,
// bias read from a zero buffer.
__device__ __forceinline__ Lin tr(const Lin& L) { return Lin{L.w, 0, L.n, L.k}; }

// gw[L.w + o*L.k + i] += sum_r dY[r][o] X[r][i] over `rows` rows (a multiple
// of 16).  dY [rows][>= L.n] and X [rows][>= L.k] are bf16 in shared memory
// with 16-byte aligned rows.  A warp owns a 16x16 tile of dW: A = dY^T and
// B = X both come from ldmatrix.trans (PTX fragment layouts: A[m][k] =
// dY[k][m], B[k][n] = X[k][n]).  Ends without a block barrier.
__device__ void dw_accum(const bf16* dY, int ldy, const bf16* X, int ldx,
                         int rows, float* gw, const Lin L) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, j = lane >> 3, r8 = lane & 7;
  const int mt = L.n >> 4, units = mt * (L.k >> 4);
  const uint32_t a_base =
      smem_u32(dY + (size_t)(r8 + ((j >> 1) & 1) * 8) * ldy + (j & 1) * 8);
  const uint32_t b_base =
      smem_u32(X + (size_t)(r8 + (j & 1) * 8) * ldx + (j >> 1) * 8);
  for (int u = warp; u < units; u += NW) {
    const int m0 = (u % mt) * 16, n0 = (u / mt) * 16;
    float acc[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][e] = 0.f;
    for (int k0 = 0; k0 < rows; k0 += 16) {
      uint32_t a[4], b[4];
      ldsm_x4_t(a, a_base + (uint32_t)(k0 * ldy + m0) * 2u);
      ldsm_x4_t(b, b_base + (uint32_t)(k0 * ldx + n0) * 2u);
      mma16816(acc[0], a, b[0], b[1]);
      mma16816(acc[1], a, b[2], b[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* p0 = gw + L.w + (size_t)(m0 + g) * L.k + n0 + h * 8 + 2 * t;
      atomicAdd(reinterpret_cast<float2*>(p0),
                make_float2(acc[h][0], acc[h][1]));
      atomicAdd(reinterpret_cast<float2*>(p0 + 8 * L.k),
                make_float2(acc[h][2], acc[h][3]));
    }
  }
}

// gb[boff + c] += sum_r dY[r][c] for c < ncols (bias gradient).
__device__ void db_accum(const bf16* dY, int ldy, int rows, float* gb,
                         int boff, int ncols) {
  for (int c = threadIdx.x; c < ncols; c += NT) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += b2f(dY[r * ldy + c]);
    atomicAdd(gb + boff + c, s);
  }
}

// Both halves of one layer's weight gradient.
__device__ __forceinline__ void grad_layer(const bf16* dY, int ldy,
                                           const bf16* X, int ldx, int rows,
                                           float* slab, int w_total,
                                           const Lin L) {
  dw_accum(dY, ldy, X, ldx, rows, slab, L);
  db_accum(dY, ldy, rows, slab + w_total, L.b, L.n);
}

// One warp's MT x NT2 tiles of 16 x 16 of dW = dY^T X over `rows` rows (a
// multiple of 16) from (m0, n0): A = dY^T and B = X both from
// ldmatrix.trans (PTX fragment layouts: A[m][k] = dY[k][m], B[k][n] =
// X[k][n]), bases a_base / b_base the lane's ldmatrix rows.  Each tile goes
// out as st(row, col, the sums of columns col .. col + 3 of that row): lanes
// t and t ^ 1 trade a half row so that each holds four consecutive columns
// of one row.
template <int MT, int NT2, typename ST>
__device__ __forceinline__ void dw_unit(uint32_t a_base, int ldy,
                                        uint32_t b_base, int ldx, int rows,
                                        int m0, int n0, ST& st) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[MT][2 * NT2][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2 * NT2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][h][e] = 0.f;
  for (int k0 = 0; k0 < rows; k0 += 16) {
    uint32_t a[MT][4], b[NT2][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      ldsm_x4_t(a[i], a_base + (uint32_t)(k0 * ldy + m0 + 16 * i) * 2u);
#pragma unroll
    for (int j = 0; j < NT2; ++j)
      ldsm_x4_t(b[j], b_base + (uint32_t)(k0 * ldx + n0 + 16 * j) * 2u);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT2; ++j) {
        mma16816(acc[i][2 * j], a[i], b[j][0], b[j][1]);
        mma16816(acc[i][2 * j + 1], a[i], b[j][2], b[j][3]);
      }
  }
  const bool odd = t & 1;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2 * NT2; ++h) {
      const float* c = acc[i][h];
      // even t keeps row g, odd t row g + 8, of columns 2 (t & ~1) .. + 3
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
      st(m0 + 16 * i + g + (odd ? 8 : 0), n0 + 8 * h + 2 * (t & ~1),
         odd ? make_float4(r0, r1, c[2], c[3])
             : make_float4(c[0], c[1], r0, r1));
    }
}

// dW = dY^T X of layer L over `rows` rows (a multiple of 16): a warp owns a
// 32 x 32 block of dW (16 wide at a ragged edge), 8 MMAs for 4 ldmatrix per
// k-step; st(row, col, float4) receives every four consecutive columns of
// the padded [L.n, L.k] once.  NTH: the block's threads.  Ends without a
// block barrier.
template <int NTH, typename ST>
__device__ void dw_blocks(const bf16* dY, int ldy, const bf16* X, int ldx,
                          int rows, const Lin& L, ST st) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = lane >> 3, r8 = lane & 7;
  const uint32_t a_base =
      smem_u32(dY + (size_t)(r8 + ((j >> 1) & 1) * 8) * ldy + (j & 1) * 8);
  const uint32_t b_base =
      smem_u32(X + (size_t)(r8 + (j & 1) * 8) * ldx + (j >> 1) * 8);
  const int mu = (L.n + 31) >> 5, nu = (L.k + 31) >> 5;
  for (int u = warp; u < mu * nu; u += NTH / 32) {
    const int m0 = (u % mu) * 32, n0 = (u / mu) * 32;
    const bool m2 = m0 + 32 <= L.n, n2 = n0 + 32 <= L.k;
    if (m2 && n2)
      dw_unit<2, 2>(a_base, ldy, b_base, ldx, rows, m0, n0, st);
    else if (m2)
      dw_unit<2, 1>(a_base, ldy, b_base, ldx, rows, m0, n0, st);
    else if (n2)
      dw_unit<1, 2>(a_base, ldy, b_base, ldx, rows, m0, n0, st);
    else
      dw_unit<1, 1>(a_base, ldy, b_base, ldx, rows, m0, n0, st);
  }
}

// dw_accum for the trunk backward's wide layers (every layer with at least
// one 32 x 32 block per warp): dw_blocks flushed to the slab with 16-byte
// reductions; then the bias as db_accum (no layer is over NT columns wide).
// NTH: the block's threads.  Ends without a block barrier.
template <int NTH>
__device__ void grad_layer_wide(const bf16* dY, int ldy, const bf16* X,
                                int ldx, int rows, float* slab, int w_total,
                                const Lin L) {
  float* gw = slab + L.w;
  const int k = L.k;
  dw_blocks<NTH>(dY, ldy, X, ldx, rows, L,
                 [&](int row, int col, float4 g) {
                   atomicAdd(reinterpret_cast<float4*>(gw + (size_t)row * k +
                                                       col), g);
                 });
  db_accum(dY, ldy, rows, slab + w_total, L.b, L.n);
}

// out[i] = sum_b slabs[b * len + i]
__global__ void reduce_slabs(const float* slabs, int nslab, int len,
                             float* out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < len;
       i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < nslab; ++b) s += slabs[(size_t)b * len + i];
    out[i] = s;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// d/dx of the periodic-embedding column `col` (pe_geo's layout) for a
// cotangent d on it: returns the channel and the contribution.
__device__ __forceinline__ float pe_geo_bwd(const float* x, int nch,
                                            int nfreq, int col, float d,
                                            int* ch) {
  if (col < nch) {
    *ch = col;
    return d;
  }
  int j = col - nch;
  const bool is_sin = j >= nfreq * nch;
  if (is_sin) j -= nfreq * nch;
  *ch = j % nch;
  const float f = (float)(1 << (j / nch));
  const float a = f * x[*ch];
  return is_sin ? d * f * cosf(a) : -d * f * sinf(a);
}

// Set the kernel's shared-memory size and launch min(nblocks, work)
// persistent blocks of `threads` on `s`; returns the cudaError_t.
template <typename Kern, typename Args>
int launch_persistent(Kern kernel, size_t smem, const Args& args, int work,
                      int nblocks, cudaStream_t s, int threads = NT) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (work <= 0) return 0;
  kernel<<<work < nblocks ? work : nblocks, threads, smem, s>>>(args);
  return (int)cudaGetLastError();
}

inline int launch_reduce(const float* slabs, int nslab, int len, float* out,
                         cudaStream_t s) {
  const int grid = (len + 255) / 256 < 1024 ? (len + 255) / 256 : 1024;
  reduce_slabs<<<grid, 256, 0, s>>>(slabs, nslab, len, out);
  return (int)cudaGetLastError();
}

}  // namespace agg
