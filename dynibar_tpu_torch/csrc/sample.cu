// K1: exact bilinear lookup of V maps at normalized points.
//
// Replaces dynibar_tpu/ops/pallas_sample.py:60 _sample_kernel (launched by
// pallas_bilinear_sample_views).  Semantics: grid_sample(align_corners=True,
// padding_mode='zeros'): x = (gx + 1)/2 * (W - 1); the four integer corners
// around (x, y) contribute with bilinear weights when they lie inside the
// map, zero otherwise.
//
// What bounds it on the H100: bytes.  It does ~8 flops per output value and
// moves the maps (about 10.6 MB of bf16 feature maps plus 16 MB of bf16
// source RGB at the FF eval shape), the f32 points and the output.  The
// maps fit the 50 MB L2, so the random corner reads hit L2 and the kernel
// streams points in and values out.
//
// Design: one thread per (view, point, channel), channels fastest, so a
// warp reads each corner's channel vector as one contiguous run and writes
// the output [V, N, C] coalesced; bf16 maps whose channel count is a
// multiple of 8 (the feature maps) take one thread per 8 channels with
// 16-byte loads and stores instead.  Every sample is exact: the TPU kernel's
// 32-row window, its coverage mask and its one-hot matmul interpolation
// have no counterpart.  Interpolation runs in f32 and rounds once.

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
__global__ void sample_kernel(const T* __restrict__ maps,
                              const float* __restrict__ grid,
                              T* __restrict__ out, int V, int H, int W, int C,
                              long long N) {
  const long long total = (long long)V * N * C;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int c = (int)(idx % C);
    const long long pn = idx / C;              // view * N + point
    const int v = (int)(pn / N);
    const float gx = grid[2 * pn], gy = grid[2 * pn + 1];
    const float x = (gx + 1.f) * 0.5f * (float)(W - 1);
    const float y = (gy + 1.f) * 0.5f * (float)(H - 1);
    const float x0 = floorf(x), y0 = floorf(y);
    const float wx1 = x - x0, wy1 = y - y0;
    const T* base = maps + (size_t)v * H * W * C + c;
    float acc = 0.f;
    const float xs[2] = {x0, x0 + 1.f}, ys[2] = {y0, y0 + 1.f};
    const float wxs[2] = {1.f - wx1, wx1}, wys[2] = {1.f - wy1, wy1};
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float xc = xs[a], yc = ys[b];
        if (xc >= 0.f && xc <= (float)(W - 1) && yc >= 0.f &&
            yc <= (float)(H - 1)) {
          const size_t off = ((size_t)(int)yc * W + (int)xc) * C;
          acc += wxs[a] * wys[b] * to_f(base[off]);
        }
      }
    }
    out[idx] = from_f<T>(acc);
  }
}

// bf16, C % 8 == 0: one thread per (view, point, 8 channels).  Same
// arithmetic, corner order and rounding as sample_kernel.
__global__ void sample_kernel_v8(const __nv_bfloat16* __restrict__ maps,
                                 const float* __restrict__ grid,
                                 __nv_bfloat16* __restrict__ out, int V, int H,
                                 int W, int C, long long N) {
  const int G = C / 8;
  const long long total = (long long)V * N * G;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int c0 = (int)(idx % G) * 8;
    const long long pn = idx / G;
    const int v = (int)(pn / N);
    const float gx = grid[2 * pn], gy = grid[2 * pn + 1];
    const float x = (gx + 1.f) * 0.5f * (float)(W - 1);
    const float y = (gy + 1.f) * 0.5f * (float)(H - 1);
    const float x0 = floorf(x), y0 = floorf(y);
    const float wx1 = x - x0, wy1 = y - y0;
    const __nv_bfloat16* base = maps + (size_t)v * H * W * C + c0;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const float xs[2] = {x0, x0 + 1.f}, ys[2] = {y0, y0 + 1.f};
    const float wxs[2] = {1.f - wx1, wx1}, wys[2] = {1.f - wy1, wy1};
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float xc = xs[a], yc = ys[b];
        if (xc >= 0.f && xc <= (float)(W - 1) && yc >= 0.f &&
            yc <= (float)(H - 1)) {
          const size_t off = ((size_t)(int)yc * W + (int)xc) * C;
          const uint4 raw = *reinterpret_cast<const uint4*>(base + off);
          const __nv_bfloat16* vals =
              reinterpret_cast<const __nv_bfloat16*>(&raw);
          const float wgt = wxs[a] * wys[b];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[j] += wgt * __bfloat162float(vals[j]);
        }
      }
    }
    uint4 packed;
    __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16(acc[j]);
    *reinterpret_cast<uint4*>(out + pn * C + c0) = packed;
  }
}

}  // namespace

extern "C" int dyn_sample_views(const void* maps, const void* grid, void* out,
                                int V, int H, int W, int C, long long N,
                                int is_bf16, void* stream) {
  const bool v8 = is_bf16 && C % 8 == 0;
  const long long total = (long long)V * N * (v8 ? C / 8 : C);
  if (total == 0) return 0;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 132LL * 64 ? want : 132LL * 64);
  cudaStream_t s = (cudaStream_t)stream;
  if (v8) {
    sample_kernel_v8<<<blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)maps, (const float*)grid, (__nv_bfloat16*)out,
        V, H, W, C, N);
  } else if (is_bf16) {
    sample_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)maps, (const float*)grid, (__nv_bfloat16*)out,
        V, H, W, C, N);
  } else {
    sample_kernel<float><<<blocks, threads, 0, s>>>(
        (const float*)maps, (const float*)grid, (float*)out, V, H, W, C, N);
  }
  return (int)cudaGetLastError();
}
