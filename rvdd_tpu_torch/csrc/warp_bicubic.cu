// Bicubic flow warp of an NHWC multichannel image, for sm_90a.
//
// Replaces two TPU kernels:
// * rvdd_tpu/ops/pallas/warp_rowmajor.py:warp_planar_pallas, which warps the
//   56-channel recurrence state once a frame.  It computes the semantics of
//   rvdd_tpu/ops/warp.py:warp(..., "bicubic"): Keys cubic with a = -0.75,
//   each of the 4x4 taps clamped to the border on its own, weights from the
//   unclipped fraction (torch grid_sample bicubic, border padding,
//   align_corners=True).
// * rvdd_tpu/ops/pallas/warp_pallas.py:warp_bicubic_pallas in the TV-L1
//   solver's mode (coeff_a = -0.5, zero_outside=True; rvdd_tpu/ops/tvl1.py:
//   _warp_catmull_zero): Catmull-Rom (a = -0.5), and the output is 0
//   wherever gx < 1 || gx >= W-2 || gy < 1 || gy >= H-2, with gx = col + u
//   and gy = row + v in fp32, i.e. wherever one of the 4x4 taps would need
//   clamping (the C library's border_out rule).  Every kept pixel has all
//   its taps inside, so clamping never changes one.  The solver warps its
//   [i1 | i1x | i1y | 0] stack (4 fp32 planes, one 16-byte vector a tap)
//   once per warp stage, at every pyramid level.
// The TPU kernels clamp flows to +-max_disp px and band the residual
// displacement because the TPU has no vector gather; the H100 gathers
// natively, so this kernel is exact for any flow.
//
// Precision: the input is read at its own type.  The port reads the fp32
// recurrence carry directly (rvdd_tpu rounds its window to bf16 first);
// interpolation runs in fp32 and the output is rounded once, to bf16 or
// kept in fp32.  The solver mode is fp32 in and out.
//
// What bounds it on the H100: bytes.  At the state warp's shape (56-ch fp32
// state at 1080x1920) it must read the state once (464 MB) and the flow
// (17 MB) and write the bf16 output (232 MB): about 0.21 ms at 3.35 TB/s.
// The solver's finest level (4 fp32 planes at 540x960) moves 16 B in, 8 B
// of flow and 16 B out a pixel, 20.7 MB: about 6.2 us.  The arithmetic (16
// fp32 FMAs per output value) is far below the card's rate.  Design: one
// thread per (pixel, 4-channel vector).  The taps of a pixel are contiguous
// 16-byte channel vectors in NHWC, the threads of one pixel cover its
// channels side by side, and neighbouring pixels share most taps, so each
// source line comes from DRAM about once and the 16x re-reads hit L1/L2.
// A zeroed pixel in the solver mode writes its zeros without a gather.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cubic_weights(float t, float a, float w[4]) {
  const float d0 = t + 1.f;
  const float d3 = 2.f - t;
  const float u = 1.f - t;
  w[0] = ((a * d0 - 5.f * a) * d0 + 8.f * a) * d0 - 4.f * a;
  w[1] = ((a + 2.f) * t - (a + 3.f)) * t * t + 1.f;
  w[2] = ((a + 2.f) * u - (a + 3.f)) * u * u + 1.f;
  w[3] = ((a * d3 - 5.f * a) * d3 + 8.f * a) * d3 - 4.f * a;
}

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  if constexpr (V == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  if constexpr (V == 4) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 t;
    t.x = *reinterpret_cast<uint32_t*>(&lo);
    t.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = t;
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// x [B, H, W, C], flow [B, H, W, 2] fp32 (u, v), out [B, H, W, C].
// ZERO: the solver's zero-outside rule (see the note at the top).
template <typename Tin, typename Tout, int V, bool ZERO>
__global__ void __launch_bounds__(256) warp_bicubic_kernel(
    const Tin* __restrict__ x, const float* __restrict__ flow,
    Tout* __restrict__ out, int H, int W, int C, long long total, float a) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= total) return;
  const int groups = C / V;
  const int g = (int)(gid % groups);
  const long long p = gid / groups;  // pixel over B*H*W
  const int col = (int)(p % W);
  const long long bh = p / W;
  const int row = (int)(bh % H);
  const long long b = bh / H;

  const float2 f = *reinterpret_cast<const float2*>(flow + 2 * p);
  const float gx = (float)col + f.x;
  const float gy = (float)row + f.y;
  if constexpr (ZERO) {
    if (gx < 1.f || gx >= (float)W - 2.f || gy < 1.f || gy >= (float)H - 2.f) {
      float zero[V];
#pragma unroll
      for (int k = 0; k < V; ++k) zero[k] = 0.f;
      store_vec<V>(out + (size_t)p * C + (size_t)g * V, zero);
      return;
    }
  }
  const float fx = floorf(gx);
  const float fy = floorf(gy);
  float wx[4], wy[4];
  cubic_weights(gx - fx, a, wx);
  cubic_weights(gy - fy, a, wy);
  // beyond [-3, size+1] every tap clamps to the same edge pixel, so this
  // clamp changes nothing and keeps the integer conversion in range
  const int ix = (int)fminf(fmaxf(fx, -3.f), (float)W + 1.f);
  const int iy = (int)fminf(fmaxf(fy, -3.f), (float)H + 1.f);

  const Tin* xb = x + (size_t)b * H * W * C + (size_t)g * V;
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int yy = min(max(iy - 1 + j, 0), H - 1);
    const Tin* xr = xb + (size_t)yy * W * C;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int xx = min(max(ix - 1 + i, 0), W - 1);
      const float w = wy[j] * wx[i];
      float v[V];
      load_vec<V>(xr + (size_t)xx * C, v);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = fmaf(v[k], w, acc[k]);
    }
  }
  store_vec<V>(out + (size_t)p * C + (size_t)g * V, acc);
}

template <typename Tin, typename Tout, int V, bool ZERO>
void launch_v(const void* x, const void* flow, void* out, int B, int H, int W,
              int C, float a, cudaStream_t s) {
  const long long total = (long long)B * H * W * (C / V);
  const dim3 block(256);
  const dim3 grid((unsigned)((total + 255) / 256));
  warp_bicubic_kernel<Tin, Tout, V, ZERO><<<grid, block, 0, s>>>(
      (const Tin*)x, (const float*)flow, (Tout*)out, H, W, C, total, a);
}

template <typename Tin, typename Tout>
void launch(const void* x, const void* flow, void* out, int B, int H, int W,
            int C, float a, bool zero, cudaStream_t s) {
  if (C % 4 == 0) {
    if (zero) launch_v<Tin, Tout, 4, true>(x, flow, out, B, H, W, C, a, s);
    else launch_v<Tin, Tout, 4, false>(x, flow, out, B, H, W, C, a, s);
  } else {
    if (zero) launch_v<Tin, Tout, 1, true>(x, flow, out, B, H, W, C, a, s);
    else launch_v<Tin, Tout, 1, false>(x, flow, out, B, H, W, C, a, s);
  }
}

}  // namespace

extern "C" {

const char* rvdd_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x_bf16 / out_bf16 select bf16 (1) or fp32 (0); a is the cubic
// coefficient; zero_outside (1) applies the solver's zero-outside rule.
// Returns cudaGetLastError().
int rvdd_warp_bicubic(const void* x, int x_bf16, const void* flow, void* out,
                      int out_bf16, int B, int H, int W, int C, float a,
                      int zero_outside, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool z = zero_outside != 0;
  if (x_bf16 && out_bf16) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, flow, out, B, H, W, C, a, z, s);
  } else if (x_bf16) {
    launch<__nv_bfloat16, float>(x, flow, out, B, H, W, C, a, z, s);
  } else if (out_bf16) {
    launch<float, __nv_bfloat16>(x, flow, out, B, H, W, C, a, z, s);
  } else {
    launch<float, float>(x, flow, out, B, H, W, C, a, z, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
