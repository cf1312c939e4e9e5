// Bicubic flow warp of an NHWC multichannel image, for sm_90a.
//
// Replaces two TPU kernels:
// * rvdd_tpu/ops/pallas/warp_rowmajor.py:warp_planar_pallas, which warps the
//   56-channel recurrence state once a frame (and the flagship's 3-channel
//   future frame).  It computes the semantics of rvdd_tpu/ops/warp.py:
//   warp(..., "bicubic"): Keys cubic with a = -0.75, each of the 4x4 taps
//   clamped to the border on its own, weights from the unclipped fraction
//   (torch grid_sample bicubic, border padding, align_corners=True).
// * rvdd_tpu/ops/pallas/warp_pallas.py:warp_bicubic_pallas in the TV-L1
//   solver's mode (coeff_a = -0.5, zero_outside=True; rvdd_tpu/ops/tvl1.py:
//   _warp_catmull_zero): Catmull-Rom (a = -0.5), and the output is 0
//   wherever gx < 1 || gx >= W-2 || gy < 1 || gy >= H-2, with gx = col + u
//   and gy = row + v in fp32, i.e. wherever one of the 4x4 taps would need
//   clamping (the C library's border_out rule).  Every kept pixel has all
//   its taps inside, so clamping never changes one.  The solver warps its
//   [i1 | i1x | i1y | 0] stack (4 fp32 planes) once per warp stage.
// The TPU kernels clamp flows to +-max_disp px and band the residual
// displacement because the TPU has no vector gather; this kernel is exact
// for any flow.
//
// Precision: the input is read at its own type (the fp32 recurrence carry
// stays fp32 in the staged window); interpolation runs in fp32 and the
// output is rounded once, to bf16 or kept in fp32.
//
// What bounds it on the H100: bytes (each input read once, the output
// written once, at 3.35 TB/s).  The state warp (56-ch fp32 at 1080x1920 to
// bf16) moves 713 MB: 0.2129 ms.  The future frame (3-ch bf16 to bf16)
// moves 41.5 MB: 0.0124 ms.  The solver's finest level (4 fp32 planes at
// 540x960) moves 20.7 MB: 0.0062 ms.  On an NVIDIA H100 80GB HBM3 at
// 700 W, the parent design (one thread per pixel and 4-channel vector over
// a 1-D grid, three 64-bit divisions a thread) took 0.560, 0.107 and
// 0.0146 ms (chip_smoke.py --warp-source); this one takes about 0.375,
// 0.049 and 0.0127 ms (PERF.md has the runs).
//
// Design: a 2-D grid of 8-row x 32-column output tiles (blockIdx.z the
// batch), 32-bit offsets inside an image, no integer division per pixel.
// A tile's pixels form vertical pairs; one thread loads a pair's flow and
// computes its weights and tap indices once.  The tile's footprint (the
// box of the clamped taps of its gathering pixels) is reduced with warp
// reductions and shared memory.  When it fits (window_pixels), the window
// is staged in shared memory and the taps are gathered from there; a tile
// whose window does not fit gathers straight from global memory (the
// direct path, exact for any flow), in the same kernel.  A pair whose two
// pixels have the same tap columns and tap rows one apart (smooth flow)
// shares 3 of its 4 tap rows: 20 loads for 32 taps.
// * The wide kernel (C % 4 == 0 and C >= 16: the state) gives a CTA of 256
//   threads a tile and all its channels, so the window is read and the
//   output written in whole contiguous pixels (a CTA per tile and 8-channel
//   slice read and wrote 32 and 16 of each pixel's 224 and 112 bytes, which
//   measured 0.51 ms).  The pairs' weights and taps go to shared memory;
//   each warp's lanes then take the channel vectors of two pairs, so a tap
//   is a 224-byte contiguous read.  Two CTAs an SM (about 113 KB each).
// * The narrow kernel (the rest: the future frame, the solver) gives a CTA
//   of 128 threads a tile and one slice of 8 channels; a thread keeps its
//   pair's weights and taps in registers, eight CTAs an SM.  A C that is
//   not a multiple of 4 is staged element by element into zero-padded
//   4-channel vectors, so a pixel is never split over threads.
// * Solver mode: a zeroed pixel writes zeros without a gather and takes no
//   part in the footprint; a tile whose every pixel is zeroed stages
//   nothing.
// What holds it back: each CTA runs flow load, footprint reduction and
// window copy before its first tap, two trips to memory and two barriers,
// and the small shapes are bound by that chain, not by bytes.
// The caller may pass an int[3] that counts tiles by path: window, direct,
// all zeroed (one atomicAdd a tile).

#include <climits>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "wgmma.cuh"  // PHASE_CLOCK (rvdd_tpu_torch/probe.py)

namespace {

// Two kernels share the helpers below.  The wide one (C % 4 == 0 and
// C >= 16: the state) gives a CTA of 256 threads an 8 x 32 tile and all its
// channels; the narrow one (the rest: the future frame, the solver) gives a
// CTA of 128 threads an 8 x 32 tile and one slice of 8 channels.
constexpr int TILE_H = 8;           // output rows of a tile
constexpr int TILE_W = 32;          // output columns of a tile
constexpr int NPAIR = TILE_H / 2 * TILE_W;  // vertical pixel pairs of a tile
constexpr int WIDE_NT = 256;        // threads of a wide CTA
constexpr int NARROW_NT = NPAIR;    // threads of a narrow CTA: one a pair
constexpr int WIDE_CTAS_PER_SM = 2;
constexpr int NARROW_CTAS_PER_SM = 8;
constexpr int SLICE = 2;            // 4-channel vectors of a narrow CTA's slice
constexpr int WIN_BYTES = 104448;   // staged window capacity, bytes
constexpr int WIN_PIX = 768;        // and pixels
constexpr int PLANE = WIN_PIX + 4;  // narrow: vectors of one plane (64 B apart mod 128)
// wide: per pair, 4 weight float4s, 2 tap int2s and its flags
constexpr int PARAM_BYTES = NPAIR * (4 * 16 + 2 * 8 + 4);

// The window capacity in pixels for nv vectors of vec_bytes a pixel: two
// wide CTAs an SM at 56 fp32 channels.
__host__ __device__ constexpr int window_pixels(int nv, int vec_bytes) {
  return WIN_BYTES / (nv * vec_bytes) < WIN_PIX ? WIN_BYTES / (nv * vec_bytes) : WIN_PIX;
}

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; };
template <> struct Vec<__nv_bfloat16> { using type = uint2; };

__device__ __forceinline__ float4 to_f4(const float4 v) { return v; }

__device__ __forceinline__ float4 to_f4(const uint2 t) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// n (1..4) channels from p, zeros after them
__device__ __forceinline__ float4 load_partial(const float* p, int n) {
  return make_float4(p[0], n > 1 ? p[1] : 0.f, n > 2 ? p[2] : 0.f, n > 3 ? p[3] : 0.f);
}

__device__ __forceinline__ uint2 load_partial(const __nv_bfloat16* p, int n) {
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  const uint32_t e0 = q[0], e1 = n > 1 ? q[1] : 0u, e2 = n > 2 ? q[2] : 0u,
                 e3 = n > 3 ? q[3] : 0u;
  return make_uint2(e0 | (e1 << 16), e2 | (e3 << 16));
}

__device__ __forceinline__ uint2 pack_bf16(const float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  return make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
}

// the first n (1..4) channels of v at o; VEC: n == 4 and o aligned
template <bool VEC>
__device__ __forceinline__ void store4(float* o, const float4 v, int n) {
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(o) = v;
  } else {
    o[0] = v.x;
    if (n > 1) o[1] = v.y;
    if (n > 2) o[2] = v.z;
    if (n > 3) o[3] = v.w;
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(__nv_bfloat16* o, const float4 v, int n) {
  if constexpr (VEC) {
    *reinterpret_cast<uint2*>(o) = pack_bf16(v);
  } else {
    o[0] = __float2bfloat16_rn(v.x);
    if (n > 1) o[1] = __float2bfloat16_rn(v.y);
    if (n > 2) o[2] = __float2bfloat16_rn(v.z);
    if (n > 3) o[3] = __float2bfloat16_rn(v.w);
  }
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float4 v) {
  acc.x = fmaf(v.x, w, acc.x);
  acc.y = fmaf(v.y, w, acc.y);
  acc.z = fmaf(v.z, w, acc.z);
  acc.w = fmaf(v.w, w, acc.w);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "n"(BYTES)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cubic_weights(float t, float a, float w[4]) {
  const float d0 = t + 1.f;
  const float d3 = 2.f - t;
  const float u = 1.f - t;
  w[0] = ((a * d0 - 5.f * a) * d0 + 8.f * a) * d0 - 4.f * a;
  w[1] = ((a + 2.f) * t - (a + 3.f)) * t * t + 1.f;
  w[2] = ((a + 2.f) * u - (a + 3.f)) * u * u + 1.f;
  w[3] = ((a * d3 - 5.f * a) * d3 + 8.f * a) * d3 - 4.f * a;
}

// One output pixel's sampling: weights and first tap column/row (taps tx..
// tx+3, ty..ty+3, each clamped to the image on its own).
struct Pix {
  float wx[4], wy[4];
  int tx, ty;
  bool in;    // inside the image
  bool live;  // inside and gathering (not zeroed by the solver's rule)
};

// The flow of pixel (row, col) of image fb, or zeros outside the image.
__device__ __forceinline__ float2 load_flow(const float* fb, int row, int col, int H, int W) {
  return row < H && col < W ? __ldg(reinterpret_cast<const float2*>(fb + 2 * (row * W + col)))
                            : make_float2(0.f, 0.f);
}

template <bool ZERO>
__device__ __forceinline__ Pix setup_pixel(const float2 f, int row, int col, int H, int W,
                                           float a) {
  Pix p;
  p.in = row < H && col < W;
  p.live = false;
  p.tx = p.ty = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) p.wx[k] = p.wy[k] = 0.f;
  if (!p.in) return p;
  const float gx = (float)col + f.x;
  const float gy = (float)row + f.y;
  if constexpr (ZERO) {
    if (gx < 1.f || gx >= (float)W - 2.f || gy < 1.f || gy >= (float)H - 2.f) return p;
  }
  const float fx = floorf(gx);
  const float fy = floorf(gy);
  cubic_weights(gx - fx, a, p.wx);
  cubic_weights(gy - fy, a, p.wy);
  // beyond [-3, size+1] every tap clamps to the same edge pixel, so this
  // clamp changes nothing and keeps the integer conversion in range
  p.tx = (int)fminf(fmaxf(fx, -3.f), (float)W + 1.f) - 1;
  p.ty = (int)fminf(fmaxf(fy, -3.f), (float)H + 1.f) - 1;
  p.live = true;
  return p;
}

// Addressing of a source: a tap (x, y) is at index
// (clamp(y) - y0) * rs + (clamp(x) - x0) * cs: the staged window (origin,
// row and pixel strides in vectors) or the whole image (origin 0, strides in
// elements).
struct Geo {
  int x0, y0, rs, cs, w1, h1;
  __device__ __forceinline__ int col(int x) const { return (min(max(x, 0), w1) - x0) * cs; }
  __device__ __forceinline__ int row(int y) const { return (min(max(y, 0), h1) - y0) * rs; }
};

// sum_i wx[i] * tap(ro + co[i]) over one tap row
template <class Load>
__device__ __forceinline__ float4 row_sum(int ro, const int co[4], const float wx[4], Load ld) {
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < 4; ++i) fma4(h, wx[i], ld(ro + co[i]));
  return h;
}

template <class Load>
__device__ __forceinline__ void gather_one(const Pix& p, const Geo& g, Load ld, float4& acc) {
  int co[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) co[i] = g.col(p.tx + i);
#pragma unroll
  for (int j = 0; j < 4; ++j) fma4(acc, p.wy[j], row_sum(g.row(p.ty + j), co, p.wx, ld));
}

// pa and pb (the pixel below it) with the same tap columns and pb's tap
// rows one below pa's: five tap rows serve both
template <class Load>
__device__ __forceinline__ void gather_pair(const Pix& pa, const Pix& pb, const Geo& g, Load ld,
                                            float4& acc_a, float4& acc_b) {
  int co[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) co[i] = g.col(pa.tx + i);
#pragma unroll
  for (int m = 0; m < 5; ++m) {
    const int ro = g.row(pa.ty + m);
    float4 ha = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 hb = ha;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = ld(ro + co[i]);
      if (m < 4) fma4(ha, pa.wx[i], v);
      if (m > 0) fma4(hb, pb.wx[i], v);
    }
    if (m < 4) fma4(acc_a, pa.wy[m], ha);
    if (m > 0) fma4(acc_b, pb.wy[m - 1], hb);
  }
}

// The tile's footprint: min/max of each thread's box over the CTA (warp
// reductions, then shared memory); ends with a barrier.
template <int NT>
__device__ __forceinline__ void reduce_box(int& x0, int& x1, int& y0, int& y1,
                                           int (*red)[NT / 32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x0 = __reduce_min_sync(0xffffffffu, x0);
  x1 = __reduce_max_sync(0xffffffffu, x1);
  y0 = __reduce_min_sync(0xffffffffu, y0);
  y1 = __reduce_max_sync(0xffffffffu, y1);
  if (lane == 0) {
    red[0][warp] = x0;
    red[1][warp] = x1;
    red[2][warp] = y0;
    red[3][warp] = y1;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    x0 = min(x0, red[0][w]);
    x1 = max(x1, red[1][w]);
    y0 = min(y0, red[2][w]);
    y1 = max(y1, red[3][w]);
  }
}

// A pixel's part of its tile's footprint: its clamped taps, if it gathers.
__device__ __forceinline__ void add_box(const Pix& p, int W, int H, int& x0, int& x1, int& y0,
                                        int& y1) {
  if (!p.live) return;
  x0 = min(x0, min(max(p.tx, 0), W - 1));
  x1 = max(x1, min(max(p.tx + 3, 0), W - 1));
  y0 = min(y0, min(max(p.ty, 0), H - 1));
  y1 = max(y1, min(max(p.ty + 3, 0), H - 1));
}

// flags of a pixel pair
constexpr int IN_A = 1, IN_B = 2, LIVE_A = 4, LIVE_B = 8, PAIR = 16;

template <class Load>
__device__ __forceinline__ void warp_two(const Pix& pa, const Pix& pb, int fl, const Geo& g,
                                         Load ld, float4& acc_a, float4& acc_b) {
  acc_a = acc_b = make_float4(0.f, 0.f, 0.f, 0.f);
  if (fl & PAIR) {
    gather_pair(pa, pb, g, ld, acc_a, acc_b);
  } else {
    if (fl & LIVE_A) gather_one(pa, g, ld, acc_a);
    if (fl & LIVE_B) gather_one(pb, g, ld, acc_b);
  }
}

// x [B, H, W, C], flow [B, H, W, 2] fp32 (u, v), out [B, H, W, C].
// ZERO: the solver's zero-outside rule.  The wide kernel (C % 4 == 0):
// lanes_log2: log2 of the threads per pixel pair (a power of two >= the
// 4-channel vectors NV, at most 32); win_pix: the window capacity in
// pixels.  tile_counts: null or int[3] (window, direct, all zeroed).
template <typename Tin, typename Tout, bool ZERO>
__global__ void __launch_bounds__(WIDE_NT, WIDE_CTAS_PER_SM) warp_bicubic_kernel_wide(
    const Tin* __restrict__ x, const float* __restrict__ flow, Tout* __restrict__ out, int H,
    int W, int C, int lanes_log2, int win_pix, float a, int* __restrict__ tile_counts) {
  using VecT = typename Vec<Tin>::type;
  constexpr int NT = WIDE_NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* s_w = reinterpret_cast<float4*>(smem_raw);  // [2 * NPAIR][2]: wx, wy
  int2* s_t = reinterpret_cast<int2*>(s_w + 4 * NPAIR);  // [2 * NPAIR]: tx, ty
  int* s_fl = reinterpret_cast<int*>(s_t + 2 * NPAIR);   // [NPAIR] pair flags
  VecT* win = reinterpret_cast<VecT*>(s_fl + NPAIR);     // [row][col][NV]
  __shared__ int red[4][NT / 32];

  const int NV = (C + 3) >> 2;
  const int x_tile = blockIdx.x * TILE_W, y_tile = blockIdx.y * TILE_H;
  const size_t img = (size_t)H * W;
  const Tin* xb = x + blockIdx.z * img * C;
  const float* fb = flow + blockIdx.z * img * 2;
  Tout* obase = out + blockIdx.z * img * C;

  PHASE_CLOCK(long long ph[3]; long long c0 = clock64(), c1;)
  // prologue: pair q (rows 2 (q / TILE_W) and the one below, column
  // q % TILE_W) is set up by thread q % NT, which also reduces the tile's
  // footprint over the clamped taps of its gathering pixels
  int fx0 = INT_MAX, fx1 = INT_MIN, fy0 = INT_MAX, fy1 = INT_MIN;
  for (int q = threadIdx.x; q < NPAIR; q += NT) {
    const int row = y_tile + 2 * (q / TILE_W), col = x_tile + q % TILE_W;
    const Pix pa = setup_pixel<ZERO>(load_flow(fb, row, col, H, W), row, col, H, W, a);
    const Pix pb = setup_pixel<ZERO>(load_flow(fb, row + 1, col, H, W), row + 1, col, H, W, a);
    s_w[4 * q] = make_float4(pa.wx[0], pa.wx[1], pa.wx[2], pa.wx[3]);
    s_w[4 * q + 1] = make_float4(pa.wy[0], pa.wy[1], pa.wy[2], pa.wy[3]);
    s_w[4 * q + 2] = make_float4(pb.wx[0], pb.wx[1], pb.wx[2], pb.wx[3]);
    s_w[4 * q + 3] = make_float4(pb.wy[0], pb.wy[1], pb.wy[2], pb.wy[3]);
    s_t[2 * q] = make_int2(pa.tx, pa.ty);
    s_t[2 * q + 1] = make_int2(pb.tx, pb.ty);
    const bool pair = pa.live && pb.live && pa.tx == pb.tx && pb.ty == pa.ty + 1;
    s_fl[q] = (pa.in ? IN_A : 0) | (pb.in ? IN_B : 0) | (pa.live ? LIVE_A : 0) |
              (pb.live ? LIVE_B : 0) | (pair ? PAIR : 0);
    add_box(pa, W, H, fx0, fx1, fy0, fy1);
    add_box(pb, W, H, fx0, fx1, fy0, fy1);
  }
  reduce_box<NT>(fx0, fx1, fy0, fy1, red);
  PHASE_CLOCK(c1 = clock64(); ph[0] = c1 - c0;)  // phase 0: flow, weights, footprint
  const bool empty = fx0 > fx1;
  const int wxn = empty ? 0 : fx1 - fx0 + 1;
  const int wyn = empty ? 0 : fy1 - fy0 + 1;
  const bool staged = !empty && wxn * wyn <= win_pix;
  if (tile_counts != nullptr && threadIdx.x == 0)
    atomicAdd(tile_counts + (empty ? 2 : staged ? 0 : 1), 1);

  if (staged) {
    // the window's rows, all channels: contiguous runs of vectors, copied
    // with cp.async by consecutive threads
    const int rowlen = wxn * NV;
    const int total = rowlen * wyn;
    const int dr = NT / rowlen, drem = NT - dr * rowlen;
    int r = threadIdx.x / rowlen, rem = threadIdx.x - r * rowlen;
    for (int k = threadIdx.x; k < total; k += NT) {
      cp_async<sizeof(VecT)>(win + k, xb + ((fy0 + r) * W + fx0) * C + 4 * rem);
      r += dr;
      rem += drem;
      if (rem >= rowlen) {
        rem -= rowlen;
        ++r;
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  PHASE_CLOCK(c0 = clock64(); ph[1] = c0 - c1;)  // phase 1: the window copy

  // each pair's NV vectors: thread k takes pair k >> lanes_log2 and vector
  // k & (lanes - 1), so a warp's lanes cover whole pixels' channels
  const int lanes = 1 << lanes_log2;
  const Geo g = staged ? Geo{fx0, fy0, wxn * NV, NV, W - 1, H - 1}
                       : Geo{0, 0, W * C, C, W - 1, H - 1};
  for (int k = threadIdx.x; k < NPAIR * lanes; k += NT) {
    const int q = k >> lanes_log2;
    const int fl = s_fl[q];
    const int row = y_tile + 2 * (q / TILE_W), col = x_tile + q % TILE_W;
    Tout* oa = obase + (size_t)(row * W + col) * C;
    Tout* ob = oa + (size_t)W * C;
    Pix pa, pb;
    if (!empty) {
      const float4 wxa = s_w[4 * q], wya = s_w[4 * q + 1];
      const float4 wxb = s_w[4 * q + 2], wyb = s_w[4 * q + 3];
      pa.wx[0] = wxa.x; pa.wx[1] = wxa.y; pa.wx[2] = wxa.z; pa.wx[3] = wxa.w;
      pa.wy[0] = wya.x; pa.wy[1] = wya.y; pa.wy[2] = wya.z; pa.wy[3] = wya.w;
      pb.wx[0] = wxb.x; pb.wx[1] = wxb.y; pb.wx[2] = wxb.z; pb.wx[3] = wxb.w;
      pb.wy[0] = wyb.x; pb.wy[1] = wyb.y; pb.wy[2] = wyb.z; pb.wy[3] = wyb.w;
      const int2 ta = s_t[2 * q], tb = s_t[2 * q + 1];
      pa.tx = ta.x; pa.ty = ta.y; pb.tx = tb.x; pb.ty = tb.y;
    }
    for (int v = k & (lanes - 1); v < NV; v += lanes) {
      float4 acc_a = make_float4(0.f, 0.f, 0.f, 0.f), acc_b = acc_a;
      if (staged) {
        const VecT* wv = win + v;
        warp_two(pa, pb, fl, g, [wv](int p) { return to_f4(wv[p]); }, acc_a, acc_b);
      } else if (!empty) {
        const Tin* src = xb + 4 * v;
        warp_two(pa, pb, fl, g,
                 [src](int p) { return to_f4(__ldg(reinterpret_cast<const VecT*>(src + p))); },
                 acc_a, acc_b);
      }
      if (fl & IN_A) store4<true>(oa + 4 * v, acc_a, 4);
      if (fl & IN_B) store4<true>(ob + 4 * v, acc_b, 4);
    }
  }
  PHASE_CLOCK(ph[2] = clock64() - c0; wg::phase_clocks_add(ph, 1);)  // phase 2: gather, store
}

// Copy nv vectors (from src's channel 0, nch channels left) of the window
// [y0, y0+wyn) x [x0, x0+wxn) into buf as [vector][row][col]; the vectors
// of a pixel are neighbours in the walk, so a warp's copies read whole
// 32-byte sectors.
template <typename Tin, bool VEC>
__device__ __forceinline__ void stage_slice(typename Vec<Tin>::type* buf, const Tin* src, int nv,
                                            int nch, int x0, int y0, int wxn, int wyn, int W,
                                            int C) {
  using VecT = typename Vec<Tin>::type;
  const int rowlen = wxn * nv;
  const int total = rowlen * wyn;
  const int dr = NARROW_NT / rowlen, drem = NARROW_NT - dr * rowlen;
  int r = threadIdx.x / rowlen, rem = threadIdx.x - r * rowlen;
  for (int k = threadIdx.x; k < total; k += NARROW_NT) {
    const int cc = nv == 2 ? rem >> 1 : rem;
    const int v = rem - cc * nv;
    const Tin* s = src + ((y0 + r) * W + x0 + cc) * C + 4 * v;
    VecT* dst = buf + v * PLANE + r * wxn + cc;
    if constexpr (VEC) {
      cp_async<sizeof(VecT)>(dst, s);
    } else {
      *dst = load_partial(s, min(4, nch - 4 * v));
    }
    r += dr;
    rem += drem;
    if (rem >= rowlen) {
      rem -= rowlen;
      ++r;
    }
  }
}

// The narrow kernel.  blockIdx.x = column tile * nslices + channel slice;
// thread q owns pixel pair q (column q % 32, rows 2 (q / 32) and the one
// below) and keeps its weights and taps in registers.
template <typename Tin, typename Tout, bool ZERO, bool VEC>
__global__ void __launch_bounds__(NARROW_NT, NARROW_CTAS_PER_SM) warp_bicubic_kernel_narrow(
    const Tin* __restrict__ x, const float* __restrict__ flow, Tout* __restrict__ out, int H,
    int W, int C, int nslices, float a, int* __restrict__ tile_counts) {
  using VecT = typename Vec<Tin>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  VecT* win = reinterpret_cast<VecT*>(smem_raw);
  __shared__ int red[4][NARROW_NT / 32];

  const int slice = blockIdx.x % nslices;
  const int col = (blockIdx.x / nslices) * TILE_W + (threadIdx.x & 31);
  const int row = blockIdx.y * TILE_H + 2 * (threadIdx.x >> 5);
  const int c_first = slice * SLICE * 4;
  const int nch = C - c_first;  // channels from c_first on
  const int nv = min(SLICE, (nch + 3) >> 2);
  const size_t img = (size_t)H * W;
  const Tin* xs = x + blockIdx.z * img * C + c_first;
  const float* fb = flow + blockIdx.z * img * 2;
  Tout* oa = out + blockIdx.z * img * C + (size_t)(row * W + col) * C + c_first;  // where in
  Tout* ob = oa + (size_t)W * C;

  PHASE_CLOCK(long long ph[3]; long long c0 = clock64(), c1;)
  const Pix pa = setup_pixel<ZERO>(load_flow(fb, row, col, H, W), row, col, H, W, a);
  const Pix pb = setup_pixel<ZERO>(load_flow(fb, row + 1, col, H, W), row + 1, col, H, W, a);
  const int fl = (pa.in ? IN_A : 0) | (pb.in ? IN_B : 0) | (pa.live ? LIVE_A : 0) |
                 (pb.live ? LIVE_B : 0) |
                 (pa.live && pb.live && pa.tx == pb.tx && pb.ty == pa.ty + 1 ? PAIR : 0);
  int fx0 = INT_MAX, fx1 = INT_MIN, fy0 = INT_MAX, fy1 = INT_MIN;
  add_box(pa, W, H, fx0, fx1, fy0, fy1);
  add_box(pb, W, H, fx0, fx1, fy0, fy1);
  reduce_box<NARROW_NT>(fx0, fx1, fy0, fy1, red);
  PHASE_CLOCK(c1 = clock64(); ph[0] = c1 - c0;)  // phase 0: flow, weights, footprint
  const bool empty = fx0 > fx1;
  const int wxn = empty ? 0 : fx1 - fx0 + 1;
  const int wyn = empty ? 0 : fy1 - fy0 + 1;
  const bool staged = !empty && wxn * wyn <= window_pixels((C + 3) >> 2, sizeof(VecT));
  if (tile_counts != nullptr && slice == 0 && threadIdx.x == 0)
    atomicAdd(tile_counts + (empty ? 2 : staged ? 0 : 1), 1);

  // bf16 out with C % 8 == 0: the slice's two vectors leave as one 16-byte
  // store per pixel (vector 0 waits, packed, for vector 1)
  const bool out16 = VEC && sizeof(Tout) == 2 && nv == 2 && (C & 7) == 0;
  uint2 held_a = make_uint2(0u, 0u), held_b = held_a;
  auto emit = [&](int v, const float4 ra, const float4 rb) {
    if constexpr (VEC && sizeof(Tout) == 2) {
      if (out16) {
        if (v == 0) {
          held_a = pack_bf16(ra);
          held_b = pack_bf16(rb);
        } else {
          const uint2 la = pack_bf16(ra), lb = pack_bf16(rb);
          if (fl & IN_A) *reinterpret_cast<uint4*>(oa) = make_uint4(held_a.x, held_a.y, la.x, la.y);
          if (fl & IN_B) *reinterpret_cast<uint4*>(ob) = make_uint4(held_b.x, held_b.y, lb.x, lb.y);
        }
        return;
      }
    }
    if (fl & IN_A) store4<VEC>(oa + 4 * v, ra, nch - 4 * v);
    if (fl & IN_B) store4<VEC>(ob + 4 * v, rb, nch - 4 * v);
  };

  float4 acc_a, acc_b;
  if (empty) {  // every pixel zeroed by the solver's rule
    acc_a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int v = 0; v < SLICE; ++v)
      if (v < nv) emit(v, acc_a, acc_a);
    return;
  }
  if (staged) {
    stage_slice<Tin, VEC>(win, xs, nv, nch, fx0, fy0, wxn, wyn, W, C);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    PHASE_CLOCK(c0 = clock64(); ph[1] = c0 - c1;)  // phase 1: the window copy
    const Geo g{fx0, fy0, wxn, 1, W - 1, H - 1};
#pragma unroll
    for (int v = 0; v < SLICE; ++v) {
      if (v < nv) {
        const VecT* plane = win + v * PLANE;
        warp_two(pa, pb, fl, g, [plane](int p) { return to_f4(plane[p]); }, acc_a, acc_b);
        emit(v, acc_a, acc_b);
      }
    }
    PHASE_CLOCK(ph[2] = clock64() - c0; wg::phase_clocks_add(ph, 1);)  // phase 2: gather, store
    return;
  }
  // direct path: the window does not fit, gather from global memory
  const Geo g{0, 0, W * C, C, W - 1, H - 1};
#pragma unroll
  for (int v = 0; v < SLICE; ++v) {
    if (v < nv) {
      const Tin* src = xs + 4 * v;
      const int n = min(4, nch - 4 * v);
      warp_two(pa, pb, fl, g,
               [src, n](int p) {
                 if constexpr (VEC) {
                   return to_f4(__ldg(reinterpret_cast<const VecT*>(src + p)));
                 } else {
                   return to_f4(load_partial(src + p, n));
                 }
               },
               acc_a, acc_b);
      emit(v, acc_a, acc_b);
    }
  }
}

template <typename Tin, typename Tout, bool ZERO>
int launch(const void* x, const void* flow, void* out, int B, int H, int W, int C, float a,
           int* tile_counts, cudaStream_t s) {
  const int nv = (C + 3) / 4;
  const int tiles_x = (W + TILE_W - 1) / TILE_W, tiles_y = (H + TILE_H - 1) / TILE_H;
  if (C % 4 == 0 && C >= 16) {
    using VecT = typename Vec<Tin>::type;
    auto kern = warp_bicubic_kernel_wide<Tin, Tout, ZERO>;
    int lanes_log2 = 0;
    while ((1 << lanes_log2) < nv && lanes_log2 < 5) ++lanes_log2;
    const int win_pix = window_pixels(nv, (int)sizeof(VecT));
    const size_t smem = PARAM_BYTES + (size_t)win_pix * nv * sizeof(VecT);
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<dim3(tiles_x, tiles_y, B), WIDE_NT, smem, s>>>(
        (const Tin*)x, (const float*)flow, (Tout*)out, H, W, C, lanes_log2, win_pix, a,
        tile_counts);
    return (int)cudaGetLastError();
  }
  const int nslices = (nv + SLICE - 1) / SLICE;
  const size_t smem = (size_t)(nv < SLICE ? nv : SLICE) * PLANE * sizeof(typename Vec<Tin>::type);
  const dim3 grid(tiles_x * nslices, tiles_y, B);
  if (C % 4 == 0)
    warp_bicubic_kernel_narrow<Tin, Tout, ZERO, true><<<grid, NARROW_NT, smem, s>>>(
        (const Tin*)x, (const float*)flow, (Tout*)out, H, W, C, nslices, a, tile_counts);
  else
    warp_bicubic_kernel_narrow<Tin, Tout, ZERO, false><<<grid, NARROW_NT, smem, s>>>(
        (const Tin*)x, (const float*)flow, (Tout*)out, H, W, C, nslices, a, tile_counts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rvdd_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x_bf16 / out_bf16 select bf16 (1) or fp32 (0); a is the cubic
// coefficient; zero_outside (1) applies the solver's zero-outside rule
// (fp32 in and out only).  tile_counts: null, or a device int[3] to which
// the kernel adds its tiles by path (window, direct, all zeroed).  The
// caller guarantees H * W * max(C, 2) < 2^31, B and the tile rows below
// 65536, and 16-byte aligned x and flow.  Returns the launch's
// cudaGetLastError().
int rvdd_warp_bicubic_tiles(const void* x, int x_bf16, const void* flow, void* out,
                            int out_bf16, int B, int H, int W, int C, float a, int zero_outside,
                            int* tile_counts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (zero_outside) {
    if (x_bf16 || out_bf16) return (int)cudaErrorInvalidValue;
    return launch<float, float, true>(x, flow, out, B, H, W, C, a, tile_counts, s);
  }
  if (x_bf16 && out_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(x, flow, out, B, H, W, C, a,
                                                          tile_counts, s);
  if (x_bf16)
    return launch<__nv_bfloat16, float, false>(x, flow, out, B, H, W, C, a, tile_counts, s);
  if (out_bf16)
    return launch<float, __nv_bfloat16, false>(x, flow, out, B, H, W, C, a, tile_counts, s);
  return launch<float, float, false>(x, flow, out, B, H, W, C, a, tile_counts, s);
}

// The interface without the tile counter.
int rvdd_warp_bicubic(const void* x, int x_bf16, const void* flow, void* out, int out_bf16,
                      int B, int H, int W, int C, float a, int zero_outside, void* stream) {
  return rvdd_warp_bicubic_tiles(x, x_bf16, flow, out, out_bf16, B, H, W, C, a, zero_outside,
                                 nullptr, stream);
}

}  // extern "C"
