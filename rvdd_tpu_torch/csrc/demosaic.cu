// Hamilton-Adams demosaic of packed GBRG raw, for sm_90a.
//
// Replaces no TPU kernel: rvdd_tpu demosaics in XLA (rvdd_tpu/ops/demosaic.py:
// hamilton_adams, fused by the compiler).  The port's plain version
// (rvdd_tpu_torch/ops/demosaic.py) shifts the full-resolution mosaic once a
// stencil tap, an arange, a clamp and an index_select an axis, and runs some
// forty elementwise ops besides: about 480 launches a frame, which kept the
// host, not the card, setting the pace of every 1080p stream.  This kernel
// computes the same function in one launch for every frame of a window.
//
// Semantics: ops/demosaic.py op for op, in fp32.  Every shift replicates the
// mosaic's edge (the tap's row and column are clamped to the image); the
// green stencil ('algorithm 1') reads cfa taps up to 2 away along a row or a
// column; the chroma stencils ('algorithm 2') read the green plane and the
// red and blue sample planes (cfa * mask) 1 away, edge-replicated too, so a
// ring sample at a clamped position is the sample of the position it clamps
// to, masks included.  Each operation rounds once, in the order the plain
// version's elementwise kernels take: the arithmetic goes through
// __fadd_rn / __fsub_rn / __fmul_rn, which nvcc never contracts into FMAs,
// divisions by 2 and 4 are the exact products by 0.5 and 0.25 that
// PyTorch's division by a scalar computes, sign() is (0 < x) - (x < 0), and
// the masks multiply as 0.0 / 1.0.  The output is bitwise the plain
// version's on the card.
//
// What bounds it on the H100: bytes.  A 1080p frame reads 8.3 MB of packed
// raw and writes 24.9 MB of RGB; the stream's two frames a window, 66.4 MB,
// take 0.0198 ms at 3.35 TB/s.
//
// Design: a 2-D grid of 32-row x 64-column output tiles (blockIdx.z the
// frame), 256 threads a CTA, three CTAs an SM (80 registers a thread).
// (1) The CTA stages its tile's mosaic plus 4 rows and columns around it
// (40 x 72 fp32), a packed pixel (a 2x2 block) a 16-byte load where the
// block lies inside the frame and the input is 16-byte aligned, each
// sample at its clamped position otherwise.  (2) It computes green, and
// the red and blue samples, on the tile plus the 1-pixel ring that the
// chroma stencils read, at each ring position's clamped coordinate, into
// shared memory.  (3) Each thread
// takes 2 rows x 4 columns of the tile, loads the 4 x 6 neighbourhood of
// the three planes with 16- and 8-byte shared loads, and computes red and
// blue; tiles start at even rows and at multiples of 4 columns, so every
// mask is a constant of the unrolled code.  It writes each row's 4 RGB
// pixels as three 16-byte stores where the image width allows (2w % 4 == 0,
// the stream's) and pixel by pixel otherwise.  Offsets inside a frame are
// 32-bit; the caller guarantees 2h * 2w * 3 < 2^31.
// On an NVIDIA H100 80GB HBM3 at 700 W it takes 0.046 ms for the stream's
// two frames, 44% of the bound (element-wise staging: 0.061 ms; the same
// with two CTAs an SM at 96 registers: 0.053 ms; red and blue in turn to
// cut registers: no faster).  What holds it back: a CTA stages, computes
// and stores in turn, behind two barriers, so the loads of three CTAs an
// SM are all that hide the memory's latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_H = 32, TILE_W = 64;  // output tile (full resolution)
constexpr int NT = 256;                  // 16 x 16 threads, 2 rows x 4 columns each
// mosaic rows/columns staged around the tile: the stencils read 3, and 4
// keep the packed 2x2 blocks whole
constexpr int HALO = 4;
constexpr int CH = TILE_H + 2 * HALO, CW = TILE_W + 2 * HALO;  // staged mosaic
constexpr int GH = TILE_H + 2, GW = TILE_W + 2;                // tile + 1-pixel ring
constexpr int GP = GW + 2;  // ring row pitch in floats: a multiple of 4 (16-byte loads)

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float sgn(float a) { return (float)((0.f < a) - (a < 0.f)); }

// green at the mosaic sample *c (row pitch CW): ops/demosaic.py:_interp_green
__device__ __forceinline__ float green_at(const float* c, float mask_g) {
  const float v = c[0];
  const float kh = mul(0.5f, add(c[-1], c[1]));
  const float kv = mul(0.5f, add(c[-CW], c[CW]));
  const float dh = add(sub(c[-2], mul(2.f, v)), c[2]);
  const float dv = add(sub(c[-2 * CW], mul(2.f, v)), c[2 * CW]);
  const float diffh = sub(c[-1], c[1]);
  const float diffv = sub(c[-CW], c[CW]);
  const float rawh = sub(kh, mul(dh, 0.25f));
  const float rawv = sub(kv, mul(dv, 0.25f));
  const float clh = add(fabsf(diffh), fabsf(dh));
  const float clv = add(fabsf(diffv), fabsf(dv));
  const float s = sgn(sub(clh, clv));
  const float g = add(mul(mul(add(1.f, s), rawv), 0.5f), mul(mul(sub(1.f, s), rawh), 0.5f));
  return add(mul(g, sub(1.f, mask_g)), mul(v, mask_g));
}

// one chroma channel at (r, k) of a thread's 4 x 6 neighbourhoods of the
// channel's samples C and of green G: ops/demosaic.py:_interp_chroma
__device__ __forceinline__ float chroma_at(const float (&C)[4][6], const float (&G)[4][6], int r,
                                           int k, float mask_o, float mask_row, float mask_col) {
  const float kh = mul(0.5f, add(C[r][k - 1], C[r][k + 1]));
  const float kv = mul(0.5f, add(C[r - 1][k], C[r + 1][k]));
  const float kp = mul(0.5f, add(C[r - 1][k - 1], C[r + 1][k + 1]));
  const float kn = mul(0.5f, add(C[r - 1][k + 1], C[r + 1][k - 1]));
  const float diffp = sub(C[r + 1][k + 1], C[r - 1][k - 1]);
  const float diffn = sub(C[r + 1][k - 1], C[r - 1][k + 1]);
  const float g = G[r][k];
  const float dh_g = add(sub(mul(0.25f, G[r][k - 1]), mul(0.5f, g)), mul(0.25f, G[r][k + 1]));
  const float dv_g = add(sub(mul(0.25f, G[r - 1][k]), mul(0.5f, g)), mul(0.25f, G[r + 1][k]));
  const float dp_g = add(sub(G[r - 1][k - 1], mul(2.f, g)), G[r + 1][k + 1]);
  const float dn_g = add(sub(G[r - 1][k + 1], mul(2.f, g)), G[r + 1][k - 1]);
  const float ch = mul(mask_row, sub(kh, dh_g));
  const float cv = mul(mask_col, sub(kv, dv_g));
  const float cp = mul(mask_o, sub(kp, mul(dp_g, 0.25f)));
  const float cn = mul(mask_o, sub(kn, mul(dn_g, 0.25f)));
  const float clp = mul(mask_o, add(fabsf(diffp), fabsf(dp_g)));
  const float cln = mul(mask_o, add(fabsf(diffn), fabsf(dn_g)));
  const float s = sgn(sub(clp, cln));
  const float diag = add(mul(mul(add(1.f, s), cn), 0.5f), mul(mul(sub(1.f, s), cp), 0.5f));
  return add(add(add(diag, ch), cv), C[r][k]);
}

__device__ __forceinline__ void load_row(const float* p, float (&dst)[6]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float2 b = *reinterpret_cast<const float2*>(p + 4);
  dst[0] = a.x, dst[1] = a.y, dst[2] = a.z, dst[3] = a.w, dst[4] = b.x, dst[5] = b.y;
}

__global__ void __launch_bounds__(NT, 3)
    hamilton_adams_kernel(const float* __restrict__ raw, long long frame_stride,
                          float* __restrict__ out, int h, int w, int vec_in, int vec_out) {
  __shared__ __align__(16) float s_cfa[CH * CW];
  __shared__ __align__(16) float s_g[GH * GP];
  __shared__ __align__(16) float s_r[GH * GP];
  __shared__ __align__(16) float s_b[GH * GP];
  const int H = 2 * h, W = 2 * w;
  const int y0 = blockIdx.y * TILE_H, x0 = blockIdx.x * TILE_W;
  const float* src = raw + (long long)blockIdx.z * frame_stride;
  const int tid = threadIdx.x;

  // (1) the mosaic, edge-replicated: mosaic (y, x) is packed (y/2, x/2),
  // channel 2(y&1) + (x&1).  A packed pixel inside the frame is one 16-byte
  // load of a 2x2 block; a block outside reads each sample at its clamped
  // position.
  auto sample = [&](int fy, int fx) {
    fy = min(max(fy, 0), H - 1);
    fx = min(max(fx, 0), W - 1);
    return __ldg(src + ((fy >> 1) * w + (fx >> 1)) * 4 + (fy & 1) * 2 + (fx & 1));
  };
  const int py0 = (y0 - HALO) / 2, px0 = (x0 - HALO) / 2;
#pragma unroll
  for (int i = tid; i < CH * CW / 4; i += NT) {
    const int r = i / (CW / 2), c = i - r * (CW / 2);
    const int py = py0 + r, px = px0 + c;
    float4 v;
    if (vec_in && py >= 0 && py < h && px >= 0 && px < w) {
      v = __ldg(reinterpret_cast<const float4*>(src) + py * w + px);
    } else {
      v.x = sample(2 * py, 2 * px), v.y = sample(2 * py, 2 * px + 1);
      v.z = sample(2 * py + 1, 2 * px), v.w = sample(2 * py + 1, 2 * px + 1);
    }
    float* d = s_cfa + 2 * r * CW + 2 * c;
    *reinterpret_cast<float2*>(d) = make_float2(v.x, v.y);
    *reinterpret_cast<float2*>(d + CW) = make_float2(v.z, v.w);
  }
  __syncthreads();

  // (2) green and the red and blue samples on the tile and its ring, each at
  // the position its coordinate clamps to
  for (int i = tid; i < GH * GW; i += NT) {
    const int r = i / GW, c = i - r * GW;
    const int cy = min(max(y0 - 1 + r, 0), H - 1);
    const int cx = min(max(x0 - 1 + c, 0), W - 1);
    const float* p = s_cfa + (cy - y0 + HALO) * CW + (cx - x0 + HALO);
    const int oy = cy & 1, ox = cx & 1;
    const float v = p[0];
    s_g[r * GP + c] = green_at(p, oy == ox ? 1.f : 0.f);
    s_r[r * GP + c] = mul(v, (oy && !ox) ? 1.f : 0.f);  // mask_r: odd row, even column
    s_b[r * GP + c] = mul(v, (!oy && ox) ? 1.f : 0.f);  // mask_b: even row, odd column
  }
  __syncthreads();

  // (3) red and blue on 2 rows x 4 columns a thread; ring row/column j holds
  // tile row/column j - 1
  const int ly = 2 * (tid >> 4), lx = 4 * (tid & 15);
  float G[4][6], R[4][6], B[4][6];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int off = (ly + r) * GP + lx;
    load_row(s_g + off, G[r]);
    load_row(s_r + off, R[r]);
    load_row(s_b + off, B[r]);
  }
#pragma unroll
  for (int py = 0; py < 2; ++py) {
    const int y = y0 + ly + py;  // y0 and ly are even: y's parity is py's
    if (y >= H) break;
    float rgb[12];
#pragma unroll
    for (int px = 0; px < 4; ++px) {  // x0 and lx are multiples of 4: x's parity is px's
      const float gr = (py == 1 && px % 2 == 1) ? 1.f : 0.f;  // green on a red row
      const float gb = (py == 0 && px % 2 == 0) ? 1.f : 0.f;  // green on a blue row
      const float mr = (py == 1 && px % 2 == 0) ? 1.f : 0.f;
      const float mb = (py == 0 && px % 2 == 1) ? 1.f : 0.f;
      rgb[3 * px + 0] = chroma_at(R, G, py + 1, px + 1, mb, gr, gb);
      rgb[3 * px + 1] = G[py + 1][px + 1];
      rgb[3 * px + 2] = chroma_at(B, G, py + 1, px + 1, mr, gb, gr);
    }
    const int x = x0 + lx;
    float* dst = out + (long long)blockIdx.z * H * W * 3 + (y * W + x) * 3;
    if (vec_out) {  // W % 4 == 0: the strip is inside the image or wholly past it
      if (x < W) {
        float4* d4 = reinterpret_cast<float4*>(dst);
        d4[0] = make_float4(rgb[0], rgb[1], rgb[2], rgb[3]);
        d4[1] = make_float4(rgb[4], rgb[5], rgb[6], rgb[7]);
        d4[2] = make_float4(rgb[8], rgb[9], rgb[10], rgb[11]);
      }
    } else {
#pragma unroll
      for (int px = 0; px < 4; ++px) {
        if (x + px < W) {
          dst[3 * px + 0] = rgb[3 * px + 0];
          dst[3 * px + 1] = rgb[3 * px + 1];
          dst[3 * px + 2] = rgb[3 * px + 2];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

const char* rvdd_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// raw: N frames of packed GBRG [h, w, 4] fp32, each contiguous, frame n at
// raw + n * frame_stride (elements); out: [N, 2h, 2w, 3] fp32, contiguous.
// The caller guarantees N, h, w > 0, N and 2h / 32 below 65536 and
// 2h * 2w * 3 < 2^31.  Returns the launch's cudaGetLastError().
int rvdd_hamilton_adams(const float* raw, long long frame_stride, float* out, int n, int h, int w,
                        void* stream) {
  const int H = 2 * h, W = 2 * w;
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, n);
  const int vec_in = frame_stride % 4 == 0 && reinterpret_cast<uintptr_t>(raw) % 16 == 0;
  const int vec_out = W % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  hamilton_adams_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(raw, frame_stride, out, h, w,
                                                               vec_in, vec_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
