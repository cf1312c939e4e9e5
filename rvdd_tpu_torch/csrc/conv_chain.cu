// One conv layer of a fused U-Net conv chain, for sm_90a: an implicit-GEMM
// 3x3 (or 1x1) convolution in NHWC with bf16 operands and fp32 accumulation
// on the tensor cores (WMMA 16x16x16), bias and relu in the epilogue.
//
// Replaces rvdd_tpu/ops/pallas/conv_pallas.py:fused_conv_chain (body
// _chain_kernel, weight packing pack_weight and the hi/lo split), which the
// port's ops/cuda/conv_chain.py drives as one launch of this kernel per
// layer.  The chain options of the TPU kernel map onto one launch:
//   * aux concat after layer 0: the layer reads its K = 9 * (C0 + Caux)
//     input through two pointers (a channel window of the aux tensor); no
//     concatenated copy is made;
//   * upsample_input: the prologue builds the 2x bilinear
//     (align_corners=False, edge-replicated) upsample of the half-res
//     input while it stages the tile, in fp32, rounded once to bf16;
//   * pool emit: the epilogue writes the whole 2x2 max pool (block tiles
//     start at even coordinates, so each window lies in one block);
//   * combined state emit: the epilogue writes the fp32 accumulator (after
//     bias and act) into a channel window of the fp32 recurrence state and
//     zero-fills the pad channels that follow it;
//   * weight split: the layer runs a second product with the lo half of
//     the weights (w = hi + lo, hi by mantissa masking) into the same fp32
//     accumulator.
// Numerics of rvdd_tpu's 'fast' preset: bf16 activations and weights, fp32
// accumulation, fp32 bias; every band (layer output) is stored as bf16.
//
// What bounds it on the H100: operations.  The six chains of a 1080p frame
// need about 1.07 TFLOP (with dec2's split layers): about 1.0 ms at the
// 989 TFLOP/s bf16 dense peak, against about 0.3 ms for their bytes.  This
// first cut keeps each layer's input tile (8x32 output pixels plus a
// one-pixel halo, all input channels) in shared memory and issues legacy
// warp-level MMAs with B fragments read through L1; it does not reach the
// wgmma peak.  Keeping a whole chain's intermediates in shared memory
// (2D tiles with halos) and wgmma/TMA pipelines are the next steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TH = 8;             // output rows per block, one warp per row
constexpr int TW = 32;            // output columns per block: 2 MMA row fragments
constexpr int NTHREADS = TH * 32;

struct LayerArgs {
  const bf16* in0;                // [B, h0, w0, in0_stride], channels at in0_off
  int in0_c, in0_stride, in0_off, in0_h, in0_w, upsample;
  const bf16* aux;                // [B, H, W, aux_stride], channels at aux_off
  int aux_c, aux_stride, aux_off;
  const bf16* w_hi;               // [ks*ks*(cin0_pad+aux_c), cout_pad]
  const bf16* w_lo;               // same shape, or null
  const float* bias;              // [cout]
  int ks, cin0_pad, cout, cout_pad, relu;
  int H, W;                       // output (full) resolution
  bf16* out;                      // [B, H, W, cout] or null
  bf16* pooled;                   // [B, H/2, W/2, cout] or null
  float* state;                   // [B, H, W, state_stride] or null
  int state_stride, state_off, state_zero;
};

union Pack8 {
  uint4 u;
  unsigned short s[8];
};

// 8 channels [c0, c0+8) of one pixel; channels >= c read as zero
__device__ __forceinline__ uint4 load_px8(const bf16* base, size_t pixel,
                                          int stride, int off, int c0, int c,
                                          bool vec) {
  const bf16* p = base + pixel * stride + off + c0;
  if (vec) return *reinterpret_cast<const uint4*>(p);
  Pack8 r;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    r.s[k] = (c0 + k < c) ? __bfloat16_as_ushort(p[k]) : (unsigned short)0;
  return r.u;
}

__device__ __forceinline__ void unpack8(uint4 u, float* v) {
  Pack8 r;
  r.u = u;
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __bfloat162float(__ushort_as_bfloat16(r.s[k]));
}

// 8 channels of the 2x bilinear (align_corners=False) upsample of the
// half-res in0 at full-res (gy, gx): rows j and jn, columns i and ic, with
// weights 0.75 / 0.25 and edge replication; rows first, as
// rvdd_tpu/ops/resize.py does, then rounded once to bf16
__device__ __forceinline__ uint4 load_up8(const LayerArgs& a, int b, int gy,
                                          int gx, int c0, bool vec) {
  const int j = gy >> 1, i = gx >> 1;
  const int jn = min(max((gy & 1) ? j + 1 : j - 1, 0), a.in0_h - 1);
  const int ic = min(max((gx & 1) ? i + 1 : i - 1, 0), a.in0_w - 1);
  const size_t r0 = (size_t)b * a.in0_h + j, r1 = (size_t)b * a.in0_h + jn;
  float v00[8], v01[8], v10[8], v11[8];
  unpack8(load_px8(a.in0, r0 * a.in0_w + i, a.in0_stride, a.in0_off, c0, a.in0_c, vec), v00);
  unpack8(load_px8(a.in0, r0 * a.in0_w + ic, a.in0_stride, a.in0_off, c0, a.in0_c, vec), v01);
  unpack8(load_px8(a.in0, r1 * a.in0_w + i, a.in0_stride, a.in0_off, c0, a.in0_c, vec), v10);
  unpack8(load_px8(a.in0, r1 * a.in0_w + ic, a.in0_stride, a.in0_off, c0, a.in0_c, vec), v11);
  Pack8 r;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float ri = 0.75f * v00[k] + 0.25f * v10[k];
    const float rn = 0.75f * v01[k] + 0.25f * v11[k];
    r.s[k] = __bfloat16_as_ushort(__float2bfloat16_rn(0.75f * ri + 0.25f * rn));
  }
  return r.u;
}

__device__ __forceinline__ float act(const LayerArgs& a, float acc, int c) {
  const float y = acc + __ldg(a.bias + c);
  return a.relu ? fmaxf(y, 0.f) : y;
}

template <int NF>  // cout_pad / 16 output-channel fragments
__global__ void __launch_bounds__(NTHREADS) conv_layer_kernel(const LayerArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int halo = a.ks >> 1;
  const int tw_in = TW + 2 * halo;
  const int th_in = TH + 2 * halo;
  const int cin_tot = a.cin0_pad + a.aux_c;  // a multiple of 16
  const int chunks = cin_tot >> 3;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;

  // ---- prologue: stage the input tile [th_in][tw_in][cin_tot] in bf16,
  // zeros outside the image (the conv's zero padding) and in pad channels
  bf16* tile = reinterpret_cast<bf16*>(smem);
  const bool in0_vec = (a.in0_c % 8 == 0) && (a.in0_stride % 8 == 0) && (a.in0_off % 8 == 0);
  const bool aux_vec = (a.aux_c % 8 == 0) && (a.aux_stride % 8 == 0) && (a.aux_off % 8 == 0);
  for (int it = threadIdx.x; it < th_in * tw_in * chunks; it += NTHREADS) {
    const int ch = it % chunks;
    const int pix = it / chunks;
    const int gy = y0 + pix / tw_in - halo;
    const int gx = x0 + pix % tw_in - halo;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W) {
      const int c0 = ch * 8;
      const size_t pixel = ((size_t)b * a.H + gy) * a.W + gx;
      if (c0 < a.cin0_pad) {
        if (c0 < a.in0_c) {
          v = a.upsample ? load_up8(a, b, gy, gx, c0, in0_vec)
                         : load_px8(a.in0, pixel, a.in0_stride, a.in0_off, c0, a.in0_c, in0_vec);
        }
      } else {
        v = load_px8(a.aux, pixel, a.aux_stride, a.aux_off, c0 - a.cin0_pad, a.aux_c, aux_vec);
      }
    }
    *reinterpret_cast<uint4*>(tile + (size_t)pix * cin_tot + ch * 8) = v;
  }
  __syncthreads();

  // ---- main loop: warp w computes output row w of the tile, two 16-pixel
  // row fragments x NF 16-channel fragments; K runs over taps x channels
  const int warp = threadIdx.x >> 5;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NF];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NF; ++n) wmma::fill_fragment(acc[m][n], 0.f);

  const int kchunks = cin_tot >> 4;
  const int ldb = a.cout_pad;
  for (int dy = 0; dy < a.ks; ++dy) {
    for (int dx = 0; dx < a.ks; ++dx) {
      const bf16* arow = tile + ((size_t)(warp + dy) * tw_in + dx) * cin_tot;
      const size_t wtap = (size_t)(dy * a.ks + dx) * cin_tot * ldb;
      for (int kc = 0; kc < kchunks; ++kc) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
#pragma unroll
        for (int m = 0; m < 2; ++m)
          wmma::load_matrix_sync(fa[m], arow + (size_t)m * 16 * cin_tot + kc * 16, cin_tot);
        const size_t woff = wtap + (size_t)kc * 16 * ldb;
#pragma unroll
        for (int n = 0; n < NF; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, a.w_hi + woff + n * 16, ldb);
#pragma unroll
          for (int m = 0; m < 2; ++m) wmma::mma_sync(acc[m][n], fa[m], fb, acc[m][n]);
          if (a.w_lo != nullptr) {
            wmma::load_matrix_sync(fb, a.w_lo + woff + n * 16, ldb);
#pragma unroll
            for (int m = 0; m < 2; ++m) wmma::mma_sync(acc[m][n], fa[m], fb, acc[m][n]);
          }
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the tile; reuse it as staging

  // ---- epilogue: accumulators -> fp32 staging [TH*TW][cout_pad]
  float* stage = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NF; ++n)
      wmma::store_matrix_sync(stage + ((size_t)warp * TW + m * 16) * ldb + n * 16,
                              acc[m][n], ldb, wmma::mem_row_major);
  __syncthreads();

  if (a.out != nullptr || a.state != nullptr) {
    for (int it = threadIdx.x; it < TH * TW * a.cout; it += NTHREADS) {
      const int c = it % a.cout;
      const int pix = it / a.cout;
      const int gy = y0 + pix / TW, gx = x0 + pix % TW;
      if (gy >= a.H || gx >= a.W) continue;
      const float y = act(a, stage[(size_t)pix * ldb + c], c);
      const size_t p = ((size_t)b * a.H + gy) * a.W + gx;
      if (a.out != nullptr) a.out[p * a.cout + c] = __float2bfloat16_rn(y);
      if (a.state != nullptr) a.state[p * a.state_stride + a.state_off + c] = y;
    }
  }
  if (a.state != nullptr && a.state_zero > 0) {
    for (int it = threadIdx.x; it < TH * TW * a.state_zero; it += NTHREADS) {
      const int c = it % a.state_zero;
      const int pix = it / a.state_zero;
      const int gy = y0 + pix / TW, gx = x0 + pix % TW;
      if (gy >= a.H || gx >= a.W) continue;
      const size_t p = ((size_t)b * a.H + gy) * a.W + gx;
      a.state[p * a.state_stride + a.state_off + a.cout + c] = 0.f;
    }
  }
  if (a.pooled != nullptr) {
    const int h2 = a.H >> 1, w2 = a.W >> 1;
    for (int it = threadIdx.x; it < (TH / 2) * (TW / 2) * a.cout; it += NTHREADS) {
      const int c = it % a.cout;
      const int q = it / a.cout;
      const int py = q / (TW / 2), px = q % (TW / 2);
      const int gy2 = (y0 >> 1) + py, gx2 = (x0 >> 1) + px;
      if (gy2 >= h2 || gx2 >= w2) continue;
      const int p00 = (2 * py) * TW + 2 * px;
      float mx = act(a, stage[(size_t)p00 * ldb + c], c);
      mx = fmaxf(mx, act(a, stage[(size_t)(p00 + 1) * ldb + c], c));
      mx = fmaxf(mx, act(a, stage[(size_t)(p00 + TW) * ldb + c], c));
      mx = fmaxf(mx, act(a, stage[(size_t)(p00 + TW + 1) * ldb + c], c));
      const size_t p = ((size_t)b * h2 + gy2) * w2 + gx2;
      a.pooled[p * a.cout + c] = __float2bfloat16_rn(mx);
    }
  }
}

template <int NF>
cudaError_t launch(const LayerArgs& a, dim3 grid, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_layer_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  conv_layer_kernel<NF><<<grid, NTHREADS, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rvdd_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// One conv layer; see LayerArgs for the tensors.  The caller guarantees
// cin0_pad % 16 == 0, aux_c % 16 == 0, cout_pad in {16, 32, 48},
// cout <= cout_pad, H == 2*in0_h and W == 2*in0_w when upsample, and
// 16-byte aligned tensors.  Returns a cudaError_t as int.
int rvdd_conv_layer(const void* in0, int in0_c, int in0_stride, int in0_off,
                    int in0_h, int in0_w, int upsample,
                    const void* aux, int aux_c, int aux_stride, int aux_off,
                    const void* w_hi, const void* w_lo, const void* bias,
                    int ks, int cin0_pad, int cout, int cout_pad, int relu,
                    int B, int H, int W,
                    void* out, void* pooled,
                    void* state, int state_stride, int state_off, int state_zero,
                    void* stream) {
  LayerArgs a;
  a.in0 = (const bf16*)in0; a.in0_c = in0_c; a.in0_stride = in0_stride;
  a.in0_off = in0_off; a.in0_h = in0_h; a.in0_w = in0_w; a.upsample = upsample;
  a.aux = (const bf16*)aux; a.aux_c = aux_c; a.aux_stride = aux_stride; a.aux_off = aux_off;
  a.w_hi = (const bf16*)w_hi; a.w_lo = (const bf16*)w_lo; a.bias = (const float*)bias;
  a.ks = ks; a.cin0_pad = cin0_pad; a.cout = cout; a.cout_pad = cout_pad; a.relu = relu;
  a.H = H; a.W = W;
  a.out = (bf16*)out; a.pooled = (bf16*)pooled;
  a.state = (float*)state; a.state_stride = state_stride; a.state_off = state_off;
  a.state_zero = state_zero;

  const int halo = ks / 2;
  const size_t tile_bytes =
      (size_t)(TH + 2 * halo) * (TW + 2 * halo) * (cin0_pad + aux_c) * sizeof(bf16);
  const size_t stage_bytes = (size_t)TH * TW * cout_pad * sizeof(float);
  const size_t smem = tile_bytes > stage_bytes ? tile_bytes : stage_bytes;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  switch (cout_pad / 16) {
    case 1: e = launch<1>(a, grid, smem, s); break;
    case 2: e = launch<2>(a, grid, smem, s); break;
    case 3: e = launch<3>(a, grid, smem, s); break;
    default: e = cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) cudaGetLastError();  // clear it; report it once
  return (int)e;
}

}  // extern "C"
