// One ConvNeXt block of a fused block chain, for sm_90a:
//   proj?(1x1) -> dw 7x7 -> channel LayerNorm -> 1x1 48->192 -> tanh GELU
//   -> 1x1 192->48, y = x + layerscale * h, in NHWC with 48 channels.
//
// Replaces rvdd_tpu/ops/pallas/convnext_pallas.py:fused_convnext_chain
// (body _cnx_kernel), which the port's ops/cuda/convnext_chain.py drives as
// one launch of this kernel per block.  The chain options map onto a launch:
//   * aux concat: block 1 reads its proj input [block-0 output | aux] through
//     two pointers (a channel window of the aux tensor); no copy is made;
//   * upsample_input: the prologue builds the 2x bilinear align_corners=True
//     upsample of the half-res input in fp32 while it stages the tile, and
//     rounds it once to bf16;
//   * the chain input's channels (9 for the flagship's chain A) are padded
//     to 16 inside the staged tile, not in memory;
//   * pool emit: the epilogue writes the 2x2 max pool of the bf16 band
//     (tiles start at even coordinates, so each window lies in one tile);
//   * combined state emit: the epilogue writes the fp32 y before the band
//     cast into channels [feat_off, feat_off+48) of the recurrence state,
//     the 1x1 head (on the bf16 band) into channels [0, n_head) and zeros
//     between them.
// Numerics of rvdd_tpu's 'fast' preset in its production depthwise mode
// (dw_impl='mxu2'): the depthwise taps are bf16 values (the TPU kernel's
// repacked [n_cg*7g, 7g] tap matrix is cast to bf16; its 'vpu' engine would
// keep fp32 taps); proj, pw1, pw2 and the head have bf16 weights and fp32
// accumulation; biases, LayerNorm and layerscale are fp32; the LN output and
// the GELU output are rounded to bf16 before their products; every band is
// stored as bf16.
//
// What bounds it on the H100: operations.  Per 1080p frame the seven chains
// need about 0.81 TFLOP of 1x1 products and 0.10 TFLOP of depthwise taps,
// all bf16 products with fp32 sums (0.91 ms at the 989 TFLOP/s bf16
// tensor-core peak; rvdd_tpu's production engine runs the depthwise on its
// matrix unit too), and about 1.5 GB of chain inputs and outputs (0.45 ms
// at 3.35 TB/s).  The 1x1 products are 90% of the bound.  This first cut:
//   * a persistent CTA of 8 warps loads the block's weights into shared
//     memory once, then walks 8x16-pixel output tiles;
//   * per tile it stages the input plus its 3-pixel halo (14x22 pixels, all
//     channels, bf16) in shared memory and, for a proj block, runs the proj
//     over the whole halo tile on the tensor cores;
//   * warp w owns output row w (16 pixels, one WMMA row fragment): the
//     depthwise taps run on CUDA cores in fp32 (2 lanes a pixel, 24
//     channels each), LN reduces with a lane shuffle;
//   * pw1 and pw2 run on the tensor cores (WMMA 16x16x16 bf16 -> fp32),
//     16 hidden channels at a time: the 192-channel hidden never leaves the
//     SM (each warp holds a 16x16 slice of it at a time);
// It uses legacy warp-level MMAs, not wgmma, and one CTA per SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int F = 48;                 // block width
constexpr int HID = 4 * F;            // hidden width
constexpr int KS = 7, R = 3, TAPS = KS * KS;
constexpr int TH = 8, TW = 16;        // output tile: warp w -> row w, one M fragment
constexpr int NWARPS = TH;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int HT = TH + 2 * R, WT = TW + 2 * R;
constexpr int NPIX = HT * WT;                      // 308 halo-tile pixels
constexpr int NPIX_PAD = (NPIX + 15) / 16 * 16;    // 320: whole M fragments
constexpr int MAX_CIN = 96;
constexpr int MAX_HEAD = 8;
constexpr int CPL = F / 2;            // channels per lane (two lanes a pixel)
// fp32 vectors in shared memory
constexpr int V_DW_B = 0, V_LN_G = 48, V_LN_B = 96, V_PW1_B = 144, V_PW2_B = 336,
              V_LS = 384, V_PROJ_B = 432, V_HEAD_B = 480, V_TOTAL = 488;

struct BlockArgs {
  const bf16* in0;             // [B, in0_h, in0_w, in0_c]
  int in0_c, in0_h, in0_w, upsample;
  const bf16* aux;             // [B, H, W, aux_stride], channels at aux_off
  int aux_c, aux_stride, aux_off;
  int cin0_pad;                // proj input: in0 channels padded to 16, then aux
  const bf16* proj_w;          // [cin0_pad + aux_c, F] or null
  const float* proj_b;
  const float* dw_w;           // [TAPS, F]
  const float* dw_b;
  const float* ln_g;
  const float* ln_b;
  const bf16* pw1;             // [F, HID]
  const float* pw1_b;
  const bf16* pw2;             // [HID, F]
  const float* pw2_b;
  const float* ls;
  const bf16* head_w;          // [F, n_head] or null
  const float* head_b;
  int n_head;
  int B, H, W;                 // output resolution
  bf16* out;                   // [B, H, W, F] or null
  bf16* pooled;                // [B, H/2, W/2, F] or null
  bf16* head_out;              // [B, H, W, n_head] or null
  float* state;                // [B, H, W, state_stride] or null
  int state_stride, feat_off;  // feat_off < 0: the state holds no features
};

struct Smem {
  int pw1, pw2, dw, vec, head, tile, hn, scr, hid, proj, raw, total;
};

__host__ __device__ inline int align128(int x) { return (x + 127) & ~127; }

// byte offsets of the shared-memory regions; cin = proj input channels (0: no proj)
__host__ __device__ inline Smem smem_layout(int cin) {
  Smem s;
  int o = 0;
  s.pw1 = o;  o = align128(o + F * HID * 2);
  s.pw2 = o;  o = align128(o + HID * F * 2);
  s.dw = o;   o = align128(o + TAPS * F * 4);
  s.vec = o;  o = align128(o + V_TOTAL * 4);
  s.head = o; o = align128(o + MAX_HEAD * F * 4);
  s.tile = o; o = align128(o + NPIX_PAD * F * 2);        // block input (after proj)
  s.hn = o;   o = align128(o + TH * TW * F * 2);         // LN out, then the bf16 band
  s.scr = o;  o = align128(o + NWARPS * 16 * F * 4);     // per-warp fp32 staging
  s.hid = o;  o = align128(o + NWARPS * 16 * 16 * 2);    // per-warp hidden slice
  s.proj = o; o = align128(o + cin * F * 2);
  s.raw = o;  o = align128(o + NPIX_PAD * cin * 2);      // proj input
  s.total = o;
  return s;
}

union Pack8 {
  uint4 u;
  unsigned short s[8];
};

__device__ __forceinline__ void unpack8(uint4 u, float* v) {
  Pack8 r;
  r.u = u;
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __bfloat162float(__ushort_as_bfloat16(r.s[k]));
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  Pack8 r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.s[k] = __bfloat16_as_ushort(__float2bfloat16_rn(v[k]));
  return r.u;
}

// 8 channels [c0, c0+8) of one pixel; channels >= c read as zero
__device__ __forceinline__ uint4 load_px8(const bf16* base, size_t pixel, int stride,
                                          int off, int c0, int c, bool vec) {
  const bf16* p = base + pixel * stride + off + c0;
  if (vec) return *reinterpret_cast<const uint4*>(p);
  Pack8 r;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    r.s[k] = (c0 + k < c) ? __bfloat16_as_ushort(p[k]) : (unsigned short)0;
  return r.u;
}

// source taps and weight of output g of a 2x align_corners=True resize from
// n_in samples, computed as ops/resize.py does (float64 position, fp32 t)
__device__ __forceinline__ void ac_taps(int g, int n_in, int& i0, int& i1, float& t) {
  const double src = (double)g * (double)(n_in - 1) / (double)(2 * n_in - 1);
  i0 = min((int)floor(src), n_in - 1);
  i1 = min(i0 + 1, n_in - 1);
  t = (float)(src - (double)i0);
}

// a * (1 - t) + b * t with no contraction, the plain version's order
__device__ __forceinline__ float lerp_rn(float a, float b, float t) {
  return __fadd_rn(__fmul_rn(a, 1.f - t), __fmul_rn(b, t));
}

// 8 channels of the 2x bilinear (align_corners=True) upsample of the
// half-res in0 at full-res (gy, gx): rows first, then columns, in fp32,
// rounded once to bf16
__device__ __forceinline__ uint4 load_up8(const BlockArgs& a, int b, int gy, int gx,
                                          int c0, bool vec) {
  int j0, j1, i0, i1;
  float ty, tx;
  ac_taps(gy, a.in0_h, j0, j1, ty);
  ac_taps(gx, a.in0_w, i0, i1, tx);
  const size_t r0 = (size_t)b * a.in0_h + j0, r1 = (size_t)b * a.in0_h + j1;
  float v00[8], v01[8], v10[8], v11[8];
  unpack8(load_px8(a.in0, r0 * a.in0_w + i0, a.in0_c, 0, c0, a.in0_c, vec), v00);
  unpack8(load_px8(a.in0, r0 * a.in0_w + i1, a.in0_c, 0, c0, a.in0_c, vec), v01);
  unpack8(load_px8(a.in0, r1 * a.in0_w + i0, a.in0_c, 0, c0, a.in0_c, vec), v10);
  unpack8(load_px8(a.in0, r1 * a.in0_w + i1, a.in0_c, 0, c0, a.in0_c, vec), v11);
  float v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    v[k] = lerp_rn(lerp_rn(v00[k], v10[k], ty), lerp_rn(v01[k], v11[k], ty), tx);
  return pack8(v);
}

__device__ __forceinline__ float gelu_tanh(float x) {
  // torch's F.gelu(approximate='tanh')
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float x_cube = x * x * x;
  const float inner = kBeta * (x + 0.044715f * x_cube);
  return 0.5f * x * (1.f + tanhf(inner));
}

__device__ __forceinline__ void copy16(void* dst, const void* src, int bytes, int tid) {
  for (int i = tid * 16; i < bytes; i += NTHREADS * 16)
    *reinterpret_cast<uint4*>((char*)dst + i) = *reinterpret_cast<const uint4*>((const char*)src + i);
}

__global__ void __launch_bounds__(NTHREADS, 1) convnext_block_kernel(const BlockArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const bool proj = a.proj_w != nullptr;
  const int cin = proj ? a.cin0_pad + a.aux_c : 0;
  const Smem L = smem_layout(cin);
  bf16* s_pw1 = reinterpret_cast<bf16*>(smem + L.pw1);
  bf16* s_pw2 = reinterpret_cast<bf16*>(smem + L.pw2);
  float* s_dw = reinterpret_cast<float*>(smem + L.dw);
  float* s_vec = reinterpret_cast<float*>(smem + L.vec);
  float* s_head = reinterpret_cast<float*>(smem + L.head);  // [n_head][F]
  bf16* s_tile = reinterpret_cast<bf16*>(smem + L.tile);
  bf16* s_hn = reinterpret_cast<bf16*>(smem + L.hn);
  float* s_scr = reinterpret_cast<float*>(smem + L.scr);
  bf16* s_hid = reinterpret_cast<bf16*>(smem + L.hid);
  bf16* s_proj = reinterpret_cast<bf16*>(smem + L.proj);
  bf16* s_raw = reinterpret_cast<bf16*>(smem + L.raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // ---- the block's weights, once per CTA
  copy16(s_pw1, a.pw1, F * HID * 2, tid);
  copy16(s_pw2, a.pw2, HID * F * 2, tid);
  copy16(s_dw, a.dw_w, TAPS * F * 4, tid);
  if (proj) copy16(s_proj, a.proj_w, cin * F * 2, tid);
  for (int i = tid; i < F; i += NTHREADS) {
    s_vec[V_DW_B + i] = a.dw_b[i];
    s_vec[V_LN_G + i] = a.ln_g[i];
    s_vec[V_LN_B + i] = a.ln_b[i];
    s_vec[V_PW2_B + i] = a.pw2_b[i];
    s_vec[V_LS + i] = a.ls[i];
    s_vec[V_PROJ_B + i] = proj ? a.proj_b[i] : 0.f;
  }
  for (int i = tid; i < HID; i += NTHREADS) s_vec[V_PW1_B + i] = a.pw1_b[i];
  for (int i = tid; i < a.n_head * F; i += NTHREADS) {
    const int j = i / F, c = i % F;
    s_head[i] = __bfloat162float(a.head_w[c * a.n_head + j]);
  }
  for (int i = tid; i < a.n_head; i += NTHREADS) s_vec[V_HEAD_B + i] = a.head_b[i];
  __syncthreads();

  const bool in0_vec = a.in0_c % 8 == 0;
  const bool aux_vec = (a.aux_c % 8 == 0) && (a.aux_stride % 8 == 0) && (a.aux_off % 8 == 0);
  const int tiles_x = (a.W + TW - 1) / TW, tiles_y = (a.H + TH - 1) / TH;
  const int ntiles = tiles_x * tiles_y * a.B;

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int b = t / (tiles_x * tiles_y);
    const int y0 = (t / tiles_x) % tiles_y * TH;
    const int x0 = t % tiles_x * TW;

    // ---- stage the halo tile [NPIX_PAD][C] in bf16: the input (or, for a
    // proj block, the proj input), zeros outside the image and in pad
    // channels
    {
      const int cdst = proj ? cin : F;
      const int c0pad = proj ? a.cin0_pad : F;
      bf16* dst = proj ? s_raw : s_tile;
      const int chunks = cdst >> 3;
      for (int it = tid; it < NPIX_PAD * chunks; it += NTHREADS) {
        const int ch = it % chunks, pix = it / chunks;
        const int gy = y0 - R + pix / WT, gx = x0 - R + pix % WT;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (pix < NPIX && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W) {
          const int c0 = ch * 8;
          const size_t pixel = ((size_t)b * a.H + gy) * a.W + gx;
          if (c0 < c0pad) {
            if (c0 < a.in0_c)
              v = a.upsample ? load_up8(a, b, gy, gx, c0, in0_vec)
                             : load_px8(a.in0, pixel, a.in0_c, 0, c0, a.in0_c, in0_vec);
          } else {
            v = load_px8(a.aux, pixel, a.aux_stride, a.aux_off, c0 - c0pad, a.aux_c, aux_vec);
          }
        }
        *reinterpret_cast<uint4*>(dst + (size_t)pix * cdst + ch * 8) = v;
      }
    }
    __syncthreads();

    // ---- proj over the whole halo tile: [NPIX_PAD, cin] @ [cin, F] + b,
    // zero outside the image (the depthwise conv's zero padding), bf16
    if (proj) {
      float* scr = s_scr + warp * 16 * F;
      for (int mf = warp; mf < NPIX_PAD / 16; mf += NWARPS) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[3];
#pragma unroll
        for (int n = 0; n < 3; ++n) wmma::fill_fragment(acc[n], 0.f);
        for (int kc = 0; kc < cin / 16; ++kc) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, s_raw + (size_t)mf * 16 * cin + kc * 16, cin);
#pragma unroll
          for (int n = 0; n < 3; ++n) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
            wmma::load_matrix_sync(fb, s_proj + kc * 16 * F + n * 16, F);
            wmma::mma_sync(acc[n], fa, fb, acc[n]);
          }
        }
#pragma unroll
        for (int n = 0; n < 3; ++n)
          wmma::store_matrix_sync(scr + n * 16, acc[n], F, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 16 * F; e += 32) {
          const int pix = mf * 16 + e / F, c = e % F;
          const int gy = y0 - R + pix / WT, gx = x0 - R + pix % WT;
          const bool in = pix < NPIX && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
          s_tile[(size_t)pix * F + c] = __float2bfloat16_rn(in ? scr[e] + s_vec[V_PROJ_B + c] : 0.f);
        }
        __syncwarp();
      }
      __syncthreads();
    }

    // ---- depthwise 7x7 (fp32) and LayerNorm: lane -> pixel lane/2 of the
    // warp's row, channels [c0, c0 + 24)
    const int p = lane >> 1, c0 = (lane & 1) * CPL;
    {
      float acc[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[c] = 0.f;
      for (int dy = 0; dy < KS; ++dy) {
        const bf16* row = s_tile + ((size_t)(warp + dy) * WT + p) * F + c0;
#pragma unroll
        for (int dx = 0; dx < KS; ++dx) {
          const float* w = s_dw + (dy * KS + dx) * F + c0;
#pragma unroll
          for (int q = 0; q < CPL / 8; ++q) {
            float v[8];
            unpack8(*reinterpret_cast<const uint4*>(row + dx * F + q * 8), v);
            const float4 w0 = *reinterpret_cast<const float4*>(w + q * 8);
            const float4 w1 = *reinterpret_cast<const float4*>(w + q * 8 + 4);
            acc[q * 8 + 0] = fmaf(v[0], w0.x, acc[q * 8 + 0]);
            acc[q * 8 + 1] = fmaf(v[1], w0.y, acc[q * 8 + 1]);
            acc[q * 8 + 2] = fmaf(v[2], w0.z, acc[q * 8 + 2]);
            acc[q * 8 + 3] = fmaf(v[3], w0.w, acc[q * 8 + 3]);
            acc[q * 8 + 4] = fmaf(v[4], w1.x, acc[q * 8 + 4]);
            acc[q * 8 + 5] = fmaf(v[5], w1.y, acc[q * 8 + 5]);
            acc[q * 8 + 6] = fmaf(v[6], w1.z, acc[q * 8 + 6]);
            acc[q * 8 + 7] = fmaf(v[7], w1.w, acc[q * 8 + 7]);
          }
        }
      }
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        acc[c] += s_vec[V_DW_B + c0 + c];
        s += acc[c];
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      const float u = s / F;
      float q2 = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        acc[c] -= u;
        q2 += acc[c] * acc[c];
      }
      q2 += __shfl_xor_sync(0xffffffffu, q2, 1);
      const float rstd = rsqrtf(q2 / F + 1e-6f);
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        acc[c] = __fadd_rn(__fmul_rn(__fmul_rn(acc[c], rstd), s_vec[V_LN_G + c0 + c]),
                           s_vec[V_LN_B + c0 + c]);
      bf16* hrow = s_hn + (size_t)(warp * TW + p) * F + c0;
#pragma unroll
      for (int q = 0; q < CPL / 8; ++q)
        *reinterpret_cast<uint4*>(hrow + q * 8) = pack8(acc + q * 8);
    }
    __syncwarp();

    // ---- pw1 -> GELU -> pw2 on the tensor cores, 16 hidden channels at a
    // time; the warp's h2 [16 px, F] lands in its fp32 staging
    float* scr = s_scr + warp * 16 * F;
    {
      bf16* hid = s_hid + warp * 256;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        wmma::load_matrix_sync(fa[k], s_hn + (size_t)warp * TW * F + k * 16, F);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc2[3];
#pragma unroll
      for (int o = 0; o < 3; ++o) wmma::fill_fragment(acc2[o], 0.f);
      for (int n = 0; n < HID / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc1;
        wmma::fill_fragment(acc1, 0.f);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, s_pw1 + k * 16 * HID + n * 16, HID);
          wmma::mma_sync(acc1, fa[k], fb, acc1);
        }
        wmma::store_matrix_sync(scr, acc1, 16, wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int e = lane; e < 256; e += 32)
          hid[e] = __float2bfloat16_rn(gelu_tanh(scr[e] + s_vec[V_PW1_B + n * 16 + (e & 15)]));
        __syncwarp();
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fh;
        wmma::load_matrix_sync(fh, hid, 16);
#pragma unroll
        for (int o = 0; o < 3; ++o) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, s_pw2 + n * 16 * F + o * 16, F);
          wmma::mma_sync(acc2[o], fh, fb, acc2[o]);
        }
        __syncwarp();
      }
#pragma unroll
      for (int o = 0; o < 3; ++o)
        wmma::store_matrix_sync(scr + o * 16, acc2[o], F, wmma::mem_row_major);
      __syncwarp();
    }

    // ---- epilogue per pixel: y = x + ls * (h2 + b2); the bf16 band goes to
    // the warp's own rows of s_hn, fp32 y and the head to the state
    {
      const int gy = y0 + warp, gx = x0 + p;
      const bool valid = gy < a.H && gx < a.W;
      const bf16* xc = s_tile + ((size_t)(warp + R) * WT + p + R) * F + c0;
      const float* h2 = scr + p * F + c0;
      float y[CPL], yb[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const float hv = h2[c] + s_vec[V_PW2_B + c0 + c];
        y[c] = __fadd_rn(__bfloat162float(xc[c]), __fmul_rn(s_vec[V_LS + c0 + c], hv));
        yb[c] = __bfloat162float(__float2bfloat16_rn(y[c]));
      }
      bf16* brow = s_hn + (size_t)(warp * TW + p) * F + c0;
#pragma unroll
      for (int q = 0; q < CPL / 8; ++q)
        *reinterpret_cast<uint4*>(brow + q * 8) = pack8(yb + q * 8);

      float part[MAX_HEAD];
#pragma unroll
      for (int j = 0; j < MAX_HEAD; ++j) {
        part[j] = 0.f;
        if (j < a.n_head) {
#pragma unroll
          for (int c = 0; c < CPL; ++c) part[j] = fmaf(yb[c], s_head[j * F + c0 + c], part[j]);
        }
        part[j] += __shfl_xor_sync(0xffffffffu, part[j], 1);
      }
      const size_t px = ((size_t)b * a.H + gy) * a.W + gx;
      if (valid && a.state != nullptr) {
        float* st = a.state + px * a.state_stride;
        if (a.feat_off >= 0) {
#pragma unroll
          for (int q = 0; q < CPL / 4; ++q)
            *reinterpret_cast<float4*>(st + a.feat_off + c0 + q * 4) =
                make_float4(y[q * 4], y[q * 4 + 1], y[q * 4 + 2], y[q * 4 + 3]);
        }
        if ((lane & 1) == 0) {
#pragma unroll
          for (int j = 0; j < MAX_HEAD; ++j)
            if (j < a.n_head) st[j] = part[j] + s_vec[V_HEAD_B + j];
          const int zend = a.feat_off >= 0 ? a.feat_off : a.state_stride;
          for (int ch = a.n_head; ch < zend; ++ch) st[ch] = 0.f;
        }
      }
      if (valid && a.head_out != nullptr && (lane & 1) == 0) {
#pragma unroll
        for (int j = 0; j < MAX_HEAD; ++j)
          if (j < a.n_head)
            a.head_out[px * a.n_head + j] = __float2bfloat16_rn(part[j] + s_vec[V_HEAD_B + j]);
      }
    }
    __syncthreads();

    // ---- band and pool from the bf16 tile in s_hn, 16-byte vectors
    if (a.out != nullptr) {
      for (int it = tid; it < TH * TW * (F / 8); it += NTHREADS) {
        const int pix = it / (F / 8), ch = it % (F / 8);
        const int gy = y0 + pix / TW, gx = x0 + pix % TW;
        if (gy >= a.H || gx >= a.W) continue;
        const size_t px = ((size_t)b * a.H + gy) * a.W + gx;
        *reinterpret_cast<uint4*>(a.out + px * F + ch * 8) =
            *reinterpret_cast<const uint4*>(s_hn + (size_t)pix * F + ch * 8);
      }
    }
    if (a.pooled != nullptr) {
      const int h2 = a.H >> 1, w2 = a.W >> 1;
      for (int it = tid; it < (TH / 2) * (TW / 2) * (F / 8); it += NTHREADS) {
        const int q = it / (F / 8), ch = it % (F / 8);
        const int py = q / (TW / 2), pxl = q % (TW / 2);
        const int gy2 = (y0 >> 1) + py, gx2 = (x0 >> 1) + pxl;
        if (gy2 >= h2 || gx2 >= w2) continue;
        const int p00 = (2 * py) * TW + 2 * pxl;
        float m[8], v[8];
        unpack8(*reinterpret_cast<const uint4*>(s_hn + (size_t)p00 * F + ch * 8), m);
        const int others[3] = {p00 + 1, p00 + TW, p00 + TW + 1};
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          unpack8(*reinterpret_cast<const uint4*>(s_hn + (size_t)others[k] * F + ch * 8), v);
#pragma unroll
          for (int e = 0; e < 8; ++e) m[e] = fmaxf(m[e], v[e]);
        }
        const size_t pp = ((size_t)b * h2 + gy2) * w2 + gx2;
        *reinterpret_cast<uint4*>(a.pooled + pp * F + ch * 8) = pack8(m);
      }
    }
    __syncthreads();  // the next tile overwrites the shared tiles
  }
}

}  // namespace

extern "C" {

const char* rvdd_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// One ConvNeXt block; see BlockArgs for the tensors.  The caller guarantees
// bf16 tensors that are contiguous and 16-byte aligned, in0_c == 48 and no
// aux without proj, cin0_pad and aux_c multiples of 16 with
// cin0_pad + aux_c <= 96, n_head <= 8, H == 2*in0_h and W == 2*in0_w when
// upsample, and a state with feat_off + 48 == state_stride (or feat_off < 0),
// state_stride and feat_off multiples of 4.  Returns a cudaError_t as int.
int rvdd_convnext_block(const void* in0, int in0_c, int in0_h, int in0_w, int upsample,
                        const void* aux, int aux_c, int aux_stride, int aux_off,
                        int cin0_pad, const void* proj_w, const void* proj_b,
                        const void* dw_w, const void* dw_b, const void* ln_g,
                        const void* ln_b, const void* pw1, const void* pw1_b,
                        const void* pw2, const void* pw2_b, const void* ls,
                        const void* head_w, const void* head_b, int n_head,
                        int B, int H, int W, void* out, void* pooled, void* head_out,
                        void* state, int state_stride, int feat_off, void* stream) {
  BlockArgs a;
  a.in0 = (const bf16*)in0; a.in0_c = in0_c; a.in0_h = in0_h; a.in0_w = in0_w;
  a.upsample = upsample;
  a.aux = (const bf16*)aux; a.aux_c = aux_c; a.aux_stride = aux_stride; a.aux_off = aux_off;
  a.cin0_pad = cin0_pad;
  a.proj_w = (const bf16*)proj_w; a.proj_b = (const float*)proj_b;
  a.dw_w = (const float*)dw_w; a.dw_b = (const float*)dw_b;
  a.ln_g = (const float*)ln_g; a.ln_b = (const float*)ln_b;
  a.pw1 = (const bf16*)pw1; a.pw1_b = (const float*)pw1_b;
  a.pw2 = (const bf16*)pw2; a.pw2_b = (const float*)pw2_b;
  a.ls = (const float*)ls;
  a.head_w = (const bf16*)head_w; a.head_b = (const float*)head_b;
  a.n_head = head_w != nullptr ? n_head : 0;
  a.B = B; a.H = H; a.W = W;
  a.out = (bf16*)out; a.pooled = (bf16*)pooled; a.head_out = (bf16*)head_out;
  a.state = (float*)state; a.state_stride = state_stride; a.feat_off = feat_off;

  const int cin = proj_w != nullptr ? cin0_pad + aux_c : 0;
  if (cin > MAX_CIN || a.n_head > MAX_HEAD || cin % 16 || (proj_w == nullptr && (in0_c != F || aux_c)))
    return (int)cudaErrorInvalidValue;
  const int smem = smem_layout(cin).total;
  cudaError_t e = cudaFuncSetAttribute(convnext_block_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, convnext_block_kernel, NTHREADS, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  const long long ntiles = (long long)((W + TW - 1) / TW) * ((H + TH - 1) / TH) * B;
  const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(ntiles < slots ? ntiles : slots);
  convnext_block_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(a);
  e = cudaGetLastError();
  return (int)e;
}

}  // extern "C"
