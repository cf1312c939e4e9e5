// One ConvNeXt block of a fused block chain, for sm_90a:
//   proj?(1x1) -> dw 7x7 -> channel LayerNorm -> 1x1 48->192 -> GELU
//   -> 1x1 192->48, y = x + layerscale * h, in NHWC with 48 channels.
//
// Replaces rvdd_tpu/ops/pallas/convnext_pallas.py:fused_convnext_chain
// (body _cnx_kernel), which the port's ops/cuda/convnext_chain.py drives as
// one launch of this kernel per block.  The chain options map onto a launch:
//   * aux concat: block 1 reads its proj input [block-0 output | aux] through
//     two pointers (a channel window of the aux tensor); no copy is made;
//   * upsample_input: the prologue builds the 2x bilinear align_corners=True
//     upsample of the half-res input in fp32 while it stages the tile, and
//     rounds it once to bf16 in the bf16 mode;
//   * the chain input's channels (9 for the flagship's chain A) are padded
//     to 16 inside the staged tile, not in memory;
//   * pool emit: the epilogue writes the 2x2 max pool of the band (tiles
//     start at even coordinates, so each window lies in one tile);
//   * combined state emit: the epilogue writes the fp32 y before the band
//     cast into channels [feat_off, feat_off+48) of the recurrence state,
//     the 1x1 head (on the band) into channels [0, n_head) and zeros
//     between them.
// Two numerics, a template parameter of the kernel (F32), picked per launch:
//   * bf16 (rvdd_tpu's 'fast' preset in its production depthwise mode,
//     dw_impl='mxu2'): the depthwise taps are bf16 values (the TPU kernel's
//     repacked [n_cg*7g, 7g] tap matrix is cast to bf16; its 'vpu' engine
//     would keep fp32 taps); proj, pw1, pw2 and the head have bf16 weights
//     and fp32 accumulation; biases, LayerNorm and layerscale are fp32; the
//     LN output and the GELU output are rounded to bf16 before their
//     products; every band is stored as bf16; the GELU is the tanh one with
//     the exact tanhf;
//   * fp32 (band_dtype=float32, mxu_precision='highest', gelu_exact=True:
//     the chains of rvdd_tpu's 'mixed' and 'accurate' presets and its fp32
//     eighth-res core): fp32 input, aux, bands, pool, head and emits, fp32
//     taps and weights, LayerNorm in fp32, nothing rounded, the erf GELU
//     with the exact erff (rvdd_tpu's kernel uses the Abramowitz-Stegun
//     polynomial, 1.5e-7 abs; its module path and the port's plain version
//     the exact erf).  pw1 and pw2 are fp32-faithful: each operand is split
//     by mantissa masks into hi, mid and lo bf16 planes that sum back to it
//     exactly (the weights on the host, the LN and GELU outputs in
//     registers), and each k-step issues six bf16 wgmma into one fp32
//     accumulator, hi.hi, hi.mid, mid.hi, hi.lo, mid.mid and lo.hi (what
//     HIGHEST does on the TPU; the dropped terms are below 2^-24 of a
//     product).  A 2-way split (conv_chain's 'high', three products) keeps
//     only about 16 bits.  The proj runs the same six products; the head
//     (at most 8 outputs) runs in fp32 on the CUDA cores.
//
// The bf16 mode.  What bounds it on the H100: operations.  Per 1080p frame
// the seven chains need about 0.81 TFLOP of 1x1 products and 0.10 TFLOP
// of depthwise taps, all bf16 products with fp32 sums (0.91 ms at the
// 989 TFLOP/s bf16 tensor-core peak; rvdd_tpu's production engine runs the
// depthwise on its matrix unit too), and about 1.5 GB of chain inputs and
// outputs (0.45 ms at 3.35 TB/s).  This kernel runs the depthwise, the
// LayerNorm and the GELU on the CUDA cores in fp32, which sets a floor of
// its own: 50 G
// depthwise FMAs (1.6 ms at 132 SMs x 128 lanes x 1.8 GHz) and 3.7 G exact
// tanhf GELUs (about 20 instructions each, some 2-3 ms), so 3-5 ms a frame.
// The design:
//   * a persistent CTA of three warpgroups (384 threads, one per SM) keeps
//     the block's weights in shared memory: pw1 [48][192], pw2 [192][48]
//     and the proj in the wgmma B layout ([K/8][N][8] bf16, packed on the
//     host), the depthwise taps and the vectors in fp32;
//   * it walks 12x32-pixel output tiles and stages each one's 18x38 input
//     halo (1.8x the outputs) as [channel group][pixel][8]; for a block
//     without proj or upsample the next tile's halo is copied with
//     cp.async while the warpgroups run the current tile's 1x1 products;
//   * an upsample block copies the half-res pixels its halo reads (at most
//     12x22) with cp.async and interpolates the halo from shared memory;
//   * a proj block copies its raw input in two halves of the halo (into the
//     LN and residual regions, free at that point) and projects each with
//     wgmma m64n48k16, writing the bf16 tile;
//   * the depthwise: a warp owns one channel group of 8 and 6 output rows,
//     lane = column, and slides down the 12 input rows of each tap column,
//     so each staged pixel is read 2 times an output instead of 7; the
//     LayerNorm reduces over the six channel groups through shared memory;
//     its bf16 output is written as the wgmma A operand, and the input's
//     center pixels are kept for the residual;
//   * a warpgroup owns 64 output pixels (two rows of the tile) at a time:
//     pw1 is wgmma m64n96k16 in two halves of 96 hidden channels (A: the LN
//     output in shared memory), bias, GELU and the bf16 rounding happen in
//     registers, and the result is the A operand of pw2's wgmma m64n48k16
//     straight from registers (the FlashAttention-3 P.V pattern): the
//     hidden never touches shared memory;
//   * the epilogue computes y = x + ls * (h2 + b2) in registers, writes the
//     fp32 state and the head from there, and stages the bf16 band for
//     16-byte stores and the pool.
// What holds it back (chip_smoke.py and clock64 phase timings on the H100):
// a plain full-resolution block spends about a third of its time in the
// depthwise and LayerNorm and most of the rest in the GELU's exact tanhf
// (removing the GELU cut a block by a third); the products themselves are
// a small share.  A proj block's raw input copy (cp.async of 16 bytes at a
// time, about 7 bytes a cycle per SM) adds about 40% to a block, an
// upsample block's source copy about 20%.  168 registers a thread (384
// threads, one CTA an SM) leave no room to keep two accumulators in flight:
// issuing the next pw1 before waiting for pw2 spilled and ptxas serialized
// the wgmma.
//
// The fp32 mode.  What bounds it: operations, about 4.9 ms a frame: its
// 0.81 TFLOP of 1x1 work at six bf16 products a MAC on the tensor cores,
// against 0.10 TFLOP of fp32 depthwise taps on the CUDA cores (1.5 ms at
// 67 TFLOP/s) and about 3 GB of fp32 chain traffic (0.9 ms).  Its design
// answers to shared memory and registers:
//   * shared memory: the bf16 mode's 12x32 tile stages an 18x38 halo of 48
//     bf16 channels (65.7 KB); in fp32 that halo is 131 KB, pw1 + pw2 in
//     three planes are 110.6 KB (36.9 KB in bf16), the LN output as three
//     A planes another 110 KB: far past the 227 KB a block may have.  So
//     the fp32 tile is 4x32 (two 64-pixel segments): a 10x38 fp32 halo
//     (73 KB), the LN output kept once in fp32 (24.6 KB, split into planes
//     only in registers), the three-plane pw1 and pw2 resident (110.6 KB),
//     227,328 B in all.  The proj's three planes (27.6 KB at 96 channels)
//     do not fit beside them: a proj block copies them from L2 at each
//     tile into the LN and sum regions, free until the depthwise, and
//     projects its halo from there (a first form that ran the proj in fp32
//     on the CUDA cores, one halo pixel a thread with the weights read
//     through L1, took 80,876 cycles a tile against 5,200 for a plain
//     block's staging: 8.2 ms a full-res block, probe, H100).  The halo is
//     3x the tile's outputs (1.8x in bf16), and without room for a second
//     halo the next tile is not prefetched;
//   * registers: the bf16 mode keeps a 96-wide half of the hidden in
//     registers, rounded and packed as pw2's A fragments, at 168 registers
//     a thread with 384 threads; three planes would triple that fragment.
//     The fp32 mode takes the hidden a quarter (48) at a time: per quarter
//     it loads the LN output's fragments from shared memory and splits them
//     (36 registers), runs pw1 (18 wgmma m64n48k16), applies bias and GELU
//     and splits the result into pw2's A fragments (36 registers), and runs
//     that quarter's pw2 (18 wgmma) into the segment's accumulator;
//   * two warpgroups run the products, one segment each, and the third is
//     idle through them; the depthwise and LayerNorm use all 384 threads,
//     12 groups of 4 channels x 32 columns, each thread all 4 rows, and the
//     fp32 halo is laid out [group of 4][pixel][4] so that a warp's reads
//     of one tap row are 512 contiguous bytes (with 8-channel groups, 32
//     bytes a lane, the same reads took two shared-memory wavefronts each
//     and the phase 15,400 cycles a tile, probe, H100);
//   * BlockArgsT<float>: every band pointer is fp32 and the upsample
//     prologue does not round.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int F = 48;                 // block width
constexpr int HID = 4 * F;            // hidden width
constexpr int CG = F / 8;             // channel groups of 8
constexpr int KS = 7, R = 3, TAPS = KS * KS;
constexpr int TH = 12, TW = 32;       // output tile
constexpr int HT = TH + 2 * R, WT = TW + 2 * R;
constexpr int NPIX = HT * WT;         // 684 halo-tile pixels
constexpr int NWG = 3;
constexpr int NTHREADS = 128 * NWG;
constexpr int NSEG = TH * TW / 64;    // 64-pixel segments: tile rows 2s, 2s+1
constexpr int SEG_PER_WG = NSEG / NWG;
constexpr int PRUN = 6;               // output rows per depthwise warp
constexpr int MAX_CIN = 96;
constexpr int MAX_HEAD = 8;
// fp32 vectors in shared memory
constexpr int V_DW_B = 0, V_LN_G = 48, V_LN_B = 96, V_PW1_B = 144, V_PW2_B = 336,
              V_LS = 384, V_PROJ_B = 432, V_HEAD_B = 480, V_TOTAL = 488;
constexpr int SEG_BYTES = CG * 64 * 16;  // one segment of the A operand
constexpr int RAW_PX = 2 * NWG * 64;  // proj input pixels staged at once: half the halo
constexpr int SRC_R = 12, SRC_C = 22;    // half-res rows and columns an upsampled halo reads
static_assert(NSEG % NWG == 0 && TH % PRUN == 0 && CG * (TH / PRUN) * 32 == NTHREADS,
              "tile, warps and segments must match");

// T is the band type: bf16 in the bf16 mode, float in the fp32 mode
template <typename T>
struct BlockArgsT {
  const T* in0;                // [B, in0_h, in0_w, in0_c]
  int in0_c, in0_h, in0_w, upsample;
  const T* aux;                // [B, H, W, aux_stride], channels at aux_off
  int aux_c, aux_stride, aux_off;
  int cin0_pad;                // proj input: in0 channels padded to 16, then aux
  const bf16* proj_w;          // [cin/8][F][8] (packed; fp32 mode: hi, mid, lo planes) or null
  const float* proj_b;
  const float* dw_w;           // [TAPS, F]
  const float* dw_b;
  const float* ln_g;
  const float* ln_b;
  const bf16* pw1;             // [F/8][HID][8] (packed); fp32 mode: hi, mid, lo planes
  const float* pw1_b;
  const bf16* pw2;             // [HID/8][F][8] (packed); fp32 mode: hi, mid, lo planes
  const float* pw2_b;
  const float* ls;
  const T* head_w;             // [F, n_head] or null
  const float* head_b;
  int n_head;
  int B, H, W;                 // output resolution
  T* out;                      // [B, H, W, F] or null
  T* pooled;                   // [B, H/2, W/2, F] or null
  T* head_out;                 // [B, H, W, n_head] or null
  float* state;                // [B, H, W, state_stride] or null
  int state_stride, feat_off;  // feat_off < 0: the state holds no features
};
using BlockArgs = BlockArgsT<bf16>;

struct Smem {
  int pw1, pw2, proj, dw, vec, head, tile, ln, res, sum1, sum2, total;
};

__host__ __device__ inline int align128(int x) { return (x + 127) & ~127; }

// byte offsets of the shared-memory regions.  ln holds the LN output (the
// pw1 A operand, [segment][cg][64][8]), and then each segment's bf16 band
// ([64][F]).  Before the depthwise, a proj block stages half its input at a
// time in ln and res (adjacent, [cin/8][RAW_PX][8]) and an upsample block
// its half-res source in ln.
__host__ __device__ inline Smem smem_layout() {
  Smem s;
  int o = 0;
  s.pw1 = o;  o = align128(o + F * HID * 2);
  s.pw2 = o;  o = align128(o + HID * F * 2);
  s.proj = o; o = align128(o + MAX_CIN * F * 2);
  s.dw = o;   o = align128(o + TAPS * F * 4);
  s.vec = o;  o = align128(o + V_TOTAL * 4);
  s.head = o; o = align128(o + MAX_HEAD * F * 4);
  s.tile = o; o = align128(o + CG * NPIX * 16);
  s.ln = o;   o = align128(o + NSEG * SEG_BYTES);
  s.res = o;  o = align128(o + NSEG * SEG_BYTES);
  s.sum1 = o; o = align128(o + CG * TH * TW * 4);
  s.sum2 = o; o = align128(o + CG * TH * TW * 4);
  s.total = o;
  return s;
}
static_assert(MAX_CIN / 8 * RAW_PX * 16 <= 2 * NSEG * SEG_BYTES && 2 * RAW_PX >= NPIX,
              "half the proj input fits the ln and res regions");
static_assert(SRC_R * SRC_C * F * 2 <= NSEG * SEG_BYTES, "the upsample source fits the ln region");

union Pack8 {
  uint4 u;
  unsigned short s[8];
};

__device__ __forceinline__ void unpack8(uint4 u, float* v) {
  v[0] = __uint_as_float(u.x << 16); v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16); v[3] = __uint_as_float(u.y & 0xffff0000u);
  v[4] = __uint_as_float(u.z << 16); v[5] = __uint_as_float(u.z & 0xffff0000u);
  v[6] = __uint_as_float(u.w << 16); v[7] = __uint_as_float(u.w & 0xffff0000u);
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  return make_uint4(wg::pack_bf16x2(v[0], v[1]), wg::pack_bf16x2(v[2], v[3]),
                    wg::pack_bf16x2(v[4], v[5]), wg::pack_bf16x2(v[6], v[7]));
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
  // torch's F.gelu(approximate='tanh'), 0.5 x (1 + tanh(b (x + k x^3))),
  // in five operations around the exact tanhf
  const float kBeta = 0.7978845608028654f;  // b = sqrt(2 / pi)
  const float hx = 0.5f * x;
  const float inner = x * fmaf(kBeta * 0.044715f, x * x, kBeta);
  return fmaf(hx, tanhf(inner), hx);
}

// 8 proj-input channels [c0, c0+8) of image pixel (gy, gx), zeros outside
// the image: in0 (padded to cin0_pad), then the aux window
__device__ __forceinline__ uint4 load_in8(const BlockArgs& a, int b, int gy, int gx, int c0,
                                          bool in0_vec, bool aux_vec) {
  if (gy < 0 || gy >= a.H || gx < 0 || gx >= a.W) return make_uint4(0u, 0u, 0u, 0u);
  const size_t pixel = ((size_t)b * a.H + gy) * a.W + gx;
  if (c0 < a.cin0_pad) {
    if (c0 >= a.in0_c) return make_uint4(0u, 0u, 0u, 0u);
    return a.upsample ? load_up8(a, b, gy, gx, c0, in0_vec)
                      : load_px8(a.in0, pixel, a.in0_c, 0, c0, a.in0_c, in0_vec);
  }
  return load_px8(a.aux, pixel, a.aux_stride, a.aux_off, c0 - a.cin0_pad, a.aux_c, aux_vec);
}

// the halo tile [CG][NPIX][8] of a block without proj or upsample: cp.async
// inside the image, zeros outside (the depthwise conv's zero padding)
// (items by octets of pixels: each quarter-warp writes one 128-byte row of
// a channel-group plane, without bank conflicts)
__device__ void stage_plain(const BlockArgs& a, int b, int y0, int x0, unsigned char* tile) {
  for (int it = threadIdx.x; it < (NPIX + 7) / 8 * 8 * CG; it += NTHREADS) {
    const int oct = it / (8 * CG), rem = it - oct * 8 * CG;
    const int cg = rem >> 3, pix = oct * 8 + (rem & 7);
    if (pix >= NPIX) continue;
    const int gy = y0 - R + pix / WT, gx = x0 - R + pix % WT;
    uint4* dst = reinterpret_cast<uint4*>(tile + ((size_t)cg * NPIX + pix) * 16);
    if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W)
      wg::cp_async16(dst, a.in0 + (((size_t)b * a.H + gy) * a.W + gx) * F + cg * 8);
    else
      *dst = make_uint4(0u, 0u, 0u, 0u);
  }
}

// the halo tile of an upsample block: the half-res pixels it reads are
// copied with cp.async into src ([row][column][F], at most SRC_R x SRC_C),
// then every halo pixel is interpolated from there
__device__ void stage_up(const BlockArgs& a, int b, int y0, int x0, unsigned char* tile,
                         unsigned char* src) {
  int jlo, jhi, ilo, ihi, unused;
  float t;
  ac_taps(max(y0 - R, 0), a.in0_h, jlo, unused, t);
  ac_taps(min(y0 + TH + R - 1, a.H - 1), a.in0_h, unused, jhi, t);
  ac_taps(max(x0 - R, 0), a.in0_w, ilo, unused, t);
  ac_taps(min(x0 + TW + R - 1, a.W - 1), a.in0_w, unused, ihi, t);
  const int sc = ihi - ilo + 1, n = (jhi - jlo + 1) * sc * CG;
  for (int it = threadIdx.x; it < n; it += NTHREADS) {
    const int px = it / CG, cg = it - px * CG, r = px / sc;
    wg::cp_async16(src + it * 16, a.in0 + (((size_t)b * a.in0_h + jlo + r) * a.in0_w + ilo +
                                           (px - r * sc)) * F + cg * 8);
  }
  wg::cp_async_commit();
  wg::cp_async_wait<0>();
  __syncthreads();
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  for (int pix = threadIdx.x; pix < NPIX; pix += NTHREADS) {
    const int gy = y0 - R + pix / WT, gx = x0 - R + pix % WT;
    uint4* dst = reinterpret_cast<uint4*>(tile) + pix;
    if (gy < 0 || gy >= a.H || gx < 0 || gx >= a.W) {
#pragma unroll
      for (int cg = 0; cg < CG; ++cg) dst[cg * NPIX] = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    int j0, j1, i0, i1;
    float ty, tx;
    ac_taps(gy, a.in0_h, j0, j1, ty);
    ac_taps(gx, a.in0_w, i0, i1, tx);
    const uint4* p00 = s4 + ((j0 - jlo) * sc + i0 - ilo) * CG;
    const uint4* p01 = s4 + ((j0 - jlo) * sc + i1 - ilo) * CG;
    const uint4* p10 = s4 + ((j1 - jlo) * sc + i0 - ilo) * CG;
    const uint4* p11 = s4 + ((j1 - jlo) * sc + i1 - ilo) * CG;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg) {
      float v00[8], v01[8], v10[8], v11[8], v[8];
      unpack8(p00[cg], v00);
      unpack8(p01[cg], v01);
      unpack8(p10[cg], v10);
      unpack8(p11[cg], v11);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k] = lerp_rn(lerp_rn(v00[k], v10[k], ty), lerp_rn(v01[k], v11[k], ty), tx);
      dst[cg * NPIX] = pack8(v);
    }
  }
}

// halo pixels [p0, p0 + RAW_PX) of a proj block's input, [cin/8][RAW_PX][8]
// (by octets of pixels, as stage_plain): cp.async for 16-byte aligned
// channel groups, loads and arithmetic otherwise, zeros outside the image
// and past the halo
__device__ void stage_raw(const BlockArgs& a, int b, int y0, int x0, int cin, int p0,
                          unsigned char* raw, bool in0_vec, bool aux_vec) {
  const int cgn = cin / 8;
  for (int it = threadIdx.x; it < RAW_PX * cgn; it += NTHREADS) {
    const int oct = it / (8 * cgn), rem = it - oct * 8 * cgn;
    const int cg = rem >> 3, i = oct * 8 + (rem & 7), pix = p0 + i;
    uint4* dst = reinterpret_cast<uint4*>(raw + (cg * RAW_PX + i) * 16);
    const int gy = y0 - R + pix / WT, gx = x0 - R + pix % WT;
    const int c0 = cg * 8;
    if (pix >= NPIX || gy < 0 || gy >= a.H || gx < 0 || gx >= a.W ||
        (c0 < a.cin0_pad && c0 >= a.in0_c)) {
      *dst = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const size_t pixel = ((size_t)b * a.H + gy) * a.W + gx;
    if (c0 < a.cin0_pad && in0_vec && !a.upsample)
      wg::cp_async16(dst, a.in0 + pixel * a.in0_c + c0);
    else if (c0 >= a.cin0_pad && aux_vec)
      wg::cp_async16(dst, a.aux + pixel * a.aux_stride + a.aux_off + c0 - a.cin0_pad);
    else
      *dst = load_in8(a, b, gy, gx, c0, in0_vec, aux_vec);
  }
}

// the bf16 mode's block (rvdd_tpu's 'fast' numerics)
__device__ __forceinline__ void block_bf16(const BlockArgs& a, unsigned char* smem) {
  const bool proj = a.proj_w != nullptr;
  const int cin = proj ? a.cin0_pad + a.aux_c : 0;
  const Smem L = smem_layout();
  const float* s_dw = reinterpret_cast<const float*>(smem + L.dw);
  float* s_vec = reinterpret_cast<float*>(smem + L.vec);
  float* s_head = reinterpret_cast<float*>(smem + L.head);  // [n_head][F]
  bf16* s_tile = reinterpret_cast<bf16*>(smem + L.tile);     // [CG][NPIX][8]
  float* s_sum1 = reinterpret_cast<float*>(smem + L.sum1);   // [CG][TH*TW]
  float* s_sum2 = reinterpret_cast<float*>(smem + L.sum2);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = tid >> 7, warp_in = warp & 3;

  // ---- the block's weights, once per CTA
  for (int i = tid * 16; i < F * HID * 2; i += NTHREADS * 16) {
    wg::cp_async16(smem + L.pw1 + i, reinterpret_cast<const unsigned char*>(a.pw1) + i);
    wg::cp_async16(smem + L.pw2 + i, reinterpret_cast<const unsigned char*>(a.pw2) + i);
  }
  for (int i = tid * 16; i < TAPS * F * 4; i += NTHREADS * 16)
    wg::cp_async16(smem + L.dw + i, reinterpret_cast<const unsigned char*>(a.dw_w) + i);
  for (int i = tid * 16; i < cin * F * 2; i += NTHREADS * 16)
    wg::cp_async16(smem + L.proj + i, reinterpret_cast<const unsigned char*>(a.proj_w) + i);
  wg::cp_async_commit();
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
  wg::cp_async_wait<0>();
  wg::fence_async_smem();
  __syncthreads();

  const bool in0_vec = a.in0_c % 8 == 0;
  const bool aux_vec = (a.aux_c % 8 == 0) && (a.aux_stride % 8 == 0) && (a.aux_off % 8 == 0);
  const bool prefetch = !proj && !a.upsample;
  const int tiles_x = (a.W + TW - 1) / TW, tiles_y = (a.H + TH - 1) / TH;
  const int ntiles = tiles_x * tiles_y * a.B;
  const uint32_t ln_base = wg::smem_addr(smem + L.ln);
  const uint32_t pw1_base = wg::smem_addr(smem + L.pw1);
  const uint32_t pw2_base = wg::smem_addr(smem + L.pw2);

  PHASE_CLOCK(long long ph[3] = {0, 0, 0}; long long c0 = 0, c1 = 0; int nt = 0;)
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    PHASE_CLOCK(c0 = clock64();)
    const int b = t / (tiles_x * tiles_y);
    const int y0 = (t / tiles_x) % tiles_y * TH;
    const int x0 = t % tiles_x * TW;

    // ---- 1. the halo tile in bf16: staged (or prefetched), interpolated,
    // or projected
    if (a.upsample && !proj) {
      stage_up(a, b, y0, x0, smem + L.tile, smem + L.ln);
      __syncthreads();
    } else if (!proj) {
      if (!prefetch || t == (int)blockIdx.x) stage_plain(a, b, y0, x0, smem + L.tile);
      wg::cp_async_commit();
      wg::cp_async_wait<0>();
      __syncthreads();
    } else {
      // the input in two copies of half the halo each (into the ln and res
      // regions); warpgroup g projects chunks g and g + NWG of each half
      // (wgmma m64n48k16, back to back) and writes them to the tile
      unsigned char* raw = smem + L.ln;
      const uint32_t raw_base = wg::smem_addr(raw), proj_base = wg::smem_addr(smem + L.proj);
      for (int part = 0; part < 2; ++part) {
        stage_raw(a, b, y0, x0, cin, part * RAW_PX, raw, in0_vec, aux_vec);
        wg::cp_async_commit();
        wg::cp_async_wait<0>();
        wg::fence_async_smem();
        __syncthreads();
        float acc[2][F / 2];
        wg::fence();
#pragma unroll
        for (int c = 0; c < 2; ++c)
          for (int kc = 0; kc < cin / 16; ++kc)
            wg::wgmma_ss_n48(acc[c],
                             wg::desc(raw_base + (2 * kc * RAW_PX + (g + c * NWG) * 64) * 16,
                                      RAW_PX * 16, 128),
                             wg::desc(proj_base + kc * 1536, 768, 128), kc > 0);
        wg::commit();
        wg::wait<0>();
#pragma unroll
        for (int c = 0; c < 2; ++c) wg::fence_regs(acc[c]);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int pix = part * RAW_PX + (g + c * NWG) * 64 + 16 * warp_in + (lane >> 2) + 8 * h;
            if (pix >= NPIX) continue;
            const int gy = y0 - R + pix / WT, gx = x0 - R + pix % WT;
            const bool in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
#pragma unroll
            for (int j = 0; j < CG; ++j) {
              const int ch = 8 * j + 2 * (lane & 3);
              const float v0 = in ? acc[c][4 * j + 2 * h] + s_vec[V_PROJ_B + ch] : 0.f;
              const float v1 = in ? acc[c][4 * j + 2 * h + 1] + s_vec[V_PROJ_B + ch + 1] : 0.f;
              *reinterpret_cast<uint32_t*>(s_tile + ((size_t)j * NPIX + pix) * 8 +
                                           2 * (lane & 3)) = wg::pack_bf16x2(v0, v1);
            }
          }
        }
        __syncthreads();  // the raw region is free (and, after the second half, the tile is whole)
      }
    }

    PHASE_CLOCK(c1 = clock64(); ph[0] += c1 - c0;)  // phase 0: the halo tile
    // ---- 2. depthwise 7x7 (fp32) and LayerNorm: warp -> channel group cg
    // and output rows [run*6, run*6 + 6), lane -> column
    {
      const int cg = warp % CG, run = warp / CG, x = lane;
      float acc[PRUN][8];
#pragma unroll
      for (int o = 0; o < PRUN; ++o)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[o][e] = 0.f;
      const bf16* col = s_tile + ((size_t)cg * NPIX + run * PRUN * WT + x) * 8;
#pragma unroll
      for (int dx = 0; dx < KS; ++dx) {
        float w[KS][8];
#pragma unroll
        for (int dy = 0; dy < KS; ++dy) {
          const float4 w0 = *reinterpret_cast<const float4*>(s_dw + (dy * KS + dx) * F + cg * 8);
          const float4 w1 = *reinterpret_cast<const float4*>(s_dw + (dy * KS + dx) * F + cg * 8 + 4);
          w[dy][0] = w0.x; w[dy][1] = w0.y; w[dy][2] = w0.z; w[dy][3] = w0.w;
          w[dy][4] = w1.x; w[dy][5] = w1.y; w[dy][6] = w1.z; w[dy][7] = w1.w;
        }
#pragma unroll
        for (int ir = 0; ir < PRUN + KS - 1; ++ir) {
          const uint4 raw = *reinterpret_cast<const uint4*>(col + (ir * WT + dx) * 8);
          if (dx == R && ir >= R && ir < R + PRUN) {  // the center pixel: the residual x
            const int row = run * PRUN + ir - R;
            *reinterpret_cast<uint4*>(smem + L.res + (row >> 1) * SEG_BYTES + cg * 1024 +
                                      ((row & 1) * 32 + x) * 16) = raw;
          }
          float v[8];
          unpack8(raw, v);
#pragma unroll
          for (int o = 0; o < PRUN; ++o) {
            const int dy = ir - o;
            if (dy >= 0 && dy < KS) {
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[o][e] = fmaf(v[e], w[dy][e], acc[o][e]);
            }
          }
        }
      }
      // LN over the 48 channels of each pixel: partial sums per channel group
#pragma unroll
      for (int o = 0; o < PRUN; ++o) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          acc[o][e] += s_vec[V_DW_B + cg * 8 + e];
          s += acc[o][e];
        }
        s_sum1[cg * TH * TW + (run * PRUN + o) * TW + x] = s;
      }
      __syncthreads();
#pragma unroll
      for (int o = 0; o < PRUN; ++o) {
        const int px = (run * PRUN + o) * TW + x;
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < CG; ++k) s += s_sum1[k * TH * TW + px];
        const float u = s / F;
        float q = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          acc[o][e] -= u;
          q += acc[o][e] * acc[o][e];
        }
        s_sum2[cg * TH * TW + px] = q;
      }
      __syncthreads();
#pragma unroll
      for (int o = 0; o < PRUN; ++o) {
        const int row = run * PRUN + o, px = row * TW + x;
        float q = 0.f;
#pragma unroll
        for (int k = 0; k < CG; ++k) q += s_sum2[k * TH * TW + px];
        const float rstd = rsqrtf(q / F + 1e-6f);
        float hn[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          hn[e] = __fadd_rn(__fmul_rn(__fmul_rn(acc[o][e], rstd), s_vec[V_LN_G + cg * 8 + e]),
                            s_vec[V_LN_B + cg * 8 + e]);
        *reinterpret_cast<uint4*>(smem + L.ln + (row >> 1) * SEG_BYTES + cg * 1024 +
                                  ((row & 1) * 32 + x) * 16) = pack8(hn);
      }
    }
    wg::fence_async_smem();
    __syncthreads();

    PHASE_CLOCK(c0 = clock64(); ph[1] += c0 - c1;)  // phase 1: depthwise and LN
    // the tile buffer is free: copy the next tile's halo while the 1x1
    // products run
    const int tn = t + gridDim.x;
    if (prefetch && tn < ntiles)
      stage_plain(a, tn / (tiles_x * tiles_y), (tn / tiles_x) % tiles_y * TH, tn % tiles_x * TW,
                  smem + L.tile);

    // ---- 3. pw1 -> GELU -> pw2 per 64-pixel segment and half of the
    // hidden, then the epilogue.  (Overlapping them, with a second pw1
    // accumulator or A fragment in flight, needs more than the 168 registers
    // a thread has here: ptxas then spills and serializes the wgmma.)
    float acc1[HID / 4], acc2[F / 2];
    uint32_t afr[6][4];
    auto issue_pw1 = [&](int s, int half) {  // acc1 = LN[s] @ pw1[:, half]
      wg::fence();
#pragma unroll
      for (int kc = 0; kc < F / 16; ++kc)
        wg::wgmma_ss_n96(acc1, wg::desc(ln_base + s * SEG_BYTES + kc * 2048, 1024, 128),
                         wg::desc(pw1_base + kc * 6144 + half * 1536, 3072, 128), kc > 0);
      wg::commit();
    };
    auto gelu_pw2 = [&](int half) {  // acc2 (+)= GELU(acc1 + b1) @ pw2[half]
      // bias, GELU, bf16: column pairs of the accumulator become the A
      // fragments of pw2's k16 steps
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int c = half * 96 + 8 * j + 2 * (lane & 3);
        const float b0 = s_vec[V_PW1_B + c], b1 = s_vec[V_PW1_B + c + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          afr[j >> 1][(j & 1) * 2 + h] = wg::pack_bf16x2(gelu_tanh(acc1[4 * j + 2 * h] + b0),
                                                         gelu_tanh(acc1[4 * j + 2 * h + 1] + b1));
      }
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 6; ++kk)
        wg::wgmma_rs_n48(acc2, afr[kk], wg::desc(pw2_base + (half * 6 + kk) * 1536, 768, 128),
                         half + kk > 0);
      wg::commit();
    };
    auto wait_all = [&]() {
      wg::wait<0>();
      wg::fence_regs(acc1);
      wg::fence_regs(acc2);
#pragma unroll
      for (int kk = 0; kk < 6; ++kk) wg::fence_regs(afr[kk]);
    };
#pragma unroll 1
    for (int si = 0; si < SEG_PER_WG; ++si) {
      const int s = g * SEG_PER_WG + si;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        issue_pw1(s, half);
        wait_all();
        gelu_pw2(half);
        wait_all();
      }

      // epilogue: y = x + ls * (h2 + b2) in registers; the bf16 band goes
      // to the segment's region as [64][F], fp32 y and the head to the state
      bf16* band = reinterpret_cast<bf16*>(smem + L.ln + s * SEG_BYTES);
      const bf16* res = reinterpret_cast<const bf16*>(smem + L.res + s * SEG_BYTES);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 16 * warp_in + (lane >> 2) + 8 * h;
        const int gy = y0 + 2 * s + (m >> 5), gx = x0 + (m & 31);
        const bool valid = gy < a.H && gx < a.W;
        const size_t px = ((size_t)b * a.H + gy) * a.W + gx;
        float part[MAX_HEAD];
#pragma unroll
        for (int k = 0; k < MAX_HEAD; ++k) part[k] = 0.f;
#pragma unroll
        for (int j = 0; j < CG; ++j) {
          const int c = 8 * j + 2 * (lane & 3);
          const __nv_bfloat162 xv =
              *reinterpret_cast<const __nv_bfloat162*>(res + (j * 64 + m) * 8 + 2 * (lane & 3));
          const float y0v = __fadd_rn(__low2float(xv), __fmul_rn(s_vec[V_LS + c],
                                      acc2[4 * j + 2 * h] + s_vec[V_PW2_B + c]));
          const float y1v = __fadd_rn(__high2float(xv), __fmul_rn(s_vec[V_LS + c + 1],
                                      acc2[4 * j + 2 * h + 1] + s_vec[V_PW2_B + c + 1]));
          const uint32_t yb = wg::pack_bf16x2(y0v, y1v);
          *reinterpret_cast<uint32_t*>(band + m * F + c) = yb;
          const float yb0 = __uint_as_float(yb << 16), yb1 = __uint_as_float(yb & 0xffff0000u);
#pragma unroll
          for (int k = 0; k < MAX_HEAD; ++k)
            if (k < a.n_head)
              part[k] = fmaf(yb1, s_head[k * F + c + 1], fmaf(yb0, s_head[k * F + c], part[k]));
          if (valid && a.state != nullptr && a.feat_off >= 0)
            *reinterpret_cast<float2*>(a.state + px * a.state_stride + a.feat_off + c) =
                make_float2(y0v, y1v);
        }
#pragma unroll
        for (int k = 0; k < MAX_HEAD; ++k) {
          if (k < a.n_head) {  // uniform
            part[k] += __shfl_xor_sync(0xffffffffu, part[k], 1);
            part[k] += __shfl_xor_sync(0xffffffffu, part[k], 2);
          }
        }
        if (valid && (lane & 3) == 0) {
          if (a.state != nullptr) {
            float* st = a.state + px * a.state_stride;
#pragma unroll
            for (int k = 0; k < MAX_HEAD; ++k)
              if (k < a.n_head) st[k] = part[k] + s_vec[V_HEAD_B + k];
            const int zend = a.feat_off >= 0 ? a.feat_off : a.state_stride;
            for (int ch = a.n_head; ch < zend; ++ch) st[ch] = 0.f;
          } else if (a.head_out != nullptr) {
#pragma unroll
            for (int k = 0; k < MAX_HEAD; ++k)
              if (k < a.n_head)
                a.head_out[px * a.n_head + k] = __float2bfloat16_rn(part[k] + s_vec[V_HEAD_B + k]);
          }
        }
      }
      wg::bar_warpgroup(g);

      // band and pool of the segment, 16-byte vectors
      const int t128 = tid & 127;
      if (a.out != nullptr) {
        for (int it = t128; it < 64 * CG; it += 128) {
          const int m = it / CG, q = it % CG;
          const int gy = y0 + 2 * s + (m >> 5), gx = x0 + (m & 31);
          if (gy >= a.H || gx >= a.W) continue;
          *reinterpret_cast<uint4*>(a.out + (((size_t)b * a.H + gy) * a.W + gx) * F + q * 8) =
              *reinterpret_cast<const uint4*>(band + m * F + q * 8);
        }
      }
      if (a.pooled != nullptr) {
        const int h2 = a.H >> 1, w2 = a.W >> 1;
        for (int it = t128; it < 16 * CG; it += 128) {
          const int pxl = it / CG, q = it % CG;
          const int gy2 = (y0 >> 1) + s, gx2 = (x0 >> 1) + pxl;
          if (gy2 >= h2 || gx2 >= w2) continue;
          float mx[8], v[8];
          unpack8(*reinterpret_cast<const uint4*>(band + (2 * pxl) * F + q * 8), mx);
          const int others[3] = {2 * pxl + 1, 32 + 2 * pxl, 33 + 2 * pxl};
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            unpack8(*reinterpret_cast<const uint4*>(band + others[k] * F + q * 8), v);
#pragma unroll
            for (int e = 0; e < 8; ++e) mx[e] = fmaxf(mx[e], v[e]);
          }
          *reinterpret_cast<uint4*>(a.pooled + (((size_t)b * h2 + gy2) * w2 + gx2) * F + q * 8) =
              pack8(mx);
        }
      }
    }
    __syncthreads();  // the next tile overwrites the shared tiles
    PHASE_CLOCK(ph[2] += clock64() - c0; ++nt;)  // phase 2: 1x1 products, GELU, epilogue
  }
  PHASE_CLOCK(wg::phase_clocks_add(ph, nt);)
  wg::cp_async_wait<0>();
}

// ------------------------------------------------------------- fp32 mode
// rvdd_tpu's band_dtype=float32, mxu_precision='highest', gelu_exact=True.
// The geometry differs from the bf16 mode's: a 4x32 tile (two 64-pixel
// segments, one per product warpgroup), an fp32 halo and fp32 LN output,
// and the pw1 and pw2 weights resident as three bf16 planes each.

namespace f32m {

constexpr int TH = 4;                 // output tile rows (TW = 32 columns as in the bf16 mode)
constexpr int HT = TH + 2 * R;
constexpr int NPIX = HT * WT;         // 380 halo-tile pixels
constexpr int NSEG = TH * TW / 64;    // 2 segments: tile rows 2s, 2s+1
constexpr int CG4 = F / 4;            // channel groups of 4 (16 bytes of fp32)
constexpr int PLANE = F * HID * 2;    // bytes of one bf16 plane of pw1 or pw2
constexpr int SEG_FLOATS = 64 * F;    // one segment of LN output or band, [64][F] fp32
static_assert(CG4 * 32 == NTHREADS && NSEG <= NWG, "tile, threads and segments must match");
static_assert(3 * MAX_CIN * F * 2 <= NSEG * SEG_FLOATS * 4 + CG4 * TH * TW * 4,
              "the proj's three planes fit the LN and sum regions (adjacent)");

struct Smem {
  int pw1, pw2, dw, vec, head, tile, ln, sum, total;
};

// pw1 and pw2 (three planes each), the fp32 taps and vectors, the fp32
// halo tile [CG4][NPIX][4], the LN output (then the band) [NSEG][64][F] and
// the LN partial sums: 227,328 bytes of the 232,448 a block may have
__host__ __device__ inline Smem smem_layout() {
  Smem s;
  int o = 0;
  s.pw1 = o;  o = align128(o + 3 * PLANE);
  s.pw2 = o;  o = align128(o + 3 * PLANE);
  s.dw = o;   o = align128(o + TAPS * F * 4);
  s.vec = o;  o = align128(o + V_TOTAL * 4);
  s.head = o; o = align128(o + MAX_HEAD * F * 4);
  s.tile = o; o = align128(o + CG4 * NPIX * 16);
  s.ln = o;   o = align128(o + NSEG * SEG_FLOATS * 4);
  s.sum = o;  o = align128(o + CG4 * TH * TW * 4);
  s.total = o;
  return s;
}

// the six products of a k-step: (A plane, B plane) with planes hi 0, mid 1,
// lo 2; the three dropped ones (mid lo, lo mid, lo lo) are below 2^-24 of
// the product, as for the TPU's HIGHEST
__host__ __device__ constexpr int plane_a(int p) { return p == 2 || p == 4 ? 1 : p == 5 ? 2 : 0; }
__host__ __device__ constexpr int plane_b(int p) { return p == 1 || p == 4 ? 1 : p == 3 ? 2 : 0; }

// a pair of fp32 values as the bf16x2 A-fragment registers of their hi,
// mid and lo planes: hi keeps the top 16 bits (mantissa mask), mid the top
// 16 bits of v - hi, lo = v - hi - mid (at most 8 significant bits, so the
// bf16 conversion is exact): v = hi + mid + lo exactly
__device__ __forceinline__ void split3x2(float x, float y, uint32_t& hi, uint32_t& mid,
                                         uint32_t& lo) {
  const uint32_t bx = __float_as_uint(x), by = __float_as_uint(y);
  const float rx = __fsub_rn(x, __uint_as_float(bx & 0xffff0000u));
  const float ry = __fsub_rn(y, __uint_as_float(by & 0xffff0000u));
  const uint32_t rbx = __float_as_uint(rx), rby = __float_as_uint(ry);
  hi = (bx >> 16) | (by & 0xffff0000u);
  mid = (rbx >> 16) | (rby & 0xffff0000u);
  lo = wg::pack_bf16x2(__fsub_rn(rx, __uint_as_float(rbx & 0xffff0000u)),
                       __fsub_rn(ry, __uint_as_float(rby & 0xffff0000u)));
}

__device__ __forceinline__ float gelu_erf(float x) {
  // torch's F.gelu(approximate='none'), x * 0.5 * (1 + erf(x / sqrt(2))),
  // with the exact erff (rvdd_tpu's kernel uses a polynomial, 1.5e-7 abs)
  return x * 0.5f * (1.f + erff(x * 0.7071067811865476f));
}

// 8 channels [c0, c0+8) of pixel `pixel` of the fp32 in0 (48 channels:
// a block that upsamples without proj)
__device__ __forceinline__ void load_f8(const float* in0, size_t pixel, int c0, float* v) {
  const float4* p = reinterpret_cast<const float4*>(in0 + pixel * F + c0);
  const float4 u0 = __ldg(p), u1 = __ldg(p + 1);
  v[0] = u0.x; v[1] = u0.y; v[2] = u0.z; v[3] = u0.w;
  v[4] = u1.x; v[5] = u1.y; v[6] = u1.z; v[7] = u1.w;
}

// 8 channels of the 2x bilinear (align_corners=True) upsample of the
// half-res in0 at full-res (gy, gx), rows first, in fp32 (not rounded)
__device__ __forceinline__ void load_up8(const BlockArgsT<float>& a, int b, int gy, int gx,
                                         int c0, float* v) {
  int j0, j1, i0, i1;
  float ty, tx;
  ac_taps(gy, a.in0_h, j0, j1, ty);
  ac_taps(gx, a.in0_w, i0, i1, tx);
  const size_t r0 = (size_t)b * a.in0_h + j0, r1 = (size_t)b * a.in0_h + j1;
  float v00[8], v01[8], v10[8], v11[8];
  load_f8(a.in0, r0 * a.in0_w + i0, c0, v00);
  load_f8(a.in0, r0 * a.in0_w + i1, c0, v01);
  load_f8(a.in0, r1 * a.in0_w + i0, c0, v10);
  load_f8(a.in0, r1 * a.in0_w + i1, c0, v11);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    v[k] = lerp_rn(lerp_rn(v00[k], v10[k], ty), lerp_rn(v01[k], v11[k], ty), tx);
}

// proj-input channels (c, c+1), c even, of image pixel (gy, gx) inside the
// image: in0 (zero in its pad channels, upsampled if asked), then the aux
// window (cin0_pad and aux_c are multiples of 16, so a pair lies in one)
__device__ __forceinline__ float2 load_in2(const BlockArgsT<float>& a, int b, int gy, int gx,
                                           int c) {
  if (c >= a.cin0_pad) {
    const float* p = a.aux + (((size_t)b * a.H + gy) * a.W + gx) * a.aux_stride + a.aux_off +
                     c - a.cin0_pad;
    return make_float2(__ldg(p), __ldg(p + 1));
  }
  if (c >= a.in0_c) return make_float2(0.f, 0.f);
  const bool two = c + 1 < a.in0_c;
  if (!a.upsample) {
    const float* p = a.in0 + (((size_t)b * a.H + gy) * a.W + gx) * a.in0_c + c;
    return make_float2(__ldg(p), two ? __ldg(p + 1) : 0.f);
  }
  int j0, j1, i0, i1;
  float ty, tx;
  ac_taps(gy, a.in0_h, j0, j1, ty);
  ac_taps(gx, a.in0_w, i0, i1, tx);
  const size_t r0 = (size_t)b * a.in0_h + j0, r1 = (size_t)b * a.in0_h + j1;
  float v[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (k == 1 && !two) {
      v[k] = 0.f;
      continue;
    }
    const float v00 = __ldg(a.in0 + (r0 * a.in0_w + i0) * a.in0_c + c + k);
    const float v01 = __ldg(a.in0 + (r0 * a.in0_w + i1) * a.in0_c + c + k);
    const float v10 = __ldg(a.in0 + (r1 * a.in0_w + i0) * a.in0_c + c + k);
    const float v11 = __ldg(a.in0 + (r1 * a.in0_w + i1) * a.in0_c + c + k);
    v[k] = lerp_rn(lerp_rn(v00, v10, ty), lerp_rn(v01, v11, ty), tx);
  }
  return make_float2(v[0], v[1]);
}

// float offset of channel c of halo pixel pix in the tile [CG4][NPIX][4]
__device__ __forceinline__ int tile_at(int pix, int c) {
  return ((c >> 2) * NPIX + pix) * 4 + (c & 3);
}

// the fp32 halo tile [CG4][NPIX][4]; zeros outside the image (the
// depthwise conv's zero padding).  A plain block copies it with cp.async
// (by pixel, so neighbouring threads read neighbouring 16 bytes); an
// upsample block interpolates it from the half-res input.  A proj block
// projects its input with the six-product wgmma: the proj's three weight
// planes ([cin/8][F][8] each, 27,648 bytes at 96 channels) are copied into
// wbuf, the LN and sum regions, which are free until the depthwise; each
// warpgroup takes 64-pixel chunks of the halo, loads all of a chunk's
// input channels from global memory as A fragments (the loads overlap),
// splits them in registers and runs the k16 steps; bias, zeros outside the
// image, then the tile.
__device__ void stage_tile(const BlockArgsT<float>& a, int b, int y0, int x0, float* tile,
                           unsigned char* wbuf, int cin) {
  const int tid = threadIdx.x;
  if (a.proj_w != nullptr) {
    constexpr int KMAX = MAX_CIN / 16;
    const int pbytes = cin * F * 2, ksteps = cin / 16;  // bytes of one plane; k16 steps
    for (int i = tid * 16; i < 3 * pbytes; i += NTHREADS * 16)
      wg::cp_async16(wbuf + i, reinterpret_cast<const unsigned char*>(a.proj_w) + i);
    wg::cp_async_commit();
    const uint32_t wb = wg::smem_addr(wbuf);
    const int g = tid >> 7, lane = tid & 31, q = lane & 3;
    const int r0 = 16 * ((tid >> 5) & 3) + (lane >> 2);
    static_assert((NPIX + 63) / 64 % NWG == 0, "every warpgroup takes as many chunks");
#pragma unroll 1
    for (int ch = g; ch * 64 < NPIX; ch += NWG) {
      int gy[2], gx[2];
      bool in[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pix = ch * 64 + r0 + 8 * h;
        gy[h] = y0 - R + pix / WT;
        gx[h] = x0 - R + pix % WT;
        in[h] = pix < NPIX && gy[h] >= 0 && gy[h] < a.H && gx[h] >= 0 && gx[h] < a.W;
      }
      // every input value of the chunk first, so that their loads overlap
      // (and, in the first chunk, the weights' copy)
      float2 v[KMAX][4];
#pragma unroll
      for (int kc = 0; kc < KMAX; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int h = r & 1;
          v[kc][r] = kc < ksteps && in[h]
                         ? load_in2(a, b, gy[h], gx[h], 16 * kc + 8 * (r >> 1) + 2 * q)
                         : make_float2(0.f, 0.f);
        }
      if (ch == g) {  // every thread's first chunk: the weights are in
        wg::cp_async_wait<0>();
        wg::fence_async_smem();
        __syncthreads();
      }
      float acc[F / 2];
#pragma unroll
      for (int kc = 0; kc < KMAX; ++kc) {
        if (kc >= ksteps) break;
        uint32_t fa[3][4];  // [plane][register]
#pragma unroll
        for (int r = 0; r < 4; ++r) split3x2(v[kc][r].x, v[kc][r].y, fa[0][r], fa[1][r], fa[2][r]);
        wg::fence();
#pragma unroll
        for (int p = 0; p < 6; ++p)
          wg::wgmma_rs_n48(acc, fa[plane_a(p)],
                           wg::desc(wb + plane_b(p) * pbytes + kc * 1536, 768, 128), kc + p > 0);
        wg::commit();
        wg::wait<0>();
        wg::fence_regs(acc);
#pragma unroll
        for (int i = 0; i < 3; ++i) wg::fence_regs(fa[i]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pix = ch * 64 + r0 + 8 * h;
        if (pix >= NPIX) continue;
#pragma unroll
        for (int j = 0; j < CG; ++j) {
          const int c = 8 * j + 2 * q;
          *reinterpret_cast<float2*>(tile + tile_at(pix, c)) =
              in[h] ? make_float2(acc[4 * j + 2 * h] + __ldg(a.proj_b + c),
                                  acc[4 * j + 2 * h + 1] + __ldg(a.proj_b + c + 1))
                    : make_float2(0.f, 0.f);
        }
      }
    }
    return;
  }
  if (a.upsample) {
    for (int it = tid; it < NPIX * CG; it += NTHREADS) {
      const int pix = it / CG, cg = it - pix * CG;
      const int gy = y0 - R + pix / WT, gx = x0 - R + pix % WT;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W) load_up8(a, b, gy, gx, cg * 8, v);
      *reinterpret_cast<float4*>(tile + tile_at(pix, cg * 8)) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(tile + tile_at(pix, cg * 8 + 4)) =
          make_float4(v[4], v[5], v[6], v[7]);
    }
    return;
  }
  for (int it = tid; it < NPIX * CG4; it += NTHREADS) {
    const int pix = it / CG4, c4 = it - pix * CG4;
    const int gy = y0 - R + pix / WT, gx = x0 - R + pix % WT;
    float* dst = tile + tile_at(pix, c4 * 4);
    if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W)
      wg::cp_async16(dst, a.in0 + (((size_t)b * a.H + gy) * a.W + gx) * F + c4 * 4);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// the fp32 mode's block: the bf16 mode's phases with fp32 bands, taps and
// LN, fp32-faithful pw1 and pw2 (operands split into three bf16 planes,
// six wgmma a k-step into fp32 accumulators) and the erf GELU
__device__ __forceinline__ void block_f32(const BlockArgsT<float>& a, unsigned char* smem) {
  const bool proj = a.proj_w != nullptr;
  const int cin = proj ? a.cin0_pad + a.aux_c : 0;
  const Smem L = smem_layout();
  const float* s_dw = reinterpret_cast<const float*>(smem + L.dw);
  float* s_vec = reinterpret_cast<float*>(smem + L.vec);
  float* s_head = reinterpret_cast<float*>(smem + L.head);  // [n_head][F]
  float* s_tile = reinterpret_cast<float*>(smem + L.tile);  // [CG4][NPIX][4]
  float* s_ln = reinterpret_cast<float*>(smem + L.ln);      // [NSEG][64][F]
  float* s_sum = reinterpret_cast<float*>(smem + L.sum);    // [CG4][TH*TW]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = tid >> 7, warp_in = warp & 3, q = lane & 3;

  // ---- the block's weights, once per CTA
  for (int i = tid * 16; i < 3 * PLANE; i += NTHREADS * 16) {
    wg::cp_async16(smem + L.pw1 + i, reinterpret_cast<const unsigned char*>(a.pw1) + i);
    wg::cp_async16(smem + L.pw2 + i, reinterpret_cast<const unsigned char*>(a.pw2) + i);
  }
  for (int i = tid * 16; i < TAPS * F * 4; i += NTHREADS * 16)
    wg::cp_async16(smem + L.dw + i, reinterpret_cast<const unsigned char*>(a.dw_w) + i);
  wg::cp_async_commit();
  for (int i = tid; i < F; i += NTHREADS) {
    s_vec[V_DW_B + i] = a.dw_b[i];
    s_vec[V_LN_G + i] = a.ln_g[i];
    s_vec[V_LN_B + i] = a.ln_b[i];
    s_vec[V_PW2_B + i] = a.pw2_b[i];
    s_vec[V_LS + i] = a.ls[i];
  }
  for (int i = tid; i < HID; i += NTHREADS) s_vec[V_PW1_B + i] = a.pw1_b[i];
  for (int i = tid; i < a.n_head * F; i += NTHREADS) {
    const int j = i / F, c = i % F;
    s_head[i] = a.head_w[c * a.n_head + j];
  }
  for (int i = tid; i < a.n_head; i += NTHREADS) s_vec[V_HEAD_B + i] = a.head_b[i];
  wg::cp_async_wait<0>();
  wg::fence_async_smem();
  __syncthreads();

  const int tiles_x = (a.W + TW - 1) / TW, tiles_y = (a.H + TH - 1) / TH;
  const int ntiles = tiles_x * tiles_y * a.B;
  const uint32_t pw1_base = wg::smem_addr(smem + L.pw1);
  const uint32_t pw2_base = wg::smem_addr(smem + L.pw2);

  PHASE_CLOCK(long long ph[3] = {0, 0, 0}; long long c0 = 0, c1 = 0; int nt = 0;)
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    PHASE_CLOCK(c0 = clock64();)
    const int b = t / (tiles_x * tiles_y);
    const int y0 = (t / tiles_x) % tiles_y * TH;
    const int x0 = t % tiles_x * TW;

    // ---- 1. the fp32 halo tile: copied, interpolated or projected
    stage_tile(a, b, y0, x0, s_tile, smem + L.ln, cin);
    wg::cp_async_commit();
    wg::cp_async_wait<0>();
    __syncthreads();

    PHASE_CLOCK(c1 = clock64(); ph[0] += c1 - c0;)  // phase 0: the halo tile
    // ---- 2. depthwise 7x7 and LayerNorm in fp32: warp -> channel group
    // c4 of 4 (one 16-byte read a staged pixel, neighbouring lanes on
    // neighbouring 16 bytes), lane -> column, all TH rows
    {
      const int c4 = warp, x = lane;
      float acc[TH][4];
#pragma unroll
      for (int o = 0; o < TH; ++o)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[o][e] = 0.f;
      const float* col = s_tile + ((size_t)c4 * NPIX + x) * 4;
#pragma unroll
      for (int dx = 0; dx < KS; ++dx) {
        float w[KS][4];
#pragma unroll
        for (int dy = 0; dy < KS; ++dy) {
          const float4 w0 = *reinterpret_cast<const float4*>(s_dw + (dy * KS + dx) * F + c4 * 4);
          w[dy][0] = w0.x; w[dy][1] = w0.y; w[dy][2] = w0.z; w[dy][3] = w0.w;
        }
#pragma unroll
        for (int ir = 0; ir < HT; ++ir) {
          const float4 u = *reinterpret_cast<const float4*>(col + (ir * WT + dx) * 4);
          const float v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int o = 0; o < TH; ++o) {
            const int dy = ir - o;
            if (dy >= 0 && dy < KS) {
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[o][e] = fmaf(v[e], w[dy][e], acc[o][e]);
            }
          }
        }
      }
      // LN over the 48 channels of each pixel: partial sums per group of 4
      // through s_sum [CG4][TH*TW], first of the values, then of the
      // squared deviations
#pragma unroll
      for (int o = 0; o < TH; ++o) {
        float sm = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[o][e] += s_vec[V_DW_B + c4 * 4 + e];
          sm += acc[o][e];
        }
        s_sum[c4 * TH * TW + o * TW + x] = sm;
      }
      __syncthreads();
      float qs[TH];
#pragma unroll
      for (int o = 0; o < TH; ++o) {
        float sm = 0.f;
#pragma unroll
        for (int k = 0; k < CG4; ++k) sm += s_sum[k * TH * TW + o * TW + x];
        const float u = sm / F;
        qs[o] = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[o][e] -= u;
          qs[o] += acc[o][e] * acc[o][e];
        }
      }
      __syncthreads();  // every thread has read the sums
#pragma unroll
      for (int o = 0; o < TH; ++o) s_sum[c4 * TH * TW + o * TW + x] = qs[o];
      __syncthreads();
#pragma unroll
      for (int o = 0; o < TH; ++o) {
        float sq = 0.f;
#pragma unroll
        for (int k = 0; k < CG4; ++k) sq += s_sum[k * TH * TW + o * TW + x];
        const float rstd = rsqrtf(sq / F + 1e-6f);
        float hn[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hn[e] = __fadd_rn(__fmul_rn(__fmul_rn(acc[o][e], rstd), s_vec[V_LN_G + c4 * 4 + e]),
                            s_vec[V_LN_B + c4 * 4 + e]);
        *reinterpret_cast<float4*>(s_ln + ((o >> 1) * 64 + (o & 1) * 32 + x) * F + c4 * 4) =
            make_float4(hn[0], hn[1], hn[2], hn[3]);
      }
    }
    wg::fence_async_smem();
    __syncthreads();

    PHASE_CLOCK(c0 = clock64(); ph[1] += c0 - c1;)  // phase 1: depthwise and LN
    // ---- 3. warpgroup g < NSEG: its segment's pw1 -> GELU -> pw2 a
    // quarter (48) of the hidden at a time, operands split into hi, mid
    // and lo in registers, six wgmma m64n48k16 a k-step; then the epilogue
    if (g < NSEG) {
      const int s = g;
      float* lns = s_ln + s * SEG_FLOATS;
      const int r0 = 16 * warp_in + (lane >> 2);
      float acc2[F / 2];
#pragma unroll 1
      for (int qt = 0; qt < HID / F; ++qt) {
        // the LN output's A fragments (rows r0, r0 + 8; k16 steps kc)
        uint32_t la[3][3][4];  // [plane][k step][register]
#pragma unroll
        for (int kc = 0; kc < F / 16; ++kc)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float2 v = *reinterpret_cast<const float2*>(
                lns + (r0 + 8 * (r & 1)) * F + 16 * kc + 8 * (r >> 1) + 2 * q);
            split3x2(v.x, v.y, la[0][kc][r], la[1][kc][r], la[2][kc][r]);
          }
        float acc1[F / 2];
        wg::fence();
#pragma unroll
        for (int kc = 0; kc < F / 16; ++kc)
#pragma unroll
          for (int p = 0; p < 6; ++p)
            wg::wgmma_rs_n48(acc1, la[plane_a(p)][kc],
                             wg::desc(pw1_base + plane_b(p) * PLANE + kc * 6144 + qt * 768, 3072, 128),
                             kc + p > 0);
        wg::commit();
        wg::wait<0>();
        wg::fence_regs(acc1);
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int kc = 0; kc < 3; ++kc) wg::fence_regs(la[i][kc]);
        // bias and erf GELU in fp32, split: column pairs of the accumulator
        // are the A fragments of pw2's k16 steps over this quarter
        uint32_t ha[3][3][4];
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const int c = qt * F + 8 * j + 2 * q;
          const float b0 = s_vec[V_PW1_B + c], b1 = s_vec[V_PW1_B + c + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = (j & 1) * 2 + h;
            split3x2(gelu_erf(acc1[4 * j + 2 * h] + b0), gelu_erf(acc1[4 * j + 2 * h + 1] + b1),
                     ha[0][j >> 1][r], ha[1][j >> 1][r], ha[2][j >> 1][r]);
          }
        }
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < 3; ++kk)
#pragma unroll
          for (int p = 0; p < 6; ++p)
            wg::wgmma_rs_n48(acc2, ha[plane_a(p)][kk],
                             wg::desc(pw2_base + plane_b(p) * PLANE + (qt * 3 + kk) * 1536, 768, 128),
                             qt + kk + p > 0);
        wg::commit();
        wg::wait<0>();
        wg::fence_regs(acc2);
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int kk = 0; kk < 3; ++kk) wg::fence_regs(ha[i][kk]);
      }

      // epilogue: y = x + ls * (h2 + b2) in registers (x from the halo
      // tile's center); the fp32 band goes to the segment's LN region
      // (free now) as [64][F], y and the head on y to the state
      float* band = lns;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = r0 + 8 * h;
        const int row = 2 * s + (m >> 5), cx = m & 31;
        const int gy = y0 + row, gx = x0 + cx;
        const bool valid = gy < a.H && gx < a.W;
        const size_t px = ((size_t)b * a.H + gy) * a.W + gx;
        float part[MAX_HEAD];
#pragma unroll
        for (int k = 0; k < MAX_HEAD; ++k) part[k] = 0.f;
#pragma unroll
        for (int j = 0; j < CG; ++j) {
          const int c = 8 * j + 2 * q;
          const float2 xv = *reinterpret_cast<const float2*>(
              s_tile + tile_at((row + R) * WT + cx + R, c));
          const float y0v = __fadd_rn(xv.x, __fmul_rn(s_vec[V_LS + c],
                                      acc2[4 * j + 2 * h] + s_vec[V_PW2_B + c]));
          const float y1v = __fadd_rn(xv.y, __fmul_rn(s_vec[V_LS + c + 1],
                                      acc2[4 * j + 2 * h + 1] + s_vec[V_PW2_B + c + 1]));
          *reinterpret_cast<float2*>(band + m * F + c) = make_float2(y0v, y1v);
#pragma unroll
          for (int k = 0; k < MAX_HEAD; ++k)
            if (k < a.n_head)
              part[k] = fmaf(y1v, s_head[k * F + c + 1], fmaf(y0v, s_head[k * F + c], part[k]));
          if (valid && a.state != nullptr && a.feat_off >= 0)
            *reinterpret_cast<float2*>(a.state + px * a.state_stride + a.feat_off + c) =
                make_float2(y0v, y1v);
        }
#pragma unroll
        for (int k = 0; k < MAX_HEAD; ++k) {
          if (k < a.n_head) {  // uniform
            part[k] += __shfl_xor_sync(0xffffffffu, part[k], 1);
            part[k] += __shfl_xor_sync(0xffffffffu, part[k], 2);
          }
        }
        if (valid && q == 0) {
          if (a.state != nullptr) {
            float* st = a.state + px * a.state_stride;
#pragma unroll
            for (int k = 0; k < MAX_HEAD; ++k)
              if (k < a.n_head) st[k] = part[k] + s_vec[V_HEAD_B + k];
            const int zend = a.feat_off >= 0 ? a.feat_off : a.state_stride;
            for (int ch = a.n_head; ch < zend; ++ch) st[ch] = 0.f;
          } else if (a.head_out != nullptr) {
#pragma unroll
            for (int k = 0; k < MAX_HEAD; ++k)
              if (k < a.n_head) a.head_out[px * a.n_head + k] = part[k] + s_vec[V_HEAD_B + k];
          }
        }
      }
      wg::bar_warpgroup(g);

      // band and pool of the segment, 16-byte vectors (4 channels each)
      const int t128 = tid & 127;
      constexpr int C4 = F / 4;
      if (a.out != nullptr) {
        for (int it = t128; it < 64 * C4; it += 128) {
          const int m = it / C4, c4 = it % C4;
          const int gy = y0 + 2 * s + (m >> 5), gx = x0 + (m & 31);
          if (gy >= a.H || gx >= a.W) continue;
          *reinterpret_cast<float4*>(a.out + (((size_t)b * a.H + gy) * a.W + gx) * F + c4 * 4) =
              *reinterpret_cast<const float4*>(band + m * F + c4 * 4);
        }
      }
      if (a.pooled != nullptr) {
        const int h2 = a.H >> 1, w2 = a.W >> 1;
        for (int it = t128; it < 16 * C4; it += 128) {
          const int pxl = it / C4, c4 = it % C4;
          const int gy2 = (y0 >> 1) + s, gx2 = (x0 >> 1) + pxl;
          if (gy2 >= h2 || gx2 >= w2) continue;
          const float4 v0 = *reinterpret_cast<const float4*>(band + (2 * pxl) * F + c4 * 4);
          const float4 v1 = *reinterpret_cast<const float4*>(band + (2 * pxl + 1) * F + c4 * 4);
          const float4 v2 = *reinterpret_cast<const float4*>(band + (32 + 2 * pxl) * F + c4 * 4);
          const float4 v3 = *reinterpret_cast<const float4*>(band + (33 + 2 * pxl) * F + c4 * 4);
          *reinterpret_cast<float4*>(a.pooled + (((size_t)b * h2 + gy2) * w2 + gx2) * F + c4 * 4) =
              make_float4(fmaxf(fmaxf(v0.x, v1.x), fmaxf(v2.x, v3.x)),
                          fmaxf(fmaxf(v0.y, v1.y), fmaxf(v2.y, v3.y)),
                          fmaxf(fmaxf(v0.z, v1.z), fmaxf(v2.z, v3.z)),
                          fmaxf(fmaxf(v0.w, v1.w), fmaxf(v2.w, v3.w)));
        }
      }
    }
    __syncthreads();  // the next tile overwrites the shared tiles
    PHASE_CLOCK(ph[2] += clock64() - c0; ++nt;)  // phase 2: 1x1 products, GELU, epilogue
  }
  PHASE_CLOCK(wg::phase_clocks_add(ph, nt);)
}

}  // namespace f32m

template <bool F32>
using band_t = typename std::conditional<F32, float, bf16>::type;

// One ConvNeXt block; F32 (a template parameter: the two modes have their
// own geometry and shared-memory layout) picks the numerics.
template <bool F32>
__global__ void __launch_bounds__(NTHREADS, 1)
    convnext_block_kernel(const __grid_constant__ BlockArgsT<band_t<F32>> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  if constexpr (F32)
    f32m::block_f32(a, smem);
  else
    block_bf16(a, smem);
}

template <bool F32>
cudaError_t launch_block(const BlockArgsT<band_t<F32>>& a, int smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(convnext_block_kernel<F32>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  const int th = F32 ? f32m::TH : TH;
  const long long ntiles = (long long)((a.W + TW - 1) / TW) * ((a.H + th - 1) / th) * a.B;
  const int grid = (int)(ntiles < sms ? ntiles : sms);
  convnext_block_kernel<F32><<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// the arguments of one block in band type T from the C entry's pointers
template <typename T>
BlockArgsT<T> make_args(const void* in0, int in0_c, int in0_h, int in0_w, int upsample,
                        const void* aux, int aux_c, int aux_stride, int aux_off,
                        int cin0_pad, const void* proj_w, const void* proj_b,
                        const void* dw_w, const void* dw_b, const void* ln_g,
                        const void* ln_b, const void* pw1, const void* pw1_b,
                        const void* pw2, const void* pw2_b, const void* ls,
                        const void* head_w, const void* head_b, int n_head,
                        int B, int H, int W, void* out, void* pooled, void* head_out,
                        void* state, int state_stride, int feat_off) {
  BlockArgsT<T> a;
  a.in0 = (const T*)in0; a.in0_c = in0_c; a.in0_h = in0_h; a.in0_w = in0_w;
  a.upsample = upsample;
  a.aux = (const T*)aux; a.aux_c = aux_c; a.aux_stride = aux_stride; a.aux_off = aux_off;
  a.cin0_pad = cin0_pad;
  a.proj_w = (const bf16*)proj_w; a.proj_b = (const float*)proj_b;
  a.dw_w = (const float*)dw_w; a.dw_b = (const float*)dw_b;
  a.ln_g = (const float*)ln_g; a.ln_b = (const float*)ln_b;
  a.pw1 = (const bf16*)pw1; a.pw1_b = (const float*)pw1_b;
  a.pw2 = (const bf16*)pw2; a.pw2_b = (const float*)pw2_b;
  a.ls = (const float*)ls;
  a.head_w = (const T*)head_w; a.head_b = (const float*)head_b;
  a.n_head = head_w != nullptr ? n_head : 0;
  a.B = B; a.H = H; a.W = W;
  a.out = (T*)out; a.pooled = (T*)pooled; a.head_out = (T*)head_out;
  a.state = (float*)state; a.state_stride = state_stride; a.feat_off = feat_off;
  return a;
}

}  // namespace

extern "C" {

const char* rvdd_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// One ConvNeXt block; see BlockArgsT for the tensors.  The caller
// guarantees tensors that are contiguous and 16-byte aligned, in0_c == 48
// and no aux without proj, cin0_pad and aux_c multiples of 16 with
// cin0_pad + aux_c <= 96, n_head <= 8, H == 2*in0_h and W == 2*in0_w when
// upsample, even H and W when pooled, a state with feat_off + 48 ==
// state_stride (or feat_off < 0), state_stride and feat_off multiples of
// 4.  f32 = 0: bf16 in0, aux, out, pooled, head_out and head_w, and pw1,
// pw2 and proj_w packed by the wrapper's pack_kmajor.  f32 = 1: those
// tensors fp32, and pw1, pw2 and proj_w three pack_kmajor planes each (hi,
// mid, lo).  Returns a cudaError_t as int.
int rvdd_convnext_block(const void* in0, int in0_c, int in0_h, int in0_w, int upsample,
                        const void* aux, int aux_c, int aux_stride, int aux_off,
                        int cin0_pad, const void* proj_w, const void* proj_b,
                        const void* dw_w, const void* dw_b, const void* ln_g,
                        const void* ln_b, const void* pw1, const void* pw1_b,
                        const void* pw2, const void* pw2_b, const void* ls,
                        const void* head_w, const void* head_b, int n_head,
                        int B, int H, int W, void* out, void* pooled, void* head_out,
                        void* state, int state_stride, int feat_off, int f32, void* stream) {
  const int cin = proj_w != nullptr ? cin0_pad + aux_c : 0;
  const int nh = head_w != nullptr ? n_head : 0;
  if (cin > MAX_CIN || nh > MAX_HEAD || cin % 16 || (proj_w == nullptr && (in0_c != F || aux_c)))
    return (int)cudaErrorInvalidValue;
#define RVDD_BLOCK_ARGS                                                                      \
  in0, in0_c, in0_h, in0_w, upsample, aux, aux_c, aux_stride, aux_off, cin0_pad, proj_w,    \
      proj_b, dw_w, dw_b, ln_g, ln_b, pw1, pw1_b, pw2, pw2_b, ls, head_w, head_b, n_head, B, \
      H, W, out, pooled, head_out, state, state_stride, feat_off
  cudaStream_t s = (cudaStream_t)stream;
  if (f32)
    return (int)launch_block<true>(make_args<float>(RVDD_BLOCK_ARGS), f32m::smem_layout().total, s);
  return (int)launch_block<false>(make_args<bf16>(RVDD_BLOCK_ARGS), smem_layout().total, s);
#undef RVDD_BLOCK_ARGS
}

}  // extern "C"

#ifdef RVDD_PHASE_CLOCKS
// copies the phase clocks to host[0..3] and zeroes them; returns a cudaError_t
extern "C" int rvdd_phase_clocks(void* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, wg::g_phase_clocks, sizeof(wg::g_phase_clocks));
  const unsigned long long zero[4] = {0, 0, 0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(wg::g_phase_clocks, zero, sizeof(zero));
  return (int)e;
}
#endif
