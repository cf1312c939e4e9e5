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
//     with the erf of rvdd_tpu's kernel (the Abramowitz-Stegun polynomial,
//     1.5e-7 abs; its module path and the port's plain version use the
//     exact erf).  pw1 and pw2 are fp32-faithful: each operand is split
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
// 67 TFLOP/s) and about 3 GB of fp32 chain traffic (0.9 ms).  A 4x32 tile
// (two 64-pixel segments) needs 6,900 cycles of products on an SM, and its
// CUDA cores must also issue the depthwise (2,352 FMA a thread of one
// warpgroup), the 24,576 GELUs and the splits of the hidden into hi, mid
// and lo planes: about 10,000 issue cycles on each of the four schedulers,
// so the CUDA-core stream, not the tensor cores, sets the pace once the
// phases overlap.  The design (warp-specialized, one persistent CTA of
// three warpgroups an SM):
//   * a rolling halo: a CTA walks a run of consecutive 4-row tiles down
//     one 32-column strip (the schedule, Sched, is contiguous ranges of
//     the tiles in (image, strip, row) order, so no CTA takes more than
//     ceil(tiles / CTAs); 1.002x the mean at 1080p).  The 10x38 fp32 halo
//     lives in a ring of 11 rows ([group of 4 channels][slot][38][4]);
//     after a run's first tile only the 4 new rows are staged (152 pixels,
//     not 380): copied with cp.async, interpolated by an upsample block
//     (the halo's source taps once a tile), projected by a proj block
//     (six-product wgmma on operands split in registers, the weight planes
//     copied into the LN region, free until the depthwise).  The ring's
//     11th row lets the next tile's new rows land in slots that the
//     current tile's epilogue does not read, so staging never waits for
//     the consumers' epilogue, except before a run's first tile (BAR_DONE);
//   * warpgroup 2, the producer (setmaxnreg to 152 registers), stages the
//     tile, runs the depthwise (lane = column and quarter of the channels,
//     all 4 rows, a pixel's 48 channels in 4 lanes of one warp, so the
//     LayerNorm sums are shuffles) and writes the LN output, then hands it
//     over (named barriers BAR_FULL / BAR_EMPTY): it works a tile ahead of
//     the consumers;
//   * warpgroups 0 and 1, the consumers (176 registers), take one segment
//     each: the LN output's A fragments split once a tile and held in
//     registers (36), so the LN region is the producer's again at once;
//     pw1 a quarter (48) of the hidden at a time, two quarters ahead in two
//     accumulators; bias, GELU and split; pw2 from registers (the
//     FlashAttention-3 P.V pattern).  The two take turns to issue their
//     batches of products (BAR_TURN, the FlashAttention-3 ping-pong), so
//     that one's GELU runs under the other's wgmma;
//   * the epilogue from registers: residual x from the ring's centre rows,
//     band and state stored as float2, the head by quad shuffles; the LN
//     rows are ordered so that a thread holds a pixel and the one below it,
//     and the 2x2 pool is one shuffle (no shared scratch);
//   * the GELU uses rvdd_tpu's kernel's erf (Abramowitz-Stegun, 1.5e-7 abs)
//     with the MUFU's approximate reciprocal and exp2: 15 instructions a
//     value where erff takes 32.  With erff a plain full-res block took
//     2.69 ms, with it 2.34 (probe, H100, the other parts as then): the
//     consumers' stream sets the pace (without any GELU the block took
//     1.42 ms).
// Budgets: shared memory 232,192 of 232,448 bytes (pw1 + pw2 in three
// planes 110,592; taps 9,408; vectors and head 3,488; ring 80,256; the LN
// output, or a proj block's weight planes, 27,648; upsample taps 576; 224
// of alignment);
// registers 168 a thread at launch, shifted by setmaxnreg to 152 for the
// producer (a proj chunk keeps 72 registers of split input and its
// accumulator) and 176 for the consumers (two pw1 accumulators, pw2's, and
// the LN's and the hidden's fragments, 144), with 12-16 bytes of spill.
// What bounds it now (probe, cycles a tile on the H100): a plain full-res
// block is balanced at about 20,000 (the producer's staging 7,200 and
// depthwise 12,100; the consumers' products 16,400 and epilogue 1,700), 1.40
// ms; a proj block (96 channels) is the producer's (projection 23,000: one
// warpgroup's chains of 36 dependent wgmma a chunk and its loads), 2.5 ms;
// an upsample block the producer's too (staging 13,300), 1.7 ms.  Tried and
// dropped (probe on variants of this source, H100): prefetching the next
// tile's input rows into L2 (plain 1.38 -> 1.66 ms: even code a block does
// not run moves the producer's register allocation); a depthwise in two
// passes, so that the new rows' copy overlaps the old rows' taps (3 KB of
// spill, 3.1 ms); the consumers projecting the next tile's first two
// chunks (940 bytes of spill, proj 3.3 ms); two accumulators for the
// projection (430 bytes of spill, slower); pw2 and the next pw1 interleaved
// in one batch (1.45 against 1.39 ms); register splits 136/184 (288 bytes
// of spill), 120/192 and 160/168 (1.95 and 2.10 ms).  The first form of
// the projection, with a wait a k-step and branchy scalar loads, staged
// for 45,000 cycles a tile; the kept one loads a chunk's inputs with no
// branch between them (float2 where the channel counts allow) and waits
// once a chunk: 23,000.  BlockArgsT<float>: every band pointer is fp32 and
// the upsample does not round.

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

__host__ __device__ constexpr int align128(int x) { return (x + 127) & ~127; }

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
// rvdd_tpu's band_dtype=float32, mxu_precision='highest', gelu_exact=True,
// warp-specialized (see the source note): warpgroup 2, the producer,
// stages each tile's new halo rows into a ring and runs the depthwise and
// LayerNorm a tile ahead; warpgroups 0 and 1, the consumers, run one
// 64-pixel segment each through pw1, GELU, pw2 and the epilogue.

namespace f32m {

constexpr int TH = 4;                 // output tile rows (TW = 32 columns as in the bf16 mode)
constexpr int HT = TH + 2 * R;        // halo rows of a tile
constexpr int RING = HT + 1;          // ring rows: a halo and one (see the source note)
constexpr int NSEG = TH * TW / 64;    // 2 segments: tile rows 2s, 2s+1
constexpr int CG4 = F / 4;            // channel groups of 4 (16 bytes of fp32)
constexpr int PLANE = F * HID * 2;    // bytes of one bf16 plane of pw1 or pw2
constexpr int RING_PX = RING * WT;    // pixels of one channel-group plane of the ring
constexpr int SEG_LN = CG4 * 64 * 4;  // floats of one segment's LN output, [CG4][64][4]
constexpr int NCONS = NSEG * 128;     // consumer threads: warpgroups 0 and 1
constexpr int KMAX = MAX_CIN / 16;    // proj k16 steps
// registers a thread after setmaxnreg (168 at launch): the producer's
// projection keeps a chunk's split input (72) and its accumulator; a
// consumer two pw1 accumulators, pw2's, and the LN's and the hidden's
// three-plane fragments (144)
constexpr int PROD_REGS = 152, CONS_REGS = 176;
// named barriers (0 is __syncthreads, 1-3 the bf16 mode's warpgroups)
constexpr int BAR_PROD = 4;   // the producer's 128 threads
constexpr int BAR_FULL = 5;   // a tile's LN output is written: the producer arrives
constexpr int BAR_EMPTY = 6;  // the consumers hold it in registers: they arrive
constexpr int BAR_DONE = 7;   // their epilogue has read the ring: before a run's first tile
constexpr int BAR_TURN = 8;   // 8 + g: consumer g's turn to issue products (the two alternate)
static_assert(NSEG == 2 && NCONS + 128 == NTHREADS, "two consumer warpgroups and a producer");
static_assert(PROD_REGS * 128 + CONS_REGS * NCONS <= 168 * NTHREADS, "the launch's registers");

struct Smem {
  int pw1, pw2, dw, vec, head, ring, ln, up, total;
};

// pw1 and pw2 (three planes each), the fp32 taps and vectors, the ring
// [CG4][RING][WT][4], the LN output [NSEG][CG4][64][4] (a proj block
// copies the proj's three weight planes there while it stages) and an
// upsample block's source taps of the halo's rows and columns
__host__ __device__ constexpr Smem smem_layout() {
  constexpr int ln_bytes = NSEG * SEG_LN * 4, proj_bytes = 3 * MAX_CIN * F * 2;
  Smem s{};
  int o = 0;
  s.pw1 = o;  o = align128(o + 3 * PLANE);
  s.pw2 = o;  o = align128(o + 3 * PLANE);
  s.dw = o;   o = align128(o + TAPS * F * 4);
  s.vec = o;  o = align128(o + V_TOTAL * 4);
  s.head = o; o = align128(o + MAX_HEAD * F * 4);
  s.ring = o; o = align128(o + CG4 * RING_PX * 16);
  s.ln = o;   o = align128(o + (ln_bytes > proj_bytes ? ln_bytes : proj_bytes));
  s.up = o;   o = align128(o + (HT + WT) * 12);
  s.total = o;
  return s;
}
static_assert(smem_layout().total <= 232448, "the shared memory a block may have");

// The schedule, mirrored by ops/cuda/convnext_chain.py:tile_runs.  Tile i
// is tile row i % R of strip (i / R) % S (32 columns) of image i / (S R);
// CTA c of n takes tiles [c T / n, (c + 1) T / n) of the T, so none takes
// more than ceil(T / n).  Its consecutive tiles of one strip form a run,
// down which the ring carries the halo.
struct Sched {
  int S, R, lo, hi;
  __device__ Sched(int B, int H, int W) {
    S = (W + TW - 1) / TW;
    R = (H + TH - 1) / TH;
    const long long T = (long long)B * S * R;
    lo = (int)(T * blockIdx.x / gridDim.x);
    hi = (int)(T * (blockIdx.x + 1) / gridDim.x);
  }
  __device__ bool run_start(int i) const { return i == lo || i % R == 0; }
  __device__ void tile(int i, int& b, int& y0, int& x0) const {
    b = i / (S * R);
    const int rem = i - b * S * R, s = rem / R;
    x0 = s * TW;
    y0 = (rem - s * R) * TH;
  }
};

// float offset of channel c of ring pixel (slot, col): image row gy lives
// in slot (gy + R) % RING, halo column col at image column x0 - R + col
__device__ __forceinline__ int ring_at(int slot, int col, int c) {
  return (((c >> 2) * RING + slot) * WT + col) * 4 + (c & 3);
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

// torch's F.gelu(approximate='none'), x * 0.5 * (1 + erf(x / sqrt(2))),
// with the erf of rvdd_tpu's kernel (convnext_pallas.py:_erf,
// Abramowitz-Stegun 7.1.26, 1.5e-7 abs) and the MUFU's reciprocal and
// exp2 (about 2^-22 relative): 15 instructions where erff takes 32 (it
// selects between two polynomials); the GELU is most of the consumers'
// instruction stream, which sets the tile's pace (see the source note)
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float gelu_erf(float x) {
  const float z = x * 0.7071067811865476f, az = fabsf(z);
  const float t = rcp_approx(fmaf(0.3275911f, az, 1.f));
  const float poly =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f), 1.421413741f),
                       -0.284496736f), 0.254829592f);
  const float e = ex2_approx(az * -1.4426950408889634f * az);  // exp(-z^2)
  const float hx = 0.5f * x;
  return fmaf(hx, copysignf(fmaf(-poly, e, 1.f), z), hx);
}

// 8 channels [c0, c0+8) of pixel `pixel` of the fp32 in0 (48 channels:
// a block that upsamples without proj)
__device__ __forceinline__ void load_f8(const float* in0, size_t pixel, int c0, float* v) {
  const float4* p = reinterpret_cast<const float4*>(in0 + pixel * F + c0);
  const float4 u0 = __ldg(p), u1 = __ldg(p + 1);
  v[0] = u0.x; v[1] = u0.y; v[2] = u0.z; v[3] = u0.w;
  v[4] = u1.x; v[5] = u1.y; v[6] = u1.z; v[7] = u1.w;
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

// One 64-pixel chunk of a proj block's halo rows, KS k16 steps of input:
// the pixels' input channels loaded from global memory as the A fragments
// of thread (lane quad q; rows h = 0, 1 at (gy, gx)), all loads first and
// with no branch between them, so that they are in flight together (a
// pixel outside the image reads one inside, then zeros); split into hi,
// mid and lo planes in registers; six wgmma m64n48k16 a k16 step on the
// weight planes at shared address wb (pbytes each) into acc.  Channel c is
// in0's below cin0_pad (zero from in0_c on) and the aux window's above.
// bar >= 0: after its loads the chunk waits for the weights' copy (this
// thread's cp.async, then the producer's named barrier bar).
template <int KS>
__device__ __forceinline__ void proj_chunk(const BlockArgsT<float>& a, int b, const int (&gy)[2],
                                           const int (&gx)[2], const bool (&in)[2], int q,
                                           uint32_t wb, int pbytes, int bar, float (&acc)[F / 2]) {
  float2 v[KS][4];
  if (a.upsample) {  // an upsampled proj input (no chain has one): load_in2
#pragma unroll
    for (int kc = 0; kc < KS; ++kc)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        v[kc][r] = in[r & 1] ? load_in2(a, b, gy[r & 1], gx[r & 1], 16 * kc + 8 * (r >> 1) + 2 * q)
                             : make_float2(0.f, 0.f);
  } else {
    const float* src0[2];
    const float* src1[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t pix = ((size_t)b * a.H + min(max(gy[h], 0), a.H - 1)) * a.W +
                         min(max(gx[h], 0), a.W - 1);
      src0[h] = a.in0 + pix * a.in0_c;
      src1[h] = a.aux != nullptr ? a.aux + pix * a.aux_stride + a.aux_off - a.cin0_pad : src0[h];
    }
    if ((a.in0_c & 1) == 0 && ((a.aux_stride | a.aux_off) & 1) == 0) {  // pairs: float2 loads
#pragma unroll
      for (int kc = 0; kc < KS; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int h = r & 1, c = 16 * kc + 8 * (r >> 1) + 2 * q;
          const bool lo = c < a.cin0_pad, ok = in[h] && (!lo || c < a.in0_c);
          const float2 x = __ldg(reinterpret_cast<const float2*>(
              lo ? src0[h] + (c < a.in0_c ? c : 0) : src1[h] + c));
          v[kc][r] = ok ? x : make_float2(0.f, 0.f);
        }
    } else {  // an odd channel count (the flagship's 9-channel chain input)
#pragma unroll
      for (int kc = 0; kc < KS; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int h = r & 1;
          float e2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 16 * kc + 8 * (r >> 1) + 2 * q + e;
            const bool lo = c < a.cin0_pad, ok = in[h] && (!lo || c < a.in0_c);
            const float x = __ldg(lo ? src0[h] + (c < a.in0_c ? c : 0) : src1[h] + c);
            e2[e] = ok ? x : 0.f;
          }
          v[kc][r] = make_float2(e2[0], e2[1]);
        }
    }
  }
  if (bar >= 0) {  // the weights are in
    wg::cp_async_wait<0>();
    wg::fence_async_smem();
    wg::bar_sync(bar, 128);
  }
  uint32_t fa[KS][3][4];  // [k step][plane][register]
#pragma unroll
  for (int kc = 0; kc < KS; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split3x2(v[kc][r].x, v[kc][r].y, fa[kc][0][r], fa[kc][1][r], fa[kc][2][r]);
  wg::fence();
#pragma unroll
  for (int kc = 0; kc < KS; ++kc)
#pragma unroll
    for (int p = 0; p < 6; ++p)
      wg::wgmma_rs_n48(acc, fa[kc][plane_a(p)],
                       wg::desc(wb + plane_b(p) * pbytes + kc * 1536, 768, 128), kc + p > 0);
  wg::commit();
  wg::wait<0>();
  wg::fence_regs(acc);
#pragma unroll
  for (int kc = 0; kc < KS; ++kc)
#pragma unroll
    for (int pl = 0; pl < 3; ++pl) wg::fence_regs(fa[kc][pl]);
}

// Halo rows [ir0, HT) of a proj block's tile at (b, y0, x0), projected
// into the ring 64 pixels at a time by the producer (pt: its thread's
// index): proj_chunk, bias, zeros outside the image.  The weight planes are
// at shared address wb; the first chunk waits for their copy with named
// barrier bar.
__device__ __forceinline__ void proj_rows(const BlockArgsT<float>& a, int b, int y0, int x0,
                                          int ir0, float* ring, uint32_t wb, int cin, int pt,
                                          int bar) {
  const int npx = (HT - ir0) * WT;
  const int s0 = (y0 + ir0) % RING;  // the slot of halo row ir0
  const int pbytes = cin * F * 2, ksteps = cin / 16;  // bytes of one plane; k16 steps
  const int lane = pt & 31, q = lane & 3, r0 = 16 * (pt >> 5) + (lane >> 2);
#pragma unroll 1
  for (int ch = 0; ch * 64 < npx; ++ch) {
    int gy[2], gx[2], at[2];
    bool in[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = ch * 64 + r0 + 8 * h, k = p / WT, col = p - k * WT;
      gy[h] = y0 - R + ir0 + k;
      gx[h] = x0 - R + col;
      at[h] = p < npx ? ring_at(s0 + k >= RING ? s0 + k - RING : s0 + k, col, 0) : -1;
      in[h] = p < npx && gy[h] >= 0 && gy[h] < a.H && gx[h] >= 0 && gx[h] < a.W;
    }
    const int cbar = ch == 0 ? bar : -1;
    float acc[F / 2];
    switch (ksteps) {  // whole pipeline stages: no branch between the wgmma
      case 1: proj_chunk<1>(a, b, gy, gx, in, q, wb, pbytes, cbar, acc); break;
      case 2: proj_chunk<2>(a, b, gy, gx, in, q, wb, pbytes, cbar, acc); break;
      case 3: proj_chunk<3>(a, b, gy, gx, in, q, wb, pbytes, cbar, acc); break;
      case 4: proj_chunk<4>(a, b, gy, gx, in, q, wb, pbytes, cbar, acc); break;
      case 5: proj_chunk<5>(a, b, gy, gx, in, q, wb, pbytes, cbar, acc); break;
      default: proj_chunk<KMAX>(a, b, gy, gx, in, q, wb, pbytes, cbar, acc); break;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (at[h] < 0) continue;
#pragma unroll
      for (int j = 0; j < CG; ++j) {
        const int c = 8 * j + 2 * q;
        *reinterpret_cast<float2*>(ring + at[h] + (c >> 2) * RING_PX * 4 + (c & 3)) =
            in[h] ? make_float2(acc[4 * j + 2 * h] + __ldg(a.proj_b + c),
                                acc[4 * j + 2 * h + 1] + __ldg(a.proj_b + c + 1))
                  : make_float2(0.f, 0.f);
      }
    }
  }
}

// The producer stages halo rows [ir0, HT) of the tile at (b, y0, x0) into
// the ring, zeros outside the image (the depthwise conv's zero padding).  A
// plain block copies them with cp.async (by pixel, so neighbouring threads
// read neighbouring 16 bytes); an upsample block interpolates them from the
// half-res input, with the source taps of the halo's rows and columns
// computed once a tile into `up`.  A proj block copies the proj's three
// weight planes ([cin/8][F][8] each, 27,648 bytes at 96 channels) into
// wbuf, the LN region (free until the depthwise), and projects them
// (proj_rows).  pt: the thread's index in the producer.
__device__ __forceinline__ void stage_rows(const BlockArgsT<float>& a, int b, int y0, int x0,
                                           int ir0, float* ring, unsigned char* wbuf,
                                           unsigned char* up, int cin, int pt) {
  const int npx = (HT - ir0) * WT;
  const int s0 = (y0 + ir0) % RING;  // the slot of halo row ir0; row ir0 + k in slot_of(k)
  auto slot_of = [s0](int k) { return s0 + k >= RING ? s0 + k - RING : s0 + k; };
  if (a.proj_w != nullptr) {
    for (int i = pt * 16; i < 3 * cin * F * 2; i += 128 * 16)
      wg::cp_async16(wbuf + i, reinterpret_cast<const unsigned char*>(a.proj_w) + i);
    wg::cp_async_commit();
    proj_rows(a, b, y0, x0, ir0, ring, wg::smem_addr(wbuf), cin, pt, BAR_PROD);
    return;
  }
  if (a.upsample) {
    // the source rows and columns (and weights) of the halo's rows and
    // columns, once a tile (float64 positions, as ops/resize.py), then
    // every pixel's 8-channel groups from them
    int* tap_i = reinterpret_cast<int*>(up);             // [HT + WT][2]
    float* tap_t = reinterpret_cast<float*>(up) + 2 * (HT + WT);
    for (int t = pt; t < HT + WT; t += 128) {
      int i0, i1;
      float tt;
      if (t < HT)
        ac_taps(min(max(y0 - R + t, 0), a.H - 1), a.in0_h, i0, i1, tt);
      else
        ac_taps(min(max(x0 - R + t - HT, 0), a.W - 1), a.in0_w, i0, i1, tt);
      tap_i[2 * t] = i0;
      tap_i[2 * t + 1] = i1;
      tap_t[t] = tt;
    }
    wg::bar_sync(BAR_PROD, 128);
    for (int it = pt; it < npx * CG; it += 128) {
      const int p = it / CG, cg = it - p * CG, k = p / WT, col = p - k * WT;
      const int gy = y0 - R + ir0 + k, gx = x0 - R + col;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W) {
        const int r = ir0 + k, c = HT + col;
        const float ty = tap_t[r], tx = tap_t[c];
        const size_t r0 = (size_t)b * a.in0_h + tap_i[2 * r], r1 = (size_t)b * a.in0_h + tap_i[2 * r + 1];
        const int i0 = tap_i[2 * c], i1 = tap_i[2 * c + 1];
        float v00[8], v01[8], v10[8], v11[8];
        load_f8(a.in0, r0 * a.in0_w + i0, cg * 8, v00);
        load_f8(a.in0, r0 * a.in0_w + i1, cg * 8, v01);
        load_f8(a.in0, r1 * a.in0_w + i0, cg * 8, v10);
        load_f8(a.in0, r1 * a.in0_w + i1, cg * 8, v11);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = lerp_rn(lerp_rn(v00[e], v10[e], ty), lerp_rn(v01[e], v11[e], ty), tx);
      }
      float* dst = ring + ring_at(slot_of(k), col, cg * 8);
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(dst + RING_PX * 4) = make_float4(v[4], v[5], v[6], v[7]);
    }
    return;
  }
  for (int it = pt; it < npx * CG4; it += 128) {
    const int p = it / CG4, c4 = it - p * CG4, k = p / WT, col = p - k * WT;
    const int gy = y0 - R + ir0 + k, gx = x0 - R + col;
    float* dst = ring + ring_at(slot_of(k), col, c4 * 4);
    if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W)
      wg::cp_async16(dst, a.in0 + (((size_t)b * a.H + gy) * a.W + gx) * F + c4 * 4);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The producer's depthwise 7x7 and LayerNorm of the tile at row y0, from
// the ring to the LN region, in fp32.  Lane 8 cq + xi of warp w takes
// column x = 8 w + xi and the channel groups cq, cq + 4, cq + 8, all TH
// rows, sliding down the HT halo rows of each tap column (a quarter-warp
// reads 8 neighbouring pixels of one 16-byte plane: 128 contiguous bytes).
// A pixel's 48 channels lie in lanes xi, xi + 8, xi + 16 and xi + 24 of one
// warp, so each LN sum takes two shuffles.  Output pixel (row o, column x)
// becomes row m = 16 (x / 8) + 8 (o % 2) + x % 8 of segment o / 2, so that
// the consumer thread holding row m also holds the pixel below it (the 2x2
// pool stays in registers).
__device__ __forceinline__ void depthwise_ln(const float* ring, const float* s_dw,
                                             const float* s_vec, float* ln, int y0, int pt) {
  const int w = pt >> 5, lane = pt & 31, cq = lane >> 3, xi = lane & 7, x = 8 * w + xi;
  int roff[HT];  // float offset of halo row ir, column x in a plane
  const int s0 = y0 % RING;
#pragma unroll
  for (int ir = 0; ir < HT; ++ir)
    roff[ir] = ((s0 + ir >= RING ? s0 + ir - RING : s0 + ir) * WT + x) * 4;
  float acc[3][TH][4];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int c4 = cq + 4 * k;
    const float* plane = ring + c4 * RING_PX * 4;
#pragma unroll
    for (int o = 0; o < TH; ++o)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][o][e] = 0.f;
#pragma unroll
    for (int dx = 0; dx < KS; ++dx) {
      float wt[KS][4];
#pragma unroll
      for (int dy = 0; dy < KS; ++dy) {
        const float4 w0 = *reinterpret_cast<const float4*>(s_dw + (dy * KS + dx) * F + c4 * 4);
        wt[dy][0] = w0.x; wt[dy][1] = w0.y; wt[dy][2] = w0.z; wt[dy][3] = w0.w;
      }
#pragma unroll
      for (int ir = 0; ir < HT; ++ir) {
        const float4 u = *reinterpret_cast<const float4*>(plane + roff[ir] + dx * 4);
        const float v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int o = 0; o < TH; ++o) {
          const int dy = ir - o;
          if (dy >= 0 && dy < KS) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[k][o][e] = fmaf(v[e], wt[dy][e], acc[k][o][e]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int o = 0; o < TH; ++o) {
    float sm = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[k][o][e] += s_vec[V_DW_B + (cq + 4 * k) * 4 + e];
        sm += acc[k][o][e];
      }
    sm += __shfl_xor_sync(0xffffffffu, sm, 8);
    sm += __shfl_xor_sync(0xffffffffu, sm, 16);
    const float u = sm / F;
    float qs = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[k][o][e] -= u;
        qs += acc[k][o][e] * acc[k][o][e];
      }
    qs += __shfl_xor_sync(0xffffffffu, qs, 8);
    qs += __shfl_xor_sync(0xffffffffu, qs, 16);
    const float rstd = rsqrtf(qs / F + 1e-6f);
    float* dst = ln + (o >> 1) * SEG_LN + (16 * w + 8 * (o & 1) + xi) * 4;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int c4 = cq + 4 * k;
      float hn[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        hn[e] = __fadd_rn(__fmul_rn(__fmul_rn(acc[k][o][e], rstd), s_vec[V_LN_G + c4 * 4 + e]),
                          s_vec[V_LN_B + c4 * 4 + e]);
      *reinterpret_cast<float4*>(dst + c4 * 64 * 4) = make_float4(hn[0], hn[1], hn[2], hn[3]);
    }
  }
}

// The producer's tiles: stage (a run's first tile: its whole halo; the
// others: their TH new rows), depthwise and LayerNorm into the LN region,
// hand it over, wait until the consumers hold it.  Phase clocks (slots 0-2):
// waiting for the consumers' release, staging or projection, depthwise + LN.
__device__ __forceinline__ void produce(const BlockArgsT<float>& a, unsigned char* smem,
                                        const Sched& sc) {
  constexpr Smem L = smem_layout();
  const int pt = threadIdx.x - NCONS;
  const int cin = a.proj_w != nullptr ? a.cin0_pad + a.aux_c : 0;
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  float* ln = reinterpret_cast<float*>(smem + L.ln);
  const float* s_dw = reinterpret_cast<const float*>(smem + L.dw);
  const float* s_vec = reinterpret_cast<const float*>(smem + L.vec);
  PHASE_CLOCK(long long ph[3] = {0, 0, 0}; long long c0 = 0, c1 = 0;)
#pragma unroll 1
  for (int i = sc.lo; i < sc.hi; ++i) {
    int b, y0, x0;
    sc.tile(i, b, y0, x0);
    const bool first = sc.run_start(i);
    PHASE_CLOCK(c0 = clock64();)
    // a new run's halo covers every slot the last tile's epilogue reads
    if (first && i != sc.lo) wg::bar_sync(BAR_DONE, NTHREADS);
    PHASE_CLOCK(c1 = clock64(); ph[0] += c1 - c0;)
    stage_rows(a, b, y0, x0, first ? 0 : HT - TH, ring, smem + L.ln, smem + L.up, cin, pt);
    wg::cp_async_commit();
    wg::cp_async_wait<0>();
    wg::bar_sync(BAR_PROD, 128);
    PHASE_CLOCK(c0 = clock64(); ph[1] += c0 - c1;)
    depthwise_ln(ring, s_dw, s_vec, ln, y0, pt);
    wg::bar_arrive(BAR_FULL, NTHREADS);
    PHASE_CLOCK(c1 = clock64(); ph[2] += c1 - c0;)
    wg::bar_sync(BAR_EMPTY, NTHREADS);
    PHASE_CLOCK(ph[0] += clock64() - c1;)
  }
  PHASE_CLOCK(if (pt == 0) wg::phase_clocks_add_at(ph, 0, 0);)
}

// A consumer's tiles: its segment (tile rows 2g, 2g + 1) through pw1 ->
// GELU -> pw2 a quarter (48) of the hidden at a time, six wgmma m64n48k16 a
// k16 step on hi, mid and lo planes, then the epilogue.  The LN output is
// loaded and split once a tile; pw1 runs two quarters ahead of the GELU, in
// two accumulators, and the two consumers take turns to issue products.
// Phase clocks (slots 3-5): waiting for the LN, products with GELU,
// epilogue.
__device__ __forceinline__ void consume(const BlockArgsT<float>& a, unsigned char* smem,
                                        const Sched& sc) {
  constexpr Smem L = smem_layout();
  const float* s_vec = reinterpret_cast<const float*>(smem + L.vec);
  const float* s_head = reinterpret_cast<const float*>(smem + L.head);  // [n_head][F]
  const float* ring = reinterpret_cast<const float*>(smem + L.ring);
  const int tid = threadIdx.x, g = tid >> 7, lane = tid & 31, q = lane & 3;
  const int r0 = 16 * ((tid >> 5) & 3) + (lane >> 2);   // accumulator rows r0 and r0 + 8
  const int col = 8 * ((tid >> 5) & 3) + (lane >> 2);  // their pixels: (2g, col), (2g + 1, col)
  const float* lns = reinterpret_cast<const float*>(smem + L.ln) + g * SEG_LN;
  const uint32_t pw1_base = wg::smem_addr(smem + L.pw1);
  const uint32_t pw2_base = wg::smem_addr(smem + L.pw2);
  PHASE_CLOCK(long long ph[3] = {0, 0, 0}; long long c0 = 0, c1 = 0; int nt = 0;)
  if (g == 1) wg::bar_arrive(BAR_TURN, NCONS);  // consumer 0 issues first
#pragma unroll 1
  for (int i = sc.lo; i < sc.hi; ++i) {
    int b, y0, x0;
    sc.tile(i, b, y0, x0);
    PHASE_CLOCK(c0 = clock64();)
    wg::bar_sync(BAR_FULL, NTHREADS);
    PHASE_CLOCK(c1 = clock64(); ph[0] += c1 - c0;)
    // the LN output's A fragments (rows r0, r0 + 8; k16 steps kc), split
    // once; then the LN region is the producer's again
    uint32_t la[3][3][4];  // [plane][k step][register]
#pragma unroll
    for (int kc = 0; kc < F / 16; ++kc)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = 16 * kc + 8 * (r >> 1) + 2 * q;
        const float2 v = *reinterpret_cast<const float2*>(
            lns + ((c >> 2) * 64 + r0 + 8 * (r & 1)) * 4 + (c & 3));
        split3x2(v.x, v.y, la[0][kc][r], la[1][kc][r], la[2][kc][r]);
      }
    wg::bar_arrive(BAR_EMPTY, NTHREADS);

    float acc1[2][F / 2], acc2[F / 2];
    uint32_t ha[3][3][4];
    auto issue_pw1 = [&](int qt, float(&acc)[F / 2]) {  // acc = LN @ pw1[:, quarter qt]
      wg::fence();
#pragma unroll
      for (int kc = 0; kc < F / 16; ++kc)
#pragma unroll
        for (int p = 0; p < 6; ++p)
          wg::wgmma_rs_n48(acc, la[plane_a(p)][kc],
                           wg::desc(pw1_base + plane_b(p) * PLANE + kc * 6144 + qt * 768, 3072, 128),
                           kc + p > 0);
      wg::commit();
    };
    auto gelu_split = [&](int qt, const float(&acc)[F / 2]) {  // ha = split(GELU(acc + b1))
      // bias and erf GELU in fp32, split: column pairs of the accumulator
      // are the A fragments of pw2's k16 steps over this quarter
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const int c = qt * F + 8 * j + 2 * q;
        const float b0 = s_vec[V_PW1_B + c], b1 = s_vec[V_PW1_B + c + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (j & 1) * 2 + h;
          split3x2(gelu_erf(acc[4 * j + 2 * h] + b0), gelu_erf(acc[4 * j + 2 * h + 1] + b1),
                   ha[0][j >> 1][r], ha[1][j >> 1][r], ha[2][j >> 1][r]);
        }
      }
    };
    auto issue_pw2 = [&](int qt) {  // acc2 (+)= ha @ pw2[quarter qt]
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 3; ++kk)
#pragma unroll
        for (int p = 0; p < 6; ++p)
          wg::wgmma_rs_n48(acc2, ha[plane_a(p)][kk],
                           wg::desc(pw2_base + plane_b(p) * PLANE + (qt * 3 + kk) * 1536, 768, 128),
                           qt + kk + p > 0);
      wg::commit();
    };
    auto fence_hidden = [&]() {
#pragma unroll
      for (int pl = 0; pl < 3; ++pl)
#pragma unroll
        for (int kk = 0; kk < 3; ++kk) wg::fence_regs(ha[pl][kk]);
    };
    // pw1 runs two quarters ahead, in two accumulators: quarter qt's GELU
    // overlaps the products of qt + 1 (and pw2 of qt - 1).  The two
    // consumers take turns to issue a batch of products (named barriers
    // BAR_TURN + g, the FlashAttention-3 ping-pong), so that one's GELU
    // runs under the other's wgmma.
    wg::bar_sync(BAR_TURN + g, NCONS);
    issue_pw1(0, acc1[0]);
    issue_pw1(1, acc1[1]);
    wg::bar_arrive(BAR_TURN + (g ^ 1), NCONS);
#pragma unroll
    for (int qt = 0; qt < HID / F; ++qt) {
      if (qt + 1 < HID / F)
        wg::wait<1>();  // all but pw1 of qt + 1: pw1 of qt and pw2 of qt - 1 are done
      else
        wg::wait<0>();
      wg::fence_regs(acc1[qt & 1]);
      wg::fence_regs(acc2);
      fence_hidden();
      gelu_split(qt, acc1[qt & 1]);
      wg::bar_sync(BAR_TURN + g, NCONS);
      issue_pw2(qt);
      if (qt + 2 < HID / F) issue_pw1(qt + 2, acc1[qt & 1]);
      wg::bar_arrive(BAR_TURN + (g ^ 1), NCONS);
    }
    wg::wait<0>();
    wg::fence_regs(acc2);
    fence_hidden();
#pragma unroll
    for (int pl = 0; pl < 3; ++pl)
#pragma unroll
      for (int kc = 0; kc < 3; ++kc) wg::fence_regs(la[pl][kc]);
    PHASE_CLOCK(c0 = clock64(); ph[1] += c0 - c1;)

    // epilogue: y = x + ls * (h2 + b2) in place of acc2 (x from the
    // ring's centre rows); the band and the state from registers, the 2x2
    // pool from the two rows this thread holds and the neighbouring
    // column's (lane ^ 4), the head on y summed over the quad's lanes
    int slot[2];
    bool valid[2];
    size_t px[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gy = y0 + 2 * g + h, gx = x0 + col;
      slot[h] = (gy + R) % RING;
      valid[h] = gy < a.H && gx < a.W;
      px[h] = ((size_t)b * a.H + gy) * a.W + gx;
    }
#pragma unroll
    for (int j = 0; j < CG; ++j) {
      const int c = 8 * j + 2 * q;
      const float ls0 = s_vec[V_LS + c], ls1 = s_vec[V_LS + c + 1];
      const float b0 = s_vec[V_PW2_B + c], b1 = s_vec[V_PW2_B + c + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 xv = *reinterpret_cast<const float2*>(ring + ring_at(slot[h], col + R, c));
        acc2[4 * j + 2 * h] = __fadd_rn(xv.x, __fmul_rn(ls0, acc2[4 * j + 2 * h] + b0));
        acc2[4 * j + 2 * h + 1] = __fadd_rn(xv.y, __fmul_rn(ls1, acc2[4 * j + 2 * h + 1] + b1));
      }
    }
    const auto store = [&](float* base, int stride) {  // y of both pixels at base[px * stride + c]
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (valid[h]) {
          float* dst = base + px[h] * stride + 2 * q;
#pragma unroll
          for (int j = 0; j < CG; ++j)
            __stcg(reinterpret_cast<float2*>(dst + 8 * j),
                   make_float2(acc2[4 * j + 2 * h], acc2[4 * j + 2 * h + 1]));
        }
    };
    if (a.out != nullptr) store(a.out, F);
    if (a.state != nullptr && a.feat_off >= 0) store(a.state + a.feat_off, a.state_stride);
    if (a.pooled != nullptr) {  // uniform
      const int h2 = a.H >> 1, w2 = a.W >> 1;
      const bool here = (lane & 4) == 0 && (y0 >> 1) + g < h2 && ((x0 + col) >> 1) < w2;
      float* dst = a.pooled + (((size_t)b * h2 + (y0 >> 1) + g) * w2 + ((x0 + col) >> 1)) * F + 2 * q;
#pragma unroll
      for (int j = 0; j < CG; ++j) {
        float mx = fmaxf(acc2[4 * j], acc2[4 * j + 2]), my = fmaxf(acc2[4 * j + 1], acc2[4 * j + 3]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        my = fmaxf(my, __shfl_xor_sync(0xffffffffu, my, 4));
        if (here) __stcg(reinterpret_cast<float2*>(dst + 8 * j), make_float2(mx, my));
      }
    }
    if (a.n_head > 0) {  // uniform: the chain's last block
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float part[MAX_HEAD];
#pragma unroll
        for (int k = 0; k < MAX_HEAD; ++k) {
          part[k] = 0.f;
          if (k < a.n_head) {
#pragma unroll
            for (int j = 0; j < CG; ++j) {
              const int c = 8 * j + 2 * q;
              part[k] = fmaf(acc2[4 * j + 2 * h + 1], s_head[k * F + c + 1],
                             fmaf(acc2[4 * j + 2 * h], s_head[k * F + c], part[k]));
            }
            part[k] += __shfl_xor_sync(0xffffffffu, part[k], 1);
            part[k] += __shfl_xor_sync(0xffffffffu, part[k], 2);
          }
        }
        if (valid[h] && q == 0) {
          if (a.state != nullptr) {
            float* st = a.state + px[h] * a.state_stride;
#pragma unroll
            for (int k = 0; k < MAX_HEAD; ++k)
              if (k < a.n_head) st[k] = part[k] + s_vec[V_HEAD_B + k];
            const int zend = a.feat_off >= 0 ? a.feat_off : a.state_stride;
            for (int ch = a.n_head; ch < zend; ++ch) st[ch] = 0.f;
          } else if (a.head_out != nullptr) {
#pragma unroll
            for (int k = 0; k < MAX_HEAD; ++k)
              if (k < a.n_head) a.head_out[px[h] * a.n_head + k] = part[k] + s_vec[V_HEAD_B + k];
          }
        }
      }
    }
    PHASE_CLOCK(ph[2] += clock64() - c0; ++nt;)
    // the next tile starts a run: its halo takes the slots read above
    if (i + 1 < sc.hi && sc.run_start(i + 1)) wg::bar_arrive(BAR_DONE, NTHREADS);
  }
  if (g == 0) wg::bar_sync(BAR_TURN, NCONS);  // consumer 1's last turn
  PHASE_CLOCK(if (tid == 0) wg::phase_clocks_add_at(ph, 3, nt);)
}

// the fp32 mode's block: the weights once per CTA, then the producer and
// the two consumers, each in its own branch to the end (setmaxnreg)
__device__ __forceinline__ void block_f32(const BlockArgsT<float>& a, unsigned char* smem) {
  constexpr Smem L = smem_layout();
  float* s_vec = reinterpret_cast<float*>(smem + L.vec);
  float* s_head = reinterpret_cast<float*>(smem + L.head);  // [n_head][F]
  const int tid = threadIdx.x;
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

  const Sched sc(a.B, a.H, a.W);
  if (tid >= NCONS) {
    wg::setmaxnreg_dec<PROD_REGS>();
    produce(a, smem, sc);
  } else {
    wg::setmaxnreg_inc<CONS_REGS>();
    consume(a, smem, sc);
  }
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

// one launch of min(tiles, n_cta) CTAs; n_cta <= 0: one CTA an SM
template <bool F32>
cudaError_t launch_block(const BlockArgsT<band_t<F32>>& a, int smem, int n_cta,
                         cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(convnext_block_kernel<F32>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  if (n_cta <= 0) n_cta = sms;
  const int th = F32 ? f32m::TH : TH;
  const long long ntiles = (long long)((a.W + TW - 1) / TW) * ((a.H + th - 1) / th) * a.B;
  const int grid = (int)(ntiles < n_cta ? ntiles : n_cta);
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
// mid, lo).  n_cta > 0 caps the grid (the card tests walk whole strips in
// one CTA); n_cta <= 0 launches one CTA an SM.  Returns a cudaError_t as int.
int rvdd_convnext_block_grid(const void* in0, int in0_c, int in0_h, int in0_w, int upsample,
                             const void* aux, int aux_c, int aux_stride, int aux_off,
                             int cin0_pad, const void* proj_w, const void* proj_b,
                             const void* dw_w, const void* dw_b, const void* ln_g,
                             const void* ln_b, const void* pw1, const void* pw1_b,
                             const void* pw2, const void* pw2_b, const void* ls,
                             const void* head_w, const void* head_b, int n_head,
                             int B, int H, int W, void* out, void* pooled, void* head_out,
                             void* state, int state_stride, int feat_off, int f32, int n_cta,
                             void* stream) {
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
    return (int)launch_block<true>(make_args<float>(RVDD_BLOCK_ARGS), f32m::smem_layout().total,
                                   n_cta, s);
  return (int)launch_block<false>(make_args<bf16>(RVDD_BLOCK_ARGS), smem_layout().total, n_cta, s);
#undef RVDD_BLOCK_ARGS
}

// rvdd_convnext_block_grid with one CTA an SM (the grid of the main path)
int rvdd_convnext_block(const void* in0, int in0_c, int in0_h, int in0_w, int upsample,
                        const void* aux, int aux_c, int aux_stride, int aux_off,
                        int cin0_pad, const void* proj_w, const void* proj_b,
                        const void* dw_w, const void* dw_b, const void* ln_g,
                        const void* ln_b, const void* pw1, const void* pw1_b,
                        const void* pw2, const void* pw2_b, const void* ls,
                        const void* head_w, const void* head_b, int n_head,
                        int B, int H, int W, void* out, void* pooled, void* head_out,
                        void* state, int state_stride, int feat_off, int f32, void* stream) {
  return rvdd_convnext_block_grid(in0, in0_c, in0_h, in0_w, upsample, aux, aux_c, aux_stride,
                                  aux_off, cin0_pad, proj_w, proj_b, dw_w, dw_b, ln_g, ln_b, pw1,
                                  pw1_b, pw2, pw2_b, ls, head_w, head_b, n_head, B, H, W, out,
                                  pooled, head_out, state, state_stride, feat_off, f32, 0, stream);
}

}  // extern "C"

