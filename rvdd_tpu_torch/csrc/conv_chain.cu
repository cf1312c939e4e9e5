// One conv layer of a fused U-Net conv chain, for sm_90a: an implicit-GEMM
// 3x3 (or 1x1) convolution in NHWC with bf16 operands and fp32 accumulation
// on the tensor cores (wgmma), bias and relu in the epilogue.
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
//     input while it stages the tile, in fp32 (rounded once to bf16 in the
//     bf16 modes);
//   * pool emit: the epilogue writes the whole 2x2 max pool (tiles start
//     at even coordinates and hold whole row pairs, so each window lies in
//     one tile);
//   * combined state emit: the epilogue writes the fp32 accumulator (after
//     bias and act) into a channel window of the fp32 recurrence state and
//     zero-fills the pad channels that follow it;
//   * weight split: the layer runs a second product with the lo half of
//     the weights (w = hi + lo, hi by mantissa masking) into the same fp32
//     accumulator (three planes, hi + mid + lo, for fp32 weights).
// Four numerics, a launch argument each (the chain's, fixed when the
// wrapper packs it):
//   * rvdd_tpu's 'fast' bands: bf16 activations and weights, fp32
//     accumulation, fp32 bias; every band (layer output) is stored as bf16;
//   * fp32 bands with bf16_3x products (band_dtype=float32 with
//     mxu_precision='high', conv_pallas.py:306-327 and :574-580): inputs,
//     bands and emitted outputs are fp32 in global memory.  Staging loads a
//     tile's fp32 values through registers and splits each by its mantissa
//     (hi = the top 16 bits, exact in bf16; lo = bf16(v - hi)) into two
//     bf16 planes of the same layout, so a tap stays a descriptor offset;
//     every layer's weights are split, and each k-step issues three wgmma
//     into one accumulator, w_hi a_hi + w_hi a_lo + w_lo a_hi (the lo lo
//     term, about 2^-16 relative, is dropped as on the TPU).  TF32 wgmma
//     would keep 10 mantissa bits against about 16 here;
//   * fp32 bands with HIGHEST products (band_dtype=float32,
//     mxu_precision='highest', fp32 weights: rvdd_tpu's 'accurate',
//     conv_pallas.py:288-304): staging splits each fp32 value into three
//     bf16 planes, hi + mid + lo = v exactly (hi and mid by mantissa masks,
//     lo the rest, at most 8 significant bits), the weights are packed as
//     three such planes, and each k-step issues six wgmma: hi.hi, hi.mid,
//     mid.hi, hi.lo, mid.mid and lo.hi, the terms HIGHEST keeps (the three
//     dropped ones are below 2^-24 of the product), as convnext_chain.cu's
//     fp32 mode does;
//   * bf16 bands with fp32 weights (weight_dtype=float32 at 'highest',
//     rvdd_tpu's 'wf32', conv_pallas.py:295-296): the tile is staged as in
//     the bf16 modes, the weights are three planes, and each k-step issues
//     three wgmma, w_hi a + w_mid a + w_lo a, exact in the weights (a is
//     bf16) up to the fp32 sums' order.
// The mode is a template parameter of the kernel: a branch between wgmma
// makes ptxas serialize them.  Why the tile is split in shared memory and
// not in registers (wgmma's register-A form): a tap is a descriptor offset
// into the staged planes, so the split runs once per staged value, where
// register A fragments would be split once per tap (nine times for a 3x3);
// and the three planes still fit beside a layer's weights (see below).
//
// What bounds it on the H100: operations.  The six chains of a 1080p frame
// need about 1.07 TFLOP (with dec2's split layers): about 1.0 ms at the
// 989 TFLOP/s bf16 dense peak, against about 0.3 ms for their bytes.  With
// fp32 weights their 0.98 TFLOP count three bf16 products each (about 3.0
// ms) and in the HIGHEST mode six (about 5.9 ms).  The
// layer is a GEMM of M = pixels, N = cout_pad (48, 16 for the head), K =
// ks^2 * (cin0_pad + aux_c) (144 to 864).  The design:
//   * a persistent CTA of two or three warpgroups keeps the layer's whole
//     packed weight matrix ([K/8][N][8] bf16, the wgmma B layout; both
//     halves of a split layer, at most 83 KB in the bf16 modes) in shared
//     memory, loaded once;
//   * each warpgroup walks its own tiles of TRW (4, or 2 where shared memory
//     is short) rows x 64 output columns in its own shared-memory region,
//     so the warpgroups drift apart and one's staging and epilogue overlap
//     another's products (a CTA-wide barrier per tile left the tensor cores
//     idle through every epilogue);
//   * a tile's input (its rows plus a one-pixel halo, all channels) is
//     staged with cp.async as [channel group of 8][row][column][8
//     channels], so 8 consecutive pixels of one channel group are one
//     128-byte core matrix and tap (dy, dx) of a 64-pixel output row is the
//     same descriptor moved by (dy * (64 + 2) + dx) * 16 bytes: no im2col
//     copy (the upsample layer, a 6-channel input and the fp32-band modes
//     build their tile with loads and arithmetic instead);
//   * the warpgroup holds one m64nN accumulator per tile row and issues
//     ks^2 * cin/16 k-steps per row, each of the mode's products (one
//     wgmma m64nNk16; two for a split layer, three in the bf16_3x and
//     fp32-weight modes, six in the HIGHEST mode), the first with scale-d
//     0, before one wait;
//   * the epilogue adds bias and relu in registers, writes the fp32 state
//     from registers, and stages the band in the warpgroup's region for
//     16-byte stores and the 2x2 pool (4-byte stores straight from the
//     accumulator layout doubled the layer's time on the H100); then the
//     region takes the next tile's input.
// The wgmma N = 48 reads 3.5 KB of shared memory per 98 KFLOP, which
// shared memory feeds at about 85% of the tensor-core rate; the rest of the
// gap to the peak is staging and the epilogue (chip_smoke.py prints each
// chain's TFLOP/s and share of the bound).
//
// Shared memory in the fp32 and fp32-weight modes: the split weights of
// the layers that read 48 + 48 aux channels (K = 864, N = 48) take 165,888
// bytes in two planes and 248,832 in three, and a tile's planes 101,376 at
// TRW 2 in two planes (152,064 in three), above the 232,448 a block may
// have.  Such a layer streams its weights instead: one warpgroup per CTA,
// and the planes of one tap (18,432 or 27,648 bytes) at a time,
// double-buffered with cp.async, so tap t + 1 (after the last, the next
// tile's first) loads while tap t's products run; a barrier and a wgmma
// wait per tap.  Every tile reloads the layer's weights from L2.  In the
// HIGHEST mode a K = 432 layer keeps its three planes (124,416 bytes)
// resident beside one warpgroup's TRW 2 tile (76,032): 200,448 bytes; a
// K = 864 layer streams beside a TRW 2 tile: 207,360.  The choice is a
// function of the layer's shape and mode alone: the resident form where
// one of its configurations fits, else the streamed one, else the launch
// fails with cudaErrorInvalidValue.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "wgmma.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TW = 64;                 // output columns per tile: one m64 product
constexpr int SMEM_MAX = 232448;       // per block on the H100

// what a launch computes: bf16 bands with 1-pass or split (hi + lo)
// weights; fp32 bands with bf16_3x products; fp32 bands with HIGHEST
// products; bf16 bands with fp32 weights; each fp32-weight mode with its
// weights resident or streamed a tap at a time
enum Mode {
  BF16 = 0, BF16_SPLIT = 1,
  F32_3X = 2, F32_3X_STREAM = 3,
  F32_6X = 4, F32_6X_STREAM = 5,
  W32 = 6, W32_STREAM = 7,
};
// a layer's numerics, as the C entry points take them: bf16 bands with
// bf16 weights, or with hi + lo weights; fp32 bands with bf16_3x or
// HIGHEST products; bf16 bands with fp32 weights
enum Prec { P_BF16 = 0, P_BF16_SPLIT = 1, P_HIGH = 2, P_HIGHEST = 3, P_W32 = 4 };

__host__ __device__ constexpr bool mode_f32(int m) { return m >= F32_3X && m <= F32_6X_STREAM; }
__host__ __device__ constexpr bool mode_stream(int m) {
  return m == F32_3X_STREAM || m == F32_6X_STREAM || m == W32_STREAM;
}
// bf16 planes of the staged tile and of the weights
__host__ __device__ constexpr int a_planes(int m) {
  return m == F32_3X || m == F32_3X_STREAM ? 2 : m == F32_6X || m == F32_6X_STREAM ? 3 : 1;
}
__host__ __device__ constexpr int w_planes(int m) { return m == BF16 ? 1 : m <= F32_3X_STREAM ? 2 : 3; }
// the HIGHEST mode sums its five small products in a second accumulator
// (see the kernel), so it runs 2-row tiles and at most two warpgroups
__host__ __device__ constexpr bool mode_6x(int m) { return m == F32_6X || m == F32_6X_STREAM; }
// the products of a k-step, and product p's (tile plane, weight plane):
// bf16 split (0, 0) (0, 1); bf16_3x (0, 0) (1, 0) (0, 1); HIGHEST (0, 0)
// (0, 1) (1, 0) (0, 2) (1, 1) (2, 0); fp32 weights (0, 0) (0, 1) (0, 2)
__host__ __device__ constexpr int n_products(int m) {
  return m == BF16 ? 1 : m == BF16_SPLIT ? 2 : m == F32_6X || m == F32_6X_STREAM ? 6 : 3;
}
__host__ __device__ constexpr int prod_a(int m, int p) {
  return m == F32_3X || m == F32_3X_STREAM ? (p == 1)
         : m == F32_6X || m == F32_6X_STREAM ? (p == 2 || p == 4 ? 1 : p == 5 ? 2 : 0)
                                             : 0;
}
__host__ __device__ constexpr int prod_b(int m, int p) {
  return m == F32_3X || m == F32_3X_STREAM ? (p == 2)
         : m == F32_6X || m == F32_6X_STREAM ? (p == 1 || p == 4 ? 1 : p == 3 ? 2 : 0)
                                             : p;
}

struct LayerArgs {
  const void* in0;                // [B, h0, w0, in0_stride], channels at in0_off
  int in0_c, in0_stride, in0_off, in0_h, in0_w, upsample;
  const void* aux;                // [B, H, W, aux_stride], channels at aux_off
  int aux_c, aux_stride, aux_off;
  const bf16* w;                  // [K/8][cout_pad][8] per weight plane: hi, (mid,) lo
  const float* bias;              // [cout]
  int ks, cin0_pad, cout, cout_pad, relu;
  int B, H, W;                    // output (full) resolution
  void* out;                      // [B, H, W, cout] or null
  void* pooled;                   // [B, H/2, W/2, cout] or null
  float* state;                   // [B, H, W, state_stride] or null
  int state_stride, state_off, state_zero;
};
// in0, aux, out and pooled are bf16 in the bf16-band modes and fp32 in the
// fp32-band modes (the band dtype); state is always fp32

// a launch configuration: tile rows per warpgroup, warpgroups per CTA
struct Config {
  int trw, nwg;
};

struct Smem {
  int rows_in, cols_in, plane;    // staged tile geometry; plane = bytes per channel group
  int tplane;                     // bytes from one plane of the staged tile to the next
  int w, wtap;                    // weights at w; a streamed tap's planes take wtap bytes
  int buf, buf_bytes, total;      // warpgroup g's region at buf + g * buf_bytes:
                                  // its input tile, then its band [trw][64][n]
};

__host__ __device__ inline int align128(int x) { return (x + 127) & ~127; }

__host__ __device__ inline Smem smem_layout(int ks, int cin_tot, int n, int mode, Config c) {
  Smem s;
  const int halo = ks / 2;
  s.rows_in = c.trw + 2 * halo;
  s.cols_in = TW + 2 * halo;
  s.plane = s.rows_in * s.cols_in * 16;
  s.tplane = (cin_tot / 8) * s.plane;
  s.w = 0;
  s.wtap = cin_tot * n * 2 * w_planes(mode);
  const int wbytes = mode_stream(mode) ? 2 * s.wtap : ks * ks * s.wtap;
  s.buf = align128(wbytes);
  const int tile = s.tplane * a_planes(mode), band = c.trw * TW * n * (mode_f32(mode) ? 4 : 2);
  s.buf_bytes = align128(tile > band ? tile : band);
  s.total = s.buf + c.nwg * s.buf_bytes;
  return s;
}

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

// the same for an fp32 tensor, as floats
__device__ __forceinline__ void load_f8(const float* base, size_t pixel, int stride, int off,
                                        int c0, int c, bool vec, float* v) {
  const float* p = base + pixel * stride + off + c0;
  if (vec) {
    const float4 x0 = *reinterpret_cast<const float4*>(p);
    const float4 x1 = *reinterpret_cast<const float4*>(p + 4);
    v[0] = x0.x; v[1] = x0.y; v[2] = x0.z; v[3] = x0.w;
    v[4] = x1.x; v[5] = x1.y; v[6] = x1.z; v[7] = x1.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = (c0 + k < c) ? p[k] : 0.f;
}

__device__ __forceinline__ void unpack8(uint4 u, float* v) {
  Pack8 r;
  r.u = u;
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __bfloat162float(__ushort_as_bfloat16(r.s[k]));
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  return make_uint4(wg::pack_bf16x2(v[0], v[1]), wg::pack_bf16x2(v[2], v[3]),
                    wg::pack_bf16x2(v[4], v[5]), wg::pack_bf16x2(v[6], v[7]));
}

// v = hi + lo in bf16: hi keeps the top 16 bits of each fp32 value (the
// mantissa mask of conv_pallas.py:315-323, exact in bf16), lo = bf16(v - hi)
__device__ __forceinline__ void split8(const float* v, uint4& hi, uint4& lo) {
  Pack8 h, l;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t bits = __float_as_uint(v[k]);
    h.s[k] = (unsigned short)(bits >> 16);
    l.s[k] = __bfloat16_as_ushort(__float2bfloat16_rn(v[k] - __uint_as_float(bits & 0xFFFF0000u)));
  }
  hi = h.u;
  lo = l.u;
}

// v = hi + mid + lo exactly in bf16: hi keeps the top 16 bits of each fp32
// value, mid the top 16 bits of r = v - hi, lo = r - mid (at most 8
// significant bits, so the conversion is exact); the wrapper's split3
__device__ __forceinline__ void split3_8(const float* v, uint4& hi, uint4& mid, uint4& lo) {
  Pack8 h, m, l;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t bits = __float_as_uint(v[k]);
    const float r = __fsub_rn(v[k], __uint_as_float(bits & 0xFFFF0000u));
    const uint32_t rb = __float_as_uint(r);
    h.s[k] = (unsigned short)(bits >> 16);
    m.s[k] = (unsigned short)(rb >> 16);
    l.s[k] = __bfloat16_as_ushort(__float2bfloat16_rn(__fsub_rn(r, __uint_as_float(rb & 0xFFFF0000u))));
  }
  hi = h.u;
  mid = m.u;
  lo = l.u;
}

// 8 channels of in0 at one pixel of its own grid, as floats
template <bool F32>
__device__ __forceinline__ void in0_f8(const LayerArgs& a, size_t pixel, int c0, bool vec,
                                       float* v) {
  if constexpr (F32)
    load_f8(static_cast<const float*>(a.in0), pixel, a.in0_stride, a.in0_off, c0, a.in0_c, vec, v);
  else
    unpack8(load_px8(static_cast<const bf16*>(a.in0), pixel, a.in0_stride, a.in0_off, c0,
                     a.in0_c, vec), v);
}

// 8 channels of the 2x bilinear (align_corners=False) upsample of the
// half-res in0 at full-res (gy, gx), in fp32: rows j and jn, columns i and
// ic, with weights 0.75 / 0.25 and edge replication; rows first, as
// rvdd_tpu/ops/resize.py does
template <bool F32>
__device__ __forceinline__ void load_up8(const LayerArgs& a, int b, int gy, int gx, int c0,
                                         bool vec, float* r) {
  const int j = gy >> 1, i = gx >> 1;
  const int jn = min(max((gy & 1) ? j + 1 : j - 1, 0), a.in0_h - 1);
  const int ic = min(max((gx & 1) ? i + 1 : i - 1, 0), a.in0_w - 1);
  const size_t r0 = (size_t)b * a.in0_h + j, r1 = (size_t)b * a.in0_h + jn;
  float v00[8], v01[8], v10[8], v11[8];
  in0_f8<F32>(a, r0 * a.in0_w + i, c0, vec, v00);
  in0_f8<F32>(a, r0 * a.in0_w + ic, c0, vec, v01);
  in0_f8<F32>(a, r1 * a.in0_w + i, c0, vec, v10);
  in0_f8<F32>(a, r1 * a.in0_w + ic, c0, vec, v11);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float ri = 0.75f * v00[k] + 0.25f * v10[k];
    const float rn = 0.75f * v01[k] + 0.25f * v11[k];
    r[k] = 0.75f * ri + 0.25f * rn;
  }
}

struct TileIdx {
  int b, y0, x0;
};

__device__ __forceinline__ TileIdx tile_idx(const LayerArgs& a, int t, int tr) {
  const int tiles_x = (a.W + TW - 1) / TW, tiles_y = (a.H + tr - 1) / tr;
  TileIdx ti;
  ti.b = t / (tiles_x * tiles_y);
  ti.y0 = (t / tiles_x) % tiles_y * tr;
  ti.x0 = t % tiles_x * TW;
  return ti;
}

// stage tile t's input [cg][rows_in][cols_in][8] into buf (the fp32-band
// modes: its hi plane, and its lo plane, or its mid and lo planes, each
// L.tplane bytes after the one before).  Items go to
// threads by octets of pixels: lane -> (channel group lane / 8, pixel lane
// % 8), so each quarter-warp writes one 128-byte core matrix (no bank
// conflicts) and a warp reads 4 channel groups of 8 neighbouring pixels.
// bf16 modes: cp.async for 16-byte aligned channel groups, loads and
// arithmetic for the upsample and for unaligned inputs.  fp32-band modes:
// loads, the upsample in fp32 and the split, through registers.  Zeros outside the
// image (the conv's zero padding) and in pad channels
template <int MODE>
__device__ void stage_tile(const LayerArgs& a, const Smem& L, int t, int tr,
                           unsigned char* buf, int t128) {
  constexpr bool F32 = mode_f32(MODE);
  constexpr int AP = a_planes(MODE);
  const TileIdx ti = tile_idx(a, t, tr);
  const int halo = a.ks >> 1;
  const int cg_n = (a.cin0_pad + a.aux_c) >> 3;
  const int npix = L.rows_in * L.cols_in;
  const int per = 8 * cg_n;  // items per octet of pixels
  const uint64_t magic = ((1ull << 32) + per - 1) / per;  // k / per == (k * magic) >> 32 here
  const int n = (npix + 7) / 8 * per;
  // vector loads: 16 bytes of bf16, or two 16-byte fp32 halves
  const int align = F32 ? 4 : 8;
  const bool in0_vec = (a.in0_c % 8 == 0) && (a.in0_stride % align == 0) && (a.in0_off % align == 0);
  const bool aux_vec = (a.aux_c % 8 == 0) && (a.aux_stride % align == 0) && (a.aux_off % align == 0);
  for (int k = t128; k < n; k += 128) {
    const int oct = (int)(((uint64_t)k * magic) >> 32), rem = k - oct * per;
    const int cg = rem >> 3, pix = oct * 8 + (rem & 7);
    if (pix >= npix) continue;
    const int r = halo ? pix / (TW + 2) : pix / TW;
    const int gy = ti.y0 + r - halo;
    const int gx = ti.x0 + pix - r * L.cols_in - halo;
    uint4* d = reinterpret_cast<uint4*>(buf + cg * L.plane + pix * 16);
    const int c0 = cg * 8;
    if (gy < 0 || gy >= a.H || gx < 0 || gx >= a.W || (c0 < a.cin0_pad && c0 >= a.in0_c)) {
#pragma unroll
      for (int p = 0; p < AP; ++p)
        *reinterpret_cast<uint4*>(buf + p * L.tplane + cg * L.plane + pix * 16) =
            make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const size_t pixel = ((size_t)ti.b * a.H + gy) * a.W + gx;
    if constexpr (F32) {
      float v[8];
      if (c0 >= a.cin0_pad)
        load_f8(static_cast<const float*>(a.aux), pixel, a.aux_stride, a.aux_off,
                c0 - a.cin0_pad, a.aux_c, aux_vec, v);
      else if (a.upsample)
        load_up8<true>(a, ti.b, gy, gx, c0, in0_vec, v);
      else
        in0_f8<true>(a, pixel, c0, in0_vec, v);
      uint4 hi, mid, lo;
      if constexpr (AP == 3) {
        split3_8(v, hi, mid, lo);
        *reinterpret_cast<uint4*>(buf + L.tplane + cg * L.plane + pix * 16) = mid;
      } else {
        split8(v, hi, lo);
      }
      *d = hi;
      *reinterpret_cast<uint4*>(buf + (AP - 1) * L.tplane + cg * L.plane + pix * 16) = lo;
    } else if (c0 < a.cin0_pad) {
      const bf16* in0 = static_cast<const bf16*>(a.in0);
      if (a.upsample) {
        float v[8];
        load_up8<false>(a, ti.b, gy, gx, c0, in0_vec, v);
        *d = pack8(v);
      } else if (in0_vec) {
        wg::cp_async16(d, in0 + pixel * a.in0_stride + a.in0_off + c0);
      } else {
        *d = load_px8(in0, pixel, a.in0_stride, a.in0_off, c0, a.in0_c, false);
      }
    } else {
      const bf16* aux = static_cast<const bf16*>(a.aux);
      if (aux_vec)
        wg::cp_async16(d, aux + pixel * a.aux_stride + a.aux_off + (c0 - a.cin0_pad));
      else
        *d = load_px8(aux, pixel, a.aux_stride, a.aux_off, c0 - a.cin0_pad, a.aux_c, false);
    }
  }
}

// cp.async of tap `tap`'s weights, its part of each of the WP planes in
// turn (wtap bytes in all), from the packed matrix (WP planes of
// [K/8][N][8], plane_bytes each) to dst; threads [0, nthreads)
template <int WP>
__device__ __forceinline__ void load_tap(unsigned char* dst, const bf16* w, int tap, int wtap,
                                         int plane_bytes, int tid, int nthreads) {
  const unsigned char* src = reinterpret_cast<const unsigned char*>(w);
  const int part = wtap / WP;
  for (int i = tid * 16; i < wtap; i += nthreads * 16) {
    const int p = (i >= part) + (WP == 3 && i >= 2 * part);
    wg::cp_async16(dst + i, src + p * plane_bytes + tap * part + (i - p * part));
  }
}

// the staged bf16 band [TRW][64][N] of tile ti to out and pooled
template <int N, int TRW>
__device__ __forceinline__ void store_band_bf16(const LayerArgs& a, const TileIdx& ti,
                                                const bf16* band, int t128) {
  constexpr int C8 = N / 8;
  bf16* out = static_cast<bf16*>(a.out);
  bf16* pooled = static_cast<bf16*>(a.pooled);
  if (out != nullptr) {
    if (a.cout == N) {
      for (int it = t128; it < TRW * TW * C8; it += 128) {
        const int pix = it / C8, q = it - pix * C8;
        const int gy = ti.y0 + pix / TW, gx = ti.x0 + pix % TW;
        if (gy >= a.H || gx >= a.W) continue;
        *reinterpret_cast<uint4*>(out + (((size_t)ti.b * a.H + gy) * a.W + gx) * N + q * 8) =
            *reinterpret_cast<const uint4*>(band + pix * N + q * 8);
      }
    } else {
      for (int it = t128; it < TRW * TW * a.cout; it += 128) {
        const int pix = it / a.cout, c = it - pix * a.cout;
        const int gy = ti.y0 + pix / TW, gx = ti.x0 + pix % TW;
        if (gy >= a.H || gx >= a.W) continue;
        out[(((size_t)ti.b * a.H + gy) * a.W + gx) * a.cout + c] = band[pix * N + c];
      }
    }
  }
  if (pooled != nullptr) {
    const int h2 = a.H >> 1, w2 = a.W >> 1;
    const int c8 = a.cout == N ? C8 : a.cout;  // 8-channel groups, or single channels
    for (int it = t128; it < (TRW / 2) * (TW / 2) * c8; it += 128) {
      const int q = it % c8, pq = it / c8;
      const int py = pq / (TW / 2), px = pq % (TW / 2);
      const int gy2 = (ti.y0 >> 1) + py, gx2 = (ti.x0 >> 1) + px;
      if (gy2 >= h2 || gx2 >= w2) continue;
      const size_t o = (((size_t)ti.b * h2 + gy2) * w2 + gx2) * a.cout;
      if (a.cout == N) {
        const bf16* s0 = band + ((2 * py) * TW + 2 * px) * N + q * 8;
        float m[8], v[8];
        unpack8(*reinterpret_cast<const uint4*>(s0), m);
        const int others[3] = {N, TW * N, TW * N + N};
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          unpack8(*reinterpret_cast<const uint4*>(s0 + others[k]), v);
#pragma unroll
          for (int e = 0; e < 8; ++e) m[e] = fmaxf(m[e], v[e]);
        }
        *reinterpret_cast<uint4*>(pooled + o + q * 8) = pack8(m);
      } else {
        const bf16* s0 = band + ((2 * py) * TW + 2 * px) * N + q;
        const float mx = fmaxf(fmaxf(__bfloat162float(s0[0]), __bfloat162float(s0[N])),
                               fmaxf(__bfloat162float(s0[TW * N]), __bfloat162float(s0[TW * N + N])));
        pooled[o + q] = __float2bfloat16_rn(mx);
      }
    }
  }
}

// the staged fp32 band [TRW][64][N] of tile ti to out and pooled (fp32)
template <int N, int TRW>
__device__ __forceinline__ void store_band_f32(const LayerArgs& a, const TileIdx& ti,
                                               const float* band, int t128) {
  constexpr int C4 = N / 4;
  float* out = static_cast<float*>(a.out);
  float* pooled = static_cast<float*>(a.pooled);
  if (out != nullptr) {
    if (a.cout == N) {
      for (int it = t128; it < TRW * TW * C4; it += 128) {
        const int pix = it / C4, q = it - pix * C4;
        const int gy = ti.y0 + pix / TW, gx = ti.x0 + pix % TW;
        if (gy >= a.H || gx >= a.W) continue;
        *reinterpret_cast<float4*>(out + (((size_t)ti.b * a.H + gy) * a.W + gx) * N + q * 4) =
            *reinterpret_cast<const float4*>(band + pix * N + q * 4);
      }
    } else {
      for (int it = t128; it < TRW * TW * a.cout; it += 128) {
        const int pix = it / a.cout, c = it - pix * a.cout;
        const int gy = ti.y0 + pix / TW, gx = ti.x0 + pix % TW;
        if (gy >= a.H || gx >= a.W) continue;
        out[(((size_t)ti.b * a.H + gy) * a.W + gx) * a.cout + c] = band[pix * N + c];
      }
    }
  }
  if (pooled != nullptr) {
    const int h2 = a.H >> 1, w2 = a.W >> 1;
    const int c4 = a.cout == N ? C4 : a.cout;  // 4-channel groups, or single channels
    for (int it = t128; it < (TRW / 2) * (TW / 2) * c4; it += 128) {
      const int q = it % c4, pq = it / c4;
      const int py = pq / (TW / 2), px = pq % (TW / 2);
      const int gy2 = (ti.y0 >> 1) + py, gx2 = (ti.x0 >> 1) + px;
      if (gy2 >= h2 || gx2 >= w2) continue;
      const size_t o = (((size_t)ti.b * h2 + gy2) * w2 + gx2) * a.cout;
      if (a.cout == N) {
        const float* s0 = band + ((2 * py) * TW + 2 * px) * N + q * 4;
        float4 m = *reinterpret_cast<const float4*>(s0);
        const int others[3] = {N, TW * N, TW * N + N};
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float4 v = *reinterpret_cast<const float4*>(s0 + others[k]);
          m = make_float4(fmaxf(m.x, v.x), fmaxf(m.y, v.y), fmaxf(m.z, v.z), fmaxf(m.w, v.w));
        }
        *reinterpret_cast<float4*>(pooled + o + q * 4) = m;
      } else {
        const float* s0 = band + ((2 * py) * TW + 2 * px) * N + q;
        pooled[o + q] = fmaxf(fmaxf(s0[0], s0[N]), fmaxf(s0[TW * N], s0[TW * N + N]));
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 16) wg::wgmma_ss_n16(d, da, db, acc);
  else if constexpr (N == 32) wg::wgmma_ss_n32(d, da, db, acc);
  else wg::wgmma_ss_n48(d, da, db, acc);
}

// N = cout_pad; TRW = tile rows of a warpgroup (one m64 accumulator each);
// MODE (a template parameter: a branch between the wgmma makes ptxas
// serialize them) picks the products and the band dtype.  Each warpgroup
// walks its own tiles in its own shared-memory region, so one warpgroup's
// staging and epilogue overlap another's products; a streamed layer runs
// one warpgroup a CTA.
template <int N, int TRW, int MODE>
__global__ void __launch_bounds__(mode_6x(MODE) ? 256 : 384) conv_layer_kernel(const LayerArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool F32 = mode_f32(MODE), STREAM = mode_stream(MODE), SMALL = mode_6x(MODE);
  constexpr int WP = w_planes(MODE), NP = n_products(MODE);
  constexpr int NACC = N / 2, C8 = N / 8;
  const int nwg = blockDim.x >> 7;
  const int cin_tot = a.cin0_pad + a.aux_c;  // a multiple of 16
  const int kch = cin_tot >> 4;
  const int K = a.ks * a.ks * cin_tot;
  const int taps = a.ks * a.ks;
  const Smem L = smem_layout(a.ks, cin_tot, N, MODE, Config{TRW, nwg});
  const int tid = threadIdx.x, g = tid >> 7, t128 = tid & 127;
  const int warp_in = t128 >> 5, lane = tid & 31;
  const int tiles_x = (a.W + TW - 1) / TW, tiles_y = (a.H + TRW - 1) / TRW;
  const int ntiles = tiles_x * tiles_y * a.B;
  const int t0 = blockIdx.x * nwg + g, stride = gridDim.x * nwg;
  unsigned char* buf = smem + L.buf + g * L.buf_bytes;
  const int hi_bytes = K * N * 2;  // bytes of one weight plane

  // ---- the layer's packed weights, once per CTA (a streamed layer: its
  // first tap), and the first tile
  if constexpr (STREAM) {
    load_tap<WP>(smem + L.w, a.w, 0, L.wtap, hi_bytes, tid, blockDim.x);
  } else {
    const int wbytes = hi_bytes * WP;
    for (int i = tid * 16; i < wbytes; i += blockDim.x * 16)
      wg::cp_async16(smem + L.w + i, reinterpret_cast<const unsigned char*>(a.w) + i);
  }
  if (t0 < ntiles) stage_tile<MODE>(a, L, t0, TRW, buf, t128);
  wg::cp_async_commit();
  wg::cp_async_wait<0>();
  wg::fence_async_smem();
  __syncthreads();

  // this thread's bias values: channels 8 j + 2 (lane % 4) + {0, 1}
  float bias[C8][2];
#pragma unroll
  for (int j = 0; j < C8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * (lane & 3) + e;
      bias[j][e] = c < a.cout ? __ldg(a.bias + c) : 0.f;
    }
  const uint32_t w_base = wg::smem_addr(smem + L.w);
  const uint32_t a_base = wg::smem_addr(buf);
  const bool st_vec = (a.state_stride % 2 == 0) && (a.state_off % 2 == 0);
  int slot = 0;  // a streamed layer: the weight buffer of the tap about to run
  PHASE_CLOCK(long long ph[3] = {0, 0, 0}; long long c0 = 0, c1 = 0; int nt = 0;)
  for (int t = t0; t < ntiles; t += stride) {
    PHASE_CLOCK(c0 = clock64();)
    wg::cp_async_wait<0>();
    wg::fence_async_smem();
    wg::bar_warpgroup(g);
    PHASE_CLOCK(c1 = clock64(); ph[0] += c1 - c0;)  // phase 0: waiting for the tile

    // ---- the products: TRW rows of 64 pixels over all taps and 16-channel
    // steps; the first product starts each sum.  The tensor cores truncate
    // what an accumulation drops below the accumulator's last bit, so each
    // wgmma into an accumulator biases it toward zero by up to an ulp: the
    // HIGHEST mode's five small products (2^-8 of hi.hi and below) go to
    // acc2, whose ulp is 2^-8 of acc's, and acc takes one wgmma a k-step
    // (one accumulator: a mean error of 1.6e-5 x std over chain A's four
    // layers on the H100, against 1.5e-7 for the products alone)
    float acc[TRW][NACC], acc2[TRW][NACC];
    wg::fence();
#pragma unroll 1
    for (int dy = 0; dy < a.ks; ++dy) {
#pragma unroll 1
      for (int dx = 0; dx < a.ks; ++dx) {
        const int tap = dy * a.ks + dx;
        const uint32_t a_tap = a_base + (dy * L.cols_in + dx) * 16;
        uint32_t wh, wstride;  // weight plane 0 of this tap, and the bytes to the next plane
        if constexpr (STREAM) {
          if (tap > 0) {  // this tap's weights are in; the last tap's products are done
            wg::cp_async_wait<0>();
            wg::fence_async_smem();
            wg::bar_warpgroup(g);
          }
          // the next tap (after the last: the next tile's first) into the
          // other buffer
          if (tap + 1 < taps || t + stride < ntiles)
            load_tap<WP>(smem + L.w + (slot ^ 1) * L.wtap, a.w, tap + 1 < taps ? tap + 1 : 0,
                         L.wtap, hi_bytes, t128, 128);
          wg::cp_async_commit();
          wh = w_base + slot * L.wtap;
          wstride = L.wtap / WP;
          wg::fence();
        } else {
          wh = w_base + tap * kch * N * 32;
          wstride = hi_bytes;
        }
#pragma unroll 1
        for (int kc = 0; kc < kch; ++kc) {
          const int accumulate = (tap + kc) > 0;
          const uint32_t wo = kc * N * 32;
          const uint32_t ak = a_tap + 2 * kc * L.plane;
          // the mode's products (tile plane, weight plane), each over the rows
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const uint64_t db = wg::desc(wh + prod_b(MODE, p) * wstride + wo, N * 16, 128);
            const uint32_t ap = ak + prod_a(MODE, p) * L.tplane;
#pragma unroll
            for (int r = 0; r < TRW; ++r) {
              const uint64_t da = wg::desc(ap + r * L.cols_in * 16, L.plane, 128);
              if (SMALL && p > 0)
                mma<N>(acc2[r], da, db, p == 1 ? accumulate : 1);
              else
                mma<N>(acc[r], da, db, p == 0 ? accumulate : 1);
            }
          }
        }
        if constexpr (STREAM) {
          wg::commit();
          wg::wait<0>();
#pragma unroll
          for (int r = 0; r < TRW; ++r) {
            wg::fence_regs(acc[r]);
            if constexpr (SMALL) wg::fence_regs(acc2[r]);
          }
          slot ^= 1;
        }
      }
    }
    if constexpr (!STREAM) {
      wg::commit();
      wg::wait<0>();
#pragma unroll
      for (int r = 0; r < TRW; ++r) {
        wg::fence_regs(acc[r]);
        if constexpr (SMALL) wg::fence_regs(acc2[r]);
      }
    }
    PHASE_CLOCK(c0 = clock64(); ph[1] += c0 - c1;)  // phase 1: the products
    wg::bar_warpgroup(g);  // the input tile is consumed: the region takes the band

    // ---- epilogue from registers: bias, act, fp32 state, band staged
    const TileIdx ti = tile_idx(a, t, TRW);
#pragma unroll
    for (int r = 0; r < TRW; ++r) {
      const int gy = ti.y0 + r;
#pragma unroll
      for (int j = 0; j < C8; ++j) {
        const int c = 8 * j + 2 * (lane & 3);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 16 * warp_in + (lane >> 2) + 8 * h;
          const int i0 = 4 * j + 2 * h;
          float v0 = (SMALL ? acc[r][i0] + acc2[r][i0] : acc[r][i0]) + bias[j][0];
          float v1 = (SMALL ? acc[r][i0 + 1] + acc2[r][i0 + 1] : acc[r][i0 + 1]) + bias[j][1];
          if (a.relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          if constexpr (F32)
            *reinterpret_cast<float2*>(reinterpret_cast<float*>(buf) + (r * TW + m) * N + c) =
                make_float2(v0, v1);
          else
            *reinterpret_cast<uint32_t*>(reinterpret_cast<bf16*>(buf) + (r * TW + m) * N + c) =
                wg::pack_bf16x2(v0, v1);
          const int gx = ti.x0 + m;
          if (a.state != nullptr && gy < a.H && gx < a.W && c < a.cout) {
            float* st = a.state + (((size_t)ti.b * a.H + gy) * a.W + gx) * a.state_stride +
                        a.state_off + c;
            if (c + 1 < a.cout && st_vec) {
              *reinterpret_cast<float2*>(st) = make_float2(v0, v1);
            } else {
              st[0] = v0;
              if (c + 1 < a.cout) st[1] = v1;
            }
            if (c == 0)
              for (int z = 0; z < a.state_zero; ++z) st[a.cout + z] = 0.f;
          }
        }
      }
    }
    wg::bar_warpgroup(g);

    // ---- band and pool from the staged band: 16-byte stores where the
    // layer's channels fill N
    if constexpr (F32)
      store_band_f32<N, TRW>(a, ti, reinterpret_cast<const float*>(buf), t128);
    else
      store_band_bf16<N, TRW>(a, ti, reinterpret_cast<const bf16*>(buf), t128);
    wg::bar_warpgroup(g);  // the band is out: stage the next tile
    if (t + stride < ntiles) stage_tile<MODE>(a, L, t + stride, TRW, buf, t128);
    wg::cp_async_commit();
    PHASE_CLOCK(ph[2] += clock64() - c0; ++nt;)  // phase 2: epilogue and staging
  }
  PHASE_CLOCK(wg::phase_clocks_add(ph, nt);)
  wg::cp_async_wait<0>();
}

// the configurations in order of preference: the first whose shared memory
// fits is launched (a streamed layer takes one warpgroup a CTA; the HIGHEST
// mode's two accumulators a row take 2-row tiles and at most 255 registers
// a thread, so two warpgroups)
constexpr Config CONFIGS[] = {{4, 3}, {2, 3}, {2, 2}, {2, 1}};
constexpr Config STREAM_CONFIGS[] = {{4, 1}, {2, 1}};
constexpr Config CONFIGS_6X[] = {{2, 2}, {2, 1}};
constexpr Config STREAM_CONFIGS_6X[] = {{2, 1}};

template <int N, int TRW, int MODE>
cudaError_t launch(const LayerArgs& a, Config c, int smem, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(conv_layer_kernel<N, TRW, MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv_layer_kernel<N, TRW, MODE>,
                                                      128 * c.nwg, smem);
  if (e != cudaSuccess) return e;
  const long long ntiles = (long long)((a.W + TW - 1) / TW) * ((a.H + TRW - 1) / TRW) * a.B;
  const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long ctas = (ntiles + c.nwg - 1) / c.nwg;
  const int grid = (int)(ctas < slots ? ctas : slots);
  conv_layer_kernel<N, TRW, MODE><<<grid, 128 * c.nwg, smem, s>>>(a);
  return cudaGetLastError();
}

// the first configuration of `mode` whose shared memory fits, or {0, 0}
Config pick(const LayerArgs& a, int n, int mode) {
  const bool stream = mode_stream(mode), six = mode_6x(mode);
  const Config* cs = six ? (stream ? STREAM_CONFIGS_6X : CONFIGS_6X)
                         : (stream ? STREAM_CONFIGS : CONFIGS);
  const int nc = six ? (stream ? 1 : 2) : (stream ? 2 : 4);
  for (int i = 0; i < nc; ++i)
    if (smem_layout(a.ks, a.cin0_pad + a.aux_c, n, mode, cs[i]).total <= SMEM_MAX) return cs[i];
  return Config{0, 0};
}

struct Plan {
  int mode;
  Config c;  // {0, 0}: nothing fits
};

// a layer's mode and configuration, a function of its shape and its
// numerics alone.  The bf16 numerics keep the weights resident (split ones
// too); the fp32-band and fp32-weight numerics keep them resident where a
// configuration fits and stream them a tap at a time otherwise (the
// layers with K = 864)
Plan plan(const LayerArgs& a, int n, int prec) {
  if (prec == P_BF16 || prec == P_BF16_SPLIT) {
    const int m = prec == P_BF16_SPLIT ? BF16_SPLIT : BF16;
    return Plan{m, pick(a, n, m)};
  }
  const int m = prec == P_HIGH ? F32_3X : prec == P_HIGHEST ? F32_6X : W32;
  const Config c = pick(a, n, m);
  return c.nwg ? Plan{m, c} : Plan{m + 1, pick(a, n, m + 1)};
}

template <int N, int MODE>
cudaError_t launch_mode(const LayerArgs& a, Config c, cudaStream_t s) {
  const int smem = smem_layout(a.ks, a.cin0_pad + a.aux_c, N, MODE, c).total;
  if constexpr (mode_6x(MODE)) return launch<N, 2, MODE>(a, c, smem, s);
  else return c.trw == 4 ? launch<N, 4, MODE>(a, c, smem, s) : launch<N, 2, MODE>(a, c, smem, s);
}

template <int N>
cudaError_t launch_plan(const LayerArgs& a, Plan p, cudaStream_t s) {
  if (p.c.nwg == 0) return cudaErrorInvalidValue;  // no configuration fits
  switch (p.mode) {
    case BF16: return launch_mode<N, BF16>(a, p.c, s);
    case BF16_SPLIT: return launch_mode<N, BF16_SPLIT>(a, p.c, s);
    case F32_3X: return launch_mode<N, F32_3X>(a, p.c, s);
    case F32_3X_STREAM: return launch_mode<N, F32_3X_STREAM>(a, p.c, s);
    case F32_6X: return launch_mode<N, F32_6X>(a, p.c, s);
    case F32_6X_STREAM: return launch_mode<N, F32_6X_STREAM>(a, p.c, s);
    case W32: return launch_mode<N, W32>(a, p.c, s);
    default: return launch_mode<N, W32_STREAM>(a, p.c, s);
  }
}

bool bad_shape(int ks, int cin_tot, int prec) {
  return cin_tot % 16 || cin_tot <= 0 || (ks != 1 && ks != 3) || prec < P_BF16 || prec > P_W32;
}

}  // namespace

extern "C" {

const char* rvdd_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// One conv layer; see LayerArgs for the tensors.  The caller guarantees
// cin0_pad % 16 == 0, aux_c % 16 == 0, cout_pad in {16, 32, 48},
// cout <= cout_pad, H == 2*in0_h and W == 2*in0_w when upsample, even H
// and W when pooled, 16-byte aligned tensors, and w packed by the wrapper's
// pack_kmajor, per plane, in the order of prec, the layer's numerics (enum
// Prec): 0 bf16 bands, weights hi; 1 bf16 bands, weights hi and lo; 2 fp32
// bands with bf16_3x products, weights hi and lo; 3 fp32 bands with
// HIGHEST products, weights hi, mid and lo; 4 bf16 bands with fp32
// weights, hi, mid and lo.  in0, aux, out and pooled are fp32 under 2 and
// 3, bf16 under the others.  Returns a cudaError_t as int.
int rvdd_conv_layer(const void* in0, int in0_c, int in0_stride, int in0_off,
                    int in0_h, int in0_w, int upsample,
                    const void* aux, int aux_c, int aux_stride, int aux_off,
                    const void* w, int prec, const void* bias,
                    int ks, int cin0_pad, int cout, int cout_pad, int relu,
                    int B, int H, int W,
                    void* out, void* pooled,
                    void* state, int state_stride, int state_off, int state_zero,
                    void* stream) {
  LayerArgs a;
  a.in0 = in0; a.in0_c = in0_c; a.in0_stride = in0_stride;
  a.in0_off = in0_off; a.in0_h = in0_h; a.in0_w = in0_w; a.upsample = upsample;
  a.aux = aux; a.aux_c = aux_c; a.aux_stride = aux_stride; a.aux_off = aux_off;
  a.w = (const bf16*)w; a.bias = (const float*)bias;
  a.ks = ks; a.cin0_pad = cin0_pad; a.cout = cout; a.cout_pad = cout_pad; a.relu = relu;
  a.B = B; a.H = H; a.W = W;
  a.out = out; a.pooled = pooled;
  a.state = (float*)state; a.state_stride = state_stride; a.state_off = state_off;
  a.state_zero = state_zero;

  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (bad_shape(ks, cin0_pad + aux_c, prec)) {
    e = cudaErrorInvalidValue;
  } else {
    const Plan p = plan(a, cout_pad, prec);
    switch (cout_pad) {
      case 16: e = launch_plan<16>(a, p, s); break;
      case 32: e = launch_plan<32>(a, p, s); break;
      case 48: e = launch_plan<48>(a, p, s); break;
      default: e = cudaErrorInvalidValue;
    }
  }
  if (e != cudaSuccess) cudaGetLastError();  // clear it; report it once
  return (int)e;
}

// The launch plan of a layer of that shape (K = ks^2 * cin_tot) in the
// numerics prec, as rvdd_conv_layer makes it: out[0] the mode (enum Mode:
// 0 bf16, 1 bf16 with split weights, 2 and 3 fp32 bands with bf16_3x
// products, 4 and 5 fp32 bands with HIGHEST products, 6 and 7 bf16 bands
// with fp32 weights, the weights resident in the first of each pair and
// streamed in the second), out[1] the tile rows, out[2] the warpgroups a
// CTA, out[3] the shared memory a CTA.  Returns a cudaError_t as int:
// cudaErrorInvalidValue for a shape the kernel does not take or that fits
// no configuration.
int rvdd_conv_layer_plan(int ks, int cin_tot, int cout_pad, int prec, int* out) {
  if (bad_shape(ks, cin_tot, prec) || (cout_pad != 16 && cout_pad != 32 && cout_pad != 48))
    return (int)cudaErrorInvalidValue;
  LayerArgs a = {};
  a.ks = ks;
  a.cin0_pad = cin_tot;
  const Plan p = plan(a, cout_pad, prec);
  if (p.c.nwg == 0) return (int)cudaErrorInvalidValue;
  out[0] = p.mode;
  out[1] = p.c.trw;
  out[2] = p.c.nwg;
  out[3] = smem_layout(ks, cin_tot, cout_pad, p.mode, p.c).total;
  return 0;
}

}  // extern "C"

