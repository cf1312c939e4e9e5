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
//     mxu_precision='high', conv_pallas.py:306-327 and :574-580), on the
//     warp-specialized body (ws::, see below): inputs, bands and emitted
//     outputs are fp32 in global memory; the tile is staged as fp32, and
//     each k-step's A values are split in registers by their mantissa (hi =
//     the top 16 bits, exact in bf16; lo = bf16(v - hi), rounded to
//     nearest) into two bf16 fragments; every layer's weights are split the
//     same way into two planes, and each k-step issues three register-A
//     wgmma into one accumulator, a_hi.w_hi, a_lo.w_hi and a_hi.w_lo (the
//     lo.lo term, about 2^-16 relative, is dropped as on the TPU).  TF32
//     wgmma would keep 10 mantissa bits against about 16 here;
//   * fp32 bands with HIGHEST products (band_dtype=float32,
//     mxu_precision='highest', fp32 weights: rvdd_tpu's 'accurate',
//     conv_pallas.py:288-304), on the same body: each k-step's A values are
//     split in registers into three bf16 fragments, hi + mid + lo = v
//     exactly (hi and mid by mantissa masks, lo the rest, at most 8
//     significant bits); the weights are packed as three such planes, and
//     each k-step issues six register-A wgmma: hi.hi, hi.mid, mid.hi,
//     hi.lo, mid.mid and lo.hi, the terms HIGHEST keeps (the three dropped
//     ones are below 2^-24 of the product), as convnext_chain.cu's fp32
//     mode does;
//   * bf16 bands with fp32 weights (weight_dtype=float32 at 'highest',
//     rvdd_tpu's 'wf32', conv_pallas.py:295-296), on the same body: the
//     tile is staged as bf16, the weights are three planes, and each k-step
//     reads its A fragment once and issues three register-A wgmma into one
//     accumulator, w_hi a + w_mid a + w_lo a, exact in the weights (a is
//     bf16) up to the fp32 sums' order.
// The mode is a template parameter of the kernel: a branch between wgmma
// makes ptxas serialize them.  The bf16 modes run the serial body
// (conv_layer_kernel); the others the warp-specialized one
// (ws::ws_layer_kernel), with a traits type as its numerics parameter
// (ws::HighNum, HighestNum, W32Num: band dtype, A and weight planes, tile
// rows).
//
// What bounds it on the H100: operations.  The six chains of a 1080p frame
// need about 1.07 TFLOP (with dec2's split layers): about 1.0 ms at the
// 989 TFLOP/s bf16 dense peak, against about 0.3 ms for their bytes.  Their
// 0.98 TFLOP count three bf16 products each with fp32 weights or in the
// bf16_3x mode (about 3.0 ms) and six in the HIGHEST mode (about 5.9 ms).
// The layer is a GEMM of M = pixels, N = cout_pad (48, 16 for the head), K
// = ks^2 * (cin0_pad + aux_c) (144 to 864).  The serial body's design (the
// bf16 modes):
//   * a persistent CTA of two or three warpgroups keeps the layer's whole
//     packed weight matrix ([K/8][N][8] bf16, the wgmma B layout; both
//     halves of a split layer, at most 83 KB) in shared memory, loaded once;
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
//     copy (the upsample layer and a 6-channel input build their tile with
//     loads and arithmetic instead);
//   * the warpgroup holds one m64nN accumulator per tile row and issues
//     ks^2 * cin/16 k-steps per row, each of the mode's products (one
//     wgmma m64nNk16; two for a split layer), the first with scale-d 0,
//     before one wait;
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
// The warp-specialized body (ws::).  In the serial body fp32 bands made
// staging (latency-bound loads through registers and the split into shared
// memory) and the epilogue its limits: a warpgroup's 2x64 tile of a 48 ->
// 48 layer at 1080p took 28,400 cycles in the bf16_3x mode, 21,800 of them
// staging and epilogue, and 29,500 in the HIGHEST mode; the fp32-weight
// mode's 4x64 tile took 22,900, staging and epilogue 10,900 of it, and its
// K = 864 layers (three planes, 248,832 bytes, above the 232,448 a block
// may have) streamed a tap at a time in one warpgroup a CTA, 1.80 ms a
// 1080p layer (probe on the H100).  Its design:
//   * a CTA of three warpgroups an SM (384 threads; setmaxnreg 104 for the
//     producer and 200 for the consumers in the HIGHEST mode, 120 and 192
//     in the bf16_3x mode, 88 and 208 with fp32 weights): warpgroup 2, the
//     producer, stages each tile's input a tile ahead into one of two
//     regions [channel group of 8][row][column][8] with TMA (a box per
//     channel group, each at a 128-byte boundary; zeros filled outside the
//     image and past in0's channels), a streamed layer's a 48-channel slab
//     at a time, with each tap of the slab's weights in two or three bulk
//     copies (a plane each) into a ring of NW = 4 stages; FULL is an
//     mbarrier, EMPTY a named barrier.  The fp32 bands take tiles of 2
//     rows x 64 (32 bytes a pixel-group), bf16 bands 4 x 64 (16 bytes);
//   * warpgroups 0 and 1, the consumers, take 32 columns of each row pair
//     as an m64 operand (a thread holds a pixel and the one below it, so
//     the 2x2 pool is one shuffle); on fp32 bands a k16 step loads the
//     thread's 8 fp32 values (a warp reads 256 contiguous bytes a load) and
//     splits them into the numerics' fragments; on bf16 bands one
//     ldmatrix.x4 an operand reads the step's A fragment (the region's
//     8-pixel x 8-channel core matrices are its 128-byte rows) once for the
//     three weight planes, so a k-step of the two operands reads 2 KB of A
//     and 4.5 KB of B where an SS wgmma per plane read 10.5 KB; a tap's
//     three steps are one group of register-A wgmma (HIGHEST: 18, hi.hi
//     into acc and the five small products into acc2; bf16_3x: 9 into acc;
//     fp32 weights: 18, 9 an operand, into acc), double-buffered: tap t + 1
//     is loaded while tap t's products run (wait<1>);
//   * the epilogue runs from registers into a result array: bias, act,
//     band, state and pool.  On bf16 bands each warp writes its 8 columns
//     of the band to a staging buffer and one TMA store takes them out
//     while the next tile's products run;
//   * an upsample layer (3x3, its half-res input whole channel groups, no
//     aux) keeps its weights beside one region and two TMA windows of its
//     half-res input [rows / 2 + 2][36][cin], fetched two tiles ahead and
//     interpolated by all 384 threads between the consumers' tiles (in
//     fp32, rounded once to bf16 on bf16 bands); a 9-channel or unaligned
//     input is staged through registers.
// Budgets (bytes of the 232,448), HIGHEST / bf16_3x / fp32 weights: K =
// 432 (48 -> 48): weights 124,416 / 82,944 / 124,416 beside two regions of
// 50,688 / 50,688 / 38,400, the fp32 weights' two staged bands of 12,288
// and 128 of mbarriers: 225,920 / 184,448 / 225,920.  An upsample K = 432
// layer: weights, one region and two windows of 20,736 / 20,736 / 13,824:
// 216,704 / 175,232 / 215,168.  K = 864 (48 + 48 aux): four weight stages
// of 13,824 / 9,216 / 13,824 beside two 48-channel slab regions: 156,800 /
// 138,368 / 156,800; every tile reloads the layer's 248,832 / 165,888 /
// 248,832 bytes of weights from L2: 1,944 / 1,296 / 972 bytes a pixel (the
// 4-row bf16 tile halves them; 2-row tiles would read 4.0 GB a 1080p
// layer).  Resident bf16_3x weights do not fit beside two slabs of 32
// channels (233,600); beside two of 16 (199,808) they would, at six slabs a
// tile of one k-step groups.  The plan is a function of the layer's shape
// and numerics: the upsample form, else resident, else streamed with the
// fewest slabs that fit (ws::plan_form, mirrored by
// ops/cuda/conv_chain.py:ws_plan), else the launch fails with
// cudaErrorInvalidValue.  Registers: 168 at launch, no spill (at 88 / 208
// the HIGHEST producer spilled up to 260 bytes, at 104 / 200 the bf16_3x
// one 8 with N = 16).
// Measured on the H100 (probe, cycles a tile of a 48 -> 48 layer at
// 1080p).  Per-thread cp.async staging took 20,700 a 2x64 fp32 tile for its
// 50,688 bytes, whatever the read order or cache hint, and slowed the
// consumers; TMA takes 1,000-1,700 to issue.  HIGHEST: one k-step a group
// of 6 wgmma, 15,600 of products, whatever the depth of the pipeline or the
// number of accumulators (three or four shortened the dependent chains by
// 5%); a tap a group of 18, 9,800 (7,776 at the tensor peak), and an
// epilogue of 2,400.  bf16_3x: a tap a group of 9, 6,900-7,050 of products
// (3,888 at the peak: the consumers' loads and split on the CUDA cores take
// about as long as the products) and 2,300 of epilogue, 9,400 a tile of
// the SM against the serial body's 14,200; two taps a group of 18 (eight
// weight stages), 7,220 against 6,858 in the same run; a second
// accumulator for lo.hi and hi.lo, 6,940 against 7,031 and an epilogue of
// 2,363 against 2,307, the same time; three fragment buffers (two groups in
// flight while the next tap loads), chain A 3.11-3.14 ms against 3.07; the
// second consumer started 2,300 or 4,700 cycles late, within 1.5%: all
// dropped.  fp32 weights, a 4x64 tile: products 7,540 (7,776 at the
// tensor peak for the two consumers together) and an epilogue of 3,200, the
// layer 0.41 ms against the serial body's 0.55; the K = 864 layer 17,400
// and 2,700, 2,100 waiting (1,200 of it for weight stages), 0.75 ms
// against 1.80; the upsample layer 4,200 interpolating, 8,700 of products,
// 0.59 ms against 0.85; the 9-channel K = 144 layer is the producer's
// (7,400 staging through registers), 0.29 ms against 0.30.  Tried on it and
// dropped: 4-byte band stores straight from the accumulator layout, an
// epilogue of 7,300 and the K = 432 layer 0.54 ms against 0.45 with TMA
// stores (separate calls); then, each in turns with the kept body in one
// call: one staging buffer and TMA store a consumer behind two named
// barriers, the six 1080p chains 2% slower than a buffer and store a warp;
// the state and pool stores deferred under the next tile's first four tap
// groups (their results held in 48 registers across those products), 9.5%
// slower (6.20 against 5.62 ms), and the band's staging deferred there
// too, about 3% slower still (separate calls); a second accumulator for
// w_mid a and w_lo a, mean errors 3.2-5.5 times lower but 20-44 bytes of
// spill and chain B 4.5% slower (0.368 against 0.352 ms); the producer's
// register staging eight items at once, spilling 60-160 bytes, 1% slower;
// an item-major bf16 interpolation, dec2 1.3% slower than a pixel a
// thread.  With four fragment buffers (wait<3>) ptxas gave the lo
// fragments of consecutive steps one register quad and the outputs were
// wrong; two are right.  An epilogue that wrote its results into the
// accumulators made ptxas serialize every wgmma of the kernel (C7515,
// reported as info, not as a warning).  An upsample layer's producer
// interpolating through registers took 28,800 a 2x64 fp32 tile; from TMA
// windows alone 16,000; with all threads 3,300-3,400 of the producer's and
// 4,700 of the consumers' waiting.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TW = 64;                 // output columns per tile: one m64 product
constexpr int SMEM_MAX = 232448;       // per block on the H100

// what a launch computes: bf16 bands with 1-pass or split (hi + lo)
// weights on the serial body conv_layer_kernel; fp32 bands with bf16_3x or
// HIGHEST products, and bf16 bands with fp32 weights, on the
// warp-specialized body (ws:: below), each with its weights resident,
// streamed (a tap of a channel slab at a time) or, for an upsample layer,
// resident beside windows of its half-res input
enum Mode {
  BF16 = 0, BF16_SPLIT = 1,
  HIGH = 2, HIGH_STREAM = 3,
  HX = 4, HX_STREAM = 5,
  W32 = 6, W32_STREAM = 7,
  HX_UP = 8, HIGH_UP = 9, W32_UP = 10,
};
// a layer's numerics, as the C entry points take them: bf16 bands with
// bf16 weights, or with hi + lo weights; fp32 bands with bf16_3x or
// HIGHEST products; bf16 bands with fp32 weights
enum Prec { P_BF16 = 0, P_BF16_SPLIT = 1, P_HIGH = 2, P_HIGHEST = 3, P_W32 = 4 };

// the modes of conv_layer_kernel, BF16 and BF16_SPLIT: its bf16 weight
// planes, and the products of a k-step (product p multiplies the staged
// bf16 tile by weight plane p: hi; hi, lo)
__host__ __device__ constexpr int w_planes(int m) { return m == BF16 ? 1 : 2; }

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
  int w;                          // the weights at w
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
  s.w = 0;
  s.buf = align128(ks * ks * cin_tot * n * 2 * w_planes(mode));
  const int tile = (cin_tot / 8) * s.plane, band = c.trw * TW * n * 2;
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

// 8 channels of the bf16 in0 at one pixel of its own grid, as floats
__device__ __forceinline__ void in0_f8(const LayerArgs& a, size_t pixel, int c0, bool vec,
                                       float* v) {
  unpack8(load_px8(static_cast<const bf16*>(a.in0), pixel, a.in0_stride, a.in0_off, c0, a.in0_c,
                   vec), v);
}

// 8 channels of the 2x bilinear (align_corners=False) upsample of the
// half-res in0 at full-res (gy, gx), in fp32: rows j and jn, columns i and
// ic, with weights 0.75 / 0.25 and edge replication; rows first, as
// rvdd_tpu/ops/resize.py does
__device__ __forceinline__ void load_up8(const LayerArgs& a, int b, int gy, int gx, int c0,
                                         bool vec, float* r) {
  const int j = gy >> 1, i = gx >> 1;
  const int jn = min(max((gy & 1) ? j + 1 : j - 1, 0), a.in0_h - 1);
  const int ic = min(max((gx & 1) ? i + 1 : i - 1, 0), a.in0_w - 1);
  const size_t r0 = (size_t)b * a.in0_h + j, r1 = (size_t)b * a.in0_h + jn;
  float v00[8], v01[8], v10[8], v11[8];
  in0_f8(a, r0 * a.in0_w + i, c0, vec, v00);
  in0_f8(a, r0 * a.in0_w + ic, c0, vec, v01);
  in0_f8(a, r1 * a.in0_w + i, c0, vec, v10);
  in0_f8(a, r1 * a.in0_w + ic, c0, vec, v11);
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

// stage tile t's input [cg][rows_in][cols_in][8] into buf.  Items go to
// threads by octets of pixels: lane -> (channel group lane / 8, pixel lane
// % 8), so each quarter-warp writes one 128-byte core matrix (no bank
// conflicts) and a warp reads 4 channel groups of 8 neighbouring pixels:
// cp.async for 16-byte aligned channel groups, loads and arithmetic for
// the upsample and for unaligned inputs.  Zeros outside the image (the
// conv's zero padding) and in pad channels
__device__ void stage_tile(const LayerArgs& a, const Smem& L, int t, int tr, unsigned char* buf,
                           int t128) {
  const TileIdx ti = tile_idx(a, t, tr);
  const int halo = a.ks >> 1;
  const int cg_n = (a.cin0_pad + a.aux_c) >> 3;
  const int npix = L.rows_in * L.cols_in;
  const int per = 8 * cg_n;  // items per octet of pixels
  const uint64_t magic = ((1ull << 32) + per - 1) / per;  // k / per == (k * magic) >> 32 here
  const int n = (npix + 7) / 8 * per;
  const bool in0_vec = (a.in0_c % 8 == 0) && (a.in0_stride % 8 == 0) && (a.in0_off % 8 == 0);
  const bool aux_vec = (a.aux_c % 8 == 0) && (a.aux_stride % 8 == 0) && (a.aux_off % 8 == 0);
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
      *d = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const size_t pixel = ((size_t)ti.b * a.H + gy) * a.W + gx;
    if (c0 < a.cin0_pad) {
      const bf16* in0 = static_cast<const bf16*>(a.in0);
      if (a.upsample) {
        float v[8];
        load_up8(a, ti.b, gy, gx, c0, in0_vec, v);
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

template <int N>
__device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 16) wg::wgmma_ss_n16(d, da, db, acc);
  else if constexpr (N == 32) wg::wgmma_ss_n32(d, da, db, acc);
  else wg::wgmma_ss_n48(d, da, db, acc);
}

// N = cout_pad; TRW = tile rows of a warpgroup (one m64 accumulator each);
// MODE (a template parameter: a branch between the wgmma makes ptxas
// serialize them) picks the products.  Each warpgroup walks its own tiles
// in its own shared-memory region, so one warpgroup's staging and epilogue
// overlap another's products.
template <int N, int TRW, int MODE>
__global__ void __launch_bounds__(384) conv_layer_kernel(const LayerArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int WP = w_planes(MODE);
  constexpr int NACC = N / 2, C8 = N / 8;
  const int nwg = blockDim.x >> 7;
  const int cin_tot = a.cin0_pad + a.aux_c;  // a multiple of 16
  const int kch = cin_tot >> 4;
  const int K = a.ks * a.ks * cin_tot;
  const Smem L = smem_layout(a.ks, cin_tot, N, MODE, Config{TRW, nwg});
  const int tid = threadIdx.x, g = tid >> 7, t128 = tid & 127;
  const int warp_in = t128 >> 5, lane = tid & 31;
  const int tiles_x = (a.W + TW - 1) / TW, tiles_y = (a.H + TRW - 1) / TRW;
  const int ntiles = tiles_x * tiles_y * a.B;
  const int t0 = blockIdx.x * nwg + g, stride = gridDim.x * nwg;
  unsigned char* buf = smem + L.buf + g * L.buf_bytes;
  const int hi_bytes = K * N * 2;  // bytes of one weight plane

  // ---- the layer's packed weights, once per CTA, and the first tile
  const int wbytes = hi_bytes * WP;
  for (int i = tid * 16; i < wbytes; i += blockDim.x * 16)
    wg::cp_async16(smem + L.w + i, reinterpret_cast<const unsigned char*>(a.w) + i);
  if (t0 < ntiles) stage_tile(a, L, t0, TRW, buf, t128);
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
  PHASE_CLOCK(long long ph[3] = {0, 0, 0}; long long c0 = 0, c1 = 0; int nt = 0;)
  for (int t = t0; t < ntiles; t += stride) {
    PHASE_CLOCK(c0 = clock64();)
    wg::cp_async_wait<0>();
    wg::fence_async_smem();
    wg::bar_warpgroup(g);
    PHASE_CLOCK(c1 = clock64(); ph[0] += c1 - c0;)  // phase 0: waiting for the tile

    // ---- the products: TRW rows of 64 pixels over all taps and 16-channel
    // steps; the first product starts each sum
    float acc[TRW][NACC];
    wg::fence();
#pragma unroll 1
    for (int dy = 0; dy < a.ks; ++dy) {
#pragma unroll 1
      for (int dx = 0; dx < a.ks; ++dx) {
        const int tap = dy * a.ks + dx;
        const uint32_t a_tap = a_base + (dy * L.cols_in + dx) * 16;
        const uint32_t wh = w_base + tap * kch * N * 32;  // weight plane 0 of this tap
#pragma unroll 1
        for (int kc = 0; kc < kch; ++kc) {
          const int accumulate = (tap + kc) > 0;
          const uint32_t wo = kc * N * 32;
          const uint32_t ak = a_tap + 2 * kc * L.plane;
          // the mode's products (the tile by weight plane p), each over the rows
#pragma unroll
          for (int p = 0; p < WP; ++p) {
            const uint64_t db = wg::desc(wh + p * hi_bytes + wo, N * 16, 128);
#pragma unroll
            for (int r = 0; r < TRW; ++r) {
              const uint64_t da = wg::desc(ak + r * L.cols_in * 16, L.plane, 128);
              mma<N>(acc[r], da, db, p == 0 ? accumulate : 1);
            }
          }
        }
      }
    }
    wg::commit();
    wg::wait<0>();
#pragma unroll
    for (int r = 0; r < TRW; ++r) wg::fence_regs(acc[r]);
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
          float v0 = acc[r][i0] + bias[j][0];
          float v1 = acc[r][i0 + 1] + bias[j][1];
          if (a.relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
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
    store_band_bf16<N, TRW>(a, ti, reinterpret_cast<const bf16*>(buf), t128);
    wg::bar_warpgroup(g);  // the band is out: stage the next tile
    if (t + stride < ntiles) stage_tile(a, L, t + stride, TRW, buf, t128);
    wg::cp_async_commit();
    PHASE_CLOCK(ph[2] += clock64() - c0; ++nt;)  // phase 2: epilogue and staging
  }
  PHASE_CLOCK(wg::phase_clocks_add(ph, nt);)
  wg::cp_async_wait<0>();
}

// ------------------------------------------------- warp-specialized body
// The fp32-band modes (rvdd_tpu's band_dtype=float32 at mxu_precision
// 'high', bf16_3x, or 'highest', fp32 weights) and the fp32-weight mode on
// bf16 bands (weight_dtype=float32 at 'highest'), warp-specialized (see
// the source note): warpgroup 2, the producer, stages each tile's input (a
// streamed layer: a channel slab at a time, and each tap of the slab's
// weights) into a ring of two regions a step ahead, with TMA where the
// input allows; warpgroups 0 and 1, the consumers, take 32 columns of the
// tile each, read each k16 step's A fragment from the region (fp32 bands:
// loaded and split in registers into AP bf16 planes; bf16 bands: one
// ldmatrix) and issue the numerics' register-A wgmma on WP weight planes.

namespace ws {

constexpr int NCONS = 256;             // consumer threads: warpgroups 0 and 1
constexpr int NTHREADS = NCONS + 128;  // and the producer, warpgroup 2

// The numerics of the body, a template parameter of the kernel (a branch
// between wgmma makes ptxas serialize them): the band dtype (F32: fp32,
// else bf16), the bf16 planes of the tile's A fragments (AP) and of the
// weights (WP), the output rows of a tile (ROWS: a consumer holds ROWS / 2
// m64 operands), the products of a k-step (NPROD; product p multiplies A
// plane pa(p) by weight plane pb(p), into the second accumulator where
// acc2(p)), whether the band goes out through shared memory with TMA
// stores (STAGE_OUT), and the registers a thread of each role after
// setmaxnreg (168 at launch).
// bf16_3x: a_hi.w_hi, a_lo.w_hi, a_hi.w_lo (the serial body's order; lo.lo,
// about 2^-16 relative, is dropped as on the TPU), all into acc.  Its
// producer has 120 registers (at 104 it spilled 8 bytes with N = 16).
struct HighNum {
  static constexpr bool F32 = true, STAGE_OUT = false;
  static constexpr int AP = 2, WP = 2, ROWS = 2, NPROD = 3, PROD_REGS = 120, CONS_REGS = 192;
  __host__ __device__ static constexpr int pa(int p) { return p == 1; }
  __host__ __device__ static constexpr int pb(int p) { return p == 2; }
  __host__ __device__ static constexpr bool acc2(int) { return false; }
};
// HIGHEST: planes hi 0, mid 1, lo 2; hi.hi, hi.mid, mid.hi, hi.lo, mid.mid
// and lo.hi (the three dropped ones are below 2^-24 of the product),
// hi.hi into acc and the five small ones into acc2
struct HighestNum {
  static constexpr bool F32 = true, STAGE_OUT = false;
  static constexpr int AP = 3, WP = 3, ROWS = 2, NPROD = 6, PROD_REGS = 104, CONS_REGS = 200;
  __host__ __device__ static constexpr int pa(int p) {
    return p == 2 || p == 4 ? 1 : p == 5 ? 2 : 0;
  }
  __host__ __device__ static constexpr int pb(int p) {
    return p == 1 || p == 4 ? 1 : p == 3 ? 2 : 0;
  }
  __host__ __device__ static constexpr bool acc2(int p) { return p > 0; }
};
// fp32 weights on bf16 bands: the bf16 tile (one A plane) by the weights'
// hi, mid and lo planes, w_hi a + w_mid a + w_lo a into acc, exact in the
// weights up to the fp32 sums' order; 4-row tiles, the band out by TMA
// stores.  Its consumers hold two operands' accumulators (48), a tap's
// fragments double-buffered (48), the bias (12) and, in the epilogue, the
// results (48); 208 registers for them and 88 for the producer (staging
// two or four items at once: stage_bf16) leave no spill
struct W32Num {
  static constexpr bool F32 = false, STAGE_OUT = true;
  static constexpr int AP = 1, WP = 3, ROWS = 4, NPROD = 3, PROD_REGS = 88, CONS_REGS = 208;
  __host__ __device__ static constexpr int pa(int) { return 0; }
  __host__ __device__ static constexpr int pb(int p) { return p; }
  __host__ __device__ static constexpr bool acc2(int) { return false; }
};
// whether product p of T is the first of a k-step into its accumulator
template <class T>
__host__ __device__ constexpr bool first_in_acc(int p) {
  return p == 0 || (T::acc2(p) && !T::acc2(p - 1));
}
template <class T>
constexpr bool regs_fit() {
  return T::PROD_REGS * 128 + T::CONS_REGS * NCONS <= 168 * NTHREADS;
}
static_assert(regs_fit<HighNum>() && regs_fit<HighestNum>() && regs_fit<W32Num>(),
              "the launch's registers");

// What the shared-memory plan needs of the numerics: the bytes of an
// 8-channel pixel group (32 fp32, 16 bf16), the weight planes, the tile
// rows, whether each consumer stages its band for a TMA store
struct Shape {
  int pg, wp, rows;
  bool staged;
};
template <class T>
__host__ __device__ constexpr Shape shape_of() {
  return Shape{T::F32 ? 32 : 16, T::WP, T::ROWS, T::STAGE_OUT};
}

// the forms of the body: weights resident beside two tile regions; weights
// streamed a tap of a channel slab at a time; an upsample layer's weights
// resident beside one region and two windows of its half-res input
enum Form { RESIDENT = 0, STREAMED = 1, UPSAMPLE = 2 };
constexpr int SRC_COLS = 36;  // the half-res window's columns (a tile's 32 and the halo)
__host__ __device__ constexpr int src_rows(int rows) { return rows / 2 + 2; }
// A region, weight stage or source window is FULL once its bytes are in:
// an mbarrier in shared memory (a region's: the producer's 128 threads
// arrive, thread 0 with the TMA bytes it expects; the others': thread 0
// with the bytes).  A region or weight stage is EMPTY once the consumers'
// products that read it are done: named barriers (0 is __syncthreads) of
// all NTHREADS threads.  BAR_JOIN: all NTHREADS threads, around an upsample
// layer's tile, which they interpolate together into its one region.
constexpr int NW = 4;  // weight stages of a streamed layer
constexpr int BAR_REMPTY = 1, BAR_WEMPTY = 3, BAR_JOIN = BAR_WEMPTY + NW;
static_assert(BAR_JOIN < 16, "16 named barriers");
// the mbarriers: regions, weight stages, source windows
constexpr int MB_REGION = 0, MB_WEIGHT = 2, MB_SRC = MB_WEIGHT + NW, MB_COUNT = MB_SRC + 2;

// The shared memory of a launch: the weights at 0 (resident: all taps of
// the wp planes; streamed: NW stages of one tap of one slab, wp planes
// each), one or two regions of one slab of a tile's input as
// [slab_c / 8][rows_in][cols_in][8] in the band dtype (a TMA box per
// 8-channel group, each at a 128-byte boundary as TMA wants: a bf16 3x3
// tile of 4 rows pads its 6,336-byte box to 6,400), an upsample layer's two
// source windows
// [src_rows][SRC_COLS][c] (one TMA box), each consumer's staged band
// [rows][32][n] (bf16, the box of a TMA store) where the numerics stage
// it, and the FULL mbarriers.  A resident layer's slab is its whole input.  The mirror is
// ops/cuda/conv_chain.py:ws_layout.
struct Layout {
  int slab_c;                   // input channels a region holds
  int rows_in, cols_in, box;    // region geometry; box = bytes of one 8-channel group
  int plane;                    // box rounded up to 128: one group to the next
  int region, nreg;             // bytes of a region; regions
  int wstage;                   // bytes of a streamed weight stage
  int r0;                       // the regions at r0 + k region
  int src, srcwin;              // the source windows at src + k srcwin
  int stg, stgbuf;              // consumer c's staged band at stg + c stgbuf
  int bars;                     // the mbarriers
  int total;
};

__host__ __device__ inline Layout layout(int ks, int cin_tot, int n, Shape sh, int form,
                                         int nslab) {
  Layout L;
  const int halo = ks / 2;
  L.slab_c = cin_tot / nslab;
  L.rows_in = sh.rows + 2 * halo;
  L.cols_in = TW + 2 * halo;
  L.box = L.rows_in * L.cols_in * sh.pg;
  L.plane = align128(L.box);
  L.region = align128((L.slab_c / 8) * L.plane);
  L.nreg = form == UPSAMPLE ? 1 : 2;
  L.wstage = L.slab_c * n * 2 * sh.wp;
  L.r0 = align128(form == STREAMED ? NW * L.wstage : ks * ks * cin_tot * n * 2 * sh.wp);
  L.src = L.r0 + L.nreg * L.region;
  L.srcwin = form == UPSAMPLE ? src_rows(sh.rows) * SRC_COLS * cin_tot * (sh.pg / 8) : 0;
  L.stg = L.src + 2 * L.srcwin;
  L.stgbuf = sh.staged ? sh.rows * (TW / 2) * n * 2 : 0;
  L.bars = L.stg + 2 * L.stgbuf;
  L.total = L.bars + 128;
  return L;
}

// The plan of a layer, a function of its shape and its numerics: an
// upsample layer whose input is whole 8-channel groups and no aux
// (upsample_tma) takes the UPSAMPLE form where it fits; else the weights
// stay resident beside the two regions where they fit (nslab 1), else they
// stream with the fewest slabs (dividing the 16-channel groups) that fit;
// nslab 0: nothing fits
__host__ __device__ inline int plan_form(int ks, int cin_tot, int n, Shape sh, bool upsample_tma,
                                         int& form) {
  form = UPSAMPLE;
  if (upsample_tma && layout(ks, cin_tot, n, sh, UPSAMPLE, 1).total <= SMEM_MAX) return 1;
  form = RESIDENT;
  if (layout(ks, cin_tot, n, sh, RESIDENT, 1).total <= SMEM_MAX) return 1;
  form = STREAMED;
  const int g = cin_tot / 16;
  for (int ns = 2; ns <= g; ++ns)
    if (g % ns == 0 && layout(ks, cin_tot, n, sh, STREAMED, ns).total <= SMEM_MAX) return ns;
  return 0;
}

// whether `elems` elements of eb bytes are a whole number of 16-byte units
__host__ __device__ inline bool al16(int elems, int eb) { return (elems * eb) % 16 == 0; }
// whether an upsample layer's half-res input can be staged with TMA: a 3x3
// layer, in whole 8-channel groups (at most 256: a TMA box) at 16-byte
// aligned pixels (eb: the band's bytes an element), no aux
__host__ __device__ inline bool upsample_tma(const LayerArgs& a, int eb) {
  return a.upsample && a.ks == 3 && a.aux_c == 0 && a.in0_c == a.cin0_pad && a.in0_c % 8 == 0 &&
         a.in0_c <= 256 && al16(a.in0_stride, eb) && al16(a.in0_off, eb);
}
// whether a layer's full-res input is staged with TMA: in0 and the aux
// window in whole 8-channel groups at 16-byte aligned pixels and offsets
// (the upsample and a 9-channel input go through registers)
__host__ __device__ inline bool tile_tma(const LayerArgs& a, int eb) {
  return !a.upsample && a.in0_c % 8 == 0 && al16(a.in0_stride, eb) && al16(a.in0_off, eb) &&
         (a.aux_c == 0 || (al16(a.aux_stride, eb) && al16(a.aux_off, eb)));
}

// this CTA's tiles of `rows` rows, t = blockIdx.x + i * gridDim.x for i < n
// (mirrored by ops/cuda/conv_chain.py:ws_tiles)
struct Sched {
  int n;
  __device__ Sched(const LayerArgs& a, int rows) {
    const int nt = ((a.W + TW - 1) / TW) * ((a.H + rows - 1) / rows) * a.B;
    n = nt > (int)blockIdx.x ? (nt - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x : 0;
  }
  __device__ int tile(int i) const { return blockIdx.x + i * gridDim.x; }
};

// ---- mbarriers, TMA and bulk copies (PTX of sm_90)
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(wg::smem_addr(b)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(wg::smem_addr(b)) : "memory");
}
// arrives and expects `bytes` more of asynchronous copies in this phase
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(wg::smem_addr(b)),
               "r"(bytes)
               : "memory");
}
// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(wg::smem_addr(b)),
      "r"(parity)
      : "memory");
}
// the box of tensor map `map` at coordinates (0, cg, x, y, b) to dst
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int cg, int x, int y,
                                         int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(wg::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(cg), "r"(x), "r"(y), "r"(b),
      "r"(wg::smem_addr(bar))
      : "memory");
}
// src to the box of tensor map `map` at coordinates (0, 0, x, y, b), in
// the bulk async-group of this thread (elements outside the tensor are
// not written)
__device__ __forceinline__ void tma_store(const void* src, const CUtensorMap* map, int x, int y,
                                          int b) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5, %6}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(wg::smem_addr(src)), "r"(0), "r"(0), "r"(x), "r"(y), "r"(b)
      : "memory");
}
// waits until this thread's bulk stores have read their shared memory
// (READ) or are done
template <bool READ>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// `bytes` (a multiple of 16) from src to dst
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          wg::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(wg::smem_addr(bar))
      : "memory");
}
// four 8x8 bf16 matrices from shared memory, each row's 16 bytes at the
// address one thread of the matrix's octet of lanes gives: register i holds
// matrix i's row lane / 4, columns 2 (lane % 4) and 2 (lane % 4) + 1 (the
// mma A-fragment order)
__device__ __forceinline__ void ldsm_x4(uint32_t (&f)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(f[0]), "=r"(f[1]), "=r"(f[2]), "=r"(f[3])
               : "r"(addr)
               : "memory");
}

// channels [c0, c0 + 4) of the fp32 in0 at one pixel of its own grid;
// channels >= in0_c read as zero
__device__ __forceinline__ float4 in0_4(const LayerArgs& a, size_t pixel, int c0, bool vec) {
  const float* p = static_cast<const float*>(a.in0) + pixel * a.in0_stride + a.in0_off + c0;
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = c0 + k < a.in0_c ? __ldg(p + k) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// the 2x bilinear upsample weights of load_up8, rows first as
// rvdd_tpu/ops/resize.py
__device__ __forceinline__ float lerp4(float x00, float x01, float x10, float x11) {
  const float ri = 0.75f * x00 + 0.25f * x10, rn = 0.75f * x01 + 0.25f * x11;
  return 0.75f * ri + 0.25f * rn;
}

// stage_slab's bf16 items (one 8-channel group of a pixel each), UB a
// thread at once: the 2x bilinear upsample of in0 (UP, four source pixels
// an item; two items at once, as four spilled at 88 registers), or in0 and
// the aux window as they are (four)
template <bool UP, int UB>
__device__ void stage_bf16(const LayerArgs& a, const Layout& L, const TileIdx& ti, int s,
                           unsigned char* dst, int pt) {
  constexpr int NV = UP ? 4 : 1;  // loads an item
  const int halo = a.ks >> 1, npix = L.rows_in * L.cols_in;
  const int n = npix * (L.slab_c / 8);
  const bool in0_vec = (a.in0_c % 8 == 0) && (a.in0_stride % 8 == 0) && (a.in0_off % 8 == 0);
  const bool aux_vec = (a.aux_stride % 8 == 0) && (a.aux_off % 8 == 0);
  const bf16* in0 = static_cast<const bf16*>(a.in0);
  const bf16* aux = static_cast<const bf16*>(a.aux);
  for (int k0 = pt; k0 < n; k0 += 128 * UB) {
    uint4 v[UB][NV];
    int off[UB], kind[UB];  // kind: -1 none, 0 zeros, 2 the upsample of v[u], 3 v[u][0]
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      const int k = k0 + 128 * u;
      kind[u] = -1;
      if (k >= n) continue;
      const int cg = k / npix, pix = k - cg * npix;
      const int r = halo ? pix / (TW + 2) : pix / TW;
      const int gy = ti.y0 + r - halo, gx = ti.x0 + pix - r * L.cols_in - halo;
      const int c0 = s * L.slab_c + cg * 8;
      off[u] = cg * L.plane + pix * 16;
      kind[u] = 0;
      if (gy < 0 || gy >= a.H || gx < 0 || gx >= a.W || (c0 < a.cin0_pad && c0 >= a.in0_c))
        continue;
      const size_t pixel = ((size_t)ti.b * a.H + gy) * a.W + gx;
      if (c0 >= a.cin0_pad) {
        v[u][0] = load_px8(aux, pixel, a.aux_stride, a.aux_off, c0 - a.cin0_pad, a.aux_c, aux_vec);
        kind[u] = 3;
      } else if constexpr (UP) {  // the four source pixels of load_up8
        const int j = gy >> 1, i = gx >> 1;
        const int jn = min(max((gy & 1) ? j + 1 : j - 1, 0), a.in0_h - 1);
        const int ic = min(max((gx & 1) ? i + 1 : i - 1, 0), a.in0_w - 1);
        const size_t r0 = (size_t)ti.b * a.in0_h + j, r1 = (size_t)ti.b * a.in0_h + jn;
        v[u][0] = load_px8(in0, r0 * a.in0_w + i, a.in0_stride, a.in0_off, c0, a.in0_c, in0_vec);
        v[u][1] = load_px8(in0, r0 * a.in0_w + ic, a.in0_stride, a.in0_off, c0, a.in0_c, in0_vec);
        v[u][2] = load_px8(in0, r1 * a.in0_w + i, a.in0_stride, a.in0_off, c0, a.in0_c, in0_vec);
        v[u][3] = load_px8(in0, r1 * a.in0_w + ic, a.in0_stride, a.in0_off, c0, a.in0_c, in0_vec);
        kind[u] = 2;
      } else {
        v[u][0] = load_px8(in0, pixel, a.in0_stride, a.in0_off, c0, a.in0_c, in0_vec);
        kind[u] = 3;
      }
    }
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      if (kind[u] < 0) continue;
      uint4 r = make_uint4(0u, 0u, 0u, 0u);
      if (kind[u] == 3) r = v[u][0];
      if constexpr (UP) {
        if (kind[u] == 2) {
          float f[4][8], o[8];
#pragma unroll
          for (int e = 0; e < 4; ++e) unpack8(v[u][e], f[e]);
#pragma unroll
          for (int e = 0; e < 8; ++e) o[e] = lerp4(f[0][e], f[1][e], f[2][e], f[3][e]);
          r = pack8(o);
        }
      }
      *reinterpret_cast<uint4*>(dst + off[u]) = r;
    }
  }
}

// The producer stages slab s of tile ti's rows and halo into region dst
// through registers (an upsampled or unaligned input): zeros outside the
// image and in pad channels, the 2x bilinear upsample as load_up8
// computes it (in fp32, rounded once to bf16 on bf16 bands), U items a
// thread at once so that their loads are in flight together.  Items are
// 16-byte parts of a pixel's 8-channel group (fp32: two halves; bf16: the
// whole group, stage_bf16), neighbouring pixels on neighbouring threads.
template <class T>
__device__ void stage_slab(const LayerArgs& a, const Layout& L, const TileIdx& ti, int s,
                           unsigned char* dst, int pt) {
  if constexpr (T::F32) {
    constexpr int U = 4;
    const int halo = a.ks >> 1, npix = L.rows_in * L.cols_in;
    const int n = 2 * npix * (L.slab_c / 8);
    const bool in0_vec = (a.in0_c % 4 == 0) && (a.in0_stride % 4 == 0) && (a.in0_off % 4 == 0);
    const float* aux = static_cast<const float*>(a.aux);
    for (int k0 = pt; k0 < n; k0 += 128 * U) {
      float4 v[U][4];
      int off[U], kind[U];  // kind: -1 none, 0 zeros, 2 the upsample of v[u], 3 v[u][0]
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = k0 + 128 * u;
        kind[u] = -1;
        if (k >= n) continue;
        const int cg = k / (2 * npix), rem = k - cg * 2 * npix, pix = rem >> 1;
        const int r = halo ? pix / (TW + 2) : pix / TW;
        const int gy = ti.y0 + r - halo, gx = ti.x0 + pix - r * L.cols_in - halo;
        const int c0 = s * L.slab_c + cg * 8 + (rem & 1) * 4;
        off[u] = cg * L.plane + pix * 32 + (rem & 1) * 16;
        kind[u] = 0;
        if (gy < 0 || gy >= a.H || gx < 0 || gx >= a.W || (c0 < a.cin0_pad && c0 >= a.in0_c))
          continue;
        const size_t pixel = ((size_t)ti.b * a.H + gy) * a.W + gx;
        if (c0 >= a.cin0_pad) {
          const float* p = aux + pixel * a.aux_stride + a.aux_off + (c0 - a.cin0_pad);
          v[u][0] = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
          kind[u] = 3;
        } else if (a.upsample) {  // the four source pixels of load_up8
          const int j = gy >> 1, i = gx >> 1;
          const int jn = min(max((gy & 1) ? j + 1 : j - 1, 0), a.in0_h - 1);
          const int ic = min(max((gx & 1) ? i + 1 : i - 1, 0), a.in0_w - 1);
          const size_t r0 = (size_t)ti.b * a.in0_h + j, r1 = (size_t)ti.b * a.in0_h + jn;
          v[u][0] = in0_4(a, r0 * a.in0_w + i, c0, in0_vec);
          v[u][1] = in0_4(a, r0 * a.in0_w + ic, c0, in0_vec);
          v[u][2] = in0_4(a, r1 * a.in0_w + i, c0, in0_vec);
          v[u][3] = in0_4(a, r1 * a.in0_w + ic, c0, in0_vec);
          kind[u] = 2;
        } else {
          v[u][0] = in0_4(a, pixel, c0, in0_vec);
          kind[u] = 3;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (kind[u] < 0) continue;
        float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kind[u] == 3) r = v[u][0];
        if (kind[u] == 2)
          r = make_float4(lerp4(v[u][0].x, v[u][1].x, v[u][2].x, v[u][3].x),
                          lerp4(v[u][0].y, v[u][1].y, v[u][2].y, v[u][3].y),
                          lerp4(v[u][0].z, v[u][1].z, v[u][2].z, v[u][3].z),
                          lerp4(v[u][0].w, v[u][1].w, v[u][2].w, v[u][3].w));
        *reinterpret_cast<float4*>(dst + off[u]) = r;
      }
    }
  } else if (a.upsample) {
    stage_bf16<true, 2>(a, L, ti, s, dst, pt);
  } else {
    stage_bf16<false, 4>(a, L, ti, s, dst, pt);
  }
}

// An upsample layer's tile from its half-res source window (rows y0/2 - 1
// .. y0/2 + ROWS/2, columns x0/2 - 2 .. x0/2 + 33 of in0, every channel,
// as [src_rows][SRC_COLS][c]) into region dst: the 2x bilinear upsample as
// load_up8 computes it (in fp32, rounded once to bf16 on bf16 bands;
// source rows and columns clamped to the image, which the window holds),
// zeros outside the image, by all NTHREADS threads.  fp32: items as in
// stage_slab; bf16: a pixel a thread, its four source offsets reckoned once
// for all its channel groups.
template <class T>
__device__ void upsample_tile(const LayerArgs& a, const Layout& L, const TileIdx& ti,
                              const unsigned char* win, unsigned char* dst) {
  const int pt = threadIdx.x;
  const int npix = L.rows_in * L.cols_in;
  const int wy = (ti.y0 >> 1) - 1, wx = (ti.x0 >> 1) - 2;  // the window's first row and column
  if constexpr (T::F32) {
    constexpr int U = 2;
    const int px_bytes = a.in0_c * 4;  // a window pixel
    for (int cg = 0; cg < L.slab_c / 8; ++cg) {
      const unsigned char* wp = win + cg * 32;
      unsigned char* dp = dst + cg * L.plane;
#pragma unroll 1
      for (int k0 = pt; k0 < 2 * npix; k0 += NTHREADS * U) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int k = k0 + NTHREADS * u;
          if (k >= 2 * npix) break;
          const int pix = k >> 1, h = k & 1, r = pix / (TW + 2);
          const int gy = ti.y0 + r - 1, gx = ti.x0 + pix - r * L.cols_in - 1;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W) {
            const int j = gy >> 1, i = gx >> 1;
            const int jn = min(max((gy & 1) ? j + 1 : j - 1, 0), a.in0_h - 1);
            const int ic = min(max((gx & 1) ? i + 1 : i - 1, 0), a.in0_w - 1);
            const unsigned char* p = wp + h * 16;
            const auto at = [&](int y, int x) {
              const unsigned char* q = p + ((y - wy) * SRC_COLS + (x - wx)) * px_bytes;
              return *reinterpret_cast<const float4*>(q);
            };
            const float4 v00 = at(j, i), v01 = at(j, ic), v10 = at(jn, i), v11 = at(jn, ic);
            v = make_float4(lerp4(v00.x, v01.x, v10.x, v11.x), lerp4(v00.y, v01.y, v10.y, v11.y),
                            lerp4(v00.z, v01.z, v10.z, v11.z), lerp4(v00.w, v01.w, v10.w, v11.w));
          }
          *reinterpret_cast<float4*>(dp + pix * 32 + h * 16) = v;
        }
      }
    }
  } else {  // a pixel a thread, its source offsets once for all its channel groups
    const int px_bytes = a.in0_c * 2;
    for (int pix = pt; pix < npix; pix += NTHREADS) {
      const int r = pix / (TW + 2);
      const int gy = ti.y0 + r - 1, gx = ti.x0 + pix - r * L.cols_in - 1;
      const bool in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
      const int j = gy >> 1, i = gx >> 1;
      const int jn = min(max((gy & 1) ? j + 1 : j - 1, 0), a.in0_h - 1);
      const int ic = min(max((gx & 1) ? i + 1 : i - 1, 0), a.in0_w - 1);
      const int o00 = ((j - wy) * SRC_COLS + (i - wx)) * px_bytes;
      const int o01 = ((j - wy) * SRC_COLS + (ic - wx)) * px_bytes;
      const int o10 = ((jn - wy) * SRC_COLS + (i - wx)) * px_bytes;
      const int o11 = ((jn - wy) * SRC_COLS + (ic - wx)) * px_bytes;
#pragma unroll 1
      for (int cg = 0; cg < L.slab_c / 8; ++cg) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (in) {
          const unsigned char* w = win + cg * 16;
          float f[4][8], o[8];
          unpack8(*reinterpret_cast<const uint4*>(w + o00), f[0]);
          unpack8(*reinterpret_cast<const uint4*>(w + o01), f[1]);
          unpack8(*reinterpret_cast<const uint4*>(w + o10), f[2]);
          unpack8(*reinterpret_cast<const uint4*>(w + o11), f[3]);
#pragma unroll
          for (int e = 0; e < 8; ++e) o[e] = lerp4(f[0][e], f[1][e], f[2][e], f[3][e]);
          v = pack8(o);
        }
        *reinterpret_cast<uint4*>(dst + cg * L.plane + pix * 16) = v;
      }
    }
  }
}

// The producer's items in the consumers' order: for each tile and slab, the
// slab's region (TMA: a box per 8-channel group, zeros filled outside the
// image and past in0's channels; an UPSAMPLE layer: interpolated from its
// source window, which TMA fetches two tiles ahead; else stage_slab), then
// (a STREAMED layer) its taps' weight stages (T::WP bulk copies each).  It
// waits only for EMPTY slots and its own source windows.  Phase clocks
// (slots 0-2): waiting for an EMPTY region or stage, staging the regions
// (TMA: issuing), issuing the weight stages.
template <int N, int FORM, class T>
__device__ void produce(const LayerArgs& a, const Layout& L, int nslab, unsigned char* smem,
                        const Sched& sc, const CUtensorMap* tin0, const CUtensorMap* taux,
                        bool tma) {
  const int pt = threadIdx.x - NCONS;
  const int taps = a.ks * a.ks, halo = a.ks >> 1, cin_tot = a.cin0_pad + a.aux_c;
  uint64_t* mb = reinterpret_cast<uint64_t*>(smem + L.bars);
  PHASE_CLOCK(long long ph[3] = {0, 0, 0}; long long c0 = 0;)
  if constexpr (FORM == UPSAMPLE) {
    // source window i into window i % 2, two tiles ahead; each tile is
    // interpolated by all NTHREADS threads (upsample_tile) between two
    // BAR_JOINs: after the consumers' products of the tile before, and
    // after the tile is in
    const auto fetch_window = [&](int i) {
      const TileIdx ti = tile_idx(a, sc.tile(i), T::ROWS);
      wg::fence_async_smem();  // the reads of its last use before the copy
      mbar_arrive_tx(&mb[MB_SRC + (i & 1)], L.srcwin);
      tma_load(smem + L.src + (i & 1) * L.srcwin, tin0, 0, (ti.x0 >> 1) - 2, (ti.y0 >> 1) - 1,
               ti.b, &mb[MB_SRC + (i & 1)]);
    };
    if (pt == 0)
      for (int i = 0; i < 2 && i < sc.n; ++i) fetch_window(i);
    for (int i = 0; i < sc.n; ++i) {
      PHASE_CLOCK(c0 = clock64();)
      mbar_wait(&mb[MB_SRC + (i & 1)], (i >> 1) & 1);
      PHASE_CLOCK(ph[0] += clock64() - c0; c0 = clock64();)
      upsample_tile<T>(a, L, tile_idx(a, sc.tile(i), T::ROWS), smem + L.src + (i & 1) * L.srcwin,
                       smem + L.r0);
      wg::bar_sync(BAR_JOIN, NTHREADS);  // the tile is in; window i % 2 is free
      PHASE_CLOCK(ph[1] += clock64() - c0; c0 = clock64();)
      if (pt == 0 && i + 2 < sc.n) fetch_window(i + 2);
      wg::bar_sync(BAR_JOIN, NTHREADS);  // the consumers' products of tile i are done
      PHASE_CLOCK(ph[0] += clock64() - c0;)
    }
  } else {
    for (int i = 0; i < sc.n; ++i) {
      const TileIdx ti = tile_idx(a, sc.tile(i), T::ROWS);
      for (int s = 0; s < nslab; ++s) {
        const int si = i * nslab + s, slot = si & 1;
        unsigned char* dst = smem + L.r0 + slot * L.region;
        PHASE_CLOCK(c0 = clock64();)
        if (si >= 2) wg::bar_sync(BAR_REMPTY + slot, NTHREADS);
        PHASE_CLOCK(ph[0] += clock64() - c0; c0 = clock64();)
        if (tma) {
          if (pt == 0) {
            wg::fence_async_smem();  // the consumers' reads before the copies
            mbar_arrive_tx(&mb[MB_REGION + slot], (L.slab_c / 8) * L.box);
            for (int cg = 0; cg < L.slab_c / 8; ++cg) {
              const int ch = s * L.slab_c + cg * 8;
              if (ch < a.cin0_pad)
                tma_load(dst + cg * L.plane, tin0, ch / 8, ti.x0 - halo, ti.y0 - halo, ti.b,
                         &mb[MB_REGION + slot]);
              else
                tma_load(dst + cg * L.plane, taux, (ch - a.cin0_pad) / 8, ti.x0 - halo, ti.y0 - halo,
                         ti.b, &mb[MB_REGION + slot]);
            }
          } else {
            mbar_arrive(&mb[MB_REGION + slot]);
          }
        } else {
          stage_slab<T>(a, L, ti, s, dst, pt);
          mbar_arrive(&mb[MB_REGION + slot]);
        }
        PHASE_CLOCK(ph[1] += clock64() - c0;)
        if constexpr (FORM == STREAMED) {
          for (int tap = 0; tap < taps; ++tap) {
            const int wi = si * taps + tap, stg = wi % NW;
            PHASE_CLOCK(c0 = clock64();)
            if (wi >= NW) wg::bar_sync(BAR_WEMPTY + stg, NTHREADS);
            PHASE_CLOCK(ph[0] += clock64() - c0; c0 = clock64();)
            if (pt == 0) {
              const int part = L.slab_c * N * 2, plane = taps * cin_tot * N * 2;
              const unsigned char* src =
                  reinterpret_cast<const unsigned char*>(a.w) + (tap * cin_tot + s * L.slab_c) * N * 2;
              unsigned char* stage = smem + stg * L.wstage;
              mbar_arrive_tx(&mb[MB_WEIGHT + stg], T::WP * part);
              for (int p = 0; p < T::WP; ++p)
                bulk_load(stage + p * part, src + p * plane, part, &mb[MB_WEIGHT + stg]);
            }
            PHASE_CLOCK(ph[2] += clock64() - c0;)
          }
        }
      }
    }
  }
  PHASE_CLOCK(if (pt == 0) wg::phase_clocks_add_at(ph, 0, 0);)
}

// a pair of fp32 values as the bf16x2 A-fragment registers of their hi,
// mid and lo planes, v = hi + mid + lo exactly: hi keeps the top 16 bits
// (mantissa mask), mid the top 16 bits of r = v - hi, lo = bf16(r - mid)
// (at most 8 significant bits, so exact); the wrapper's split3
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

// a pair of fp32 values as the bf16x2 A-fragment registers of their hi
// and lo planes, v = hi + lo: hi keeps the top 16 bits (mantissa mask,
// exact in bf16), lo = bf16(v - hi) rounded to nearest even; the
// wrapper's split_weight
__device__ __forceinline__ void split2x2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const uint32_t bx = __float_as_uint(x), by = __float_as_uint(y);
  hi = (bx >> 16) | (by & 0xffff0000u);
  lo = wg::pack_bf16x2(__fsub_rn(x, __uint_as_float(bx & 0xffff0000u)),
                       __fsub_rn(y, __uint_as_float(by & 0xffff0000u)));
}

// v's AP fragments: f[0][r] hi, then (lo) or (mid, lo)
template <int AP>
__device__ __forceinline__ void split_pair(float2 v, uint32_t (&f)[AP][4], int r) {
  if constexpr (AP == 3)
    split3x2(v.x, v.y, f[0][r], f[1][r], f[2][r]);
  else
    split2x2(v.x, v.y, f[0][r], f[1][r]);
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                       int acc) {
  if constexpr (N == 16) wg::wgmma_rs_n16(d, a, db, acc);
  else if constexpr (N == 32) wg::wgmma_rs_n32(d, a, db, acc);
  else wg::wgmma_rs_n48(d, a, db, acc);
}

// A k16 step of a slab: tap (dy, dx), 16-channel step kc of the slab
struct KPos {
  int tap, dy, dx, kc;
};

// A consumer's tiles: columns [32 c, 32 c + 32) of each pair of tile rows
// (2 r, 2 r + 1) as m64 operand r (row m = 16 w + g + 8 h of warp w, lane
// 4 g + q is pixel (2 r + h, 32 c + 8 w + g), so a thread holds a pixel and
// the one below it).  A k16 step's A fragment of an operand: on fp32
// bands, the thread's 8 fp32 values (channels 2q, 2q + 1, 2q + 8, 2q + 9
// of both pixels; a warp reads 256 contiguous bytes a load) split into AP
// bf16 fragments; on bf16 bands one ldmatrix.x4 (the region's 8-pixel x
// 8-channel core matrices are its 128-byte rows: lanes 8 i .. 8 i + 7
// give the rows of matrix i, pixel row h = i % 2, channel group i / 2 of
// the step), read once for all the weight planes.  The products are the
// numerics' (NPROD a step and operand), issued a tap (three steps) a group
// where a slab is 48 channels and a step a group otherwise.  The fragments
// are double-buffered: group g + 1 is loaded while group g's products run
// (wait<1>; with more groups in flight ptxas gave the lo fragments of
// consecutive steps one register quad).  A weight stage is released
// (EMPTY) once the products of its last step are done; at a slab's end
// the products drain and its region is released.  An upsample layer's
// tile is first interpolated by all threads (BAR_JOIN).  The epilogue
// runs from registers into a result array (writing the accumulators there
// made ptxas serialize every wgmma, C7515): bias and act into res, then
// the stores: where band_tma (T::STAGE_OUT, a band of cout == N channels)
// each warp writes its 8 columns of the band to its staging buffer and
// one TMA store a warp takes them out while the next tile's products run
// (4-byte stores straight from the accumulator layout took the epilogue
// to 7,300 cycles a 4-row tile); then state, 2x2 pool (the pixel below in
// the thread, the one beside it in lane ^ 4) and any band not staged, an
// operand's pixel row at a time.  Phase clocks (slots 3-5, 6): waiting
// for FULL regions and stages (and interpolating), the products, the
// epilogue, and of the wait, the weight stages'.
template <int N, int FORM, class T>
__device__ void consume(const LayerArgs& a, const Layout& L, int nslab, unsigned char* smem,
                        const Sched& sc, const CUtensorMap* tout, bool band_tma) {
  constexpr int NACC = N / 2, C8 = N / 8, R = T::ROWS / 2, AP = T::AP, PG = T::F32 ? 32 : 16;
  constexpr bool STREAM = FORM == STREAMED;
  using Band = typename std::conditional<T::F32, float, bf16>::type;
  const int tid = threadIdx.x, c = tid >> 7, lane = tid & 31, q = lane & 3;
  const int col = 32 * c + 8 * ((tid >> 5) & 3) + (lane >> 2);
  const int cin_tot = a.cin0_pad + a.aux_c, taps = a.ks * a.ks, ksl = L.slab_c / 16;
  const int steps = taps * ksl;                   // k16 steps a slab
  const int ns = sc.n * nslab, nw = ns * taps;   // regions and weight stages of this CTA
  uint64_t* mb = reinterpret_cast<uint64_t*>(smem + L.bars);
  const uint32_t w_base = wg::smem_addr(smem);
  const uint32_t wplane = STREAM ? L.slab_c * N * 2 : taps * cin_tot * N * 2;  // plane to plane
  const int row1 = L.cols_in * PG;  // to the pixel below
  // fp32: the thread's pixel (0, col), channel 2q; bf16: the row of core
  // matrix lane / 8 this lane gives to ldmatrix
  const unsigned char* rbase =
      T::F32 ? smem + L.r0 + col * 32 + q * 8
             : smem + L.r0 + (lane >> 4) * L.plane +
                   (((lane >> 3) & 1) * L.cols_in + 32 * c + 8 * ((tid >> 5) & 3) + (lane & 7)) * 16;
  float bias[C8][2];  // channels 8 j + 2 q + {0, 1}
#pragma unroll
  for (int j8 = 0; j8 < C8; ++j8)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ch = 8 * j8 + 2 * q + e;
      bias[j8][e] = ch < a.cout ? __ldg(a.bias + ch) : 0.f;
    }
  const bool st_vec = (a.state_stride % 2 == 0) && (a.state_off % 2 == 0);
  const bool out_vec = a.cout % 2 == 0;
  PHASE_CLOCK(long long ph[3] = {0, 0, 0}; long long t0 = 0, tw = 0, tww = 0; int nt = 0;)

  const auto wait_full = [&](int k, int parity) {
    PHASE_CLOCK(const long long b0 = clock64();)
    mbar_wait(&mb[k], parity);
    PHASE_CLOCK(const long long d = clock64() - b0; tw += d; if (k >= MB_WEIGHT) tww += d;)
  };
  const auto release_w = [&](int f) {  // f = weight stage + 1, or 0
    if (f) wg::bar_arrive(BAR_WEMPTY + f - 1, NTHREADS);
  };

  // ---- the epilogue's stores of operand r's pixel row h of tile pend from
  // its results rr: band and state, and after row 1 the 2x2 pool
  float res[R][NACC];
  TileIdx pend{0, 0, 0};  // the tile of the epilogue
  const auto store_row = [&](const float(&rr)[NACC], int r, int h) {
    const int gx = pend.x0 + col, gy = pend.y0 + 2 * r + h;
    if (gy < a.H && gx < a.W) {
      const size_t px = ((size_t)pend.b * a.H + gy) * a.W + gx;
#pragma unroll
      for (int j8 = 0; j8 < C8; ++j8) {
        const int ch = 8 * j8 + 2 * q;
        const float v0 = rr[4 * j8 + 2 * h], v1 = rr[4 * j8 + 2 * h + 1];
        if (ch >= a.cout) continue;
        if (a.out != nullptr && !band_tma) {
          Band* o = static_cast<Band*>(a.out) + px * a.cout + ch;
          if constexpr (T::F32) {
            if (ch + 1 < a.cout && out_vec) {
              *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
            } else {
              o[0] = v0;
              if (ch + 1 < a.cout) o[1] = v1;
            }
          } else {
            if (ch + 1 < a.cout && out_vec) {
              *reinterpret_cast<uint32_t*>(o) = wg::pack_bf16x2(v0, v1);
            } else {
              o[0] = __float2bfloat16_rn(v0);
              if (ch + 1 < a.cout) o[1] = __float2bfloat16_rn(v1);
            }
          }
        }
        if (a.state != nullptr) {
          float* st = a.state + px * a.state_stride + a.state_off + ch;
          if (ch + 1 < a.cout && st_vec) {
            *reinterpret_cast<float2*>(st) = make_float2(v0, v1);
          } else {
            st[0] = v0;
            if (ch + 1 < a.cout) st[1] = v1;
          }
          if (ch == 0)
            for (int z = 0; z < a.state_zero; ++z) st[a.cout + z] = 0.f;
        }
      }
    }
    if (h == 1 && a.pooled != nullptr) {  // uniform; tiles start at even rows and columns
      const int h2 = a.H >> 1, w2 = a.W >> 1, gy2 = (pend.y0 >> 1) + r, gx2 = gx >> 1;
      const bool here = (lane & 4) == 0 && gy2 < h2 && gx2 < w2;
      Band* pooled = static_cast<Band*>(a.pooled) + (((size_t)pend.b * h2 + gy2) * w2 + gx2) * a.cout;
#pragma unroll
      for (int j8 = 0; j8 < C8; ++j8) {
        const int ch = 8 * j8 + 2 * q;
        float mx = fmaxf(rr[4 * j8], rr[4 * j8 + 2]), my = fmaxf(rr[4 * j8 + 1], rr[4 * j8 + 3]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        my = fmaxf(my, __shfl_xor_sync(0xffffffffu, my, 4));
        if (here && ch < a.cout) {
          if constexpr (T::F32) {
            if (ch + 1 < a.cout && out_vec) {
              *reinterpret_cast<float2*>(pooled + ch) = make_float2(mx, my);
            } else {
              pooled[ch] = mx;
              if (ch + 1 < a.cout) pooled[ch + 1] = my;
            }
          } else {
            if (ch + 1 < a.cout && out_vec) {
              *reinterpret_cast<uint32_t*>(pooled + ch) = wg::pack_bf16x2(mx, my);
            } else {
              pooled[ch] = __float2bfloat16_rn(mx);
              if (ch + 1 < a.cout) pooled[ch + 1] = __float2bfloat16_rn(my);
            }
          }
        }
      }
    }
  };
  // the band of tile pend: warp w's 8 columns to its buffer [rows][8][N],
  // then one TMA store
  const auto stage_band = [&]() {
    const int w = (tid >> 5) & 3;
    unsigned char* stg = smem + L.stg + c * L.stgbuf + w * (L.stgbuf / 4);
    if (lane == 0) bulk_wait<true>();  // the last store has read the buffer
    __syncwarp();
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j8 = 0; j8 < C8; ++j8)
          *reinterpret_cast<uint32_t*>(
              stg + (((2 * r + h) * 8 + (lane >> 2)) * N + 8 * j8 + 2 * q) * 2) =
              wg::pack_bf16x2(res[r][4 * j8 + 2 * h], res[r][4 * j8 + 2 * h + 1]);
    wg::fence_async_smem();
    __syncwarp();
    if (lane == 0) tma_store(stg, tout, pend.x0 + 32 * c + 8 * w, pend.y0, pend.b);
  };

#pragma unroll 1
  for (int i = 0; i < sc.n; ++i) {
    PHASE_CLOCK(t0 = clock64(); tw = 0;)
    float acc[R][NACC], acc2[R][NACC];  // acc2: HIGHEST's small products
    uint32_t fa[R][AP][4], fb[R][AP][4];
    int j = 0;  // k16 steps of the tile issued
#pragma unroll 1
    for (int s = 0; s < nslab; ++s) {
      const int si = i * nslab + s, wi0 = si * taps, slot = FORM == UPSAMPLE ? 0 : si & 1;
      const unsigned char* region = rbase + slot * L.region;
      KPos cur{0, 0, 0, 0};
      int k = 0, last = 0;  // steps of the slab issued; what the step in flight frees
      // operand r's A fragments of step cur into f[r]
      const auto load_step = [&](uint32_t(&f)[R][AP][4]) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const unsigned char* b =
              region + 2 * cur.kc * L.plane + (cur.dy * L.cols_in + cur.dx) * PG + 2 * r * row1;
          if constexpr (T::F32) {
            const float2 v0 = *reinterpret_cast<const float2*>(b);
            const float2 v1 = *reinterpret_cast<const float2*>(b + row1);
            const float2 v2 = *reinterpret_cast<const float2*>(b + L.plane);
            const float2 v3 = *reinterpret_cast<const float2*>(b + L.plane + row1);
            split_pair<AP>(v0, f[r], 0);
            split_pair<AP>(v1, f[r], 1);
            split_pair<AP>(v2, f[r], 2);
            split_pair<AP>(v3, f[r], 3);
          } else {
            ldsm_x4(f[r][0], wg::smem_addr(b));
          }
        }
      };
      // product p of a step from fragments f and weight descriptor d0,
      // over the operands
      const auto product = [&](int p, const uint32_t(&f)[R][AP][4], uint64_t d0, int first) {
        const uint64_t db = d0 + ((T::pb(p) * wplane) >> 4);
        const int scale_d = first_in_acc<T>(p) ? first : 1;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (T::acc2(p))
            mma_rs<N>(acc2[r], f[r][T::pa(p)], db, scale_d);
          else
            mma_rs<N>(acc[r], f[r][T::pa(p)], db, scale_d);
        }
      };
      const auto issue = [&](const uint32_t(&f)[R][AP][4]) {
        const uint32_t wb =
            w_base + (STREAM ? ((wi0 + cur.tap) % NW) * L.wstage + cur.kc * N * 32
                             : (cur.tap * cin_tot + s * L.slab_c + cur.kc * 16) * N * 2);
        const uint64_t d0 = wg::desc(wb, N * 16, 128);  // + plane offset / 16 per weight plane
        const int first = j > 0;                        // 0: the product starts its accumulator
        wg::fence();
#pragma unroll
        for (int p = 0; p < T::NPROD; ++p) product(p, f, d0, first);
        wg::commit();
      };
      // step k of the slab from fc; then step k + 1's fragments into fn,
      // once step k - 1 (which read fn) is done
      const auto step = [&](uint32_t(&fc)[R][AP][4], uint32_t(&fn)[R][AP][4]) {
        const int wi = wi0 + cur.tap;
        const int frees = STREAM && cur.kc == ksl - 1 && wi + NW < nw ? 1 + wi % NW : 0;
        issue(fc);
        wg::wait<1>();
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int pl = 0; pl < AP; ++pl) wg::fence_regs(fn[r][pl]);
        release_w(last);
        last = frees;
        ++j;
        if (++k < steps) {
          if (++cur.kc == ksl) {
            cur.kc = 0;
            ++cur.tap;
            if (++cur.dx == a.ks) {
              cur.dx = 0;
              ++cur.dy;
            }
            if (STREAM) wait_full(MB_WEIGHT + (wi0 + cur.tap) % NW, ((wi0 + cur.tap) / NW) & 1);
          }
          load_step(fn);
        }
      };
      if constexpr (FORM == UPSAMPLE) {  // interpolate the tile with the producer
        PHASE_CLOCK(const long long b0 = clock64();)
        mbar_wait(&mb[MB_SRC + (i & 1)], (i >> 1) & 1);
        upsample_tile<T>(a, L, tile_idx(a, sc.tile(i), T::ROWS), smem + L.src + (i & 1) * L.srcwin,
                         smem + L.r0);
        wg::bar_sync(BAR_JOIN, NTHREADS);
        PHASE_CLOCK(tw += clock64() - b0;)
      } else {
        wait_full(MB_REGION + slot, (si >> 1) & 1);
      }
      if (STREAM) wait_full(MB_WEIGHT + wi0 % NW, (wi0 / NW) & 1);
      if (ksl == 3) {  // a 48-channel slab: a tap's three steps a group
        uint32_t ga[3][R][AP][4], gb[3][R][AP][4];  // [step][operand][plane][register]
        const auto load_tap = [&](uint32_t(&f)[3][R][AP][4]) {
#pragma unroll
          for (int kc = 0; kc < 3; ++kc) {
            cur.kc = kc;
            load_step(f[kc]);
          }
        };
        const auto issue_tap = [&](const uint32_t(&f)[3][R][AP][4]) {
          const uint32_t wb = w_base + (STREAM ? ((wi0 + cur.tap) % NW) * L.wstage
                                               : (cur.tap * cin_tot + s * L.slab_c) * N * 2);
          wg::fence();
#pragma unroll
          for (int kc = 0; kc < 3; ++kc) {
            const uint64_t d0 = wg::desc(wb + kc * N * 32, N * 16, 128);
            const int first = j + kc > 0;
#pragma unroll
            for (int p = 0; p < T::NPROD; ++p) product(p, f[kc], d0, first);
          }
          wg::commit();
        };
        // tap t from fc; then tap t + 1's fragments into fn, once tap t - 1
        // (which read fn) is done
        const auto step_tap = [&](uint32_t(&fc)[3][R][AP][4], uint32_t(&fn)[3][R][AP][4]) {
          const int wi = wi0 + cur.tap;
          const int frees = STREAM && wi + NW < nw ? 1 + wi % NW : 0;
          issue_tap(fc);
          wg::wait<1>();
#pragma unroll
          for (int kc = 0; kc < 3; ++kc)
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
              for (int pl = 0; pl < AP; ++pl) wg::fence_regs(fn[kc][r][pl]);
          release_w(last);
          last = frees;
          j += 3;
          k += 3;
          if (++cur.tap < taps) {
            if (++cur.dx == a.ks) {
              cur.dx = 0;
              ++cur.dy;
            }
            if (STREAM) wait_full(MB_WEIGHT + (wi0 + cur.tap) % NW, ((wi0 + cur.tap) / NW) & 1);
            load_tap(fn);
          }
        };
        load_tap(ga);
#pragma unroll 1
        while (true) {
          step_tap(ga, gb);
          if (k == steps) break;
          step_tap(gb, ga);
          if (k == steps) break;
        }
        wg::wait<0>();
#pragma unroll
        for (int kc = 0; kc < 3; ++kc)
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int pl = 0; pl < AP; ++pl) {
              wg::fence_regs(ga[kc][r][pl]);
              wg::fence_regs(gb[kc][r][pl]);
            }
        release_w(last);
        if (FORM == UPSAMPLE)
          wg::bar_sync(BAR_JOIN, NTHREADS);
        else if (si + 2 < ns)
          wg::bar_arrive(BAR_REMPTY + slot, NTHREADS);
        continue;
      }
      load_step(fa);
#pragma unroll 1
      while (true) {
        step(fa, fb);
        if (k == steps) break;
        step(fb, fa);
        if (k == steps) break;
      }
      // drain: the slab's products are done; its stages and region are free
      wg::wait<0>();
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int pl = 0; pl < AP; ++pl) {
          wg::fence_regs(fa[r][pl]);
          wg::fence_regs(fb[r][pl]);
        }
      release_w(last);
      if (FORM == UPSAMPLE)
        wg::bar_sync(BAR_JOIN, NTHREADS);
      else if (si + 2 < ns)
        wg::bar_arrive(BAR_REMPTY + slot, NTHREADS);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      wg::fence_regs(acc[r]);
      if constexpr (T::NPROD > 1 && T::acc2(T::NPROD - 1)) wg::fence_regs(acc2[r]);
    }
    PHASE_CLOCK(const long long t1 = clock64(); ph[0] += tw; ph[1] += t1 - t0 - tw;)

    // ---- epilogue from registers: v = the products (HIGHEST: hi.hi + the
    // small ones) + bias, act; band, state, pool
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j8 = 0; j8 < C8; ++j8)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * j8 + e;
          float v = acc[r][x];
          if constexpr (T::NPROD > 1 && T::acc2(T::NPROD - 1)) v += acc2[r][x];
          v += bias[j8][e & 1];
          res[r][x] = a.relu ? fmaxf(v, 0.f) : v;
        }
    pend = tile_idx(a, sc.tile(i), T::ROWS);
    if constexpr (T::STAGE_OUT)
      if (band_tma) stage_band();
#pragma unroll
    for (int k = 0; k < 2 * R; ++k) store_row(res[k >> 1], k >> 1, k & 1);
    PHASE_CLOCK(ph[2] += clock64() - t1; ++nt;)
  }
  if constexpr (T::STAGE_OUT)
    if (band_tma && lane == 0) bulk_wait<false>();
  PHASE_CLOCK(if (tid == 0) {
    wg::phase_clocks_add_at(ph, 3, nt);
    atomicAdd(&wg::g_phase_clocks[6], (unsigned long long)tww);
  })
}

// One layer on the warp-specialized body (N = cout_pad; FORM: resident,
// streamed in nslab slabs, or upsample; T: the numerics; tma: the tile
// staged with the tensor maps tin0 and taux, an upsample layer's source
// window with tin0; tma_out: the band stored with the tensor map tout): a
// resident layer's weights once per CTA and the FULL mbarriers, then the
// producer and the two consumers, each in its own branch to the end
template <int N, int FORM, class T>
__global__ void __launch_bounds__(NTHREADS, 1)
    ws_layer_kernel(const __grid_constant__ LayerArgs a, const __grid_constant__ CUtensorMap tin0,
                    const __grid_constant__ CUtensorMap taux,
                    const __grid_constant__ CUtensorMap tout, int nslab, int tma, int tma_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(a.ks, a.cin0_pad + a.aux_c, N, shape_of<T>(), FORM, nslab);
  if constexpr (FORM != STREAMED) {
    const int wbytes = a.ks * a.ks * (a.cin0_pad + a.aux_c) * N * 2 * T::WP;
    for (int i = threadIdx.x * 16; i < wbytes; i += NTHREADS * 16)
      wg::cp_async16(smem + i, reinterpret_cast<const unsigned char*>(a.w) + i);
    wg::cp_async_commit();
    wg::cp_async_wait<0>();
    wg::fence_async_smem();
  }
  if (threadIdx.x == 0) {
    uint64_t* mb = reinterpret_cast<uint64_t*>(smem + L.bars);
    for (int k = 0; k < MB_COUNT; ++k) mbar_init(&mb[k], k < MB_WEIGHT ? 128 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const Sched sc(a, T::ROWS);
  if (threadIdx.x >= NCONS) {
    wg::setmaxnreg_dec<T::PROD_REGS>();
    produce<N, FORM, T>(a, L, nslab, smem, sc, &tin0, &taux, tma != 0);
  } else {
    wg::setmaxnreg_inc<T::CONS_REGS>();
    consume<N, FORM, T>(a, L, nslab, smem, sc, &tout, tma_out != 0);
  }
}

// cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, without linking libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of channels [off, off + c) (c % inner == 0, inner 8 or
// c) of an NHWC tensor [B, H, W, stride] of fp32 (f32) or bf16 as
// [B][H][W][c / inner][inner], boxes of inner channels x cols x rows
// (coordinates outside the tensor read as zero).  TMA wants the base and
// the strides in whole 16-byte units (tile_tma, upsample_tma)
bool encode(CUtensorMap* m, const void* base, bool f32, int c, int inner, int stride, int off,
            int B, int H, int W, int rows, int cols) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const int eb = f32 ? 4 : 2;
  const cuuint64_t row = (cuuint64_t)stride * eb;
  const cuuint64_t dims[5] = {(cuuint64_t)inner, (cuuint64_t)(c / inner), (cuuint64_t)W,
                              (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[4] = {(cuuint64_t)inner * eb, row, row * W, row * W * H};
  const cuuint32_t box[5] = {(cuuint32_t)inner, 1, (cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return fn(m, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
            const_cast<unsigned char*>(static_cast<const unsigned char*>(base) + (size_t)off * eb),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// one launch of min(tiles, n_cta) CTAs; n_cta <= 0: one CTA an SM
template <int N, int FORM, class T>
cudaError_t launch(const LayerArgs& a, int nslab, int n_cta, cudaStream_t s) {
  const Layout L = layout(a.ks, a.cin0_pad + a.aux_c, N, shape_of<T>(), FORM, nslab);
  constexpr int EB = T::F32 ? 4 : 2;
  CUtensorMap tin0{}, taux{}, tout{};
  bool ok = true;
  const bool tma = FORM == UPSAMPLE || tile_tma(a, EB);
  // the band as [B][H][W][1][cout], boxes of cout channels x 32 columns x
  // the tile's rows: one consumer's half of a tile
  const bool tma_out = T::STAGE_OUT && a.out != nullptr && a.cout == N;
  if (tma_out)
    ok = encode(&tout, a.out, T::F32, N, N, N, 0, a.B, a.H, a.W, T::ROWS, 8);
  if (FORM == UPSAMPLE)
    ok = ok && encode(&tin0, a.in0, T::F32, a.in0_c, a.in0_c, a.in0_stride, a.in0_off, a.B, a.in0_h,
                a.in0_w, src_rows(T::ROWS), SRC_COLS);
  else if (tma)
    ok = ok && encode(&tin0, a.in0, T::F32, a.in0_c, 8, a.in0_stride, a.in0_off, a.B, a.H, a.W,
                L.rows_in, L.cols_in) &&
         (a.aux_c == 0 || encode(&taux, a.aux, T::F32, a.aux_c, 8, a.aux_stride, a.aux_off, a.B,
                                 a.H, a.W, L.rows_in, L.cols_in));
  if (!ok) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(ws_layer_kernel<N, FORM, T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (n_cta <= 0) n_cta = sms;
  const long long ntiles =
      (long long)((a.W + TW - 1) / TW) * ((a.H + T::ROWS - 1) / T::ROWS) * a.B;
  const int grid = (int)(ntiles < n_cta ? ntiles : n_cta);
  ws_layer_kernel<N, FORM, T><<<grid, NTHREADS, L.total, s>>>(a, tin0, taux, tout, nslab,
                                                               tma ? 1 : 0, tma_out ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace ws

// the configurations of conv_layer_kernel in order of preference: the first
// whose shared memory fits is launched
constexpr Config CONFIGS[] = {{4, 3}, {2, 3}, {2, 2}, {2, 1}};

template <int N, int TRW, int MODE>
cudaError_t launch(const LayerArgs& a, Config c, int smem, int n_cta, cudaStream_t s) {
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
  long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (n_cta > 0 && n_cta < slots) slots = n_cta;
  const long long ctas = (ntiles + c.nwg - 1) / c.nwg;
  const int grid = (int)(ctas < slots ? ctas : slots);
  conv_layer_kernel<N, TRW, MODE><<<grid, 128 * c.nwg, smem, s>>>(a);
  return cudaGetLastError();
}

// the first configuration of `mode` whose shared memory fits, or {0, 0}
Config pick(const LayerArgs& a, int n, int mode) {
  for (const Config& c : CONFIGS)
    if (smem_layout(a.ks, a.cin0_pad + a.aux_c, n, mode, c).total <= SMEM_MAX) return c;
  return Config{0, 0};
}

struct Plan {
  int mode;
  Config c;   // {0, 0}: nothing fits
  int nslab;  // the warp-specialized body: input channel slabs of a tile (1: weights resident)
  int smem;   // bytes of shared memory a CTA
};

// the plan of a layer on the warp-specialized body in the numerics T
template <class T>
Plan ws_plan(const LayerArgs& a, int n, int resident, int streamed, int upsample) {
  const int cin_tot = a.cin0_pad + a.aux_c;
  int form;
  const ws::Shape sh = ws::shape_of<T>();
  const int ns = ws::plan_form(a.ks, cin_tot, n, sh, ws::upsample_tma(a, T::F32 ? 4 : 2), form);
  const int m = form == ws::UPSAMPLE ? upsample : form == ws::STREAMED ? streamed : resident;
  if (ns == 0) return Plan{m, Config{0, 0}, 0, 0};
  return Plan{m, Config{T::ROWS, ws::NTHREADS / 128}, ns,
              ws::layout(a.ks, cin_tot, n, sh, form, ns).total};
}

// a layer's mode and configuration, a function of its shape and its
// numerics alone.  The bf16 numerics keep the weights resident (split ones
// too) on the serial body; the others run the warp-specialized body
// (ws::plan_form)
Plan plan(const LayerArgs& a, int n, int prec) {
  if (prec == P_HIGH) return ws_plan<ws::HighNum>(a, n, HIGH, HIGH_STREAM, HIGH_UP);
  if (prec == P_HIGHEST) return ws_plan<ws::HighestNum>(a, n, HX, HX_STREAM, HX_UP);
  if (prec == P_W32) return ws_plan<ws::W32Num>(a, n, W32, W32_STREAM, W32_UP);
  const int m = prec == P_BF16_SPLIT ? BF16_SPLIT : BF16;
  const Config c = pick(a, n, m);
  return Plan{m, c, 0, c.nwg ? smem_layout(a.ks, a.cin0_pad + a.aux_c, n, m, c).total : 0};
}

template <int N, int MODE>
cudaError_t launch_mode(const LayerArgs& a, Config c, int n_cta, cudaStream_t s) {
  const int smem = smem_layout(a.ks, a.cin0_pad + a.aux_c, N, MODE, c).total;
  return c.trw == 4 ? launch<N, 4, MODE>(a, c, smem, n_cta, s) : launch<N, 2, MODE>(a, c, smem, n_cta, s);
}

template <int N>
cudaError_t launch_plan(const LayerArgs& a, Plan p, int n_cta, cudaStream_t s) {
  if (p.c.nwg == 0) return cudaErrorInvalidValue;  // no configuration fits
  switch (p.mode) {
    case BF16: return launch_mode<N, BF16>(a, p.c, n_cta, s);
    case BF16_SPLIT: return launch_mode<N, BF16_SPLIT>(a, p.c, n_cta, s);
    case HIGH: return ws::launch<N, ws::RESIDENT, ws::HighNum>(a, p.nslab, n_cta, s);
    case HIGH_STREAM: return ws::launch<N, ws::STREAMED, ws::HighNum>(a, p.nslab, n_cta, s);
    case HIGH_UP: return ws::launch<N, ws::UPSAMPLE, ws::HighNum>(a, p.nslab, n_cta, s);
    case HX: return ws::launch<N, ws::RESIDENT, ws::HighestNum>(a, p.nslab, n_cta, s);
    case HX_STREAM: return ws::launch<N, ws::STREAMED, ws::HighestNum>(a, p.nslab, n_cta, s);
    case HX_UP: return ws::launch<N, ws::UPSAMPLE, ws::HighestNum>(a, p.nslab, n_cta, s);
    case W32: return ws::launch<N, ws::RESIDENT, ws::W32Num>(a, p.nslab, n_cta, s);
    case W32_STREAM: return ws::launch<N, ws::STREAMED, ws::W32Num>(a, p.nslab, n_cta, s);
    default: return ws::launch<N, ws::UPSAMPLE, ws::W32Num>(a, p.nslab, n_cta, s);
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
// 3, bf16 under the others.  n_cta > 0 caps the grid (the card tests walk
// many tiles in few CTAs); n_cta <= 0 launches the plan's grid.  Returns a
// cudaError_t as int.
int rvdd_conv_layer_grid(const void* in0, int in0_c, int in0_stride, int in0_off,
                         int in0_h, int in0_w, int upsample,
                         const void* aux, int aux_c, int aux_stride, int aux_off,
                         const void* w, int prec, const void* bias,
                         int ks, int cin0_pad, int cout, int cout_pad, int relu,
                         int B, int H, int W,
                         void* out, void* pooled,
                         void* state, int state_stride, int state_off, int state_zero,
                         int n_cta, void* stream) {
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
      case 16: e = launch_plan<16>(a, p, n_cta, s); break;
      case 32: e = launch_plan<32>(a, p, n_cta, s); break;
      case 48: e = launch_plan<48>(a, p, n_cta, s); break;
      default: e = cudaErrorInvalidValue;
    }
  }
  if (e != cudaSuccess) cudaGetLastError();  // clear it; report it once
  return (int)e;
}

// rvdd_conv_layer_grid with the plan's grid (the main path's)
int rvdd_conv_layer(const void* in0, int in0_c, int in0_stride, int in0_off,
                    int in0_h, int in0_w, int upsample,
                    const void* aux, int aux_c, int aux_stride, int aux_off,
                    const void* w, int prec, const void* bias,
                    int ks, int cin0_pad, int cout, int cout_pad, int relu,
                    int B, int H, int W,
                    void* out, void* pooled,
                    void* state, int state_stride, int state_off, int state_zero,
                    void* stream) {
  return rvdd_conv_layer_grid(in0, in0_c, in0_stride, in0_off, in0_h, in0_w, upsample, aux, aux_c,
                              aux_stride, aux_off, w, prec, bias, ks, cin0_pad, cout, cout_pad,
                              relu, B, H, W, out, pooled, state, state_stride, state_off,
                              state_zero, 0, stream);
}

// The launch plan of a layer of that shape (K = ks^2 * cin_tot; upsample:
// its input is upsampled, and is cin_tot channels with no aux) in the
// numerics prec, as rvdd_conv_layer makes it: out[0] the mode (enum Mode:
// 0 bf16, 1 bf16 with split weights; on the warp-specialized body, 2 and
// 3 fp32 bands with bf16_3x products, 4 and 5 with HIGHEST products, 6
// and 7 bf16 bands with fp32 weights, the weights resident in the first
// of each pair and streamed in the second; 8 HIGHEST's, 9 bf16_3x's and 10
// the fp32 weights' upsample form), out[1] the tile rows, out[2] the
// warpgroups a CTA, out[3] the shared memory a CTA, out[4] the
// warp-specialized body's input channel slabs a tile (0 on the serial
// body), out[5] its weight stages (0 when resident).  Returns a cudaError_t as int:
// cudaErrorInvalidValue for a shape the kernel does not take or that fits
// no configuration.
int rvdd_conv_layer_plan(int ks, int cin_tot, int cout_pad, int prec, int upsample, int* out) {
  if (bad_shape(ks, cin_tot, prec) || (cout_pad != 16 && cout_pad != 32 && cout_pad != 48))
    return (int)cudaErrorInvalidValue;
  LayerArgs a = {};
  a.ks = ks;
  a.cin0_pad = a.in0_c = a.in0_stride = cin_tot;
  a.upsample = upsample;
  const Plan p = plan(a, cout_pad, prec);
  if (p.c.nwg == 0) return (int)cudaErrorInvalidValue;
  out[0] = p.mode;
  out[1] = p.c.trw;
  out[2] = p.c.nwg;
  out[3] = p.smem;
  out[4] = p.nslab;
  out[5] = p.mode == HX_STREAM || p.mode == HIGH_STREAM || p.mode == W32_STREAM ? ws::NW : 0;
  return 0;
}

}  // extern "C"
