// The device code of both RoIAlign pooler kernels: multilevel ROIAlignV2
// (aligned=True), adaptive sampling (POOLER_SAMPLING_RATIO 0, n =
// ceil(bin cells) samples per bin, no cap) or a fixed s x s grid; bf16 NHWC
// features -- or int8 ones with one f32 scale a level -- in, bf16 (B, R, P,
// P, C) out, or float32 features in and float32 out; f32 accumulation.
// roi_align_blocked.cu (K2: large maps and
// adaptive sampling) and roi_align.cu (K1: fixed sampling on small maps,
// with kernels specialised at the fast profile's P and s) each include it
// and export their own entry point.
//
// Float32 levels: the reference's XLA path off the TPU (its TPU kernel casts
// each staged chunk to bf16, roi_align_pallas.py:141; the port's plain
// versions, which the float32 profiles' parity tests use, do not): chunks
// staged as f32 cells (a slot holds half the cells of a bf16 one), a lane's
// 8 channels two 16-byte loads, the same weights and sums, f32 out.
//
// Int8 levels: each cell is the bf16 value bf16(q * s_l) of the plain
// version's dequantized level (one __fmul_rn and one rounding); the scale of
// the box's level comes from `scales`. (The TPU kernels fold the scale into
// their weights or rows instead, roi_align_pallas.py:110-115, 453-457.)
//
// What bounds it on an H100: bytes and their latency, then instruction
// issue. Each cell a box touches is read once per box (from L2: the
// proposals of an image overlap) and costs one multiply-add per channel,
// some 300x below the card's ridge; the output is 2 bytes per bin and
// channel. What the design does about it:
//   * Work split. A block takes (image, box, band of output rows). Its
//     warps split the output columns q (1, 2 or 4 a warp), a lane holds 8
//     channels (one 16-byte bf16 vector), and the band's bins stay in
//     registers. P = 7: one band of 7 rows, 7 warps; P = 14: bands of 4
//     rows, 7 warps of 2 columns, so K2's mask pooler's 1,600 boxes make
//     6,400 blocks (K1's, at the fast profile, 512 boxes and 2,048).
//   * Weights first. Each block evaluates its band's y-weights and all
//     x-weights into shared memory, each bin's over its own tap span, with
//     each bin's non-zero range and, per row, the band rows it weighs; only
//     the rows and columns of non-zero weight are staged.
//   * Staging. That region is cut into chunks -- whole rows when a row
//     fits, else row segments -- in a ring of kStages copy slots. One
//     thread issues one bulk copy (cp.async.bulk, the non-tensor TMA) per
//     row segment, contiguous in NHWC, its bytes counted on the slot's
//     mbarrier, so the next chunk's copy overlaps the current chunk's sums.
//     One block barrier a chunk.
//   * Arithmetic. Per staged row the x-pass t[q] = sum_x wx[q, x] f[y, x]
//     runs once (carried across the segments of a long row; two rows at a
//     time when a warp has one column); then acc[p, q] += wy[p, y] t[q] for
//     the band rows that weigh y.
//   * Int8 levels. Chunks are copied as int8, half the bytes. Once a chunk
//     lands, the block dequantizes each of its cells once -- 16 channels a
//     thread from one 16-byte load, each bf16(q * s_l) with one __fmul_rn
//     and one rounding, the plain version's dequantized value -- into a
//     bf16 work buffer, which the x-pass then reads as it reads a bf16
//     chunk: a cell read by several output columns is converted once. The
//     work buffer is refilled once every warp is done with it (a second
//     barrier a chunk, after the first chunk). The convert is still what
//     int8 levels cost over bf16 ones: the bytes they save bound nothing.
// The weights are those of the plain version (ops/roi_align_kernel.py:
// bin_sizes, _axis_weight_matrix, _axis_weights_adaptive_at), operation for
// operation, each explicitly rounded (no contraction into FMA), so that the
// floor/ceil decisions of the series and the [-1, dim] border rule fall the
// same way in both (a division by the stride, a power of two, is the product
// with its exact reciprocal). The adaptive series divides (lo + p * bin) by
// the stride after the sum, as the plain version (and the reference's XLA form,
// roadsurf_tpu/ops/roi_align.py:148) does; the TPU kernel divides lo and bin
// by the stride first (roi_align_pallas.py:307-313), which rounds
// differently.

#pragma once

#include <algorithm>
#include <climits>
#include <cstdint>

#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bulk_copy.cuh"
#include "smem_cap.cuh"

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxSampling = 16;
constexpr int kMaxOut = 32;
constexpr int kMaxSmem = 232448;
constexpr int kLaneC = 8;              // channels a lane holds
constexpr int kMaxC = 32 * kLaneC;     // channels a block holds
constexpr int kMaxWarps = 8;           // output columns a block's warps split
constexpr int kStages = 2;             // the staging ring's copy slots
constexpr int kStageBytes = 49152;     // a slot of bf16 cells
constexpr int kStageBytes8 = 24576;    // a slot of int8 cells; a bf16 work
                                       // buffer of twice that holds its cells

// The kernel's phases, for attributing its time (tools/
// bench_pooler_variants.py builds a library of each with
// -DROI_ALIGN_STAGE=n): it stops after the weights are in shared memory
// (0), after each chunk is staged (1: its bulk copies landed and, for int8
// levels, its cells dequantized), after the x-pass (2: each staged row's
// sums added into the band's first row unweighted, so that the pass is
// kept), or runs whole (3). Only 3 computes the pooler; it is the default,
// and every build of K1 and K2 takes it.
#ifndef ROI_ALIGN_STAGE
#define ROI_ALIGN_STAGE 3
#endif
constexpr int kStageWeights = 0;
constexpr int kStageCopy = 1;
constexpr int kStageXPass = 2;
constexpr int kStageFull = 3;
constexpr int kStage = ROI_ALIGN_STAGE;
static_assert(kStage >= kStageWeights && kStage <= kStageFull,
              "ROI_ALIGN_STAGE is 0, 1, 2 or 3");

// Bytes of the staging ring (and, for int8 levels, the work buffer) in
// front of the weight tables.
__host__ __device__ constexpr int ring_bytes(bool int8) {
  return int8 ? kStages * kStageBytes8 + 2 * kStageBytes8
              : kStages * kStageBytes;
}

struct Pyramid {
  const void* feat[kMaxLevels];
  int H[kMaxLevels];
  int W[kMaxLevels];
  float stride[kMaxLevels];
  int n_levels;
};

// One axis of one box.
struct Axis {
  float lo;      // box start, image pixels
  float bin;     // bin size, image pixels
  float inv;     // 1 / level stride: a power of two, so x * inv == x / stride
  float dim;     // level side, cells
  int sampling;  // 0: adaptive
  float n;       // adaptive: samples per bin
  float dt;      // adaptive: true sample spacing, cells
  float dl;      // adaptive: guarded spacing (1 for zero-size bins)
};

__device__ __forceinline__ Axis make_axis(float lo, float bin, float stride,
                                          int dim, int sampling) {
  Axis a;
  a.lo = lo;
  a.bin = bin;
  a.inv = 1.0f / stride;
  a.dim = static_cast<float>(dim);
  a.sampling = sampling;
  const float bins = __fmul_rn(bin, a.inv);
  a.n = fmaxf(ceilf(bins), 1.0f);
  a.dt = __fdiv_rn(bins, a.n);
  a.dl = a.dt > 0.0f ? a.dt : 1.0f;
  return a;
}

// Image position of bin p's start: lo + p * bin.
__device__ __forceinline__ float bin_start(float lo, float bin, int p) {
  return __fadd_rn(lo, __fmul_rn(static_cast<float>(p), bin));
}

// Sample i of bin p sits at A + (i + 0.5) * dl.
__device__ __forceinline__ float bin_origin(const Axis& a, int p) {
  float v = __fsub_rn(__fmul_rn(bin_start(a.lo, a.bin, p), a.inv), 0.5f);
  return __fadd_rn(v, __fmul_rn(0.5f, __fsub_rn(a.dt, a.dl)));
}

// i-coordinate of position x: c_i <= x  <=>  i <= t(x).
__device__ __forceinline__ float tpos(float x, float A, float dl) {
  return __fsub_rn(__fdiv_rn(__fsub_rn(x, A), dl), 0.5f);
}

// (count, sum of c_i) over integer i in [i0, i1] and [0, n - 1].
__device__ __forceinline__ float2 series(float i0, float i1, float A,
                                         float dl, float n) {
  const float i0c = fmaxf(i0, 0.0f);
  const float i1c = fminf(i1, __fsub_rn(n, 1.0f));
  const float m = fmaxf(__fadd_rn(__fsub_rn(i1c, i0c), 1.0f), 0.0f);
  const float si = __fmul_rn(__fmul_rn(0.5f, __fadd_rn(i0c, i1c)), m);
  const float s =
      m > 0.0f ? __fadd_rn(__fmul_rn(m, __fadd_rn(A, __fmul_rn(0.5f, dl))),
                           __fmul_rn(dl, si))
               : 0.0f;
  return make_float2(m, s);
}

// Adaptive weight of cell d (0 <= d <= dim - 1) in bin p.
__device__ __forceinline__ float adaptive_weight(const Axis& a, int p,
                                                 float d) {
  const float A = bin_origin(a, p);
  const float hi1 = floorf(tpos(d, A, a.dl));
  const float2 r1 =
      series(__fadd_rn(floorf(tpos(__fsub_rn(d, 1.0f), A, a.dl)), 1.0f), hi1,
             A, a.dl, a.n);
  const float part1 = __fsub_rn(r1.y, __fmul_rn(r1.x, __fsub_rn(d, 1.0f)));
  const float2 r2 = series(__fadd_rn(hi1, 1.0f),
                           floorf(tpos(__fadd_rn(d, 1.0f), A, a.dl)), A,
                           a.dl, a.n);
  const float part2 = __fsub_rn(__fmul_rn(r2.x, __fadd_rn(d, 1.0f)), r2.y);
  float w = __fadd_rn(part1, part2);
  if (d == 0.0f) {
    const float2 b0 =
        series(ceilf(tpos(-1.0f, A, a.dl)),
               __fsub_rn(ceilf(tpos(0.0f, A, a.dl)), 1.0f), A, a.dl, a.n);
    w = __fadd_rn(w, __fsub_rn(b0.x, __fadd_rn(b0.y, b0.x)));
  }
  const float last = __fsub_rn(a.dim, 1.0f);
  if (d == last) {
    const float2 bt =
        series(__fadd_rn(floorf(tpos(last, A, a.dl)), 1.0f),
               floorf(tpos(a.dim, A, a.dl)), A, a.dl, a.n);
    w = __fadd_rn(w, __fsub_rn(bt.y, __fmul_rn(bt.x, last)));
  }
  return __fdiv_rn(w, a.n);
}

// Fixed-grid weight of cell d in bin p: the tent sum over the s samples.
__device__ __forceinline__ float fixed_weight(const Axis& a, int p,
                                              float d) {
  float m = 0.0f;
  const float last = __fsub_rn(a.dim, 1.0f);
  for (int s = 0; s < a.sampling; ++s) {
    const float u = (s + 0.5f) / static_cast<float>(a.sampling);
    float c = __fadd_rn(static_cast<float>(p), u);
    c = __fmul_rn(c, a.bin);
    c = __fadd_rn(a.lo, c);
    c = __fmul_rn(c, a.inv);
    c = __fsub_rn(c, 0.5f);
    if (c >= -1.0f && c <= a.dim) {
      const float cc = fminf(fmaxf(c, 0.0f), last);
      m = __fadd_rn(m, fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(cc, d))), 0.0f));
    }
  }
  return __fdiv_rn(m, static_cast<float>(a.sampling));
}

// Cells [s0, s1] that can carry weight for samples between image positions
// lo and hi: a sample's taps are floor(c) and floor(c) + 1, and one cell of
// margin on each side covers the rounding.
__device__ __forceinline__ int2 tap_span(float lo, float hi, float inv,
                                         int dim) {
  const float last = static_cast<float>(dim - 1);
  const float a = floorf(fminf(lo, hi) * inv - 0.5f) - 1.0f;
  const float b = floorf(fmaxf(lo, hi) * inv - 0.5f) + 2.0f;
  return make_int2(static_cast<int>(fminf(fmaxf(a, 0.0f), last)),
                   static_cast<int>(fminf(fmaxf(b, 0.0f), last)));
}

// Weights of bins p0 .. p0 + nb - 1 at cells s0 .. s0 + n - 1 into
// w[i * n + cell - s0], each bin's evaluated over its own tap span only
// (the other cells weigh 0 and are never read); lo[i], hi[i] get the first
// and last cell of non-zero weight, and bit i of mask[cell - s0] (when
// given) is set where bin i's weight is non-zero.
__device__ __forceinline__ void fill_weights(const Axis& a, int p0, int nb,
                                             int s0, int n, float* w,
                                             int* lo, int* hi, int* mask) {
  // a bin's tap span holds at most ceil(|bin| / stride) + 4 cells; one
  // more covers the rounding of the bin edges
  const int span =
      min(n, static_cast<int>(ceilf(fabsf(a.bin) * a.inv)) + 5);
  for (int k = threadIdx.x; k < nb * span; k += blockDim.x) {
    const int i = k / span;
    const int2 t = tap_span(bin_start(a.lo, a.bin, p0 + i),
                            bin_start(a.lo, a.bin, p0 + i + 1), a.inv,
                            static_cast<int>(a.dim));
    const int cell = max(t.x, s0) + k - i * span;
    if (cell > min(t.y, s0 + n - 1)) continue;
    const float d = static_cast<float>(cell);
    const float v = a.sampling == 0 ? adaptive_weight(a, p0 + i, d)
                                    : fixed_weight(a, p0 + i, d);
    w[i * n + cell - s0] = v;
    if (v != 0.0f) {
      atomicMin(&lo[i], cell);
      atomicMax(&hi[i], cell);
      if (mask != nullptr) atomicOr(&mask[cell - s0], 1 << i);
    }
  }
}

// A lane's 8 channels of a staged bf16 cell as f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// A lane's 8 channels of a staged f32 cell.
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
  v[4] = b.x;
  v[5] = b.y;
  v[6] = b.z;
  v[7] = b.w;
}

// 16 int8 channels dequantized to their bf16 values bf16(q * s): q + 128 in
// the low byte of 2^23's bits is 2^23 + 128 + q exactly, then one product
// each, rounded to bf16 two at a time.
__device__ __forceinline__ void dequant16(uint4 u, float s,
                                          __nv_bfloat16* dst) {
  const unsigned w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u,
                         u.z ^ 0x80808080u, u.w ^ 0x80808080u};
  unsigned o[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const unsigned sel = 0x7440u | (2 * (k % 2));
    const float a = __fsub_rn(
        __uint_as_float(__byte_perm(w[k / 2], 0x4B000000u, sel)), 8388736.0f);
    const float b = __fsub_rn(
        __uint_as_float(__byte_perm(w[k / 2], 0x4B000000u, sel + 1)),
        8388736.0f);
    const __nv_bfloat162 h =
        __floats2bfloat162_rn(__fmul_rn(a, s), __fmul_rn(b, s));
    o[k] = *reinterpret_cast<const unsigned*>(&h);
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(o[0], o[1], o[2], o[3]);
  d[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// A chunk of the staged region: rows y .. y + nr - 1, cells xs .. xs + ncx
// - 1.
struct Chunk {
  int y, nr, xs, ncx;
};

// The region [rx0, rx0 + nx) x [ry0, ry0 + ny) in chunks of at most `cap`
// cells: rows_per whole rows when a row fits, else segs segments a row.
struct Region {
  int rx0, nx, ry0, ny, cap, rows_per, segs, chunks;

  __device__ __forceinline__ Chunk chunk(int c) const {
    Chunk k;
    if (segs == 1) {
      k.y = ry0 + c * rows_per;
      k.nr = min(rows_per, ry0 + ny - k.y);
      k.xs = rx0;
      k.ncx = nx;
    } else {
      k.y = ry0 + c / segs;
      k.nr = 1;
      k.xs = rx0 + (c % segs) * cap;
      k.ncx = min(cap, rx0 + nx - k.xs);
    }
    return k;
  }
};

// Block (box, band of output rows): see the note at the top. Warp w takes
// the output columns w, w + warps, ... (QPW of them), every row of the band.
// With two columns a warp (P = 14) the registers are held to two blocks an
// SM, which ran faster than one block of more registers.
// kP > 0 and kS >= 0 fix P and the sampling at compile time (K1's
// specialisations); 0 and -1 take them from the arguments. T: the levels'
// type (bf16, int8 or float); out is float for float levels, else bf16.
template <typename T, int QPW, int kP, int kS>
__global__ void __launch_bounds__(32 * kMaxWarps, QPW == 2 ? 2 : 1)
    roi_align_staged_kernel(Pyramid pyr, const float* __restrict__ scales,
                            const float* __restrict__ boxes,
                            const int* __restrict__ lvl,
                            void* __restrict__ out, int R, int C,
                            int P_arg, int sampling_arg, int side) {
  const int P = kP > 0 ? kP : P_arg;
  const int sampling = kS >= 0 ? kS : sampling_arg;
  constexpr int kBand = kMaxWarps / QPW;  // band rows a block holds
  constexpr bool kPair = QPW == 1;        // two rows' x-passes at a time
  constexpr bool kInt8 = sizeof(T) == 1;
  constexpr bool kF32 = sizeof(T) == 4;
  // the x-pass's cells: f32 for float levels, else bf16 (int8 cells
  // dequantized into the work buffer)
  using Cell = typename std::conditional<kF32, float, __nv_bfloat16>::type;
  constexpr int kSlot = kInt8 ? kStageBytes8 : kStageBytes;  // a copy slot
  // chunks in flight: a bf16 slot is read in place, so the copy into it
  // waits for the next chunk's barrier; an int8 slot is free once its
  // chunk is dequantized
  constexpr int kAhead = kInt8 ? kStages : kStages - 1;
  constexpr int kRingBytes = ring_bytes(kInt8);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t full[kStages];  // slot s holds its chunk
  // int8: the bf16 work buffer, kSlot values (an int8 slot's cells)
  __nv_bfloat16* work =
      reinterpret_cast<__nv_bfloat16*>(smem + kStages * kSlot);
  float* wy = reinterpret_cast<float*>(smem + kRingBytes);
  float* wx = wy + kBand * side;                      // [P][x span]
  int* rows = reinterpret_cast<int*>(wx + P * side);  // [y span]: bins
  int* ya = rows + side;
  int* yb = ya + kBand;
  int* xa = yb + kBand;
  int* xb = xa + P;

  const int n_bands = (P + kBand - 1) / kBand;
  const int roi = blockIdx.x / n_bands;  // b * R + r
  const int p0 = (blockIdx.x - roi * n_bands) * kBand;
  const int nb = min(kBand, P - p0);
  const int b = roi / R;
  const int l = min(max(lvl[roi], 0), pyr.n_levels - 1);
  // the box's level, read with constant indices (a dynamic index would
  // copy the whole parameter struct to the stack of every thread)
  const void* feat = nullptr;
  int H = 1, W = 1;
  float stride = 1.0f;
#pragma unroll
  for (int k = 0; k < kMaxLevels; ++k) {
    if (k == l) {
      feat = pyr.feat[k];
      H = pyr.H[k];
      W = pyr.W[k];
      stride = pyr.stride[k];
    }
  }
  const float* bx = boxes + 4 * static_cast<size_t>(roi);
  const float bin_x =
      __fdiv_rn(__fsub_rn(bx[2], bx[0]), static_cast<float>(P));
  const float bin_y =
      __fdiv_rn(__fsub_rn(bx[3], bx[1]), static_cast<float>(P));

  // the weights over the tap spans of the box's columns and the band's
  // rows, with each bin's non-zero range and each row's bins
  const int2 sx = tap_span(bx[0], bx[2], 1.0f / stride, W);
  const int2 sy = tap_span(bin_start(bx[1], bin_y, p0),
                           bin_start(bx[1], bin_y, p0 + nb), 1.0f / stride,
                           H);
  const int nxt = sx.y - sx.x + 1;
  const int nyt = sy.y - sy.x + 1;
  for (int i = threadIdx.x; i < kBand; i += blockDim.x) {
    ya[i] = INT_MAX;
    yb[i] = -1;
  }
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    xa[i] = INT_MAX;
    xb[i] = -1;
  }
  for (int i = threadIdx.x; i < nyt; i += blockDim.x) rows[i] = 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) bulk::mbar_init(&full[i]);
    bulk::fence_init();
  }
  __syncthreads();
  fill_weights(make_axis(bx[1], bin_y, stride, H, sampling), p0, nb, sy.x,
               nyt, wy, ya, yb, rows);
  fill_weights(make_axis(bx[0], bin_x, stride, W, sampling), 0, P, sx.x,
               nxt, wx, xa, xb, nullptr);
  __syncthreads();

  // the region staged: the rows and columns of non-zero weight
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  int ry0 = INT_MAX, ry1 = -1, rx0 = INT_MAX, rx1 = -1;
  for (int i = 0; i < nb; ++i) {
    ry0 = min(ry0, ya[i]);
    ry1 = max(ry1, yb[i]);
  }
  int xlo[QPW], xhi[QPW];  // this warp's columns' ranges
#pragma unroll
  for (int j = 0; j < QPW; ++j) {
    xlo[j] = INT_MAX;
    xhi[j] = -1;
  }
  for (int q = 0; q < P; ++q) {
    rx0 = min(rx0, xa[q]);
    rx1 = max(rx1, xb[q]);
#pragma unroll
    for (int j = 0; j < QPW; ++j) {
      if (q == warp + j * nwarps) {
        xlo[j] = xa[q];
        xhi[j] = xb[q];
      }
    }
  }
  const int cell_bytes = C * static_cast<int>(sizeof(T));
  Region g;
  g.rx0 = rx0;
  g.nx = rx1 - rx0 + 1;
  g.ry0 = ry0;
  g.ny = ry1 - ry0 + 1;
  g.cap = kSlot / cell_bytes;
  g.rows_per = g.nx <= g.cap ? g.cap / g.nx : 1;
  g.segs = g.nx <= g.cap ? 1 : (g.nx + g.cap - 1) / g.cap;
  g.chunks = rx0 > rx1 || ry0 > ry1 ? 0
             : g.segs == 1          ? (g.ny + g.rows_per - 1) / g.rows_per
                                    : g.ny * g.segs;
  if constexpr (kStage == kStageWeights) g.chunks = 0;

  // one thread copies a chunk: one bulk copy per row segment (contiguous in
  // NHWC), all counted on the slot's barrier
  const T* f =
      static_cast<const T*>(feat) + static_cast<size_t>(b) * H * W * C;
  auto issue = [&](int c) {
    const Chunk k = g.chunk(c);
    const int slot = c % kStages;
    unsigned char* dst = smem + slot * kSlot;
    const unsigned row_bytes = k.ncx * cell_bytes;
    bulk::mbar_expect(&full[slot], k.nr * row_bytes);
    for (int r = 0; r < k.nr; ++r)
      bulk::copy(dst + r * row_bytes,
                 f + (static_cast<size_t>(k.y + r) * W + k.xs) * C, row_bytes,
                 &full[slot]);
  };
  if (threadIdx.x == 0)
    for (int c = 0; c < kAhead && c < g.chunks; ++c) issue(c);

  const float scale = scales != nullptr ? scales[l] : 1.0f;
  const bool active = lane * kLaneC < C;
  float acc[kBand][QPW][kLaneC];
  float t0[QPW][kLaneC], t1[QPW][kLaneC];  // x-passes of two rows
#pragma unroll
  for (int j = 0; j < QPW; ++j)
#pragma unroll
    for (int e = 0; e < kLaneC; ++e) {
      t0[j][e] = t1[j][e] = 0.0f;
#pragma unroll
      for (int i = 0; i < kBand; ++i) acc[i][j][e] = 0.0f;
    }
  // the y-pass of row y into the band's rows that weigh it
  auto ypass = [&](int y, float(&t)[QPW][kLaneC]) {
    if constexpr (kStage == kStageXPass) {
#pragma unroll
      for (int j = 0; j < QPW; ++j)
#pragma unroll
        for (int e = 0; e < kLaneC; ++e) {
          acc[0][j][e] += t[j][e];
          t[j][e] = 0.0f;
        }
      return;
    }
    const int bins = rows[y - sy.x];
#pragma unroll
    for (int i = 0; i < kBand; ++i) {
      if (bins >> i & 1) {
        const float w = wy[i * nyt + y - sy.x];
#pragma unroll
        for (int j = 0; j < QPW; ++j)
#pragma unroll
          for (int e = 0; e < kLaneC; ++e) acc[i][j][e] += w * t[j][e];
      }
    }
#pragma unroll
    for (int j = 0; j < QPW; ++j)
#pragma unroll
      for (int e = 0; e < kLaneC; ++e) t[j][e] = 0.0f;
  };

  for (int c = 0; c < g.chunks; ++c) {
    bulk::mbar_wait(&full[c % kStages], (c / kStages) & 1);  // chunk c landed
    const Chunk k = g.chunk(c);
    unsigned char* slot = smem + (c % kStages) * kSlot;
    // the chunk's cells: the slot itself, or the work buffer
    const Cell* cells = reinterpret_cast<const Cell*>(slot);
    if constexpr (kInt8) {
      // each cell once, 16 channels a thread, once every warp is done
      // with chunk c - 1's cells
      if (c > 0) __syncthreads();
      const uint4* src = reinterpret_cast<const uint4*>(slot);
      const int items = k.nr * k.ncx * C / 16;
      for (int i = threadIdx.x; i < items; i += blockDim.x)
        dequant16(src[i], scale, work + 16 * i);
      cells = work;
    }
    // bf16: every warp is done with chunk c - 1's slot; int8: chunk c's
    // cells are all dequantized and its slot is free
    __syncthreads();
    if (threadIdx.x == 0 && c + kAhead < g.chunks) issue(c + kAhead);
    if (!active) continue;
    if constexpr (kStage == kStageCopy) continue;
    const Cell* buf = cells + lane * kLaneC;
    // the x-pass of each row for each of the warp's columns, two rows at a
    // time; a row cut into segments carries its sums to its last segment
    int r = 0;
    for (; kPair && r + 1 < k.nr; r += 2) {
      const Cell* row = buf + (r * k.ncx - k.xs) * C;
#pragma unroll
      for (int j = 0; j < QPW; ++j) {
        const float* wq = wx + (warp + j * nwarps) * nxt - sx.x;
#pragma unroll 2
        for (int x = xlo[j]; x <= xhi[j]; ++x) {
          float v0[kLaneC], v1[kLaneC];
          load8(row + x * C, v0);
          load8(row + (k.ncx + x) * C, v1);
          const float w = wq[x];
#pragma unroll
          for (int e = 0; e < kLaneC; ++e) {
            t0[j][e] += w * v0[e];
            t1[j][e] += w * v1[e];
          }
        }
      }
      ypass(k.y + r, t0);
      ypass(k.y + r + 1, t1);
    }
    for (; r < k.nr; ++r) {
      const Cell* row = buf + (r * k.ncx - k.xs) * C;
#pragma unroll
      for (int j = 0; j < QPW; ++j) {
        const float* wq = wx + (warp + j * nwarps) * nxt - sx.x;
        const int x0 = max(xlo[j], k.xs);
        const int x1 = min(xhi[j], k.xs + k.ncx - 1);
#pragma unroll 4
        for (int x = x0; x <= x1; ++x) {
          float v[kLaneC];
          load8(row + x * C, v);
          const float w = wq[x];
#pragma unroll
          for (int e = 0; e < kLaneC; ++e) t0[j][e] += w * v[e];
        }
      }
      if (k.xs + k.ncx == g.rx0 + g.nx) ypass(k.y + r, t0);
    }
  }

  if (!active) return;
#pragma unroll
  for (int i = 0; i < kBand; ++i) {
    if (i >= nb) continue;
#pragma unroll
    for (int j = 0; j < QPW; ++j) {
      const int q = warp + j * nwarps;
      if (q >= P) continue;
      const size_t at =
          ((static_cast<size_t>(roi) * P + p0 + i) * P + q) * C +
          lane * kLaneC;
      if constexpr (kF32) {
        float4* dst = reinterpret_cast<float4*>(static_cast<float*>(out) + at);
        dst[0] = make_float4(acc[i][j][0], acc[i][j][1], acc[i][j][2],
                             acc[i][j][3]);
        dst[1] = make_float4(acc[i][j][4], acc[i][j][5], acc[i][j][6],
                             acc[i][j][7]);
        continue;
      }
      uint4 o;
      unsigned* ow = reinterpret_cast<unsigned*>(&o);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 h =
            __floats2bfloat162_rn(acc[i][j][2 * e], acc[i][j][2 * e + 1]);
        ow[e] = *reinterpret_cast<const unsigned*>(&h);
      }
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + at) = o;
    }
  }
}

using Kernel = void (*)(Pyramid, const float*, const float*, const int*,
                       void*, int, int, int, int, int);

int launch(Kernel kernel, dim3 grid, int threads, long long smem,
           cudaStream_t stream, const Pyramid& pyr, const float* sc,
           const float* boxes, const int* lvl, void* out, int R,
           int C, int P, int sampling, int side) {
  if (smem > 48 * 1024) {
    const cudaError_t err = raise_smem_cap(
        reinterpret_cast<const void*>(kernel), static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, threads, static_cast<size_t>(smem), stream>>>(
      pyr, sc, boxes, lvl, out, R, C, P, sampling, side);
  return static_cast<int>(cudaGetLastError());
}

// The kernel for (T, qpw), and with kSpecialise K1's compile-time ones for
// the fast profile's poolers (P = 7 and 14 at s = 2).
template <typename T, bool kSpecialise>
Kernel pick(int qpw, int P, int sampling) {
  if constexpr (kSpecialise) {
    if (P == 7 && sampling == 2) return &roi_align_staged_kernel<T, 1, 7, 2>;
    if (P == 14 && sampling == 2)
      return &roi_align_staged_kernel<T, 2, 14, 2>;
  }
  return qpw == 1   ? &roi_align_staged_kernel<T, 1, 0, -1>
         : qpw == 2 ? &roi_align_staged_kernel<T, 2, 0, -1>
                    : &roi_align_staged_kernel<T, 4, 0, -1>;
}

// The shared launcher of both entry points: checks the arguments and the
// block's shared memory, picks the kernel and launches it on `stream`;
// returns cudaGetLastError() (0 = launched). feats: n_levels NHWC levels
// (B, h_l, w_l, C) at strides 2^(min_level + l): int8 with scales[l] (f32,
// device) the scale of level l when `scales` is not NULL, else float32 when
// f32, else bf16; boxes (B, R, 4) f32 XYXY; lvl (B, R) int32 level index;
// out (B, R, P, P, C) float32 for float32 levels, else bf16. C a multiple of
// 8 (bf16, float32) or 16 (int8) up to 256, level and out pointers
// 16-byte aligned, min_sampling <= sampling <= 16 (0: adaptive), 1 <= P <=
// 32 (checked by the wrappers). A block's shared memory (the ring, and
// weight tables of P + band + 1 rows of the longest level side) is checked
// here only: cudaErrorInvalidValue when it exceeds kMaxSmem.
template <bool kSpecialise>
int pooler_run(const void* f0, const void* f1, const void* f2,
               const void* f3, int h0, int w0, int h1, int w1, int h2,
               int w2, int h3, int w3, int n_levels, int min_level,
               const void* scales, const void* boxes, const void* lvl,
               void* out, int B, int R, int C, int P, int sampling, int f32,
               int min_sampling, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* sc = static_cast<const float*>(scales);
  if (n_levels < 1 || n_levels > kMaxLevels || sampling < min_sampling ||
      sampling > kMaxSampling || P < 1 || P > kMaxOut || C < 1 ||
      C > kMaxC || C % (sc == nullptr ? 8 : 16) != 0 || B < 1 || R < 1 ||
      (f32 != 0 && sc != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Pyramid pyr;
  const void* fs[kMaxLevels] = {f0, f1, f2, f3};
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  int side = 1;
  for (int l = 0; l < kMaxLevels; ++l) {
    pyr.feat[l] = fs[l];
    pyr.H[l] = hs[l];
    pyr.W[l] = ws[l];
    pyr.stride[l] = static_cast<float>(1 << (min_level + l));
    if (l < n_levels) {
      if (hs[l] < 1 || ws[l] < 1)
        return static_cast<int>(cudaErrorInvalidValue);
      side = std::max(side, std::max(hs[l], ws[l]));
    }
  }
  pyr.n_levels = n_levels;
  // output columns a warp takes (1, 2 or 4), and the band rows a block
  // holds (8, 4 or 2)
  const int qpw = P <= kMaxWarps ? 1 : P <= 2 * kMaxWarps ? 2 : 4;
  const int band = kMaxWarps / qpw;
  const int warps = (P + qpw - 1) / qpw;
  const long long smem = ring_bytes(sc != nullptr) +
                         4LL * (band + P + 1) * side + 4LL * 2 * (band + P);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      static_cast<long long>(B) * R * ((P + band - 1) / band);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const Kernel kernel =
      sc != nullptr ? pick<int8_t, kSpecialise>(qpw, P, sampling)
      : f32 != 0    ? pick<float, kSpecialise>(qpw, P, sampling)
                    : pick<__nv_bfloat16, kSpecialise>(qpw, P, sampling);
  return launch(kernel, grid, 32 * warps, smem,
                static_cast<cudaStream_t>(stream), pyr, sc,
                static_cast<const float*>(boxes),
                static_cast<const int*>(lvl), out, R, C, P, sampling, side);
}

}  // namespace
