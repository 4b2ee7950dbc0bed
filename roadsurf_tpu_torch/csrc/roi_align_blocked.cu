// Multilevel ROIAlignV2 (aligned=True) on large maps, adaptive sampling
// (POOLER_SAMPLING_RATIO 0, n = ceil(bin cells) samples per bin, no cap) or
// a fixed s x s grid; bf16 NHWC features -- or int8 ones with one f32 scale
// a level -- in, bf16 (B, R, P, P, C) out, f32 accumulation.
//
// Replaces the TPU kernel roi_align_fused_blocked (roadsurf_tpu/ops/
// roi_align_pallas.py:471) in both its modes; the wrapper, the plain PyTorch
// version and the note on what bounds this kernel are in
// roadsurf_tpu_torch/ops/roi_align_blocked_kernel.py. Int8 levels: each cell
// is the bf16 value bf16(q * s_l) of the plain version's dequantized level,
// one convert per cell read; the scale of the box's level comes from
// `scales`. (The TPU kernel scales the accumulated row instead,
// roi_align_pallas.py:453-457.)
//
// Grid: one block per (image, box); threads over channel pairs. The block
// first evaluates the box's interpolation weights along y for all P rows
// and along x for all P columns, over the box's tap span only, into shared
// memory, and records each row's and column's non-zero range; then every
// thread computes out[p, q, c] = sum_y wy[p, y] * sum_x wx[q, x] * f[y, x, c]
// for its channels.
//
// The weights are those of the plain version (ops/roi_align_kernel.py:
// bin_sizes, _axis_weight_matrix, _axis_weights_adaptive_at), operation for
// operation, each explicitly rounded (no contraction into FMA), so that the
// floor/ceil decisions of the series and the [-1, dim] border rule fall the
// same way in both. The adaptive series divides (lo + p * bin) by the stride
// after the sum, as the plain version (and the reference's XLA form,
// roadsurf_tpu/ops/roi_align.py:148) does; the TPU kernel divides lo and bin
// by the stride first (roi_align_pallas.py:307-313), which rounds
// differently.

#include <algorithm>
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxSampling = 16;
constexpr int kMaxOut = 32;
constexpr int kMaxSmem = 232448;
constexpr int kThreads = 128;

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
  float stride;  // level stride
  float dim;     // level side, cells
  int sampling;  // 0: adaptive
  float n;       // adaptive: samples per bin
  float dt;      // adaptive: true sample spacing, cells
  float dl;      // adaptive: guarded spacing (1 for zero-size bins)
};

__device__ __forceinline__ Axis make_axis(float lo, float hi, int P,
                                          float stride, int dim,
                                          int sampling) {
  Axis a;
  a.lo = lo;
  a.bin = __fdiv_rn(__fsub_rn(hi, lo), static_cast<float>(P));
  a.stride = stride;
  a.dim = static_cast<float>(dim);
  a.sampling = sampling;
  const float bins = __fdiv_rn(a.bin, stride);
  a.n = fmaxf(ceilf(bins), 1.0f);
  a.dt = __fdiv_rn(bins, a.n);
  a.dl = a.dt > 0.0f ? a.dt : 1.0f;
  return a;
}

// Sample i of bin p sits at A + (i + 0.5) * dl.
__device__ __forceinline__ float bin_origin(const Axis& a, int p) {
  float v = __fadd_rn(a.lo, __fmul_rn(static_cast<float>(p), a.bin));
  v = __fsub_rn(__fdiv_rn(v, a.stride), 0.5f);
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
__device__ float adaptive_weight(const Axis& a, int p, float d) {
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
__device__ float fixed_weight(const Axis& a, int p, float d) {
  float m = 0.0f;
  const float last = __fsub_rn(a.dim, 1.0f);
  for (int s = 0; s < a.sampling; ++s) {
    const float u = (s + 0.5f) / static_cast<float>(a.sampling);
    float c = __fadd_rn(static_cast<float>(p), u);
    c = __fmul_rn(c, a.bin);
    c = __fadd_rn(a.lo, c);
    c = __fdiv_rn(c, a.stride);
    c = __fsub_rn(c, 0.5f);
    if (c >= -1.0f && c <= a.dim) {
      const float cc = fminf(fmaxf(c, 0.0f), last);
      m = __fadd_rn(m, fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(cc, d))), 0.0f));
    }
  }
  return __fdiv_rn(m, static_cast<float>(a.sampling));
}

__device__ __forceinline__ float axis_weight(const Axis& a, int p, float d) {
  return a.sampling == 0 ? adaptive_weight(a, p, d) : fixed_weight(a, p, d);
}

// Cells [s0, s1] that can carry weight: every sample lies between the box
// edges (up to rounding), and a sample's taps are floor(c) and floor(c) + 1;
// one cell of margin on each side covers the rounding.
__device__ __forceinline__ int2 tap_span(float lo, float hi, float stride,
                                         int dim) {
  const float last = static_cast<float>(dim - 1);
  const float a = floorf(fminf(lo, hi) / stride - 0.5f) - 1.0f;
  const float b = floorf(fmaxf(lo, hi) / stride - 0.5f) + 2.0f;
  return make_int2(static_cast<int>(fminf(fmaxf(a, 0.0f), last)),
                   static_cast<int>(fminf(fmaxf(b, 0.0f), last)));
}

// Weights of bins 0..P-1 at the cells of `span` into w[p * side + cell -
// span.x]; lo[p], hi[p] get the first and last cell of non-zero weight.
__device__ __forceinline__ void fill_weights(const Axis& a, int2 span, int P,
                                             int side, float* w, int* lo,
                                             int* hi) {
  const int n = span.y - span.x + 1;
  for (int i = threadIdx.x; i < P * n; i += blockDim.x) {
    const int p = i / n;
    const int cell = span.x + i % n;
    const float v = axis_weight(a, p, static_cast<float>(cell));
    w[p * side + cell - span.x] = v;
    if (v != 0.0f) {
      atomicMin(&lo[p], cell);
      atomicMax(&hi[p], cell);
    }
  }
}

// Two neighbouring channels of a level as f32; int8 ones dequantized to
// their bf16 values.
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p, float) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float dequant(signed char q, float s) {
  return __bfloat162float(
      __float2bfloat16_rn(__fmul_rn(static_cast<float>(q), s)));
}

__device__ __forceinline__ float2 load2(const int8_t* p, float s) {
  const char2 v = *reinterpret_cast<const char2*>(p);
  return make_float2(dequant(v.x, s), dequant(v.y, s));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    roi_align_blocked_kernel(Pyramid pyr, const float* __restrict__ scales,
                             const float* __restrict__ boxes,
                             const int* __restrict__ lvl,
                             __nv_bfloat16* __restrict__ out, int R, int C,
                             int P, int sampling, int side) {
  extern __shared__ float smem[];
  float* wy = smem;             // [P][side]
  float* wx = smem + P * side;  // [P][side]
  int* ya = reinterpret_cast<int*>(wx + P * side);
  int* yb = ya + P;
  int* xa = yb + P;
  int* xb = xa + P;

  const int roi = blockIdx.x;  // b * R + r
  const int b = roi / R;
  const int l = min(max(lvl[roi], 0), pyr.n_levels - 1);
  const int H = pyr.H[l];
  const int W = pyr.W[l];
  const float stride = pyr.stride[l];
  const float* bx = boxes + 4 * static_cast<size_t>(roi);
  const Axis ax = make_axis(bx[0], bx[2], P, stride, W, sampling);
  const Axis ay = make_axis(bx[1], bx[3], P, stride, H, sampling);
  const int2 sx = tap_span(bx[0], bx[2], stride, W);
  const int2 sy = tap_span(bx[1], bx[3], stride, H);

  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    ya[i] = INT_MAX;
    yb[i] = -1;
    xa[i] = INT_MAX;
    xb[i] = -1;
  }
  __syncthreads();
  fill_weights(ay, sy, P, side, wy, ya, yb);
  fill_weights(ax, sx, P, side, wx, xa, xb);
  __syncthreads();

  const T* f =
      static_cast<const T*>(pyr.feat[l]) + static_cast<size_t>(b) * H * W * C;
  const float scale = scales != nullptr ? scales[l] : 1.0f;
  __nv_bfloat16* o = out + static_cast<size_t>(roi) * P * P * C;
  for (int c = 2 * threadIdx.x; c < C; c += 2 * blockDim.x) {
    for (int p = 0; p < P; ++p) {
      const float* wyp = wy + p * side;
      for (int q = 0; q < P; ++q) {
        const float* wxq = wx + q * side;
        float a0 = 0.0f, a1 = 0.0f;
        for (int y = ya[p]; y <= yb[p]; ++y) {
          const T* row = f + static_cast<size_t>(y) * W * C + c;
          float r0 = 0.0f, r1 = 0.0f;
          for (int x = xa[q]; x <= xb[q]; ++x) {
            const float2 v = load2(row + static_cast<size_t>(x) * C, scale);
            const float w = wxq[x - sx.x];
            r0 += w * v.x;
            r1 += w * v.y;
          }
          const float w = wyp[y - sy.x];
          a0 += w * r0;
          a1 += w * r1;
        }
        *reinterpret_cast<__nv_bfloat162*>(
            o + (static_cast<size_t>(p) * P + q) * C + c) =
            __floats2bfloat162_rn(a0, a1);
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// feats: n_levels NHWC levels (B, h_l, w_l, C) at strides 2^(min_level + l),
// bf16 when `scales` is NULL, else int8 with scales[l] (f32, device) the
// scale of level l; boxes (B, R, 4) f32 XYXY; lvl (B, R) int32 level index;
// out (B, R, P, P, C) bf16. C even, pointers 4-byte aligned,
// 0 <= sampling <= 16 (0: adaptive), 1 <= P <= 32 (checked by the wrapper).
int roi_align_blocked_run(const void* f0, const void* f1, const void* f2,
                          const void* f3, int h0, int w0, int h1, int w1,
                          int h2, int w2, int h3, int w3, int n_levels,
                          int min_level, const void* scales,
                          const void* boxes, const void* lvl, void* out,
                          int B, int R, int C, int P, int sampling,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_levels < 1 || n_levels > kMaxLevels || sampling < 0 ||
      sampling > kMaxSampling || P < 1 || P > kMaxOut || C < 2 ||
      C % 2 != 0 || B < 1 || R < 1)
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
  const long long smem =
      2LL * P * side * sizeof(float) + 4LL * P * sizeof(int);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const float* sc = static_cast<const float*>(scales);
  auto kernel = sc == nullptr ? &roi_align_blocked_kernel<__nv_bfloat16>
                              : &roi_align_blocked_kernel<int8_t>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = ((C / 2 + 31) / 32) * 32;
  if (threads > kThreads) threads = kThreads;
  const long long blocks = static_cast<long long>(B) * R;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), threads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      pyr, sc, static_cast<const float*>(boxes),
      static_cast<const int*>(lvl), static_cast<__nv_bfloat16*>(out), R, C, P,
      sampling, side);
  return static_cast<int>(cudaGetLastError());
}

const char* roi_align_blocked_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
