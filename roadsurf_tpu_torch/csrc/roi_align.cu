// Multilevel ROIAlignV2 (aligned=True) at a fixed s x s sampling grid, bf16
// NHWC features -- or int8 ones with one f32 scale a level -- in, bf16
// (B, R, P, P, C) out, f32 accumulation.
//
// Replaces the TPU kernel roi_align_fused (roadsurf_tpu/ops/
// roi_align_pallas.py:638) in both its modes; the wrapper, the plain PyTorch
// version and the note on what bounds this kernel are in
// roadsurf_tpu_torch/ops/roi_align_kernel.py.
//
// Int8 levels: each tap is the bf16 value bf16(q * s_l) of the plain
// version's dequantized level, one convert per tap; the scale of the box's
// level is read from `scales`.
//
// Grid: one block per (image, box, output row p); threads over channel
// pairs. Each block computes its row's y taps and all P x taps once into
// shared memory, then every thread walks the P output bins of the row for
// its channels: s*s samples per bin, 4 bilinear taps per sample.
//
// Semantics of one sample (reference ops/roi_align.py:48-62): coordinate
// c = (lo + (bin + (s + 0.5) / sampling) * bin_size) / stride - 0.5; it
// counts iff c lies in [-1, dim], is then clamped to [0, dim - 1], and
// splits between floor(c) and min(floor(c) + 1, dim - 1). The coordinate is
// computed with explicitly rounded operations (no contraction into FMA) so
// that it equals the plain version's tensor arithmetic bit for bit, and a
// sample on the border of [-1, dim] falls on the same side in both.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxSampling = 16;
constexpr int kMaxTaps = 256;  // out_size * sampling along x

struct Pyramid {
  const void* feat[kMaxLevels];
  int H[kMaxLevels];
  int W[kMaxLevels];
  float stride[kMaxLevels];
  int n_levels;
};

// Two taps along one axis; both weights are 0 for a sample outside
// [-1, dim].
struct Tap {
  int i0;
  int i1;
  float w0;
  float w1;
};

__device__ __forceinline__ Tap axis_tap(float lo, float bin_size, int bin,
                                        int s, int sampling, float stride,
                                        int dim) {
  const float u = (s + 0.5f) / static_cast<float>(sampling);
  float c = __fadd_rn(static_cast<float>(bin), u);
  c = __fmul_rn(c, bin_size);
  c = __fadd_rn(lo, c);
  c = __fdiv_rn(c, stride);
  c = __fsub_rn(c, 0.5f);
  Tap t{0, 0, 0.0f, 0.0f};
  if (!(c >= -1.0f && c <= static_cast<float>(dim))) return t;
  const float cc = fminf(fmaxf(c, 0.0f), static_cast<float>(dim - 1));
  const float fl = floorf(cc);
  t.i0 = static_cast<int>(fl);
  t.i1 = min(t.i0 + 1, dim - 1);
  t.w1 = cc - fl;
  t.w0 = 1.0f - t.w1;
  return t;
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
__global__ void roi_align_kernel(Pyramid pyr, const float* __restrict__ scales,
                                 const float* __restrict__ boxes,
                                 const int* __restrict__ lvl,
                                 __nv_bfloat16* __restrict__ out, int R, int C,
                                 int P, int sampling) {
  __shared__ Tap ytap[kMaxSampling];
  __shared__ Tap xtap[kMaxTaps];

  const int p = blockIdx.x % P;
  const int roi = blockIdx.x / P;  // b * R + r
  const int b = roi / R;
  const int l = min(max(lvl[roi], 0), pyr.n_levels - 1);
  const int H = pyr.H[l];
  const int W = pyr.W[l];
  const float stride = pyr.stride[l];
  const float* bx = boxes + 4 * static_cast<size_t>(roi);
  const float x0 = bx[0];
  const float y0 = bx[1];
  const float bw = __fdiv_rn(__fsub_rn(bx[2], x0), static_cast<float>(P));
  const float bh = __fdiv_rn(__fsub_rn(bx[3], y0), static_cast<float>(P));

  for (int i = threadIdx.x; i < P * sampling; i += blockDim.x)
    xtap[i] = axis_tap(x0, bw, i / sampling, i % sampling, sampling, stride,
                       W);
  for (int i = threadIdx.x; i < sampling; i += blockDim.x)
    ytap[i] = axis_tap(y0, bh, p, i, sampling, stride, H);
  __syncthreads();

  const T* f =
      static_cast<const T*>(pyr.feat[l]) + static_cast<size_t>(b) * H * W * C;
  const float scale = scales != nullptr ? scales[l] : 1.0f;
  __nv_bfloat16* o = out + (static_cast<size_t>(roi) * P + p) * P * C;
  const float inv = 1.0f / static_cast<float>(sampling * sampling);

  for (int c = 2 * threadIdx.x; c < C; c += 2 * blockDim.x) {
    for (int q = 0; q < P; ++q) {
      float a0 = 0.0f, a1 = 0.0f;
      for (int sy = 0; sy < sampling; ++sy) {
        const Tap ty = ytap[sy];
        if (ty.w0 == 0.0f && ty.w1 == 0.0f) continue;
        const T* r0 = f + static_cast<size_t>(ty.i0) * W * C + c;
        const T* r1 = f + static_cast<size_t>(ty.i1) * W * C + c;
        for (int sx = 0; sx < sampling; ++sx) {
          const Tap tx = xtap[q * sampling + sx];
          if (tx.w0 == 0.0f && tx.w1 == 0.0f) continue;
          const float2 v00 = load2(r0 + static_cast<size_t>(tx.i0) * C, scale);
          const float2 v01 = load2(r0 + static_cast<size_t>(tx.i1) * C, scale);
          const float2 v10 = load2(r1 + static_cast<size_t>(tx.i0) * C, scale);
          const float2 v11 = load2(r1 + static_cast<size_t>(tx.i1) * C, scale);
          const float w00 = ty.w0 * tx.w0, w01 = ty.w0 * tx.w1;
          const float w10 = ty.w1 * tx.w0, w11 = ty.w1 * tx.w1;
          a0 += w00 * v00.x + w01 * v01.x + w10 * v10.x + w11 * v11.x;
          a1 += w00 * v00.y + w01 * v01.y + w10 * v10.y + w11 * v11.y;
        }
      }
      *reinterpret_cast<__nv_bfloat162*>(o + static_cast<size_t>(q) * C +
                                         c) =
          __floats2bfloat162_rn(a0 * inv, a1 * inv);
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
// 1 <= sampling <= 16, P * sampling <= 256 (checked by the wrapper).
int roi_align_run(const void* f0, const void* f1, const void* f2,
                  const void* f3, int h0, int w0, int h1, int w1, int h2,
                  int w2, int h3, int w3, int n_levels, int min_level,
                  const void* scales, const void* boxes, const void* lvl,
                  void* out, int B, int R, int C, int P, int sampling,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_levels < 1 || n_levels > kMaxLevels || sampling < 1 ||
      sampling > kMaxSampling || P < 1 || P * sampling > kMaxTaps ||
      C < 2 || C % 2 != 0 || B < 1 || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Pyramid pyr;
  const void* fs[kMaxLevels] = {f0, f1, f2, f3};
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  for (int l = 0; l < kMaxLevels; ++l) {
    pyr.feat[l] = fs[l];
    pyr.H[l] = hs[l];
    pyr.W[l] = ws[l];
    pyr.stride[l] = static_cast<float>(1 << (min_level + l));
  }
  pyr.n_levels = n_levels;
  int threads = ((C / 2 + 31) / 32) * 32;
  if (threads > 128) threads = 128;
  const long long blocks = static_cast<long long>(B) * R * P;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const float* sc = static_cast<const float*>(scales);
  const float* bx = static_cast<const float*>(boxes);
  const int* lv = static_cast<const int*>(lvl);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sc == nullptr)
    roi_align_kernel<__nv_bfloat16>
        <<<static_cast<unsigned>(blocks), threads, 0, st>>>(
            pyr, sc, bx, lv, o, R, C, P, sampling);
  else
    roi_align_kernel<int8_t>
        <<<static_cast<unsigned>(blocks), threads, 0, st>>>(
            pyr, sc, bx, lv, o, R, C, P, sampling);
  return static_cast<int>(cudaGetLastError());
}

const char* roi_align_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
