// LayerNorm over the channels of bf16 rows (K8): ViTDet's LayerNorms, with
// the residual sum before them, the window pad after them and the ReLU or
// GELU that follows, in one pass.
//
// Replaces no TPU kernel: the JAX package has no ViT and no LayerNorm.
// PyTorch runs each LayerNorm as ATen's vectorized_layer_norm_kernel, a
// whole block a row (at C = 256..768 a thread holds 2 to 6 values, so the
// kernel is bound by launching and reducing blocks, ~27% of its byte bound
// over a ViTDet-B forward on an H100), and the add before it, the pad and
// the activation after it are one more pass through device memory each (the
// add of a padded slice through ATen's generic elementwise kernel). The
// wrapper and the plain PyTorch version are in
// roadsurf_tpu_torch/ops/layer_norm.py.
//
// Rows are a (B, H, W) grid of C contiguous channels. In float32:
//   s = bf16(x + r)                      (residual mode: bit for bit
//                                         PyTorch's add; s is written)
//   u = s, or x without a residual
//   mean = sum(u) / C,  var = sum((u - mean)^2) / C
//   y = bf16((u - mean) * rsqrt(var + eps) * w + b)
//   y = bf16(act(y))                     (ReLU as ATen's clamp_min, GELU
//                                         in its exact erf form, as ATen)
// and y goes to row (b, h, w) of a (B, Hp, Wp, C) output whose rows beyond
// H or W are zero (the windowed blocks' pad after norm1).
//
// What bounds it on an H100: bytes. Each input value is read once and each
// output value written once: x, r, s and y of a ViT block's norm, 4 x 12.6
// MB a 1024 px image. The design moves them at full width: L lanes a row,
// V 16-byte vectors a lane, the row held in registers, so the mean and then
// the centred variance come from registers by warp shuffles and nothing is
// read twice. It is built for ViTDet-B's three widths, each split exactly
// (768: 32 x 3, 384: 16 x 3, 256: 16 x 2); other widths take the plain
// version. A warp holds 32 / L rows; w and b are loaded once a warp into
// registers, and each warp walks rows in a grid-stride loop over a grid
// that fills the SMs once, with the next rows' loads sent before the
// current rows reduce, so that enough bytes are in flight to reach the
// memory's rate. Nothing is allocated and nothing synchronises: a CUDA
// graph can capture it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // a block's threads
constexpr int kMaxDevices = 64;

enum Act { kNone = 0, kRelu = 1, kGelu = 2 };

__device__ __forceinline__ float lo(unsigned w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ unsigned to_bf16(float f) {
  return __bfloat16_as_ushort(__float2bfloat16(f));
}

__device__ __forceinline__ unsigned pack(float a, float b) {
  return to_bf16(a) | (to_bf16(b) << 16);
}

__device__ __forceinline__ void unpack(const uint4& v, float* f) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = lo(w[i]);
    f[2 * i + 1] = hi(w[i]);
  }
}

// a value rounded to bf16, then the activation, rounded again
__device__ __forceinline__ float activate(float v, int act) {
  v = __uint_as_float(to_bf16(v) << 16);
  if (act == kRelu) return isnan(v) ? v : fmaxf(v, 0.0f);
  if (act == kGelu) {
    constexpr float kAlpha = 0.70710678118654752440f;  // M_SQRT1_2
    return v * 0.5f * (1.0f + erff(v * kAlpha));
  }
  return v;
}

template <int L>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Rows {
  const unsigned short* x;
  const unsigned short* r;  // null without a residual
  unsigned short* s;        // (B, H, W, C) contiguous, null without r
  unsigned short* y;        // (B, Hp, Wp, C) contiguous
  const unsigned short* w;
  const unsigned short* b;
  long long xb, xh, xw;     // x's strides in elements
  long long rb, rh, rw;     // r's
  int B, H, W, Hp, Wp, C;
  float eps;
  int act;
};

// the input row of output row `row`, or -1 in the pad (or past the end);
// in 32 bits (fewer than 2^31 rows), a 64-bit division being many times
// the instructions
__device__ __forceinline__ void locate(const Rows& p, long long row,
                                       long long total, int* b, int* h,
                                       int* w) {
  *b = -1;
  *h = *w = 0;
  if (row >= total) return;
  const unsigned r = static_cast<unsigned>(row);
  const unsigned hw = r / static_cast<unsigned>(p.Wp);
  const int ww = static_cast<int>(r - hw * p.Wp);
  const int bb = static_cast<int>(hw / static_cast<unsigned>(p.Hp));
  const int hh = static_cast<int>(hw - bb * p.Hp);
  if (hh >= p.H || ww >= p.W) return;
  *b = bb;
  *h = hh;
  *w = ww;
}

// the bf16 sum of two vectors of 8 bf16 values, each add rounded as
// PyTorch rounds it
__device__ __forceinline__ uint4 add(const uint4& a, const uint4& b) {
  float fa[8], fb[8];
  unpack(a, fa);
  unpack(b, fb);
  return make_uint4(pack(__fadd_rn(fa[0], fb[0]), __fadd_rn(fa[1], fb[1])),
                    pack(__fadd_rn(fa[2], fb[2]), __fadd_rn(fa[3], fb[3])),
                    pack(__fadd_rn(fa[4], fb[4]), __fadd_rn(fa[5], fb[5])),
                    pack(__fadd_rn(fa[6], fb[6]), __fadd_rn(fa[7], fb[7])));
}

// L lanes a row, V vectors of 8 channels a lane, C = 8 L V: lane l of a
// row holds the vectors l, l + L, ... Values stay packed bf16 in registers
// (the sum s is bf16 anyway) and are unpacked in each pass.
template <int V, int L, bool kRes>
__global__ void __launch_bounds__(kThreads, 2)
    layer_norm_rows_kernel(const Rows p) {
  const int lane = threadIdx.x & 31;
  const int li = lane % L;
  const int sub = lane / L;
  constexpr int kRowsWarp = 32 / L;
  const long long total = static_cast<long long>(p.B) * p.Hp * p.Wp;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const long long step =
      static_cast<long long>(gridDim.x) * (kThreads / 32) * kRowsWarp;

  uint4 wv[V], bv[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int v = j * L + li;
    wv[j] = *reinterpret_cast<const uint4*>(p.w + v * 8);
    bv[j] = *reinterpret_cast<const uint4*>(p.b + v * 8);
  }

  auto load = [&](int bb, int hh, int ww, uint4* xo, uint4* ro) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int v = j * L + li;
      xo[j] = make_uint4(0, 0, 0, 0);
      if (kRes) ro[j] = make_uint4(0, 0, 0, 0);
      if (bb >= 0) {
        xo[j] = *reinterpret_cast<const uint4*>(
            p.x + bb * p.xb + hh * p.xh + ww * p.xw + v * 8);
        if (kRes)
          ro[j] = *reinterpret_cast<const uint4*>(
              p.r + bb * p.rb + hh * p.rh + ww * p.rw + v * 8);
      }
    }
  };
  long long row = warp * kRowsWarp + sub;
  int b, h, w;
  uint4 xv[V], rv[V];
  locate(p, row, total, &b, &h, &w);
  load(b, h, w, xv, rv);

  // every lane of the warp runs the same iterations (the shuffles need
  // them all); a lane past the end or in the pad holds zeros
  for (long long base = warp * kRowsWarp; base < total; base += step) {
    // the next rows' loads go out before this row reduces
    const long long next = row + step;
    int nb, nh, nw;
    uint4 xn[V], rn[V];
    locate(p, next, total, &nb, &nh, &nw);
    load(nb, nh, nw, xn, rn);

    uint4 sv[V];
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sv[j] = kRes ? add(xv[j], rv[j]) : xv[j];
      float f[8];
      unpack(sv[j], f);
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += f[i];
    }
    const float mean = row_sum<L>(sum) / p.C;
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float f[8];
      unpack(sv[j], f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = f[i] - mean;
        sq += d * d;
      }
    }
    const float rstd = rsqrtf(row_sum<L>(sq) / p.C + p.eps);

    if (row < total) {
      unsigned short* yrow = p.y + row * p.C;
      const long long srow =
          (static_cast<long long>(b) * p.H + h) * p.W + w;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int v = j * L + li;
        uint4 out = make_uint4(0, 0, 0, 0);
        if (b >= 0) {
          float f[8], wf[8], bf[8], o[8];
          unpack(sv[j], f);
          unpack(wv[j], wf);
          unpack(bv[j], bf);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            o[i] = activate((f[i] - mean) * rstd * wf[i] + bf[i], p.act);
          out = make_uint4(pack(o[0], o[1]), pack(o[2], o[3]),
                           pack(o[4], o[5]), pack(o[6], o[7]));
          if (kRes)
            *reinterpret_cast<uint4*>(p.s + srow * p.C + v * 8) = sv[j];
        }
        *reinterpret_cast<uint4*>(yrow + v * 8) = out;
      }
    }

    row = next;
    b = nb;
    h = nh;
    w = nw;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      xv[j] = xn[j];
      if (kRes) rv[j] = rn[j];
    }
  }
}

template <int V, int L, bool kRes>
cudaError_t launch(const Rows& p, int device, cudaStream_t stream) {
  static int resident[kMaxDevices];  // blocks the card holds at once
  if (resident[device] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, layer_norm_rows_kernel<V, L, kRes>, kThreads, 0);
    if (err != cudaSuccess) return err;
    resident[device] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long total = static_cast<long long>(p.B) * p.Hp * p.Wp;
  const long long rows_block = (kThreads / 32) * (32 / L);
  const long long needed = (total + rows_block - 1) / rows_block;
  const int blocks = static_cast<int>(
      needed < resident[device] ? needed : resident[device]);
  layer_norm_rows_kernel<V, L, kRes><<<blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// x (B, H, W, C) bf16 rows at element strides (xb, xh, xw), channels
// contiguous; r the same shape at (rb, rh, rw), or null; s (B, H, W, C)
// and y (B, Hp, Wp, C) contiguous, s null where r is; w, b (C). Every
// pointer 16-byte aligned, every stride a multiple of 8, H <= Hp, W <= Wp,
// B * Hp * Wp < 2^31, act 0 (none), 1 (ReLU) or 2 (GELU): checked by the
// wrapper. C is 256, 384 or 768; another width returns
// cudaErrorInvalidValue.
int layer_norm_bf16(const void* x, const void* r, void* s, void* y,
                    const void* w, const void* b, long long xb, long long xh,
                    long long xw, long long rb, long long rh, long long rw,
                    int B, int H, int W, int Hp, int Wp, int C, float eps,
                    int act, int device, void* stream) {
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Rows p{static_cast<const unsigned short*>(x),
         static_cast<const unsigned short*>(r),
         static_cast<unsigned short*>(s),
         static_cast<unsigned short*>(y),
         static_cast<const unsigned short*>(w),
         static_cast<const unsigned short*>(b),
         xb, xh, xw, rb, rh, rw, B, H, W, Hp, Wp, C, eps, act};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool res = r != nullptr;
#define LAYER_NORM_CASE(WIDTH, V, L)                                \
  case WIDTH:                                                       \
    err = res ? launch<V, L, true>(p, device, st)                   \
              : launch<V, L, false>(p, device, st);                 \
    break;
  switch (C) {
    LAYER_NORM_CASE(768, 3, 32)
    LAYER_NORM_CASE(384, 3, 16)
    LAYER_NORM_CASE(256, 2, 16)
    default:
      err = cudaErrorInvalidValue;
  }
#undef LAYER_NORM_CASE
  return static_cast<int>(err);
}

const char* layer_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
