// The conv epilogue: a conv's bias, then a residual or the coarser FPN
// level, then ReLU, in one in-place pass over the conv's bf16 output in
// channels_last (NHWC) memory.
//
// Replaces no TPU kernel: XLA fuses the JAX package's bias adds, residual
// sums and ReLUs into its convolutions. PyTorch runs a cuDNN conv without its
// bias and then adds the (1, C, 1, 1) bias in a separate broadcast pass (a
// generic, non-vectorised kernel, ~1.2 TB/s on an H100); each ReLU, residual
// sum and FPN top-down sum is one more trip through device memory. The
// wrapper and the plain PyTorch version are in
// roadsurf_tpu_torch/ops/bias_act.py.
//
// Every value is computed as that sequence of PyTorch ops computes it, bit
// for bit: each add in f32 of two bf16 values, rounded to bf16 with
// __float2bfloat16 (what c10::BFloat16 does on sm_80 and later), and ReLU as
// ATen's clamp_min (a NaN passes unchanged, else fmaxf(v, 0)):
//   t = bf16(y + b)
//   mode 1 (residual r):          t = bf16(t + r)
//   mode 2 (residual r, bias rb): t = bf16(t + bf16(r + rb))
//   mode 3 (coarser level r):     t = bf16(t + r[n, h / 2, w / 2, c])
//   relu:                         t = isnan(t) ? t : fmaxf(t, 0)
//
// What bounds it on an H100: bytes. It reads and writes each output value
// once (4 bytes) and reads a residual once (2 more; the coarser level, a
// quarter of that from device memory, the rest from L2). The design moves
// those bytes at full width: 16-byte loads and stores along C (8 channels a
// thread), f32 math in registers. A block covers a run of whole pixels
// (C / 8 threads a pixel), so each thread keeps the same 8 channels, and
// loads their bias once into registers, for every pixel of its grid-stride
// loop; the grid holds as many blocks as the SMs hold at once. Over a parity
// forward's 77 calls it moves 0.94 GB a tile at ~2.9 TB/s on an H100 80GB
// HBM3 at 700 W, 87% of the card's 3.35 TB/s. Where C is not a multiple of
// 8 (the RPN's objectness and deltas, C = 3 and 12) or a pointer is not
// 16-byte aligned, the same kernel runs one channel a thread.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // a block's threads, about
constexpr int kMaxThreads = 1024;    // a block's threads, at most
constexpr int kSmThreads = 2048;     // resident threads an SM holds
constexpr int kMaxDevices = 64;

enum Mode { kBias = 0, kResidual = 1, kResidualBias = 2, kCoarser = 3 };

__device__ __forceinline__ float to_f32(unsigned short h) {
  return __bfloat162float(__ushort_as_bfloat16(h));
}

__device__ __forceinline__ unsigned short to_bf16(float f) {
  return __bfloat16_as_ushort(__float2bfloat16(f));
}

// kVec bf16 values a thread: one 16-byte access for 8, a 2-byte one for 1
template <int kVec>
struct Pack {
  unsigned short h[kVec];
};

template <int kVec>
__device__ __forceinline__ Pack<kVec> load(const unsigned short* p);

template <>
__device__ __forceinline__ Pack<8> load<8>(const unsigned short* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  Pack<8> out;
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out.h[2 * i] = static_cast<unsigned short>(w[i] & 0xffffu);
    out.h[2 * i + 1] = static_cast<unsigned short>(w[i] >> 16);
  }
  return out;
}

template <>
__device__ __forceinline__ Pack<1> load<1>(const unsigned short* p) {
  Pack<1> out;
  out.h[0] = *p;
  return out;
}

template <int kVec>
__device__ __forceinline__ void store(unsigned short* p, const Pack<kVec>& v);

template <>
__device__ __forceinline__ void store<8>(unsigned short* p,
                                         const Pack<8>& v) {
  uint4 w;
  w.x = v.h[0] | (static_cast<unsigned>(v.h[1]) << 16);
  w.y = v.h[2] | (static_cast<unsigned>(v.h[3]) << 16);
  w.z = v.h[4] | (static_cast<unsigned>(v.h[5]) << 16);
  w.w = v.h[6] | (static_cast<unsigned>(v.h[7]) << 16);
  *reinterpret_cast<uint4*>(p) = w;
}

template <>
__device__ __forceinline__ void store<1>(unsigned short* p,
                                         const Pack<1>& v) {
  *p = v.h[0];
}

// y (pixels, C) in place; bias (C); r (pixels, C) for modes 1 and 2, or
// (N, H / 2, W / 2, C) for mode 3; rbias (C) for mode 2. blockDim.x is a
// multiple of chunks = C / kVec.
template <int kVec, int kMode, bool kRelu>
__global__ void __launch_bounds__(kMaxThreads)
    bias_act_elementwise_kernel(unsigned short* __restrict__ y,
                                const unsigned short* __restrict__ bias,
                                const unsigned short* __restrict__ r,
                                const unsigned short* __restrict__ rbias,
                                long long pixels, int C, int H, int W) {
  const int chunks = C / kVec;
  const int chunk = threadIdx.x % chunks;
  const int per_block = blockDim.x / chunks;  // pixels a block covers
  const int c0 = chunk * kVec;

  const Pack<kVec> bp = load<kVec>(bias + c0);
  float b[kVec], rb[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) b[i] = to_f32(bp.h[i]);
  if (kMode == kResidualBias) {
    const Pack<kVec> rp = load<kVec>(rbias + c0);
#pragma unroll
    for (int i = 0; i < kVec; ++i) rb[i] = to_f32(rp.h[i]);
  }

  const long long step = static_cast<long long>(gridDim.x) * per_block;
  for (long long p = static_cast<long long>(blockIdx.x) * per_block +
                     threadIdx.x / chunks;
       p < pixels; p += step) {
    const long long off = p * C + c0;
    Pack<kVec> v = load<kVec>(y + off);
    Pack<kVec> s{};
    if (kMode == kResidual || kMode == kResidualBias) {
      s = load<kVec>(r + off);
    } else if (kMode == kCoarser) {
      const long long w = p % W;
      const long long nh = p / W;
      const long long h = nh % H;
      const long long n = nh / H;
      s = load<kVec>(r + ((n * (H / 2) + h / 2) * (W / 2) + w / 2) * C + c0);
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      unsigned short t = to_bf16(__fadd_rn(to_f32(v.h[i]), b[i]));
      if (kMode == kResidualBias) {
        const unsigned short u = to_bf16(__fadd_rn(to_f32(s.h[i]), rb[i]));
        t = to_bf16(__fadd_rn(to_f32(t), to_f32(u)));
      } else if (kMode != kBias) {
        t = to_bf16(__fadd_rn(to_f32(t), to_f32(s.h[i])));
      }
      if (kRelu) {
        const float f = to_f32(t);
        if (!isnan(f)) t = to_bf16(fmaxf(f, 0.0f));
      }
      v.h[i] = t;
    }
    store<kVec>(y + off, v);
  }
}

template <int kVec, int kMode, bool kRelu>
cudaError_t launch(unsigned short* y, const unsigned short* bias,
                   const unsigned short* r, const unsigned short* rbias,
                   long long pixels, int C, int H, int W, int sms,
                   cudaStream_t stream) {
  const int chunks = C / kVec;
  const int per_block = chunks >= kThreads ? 1 : kThreads / chunks;
  const int threads = chunks * per_block;
  const long long needed = (pixels + per_block - 1) / per_block;
  const long long resident =
      static_cast<long long>(sms) * (kSmThreads / threads);
  const int blocks = static_cast<int>(needed < resident ? needed : resident);
  bias_act_elementwise_kernel<kVec, kMode, kRelu>
      <<<blocks, threads, 0, stream>>>(y, bias, r, rbias, pixels, C, H, W);
  return cudaGetLastError();
}

template <int kVec>
cudaError_t dispatch(int mode, bool relu, unsigned short* y,
                     const unsigned short* bias, const unsigned short* r,
                     const unsigned short* rbias, long long pixels, int C,
                     int H, int W, int sms, cudaStream_t stream) {
#define BIAS_ACT_CASE(M)                                                   \
  case M:                                                                  \
    return relu ? launch<kVec, M, true>(y, bias, r, rbias, pixels, C, H, W, \
                                        sms, stream)                       \
                : launch<kVec, M, false>(y, bias, r, rbias, pixels, C, H,  \
                                         W, sms, stream);
  switch (mode) {
    BIAS_ACT_CASE(kBias)
    BIAS_ACT_CASE(kResidual)
    BIAS_ACT_CASE(kResidualBias)
    BIAS_ACT_CASE(kCoarser)
    default:
      return cudaErrorInvalidValue;
  }
#undef BIAS_ACT_CASE
}

bool aligned(const void* p) {
  return p == nullptr || reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched). y
// (pixels = N * H * W, C) bf16, NHWC, updated in place; bias (C) bf16; r and
// rbias as the kernel above takes them for `mode` (null where unused); relu
// 0 or 1. 1 <= C, and C / 8 <= 1024 where C is a multiple of 8 and the
// pointers are 16-byte aligned, else C <= 1024 (checked by the wrapper).
int bias_act_bf16(void* y, const void* bias, const void* r,
                  const void* rbias, long long pixels, int C, int H, int W,
                  int mode, int relu, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices || pixels < 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  static int sm_counts[kMaxDevices];
  int sms = sm_counts[device];
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
    sm_counts[device] = sms;
  }
  auto* yy = static_cast<unsigned short*>(y);
  const auto* bb = static_cast<const unsigned short*>(bias);
  const auto* rr = static_cast<const unsigned short*>(r);
  const auto* rb = static_cast<const unsigned short*>(rbias);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 8 == 0 && C / 8 <= kMaxThreads && aligned(y) && aligned(bias) &&
      aligned(r) && aligned(rbias))
    return static_cast<int>(dispatch<8>(mode, relu != 0, yy, bb, rr, rb,
                                        pixels, C, H, W, sms, s));
  if (C > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch<1>(mode, relu != 0, yy, bb, rr, rb,
                                      pixels, C, H, W, sms, s));
}

const char* bias_act_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
