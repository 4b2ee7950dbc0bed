// The gradient of multilevel ROIAlignV2 (aligned=True) with respect to the
// levels: d levels (B, H_l, W_l, C) from d pooled (B, R, P, P, C) bf16, at
// a fixed s x s grid or adaptive sampling (POOLER_SAMPLING_RATIO 0, n =
// ceil(bin cells) samples per bin, no cap). Levels' gradients come out in
// bf16 or float32.
//
// The reference package has no TPU kernel for it: its training pools with
// the XLA separable path and takes this gradient from XLA's autodiff of it
// (roadsurf_tpu/ops/roi_align.py:318 _roi_align_separable; its fused
// kernels have no VJP, ops/roi_align.py:484-485). The port's training
// forward pools with K1 and K2, so their backward is this kernel; the
// wrapper, the plain PyTorch version and the autograd.Function are in
// roadsurf_tpu_torch/ops/roi_align_backward_kernel.py and ops/roi_align.py.
//
// What it computes: for box r of image b on level l, with the forward's
// axis weights wy (P, H_l) and wx (P, W_l),
//   d F_l[b, y, x, c] += sum_p wy[p, y] * sum_q wx[q, x] * dP[b, r, p, q, c].
// The weights come from the forward's device code (roi_align_staged.cuh:
// make_axis, fill_weights), so both passes weigh every sample alike, bit
// for bit.
//
// What bounds it on an H100: the scatter. Each box adds into every cell of
// its region and every channel -- one f32 atomic add each, at the box
// pooler's training shapes some 10^8 to 10^9 of them -- against a byte
// bound of dP read once and the levels' gradients written once (plus the
// f32 accumulator's zeroing, its read and the bf16 cast). The first design
// is the simple one:
//   * one block per box, threads over the channels (one a thread at C =
//     256: a warp's reads of dP and its atomics cover 32 consecutive
//     channels, one 64- or 128-byte segment each);
//   * the box's weights into shared memory first, over the box's tap spans,
//     with each bin's first and last cell of non-zero weight;
//   * per column x of the box's region: T[p] = sum_q wx[q, x] dP[p, q, c]
//     over the bins q that weigh x (registers, P <= kPM), then for each row
//     y one atomicAdd of sum_p wy[p, y] T[p] into the level's f32
//     accumulator, zeroed before the launch;
//   * a second kernel casts the accumulator to bf16 (8 values a thread).
// The atomics make the f32 sums' order, and so their last bits, vary from
// run to run. Measured (chip_smoke.py kernels_k5, NVIDIA H100 80GB HBM3 at
// 700 W): at the YAML's training shapes at B=8 the box pooler's gradient
// takes 3.09 ms and the mask pooler's 1.67 ms, against byte bounds of
// 0.126 and 0.096 ms; in a training step the two are 13% of the device's
// time. Vector atomics (float2/float4 atomicAdd on sm_90), a shared-memory
// tile of an image's boxes summed before one write per cell, and wgmma for
// the two contractions are later work.

#include "roi_align_staged.cuh"

namespace {

constexpr int kBwdThreads = 256;

struct Grads {
  float* acc[kMaxLevels];  // (B, H_l, W_l, C) f32 each
  int H[kMaxLevels];
  int W[kMaxLevels];
  float stride[kMaxLevels];
  int n_levels;
};

__device__ __forceinline__ float bf16_to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Block per box: see the note at the top. kPM >= P bounds the per-column
// sums held in registers.
template <int kPM>
__global__ void __launch_bounds__(kBwdThreads)
    roi_align_backward_kernel(Grads gr, const float* __restrict__ boxes,
                              const int* __restrict__ lvl,
                              const __nv_bfloat16* __restrict__ dout, int R,
                              int C, int P, int sampling, int side) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int roi = blockIdx.x;  // b * R + r
  const int b = roi / R;
  const int l = min(max(lvl[roi], 0), gr.n_levels - 1);
  float* acc = nullptr;
  int H = 1, W = 1;
  float stride = 1.0f;
#pragma unroll
  for (int k = 0; k < kMaxLevels; ++k) {
    if (k == l) {
      acc = gr.acc[k];
      H = gr.H[k];
      W = gr.W[k];
      stride = gr.stride[k];
    }
  }
  const float* bx = boxes + 4 * static_cast<size_t>(roi);
  const float bin_x =
      __fdiv_rn(__fsub_rn(bx[2], bx[0]), static_cast<float>(P));
  const float bin_y =
      __fdiv_rn(__fsub_rn(bx[3], bx[1]), static_cast<float>(P));
  const float inv = 1.0f / stride;
  // every bin's tap span lies in the span of the box's first and last bin
  // edges
  const int2 sx = tap_span(bin_start(bx[0], bin_x, 0),
                           bin_start(bx[0], bin_x, P), inv, W);
  const int2 sy = tap_span(bin_start(bx[1], bin_y, 0),
                           bin_start(bx[1], bin_y, P), inv, H);
  const int nxt = sx.y - sx.x + 1;
  const int nyt = sy.y - sy.x + 1;
  float* wy = reinterpret_cast<float*>(smem);  // [P][nyt]
  float* wx = wy + P * side;                   // [P][nxt]
  int* ya = reinterpret_cast<int*>(wx + P * side);
  int* yb = ya + P;
  int* xa = yb + P;
  int* xb = xa + P;
  for (int i = threadIdx.x; i < P * nyt; i += blockDim.x) wy[i] = 0.0f;
  for (int i = threadIdx.x; i < P * nxt; i += blockDim.x) wx[i] = 0.0f;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    ya[i] = xa[i] = INT_MAX;
    yb[i] = xb[i] = -1;
  }
  __syncthreads();
  fill_weights(make_axis(bx[1], bin_y, stride, H, sampling), 0, P, sy.x, nyt,
               wy, ya, yb, nullptr);
  fill_weights(make_axis(bx[0], bin_x, stride, W, sampling), 0, P, sx.x, nxt,
               wx, xa, xb, nullptr);
  __syncthreads();

  // the region of non-zero weight
  int ry0 = INT_MAX, ry1 = -1, rx0 = INT_MAX, rx1 = -1;
  for (int p = 0; p < P; ++p) {
    ry0 = min(ry0, ya[p]);
    ry1 = max(ry1, yb[p]);
    rx0 = min(rx0, xa[p]);
    rx1 = max(rx1, xb[p]);
  }
  if (ry0 > ry1 || rx0 > rx1) return;

  const __nv_bfloat16* g = dout + static_cast<size_t>(roi) * P * P * C;
  float* dst = acc + static_cast<size_t>(b) * H * W * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    for (int x = rx0; x <= rx1; ++x) {
      float t[kPM];
#pragma unroll
      for (int p = 0; p < kPM; ++p) t[p] = 0.0f;
      // the bins that weigh column x (the same for every thread)
      for (int q = 0; q < P; ++q) {
        if (x < xa[q] || x > xb[q]) continue;
        const float w = wx[q * nxt + x - sx.x];
        const __nv_bfloat16* gq = g + static_cast<size_t>(q) * C + c;
#pragma unroll
        for (int p = 0; p < kPM; ++p)
          if (p < P)
            t[p] += w * bf16_to_float(gq[static_cast<size_t>(p) * P * C]);
      }
      for (int y = ry0; y <= ry1; ++y) {
        float v = 0.0f;
#pragma unroll
        for (int p = 0; p < kPM; ++p)
          if (p < P && y >= ya[p] && y <= yb[p])
            v += wy[p * nyt + y - sy.x] * t[p];
        atomicAdd(dst + (static_cast<size_t>(y) * W + x) * C + c, v);
      }
    }
  }
}

// out[i] = bf16(acc[i]), 8 values a thread (n a multiple of 8, both
// 16-byte aligned).
__global__ void cast_bf16_kernel(const float* __restrict__ acc,
                                 __nv_bfloat16* __restrict__ out, long long n8) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n8; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float4 a = reinterpret_cast<const float4*>(acc)[2 * i];
    const float4 b = reinterpret_cast<const float4*>(acc)[2 * i + 1];
    const __nv_bfloat162 h0 = __floats2bfloat162_rn(a.x, a.y);
    const __nv_bfloat162 h1 = __floats2bfloat162_rn(a.z, a.w);
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(b.x, b.y);
    const __nv_bfloat162 h3 = __floats2bfloat162_rn(b.z, b.w);
    uint4 o;
    o.x = *reinterpret_cast<const unsigned*>(&h0);
    o.y = *reinterpret_cast<const unsigned*>(&h1);
    o.z = *reinterpret_cast<const unsigned*>(&h2);
    o.w = *reinterpret_cast<const unsigned*>(&h3);
    reinterpret_cast<uint4*>(out)[i] = o;
  }
}

using BwdKernel = void (*)(Grads, const float*, const int*,
                           const __nv_bfloat16*, int, int, int, int, int);

}  // namespace

extern "C" {

// Zeroes `acc` (the levels' f32 gradients, level after level, each (B, h_l,
// w_l, C)), scatters d pooled `dout` (B, R, P, P, C) bf16 into it for the
// boxes (B, R, 4) f32 XYXY on levels `lvl` (B, R) int32 at strides
// 2^(min_level + l), and, when `out` is not NULL, casts it into `out` (bf16,
// the same layout). All on `stream`; returns cudaGetLastError() (0 =
// launched). C a multiple of 8 up to 256, 1 <= P <= 32, 0 <= sampling <= 16
// (0: adaptive), pointers 16-byte aligned (checked by the wrapper); the
// weight tables (2 P rows of the longest level side) must fit a block's
// shared memory (checked here: cudaErrorInvalidValue).
int roi_align_backward_run(void* acc, void* out, int h0, int w0, int h1,
                           int w1, int h2, int w2, int h3, int w3,
                           int n_levels, int min_level, const void* boxes,
                           const void* lvl, const void* dout, int B, int R,
                           int C, int P, int sampling, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_levels < 1 || n_levels > kMaxLevels || sampling < 0 ||
      sampling > kMaxSampling || P < 1 || P > kMaxOut || C < 8 ||
      C > kMaxC || C % 8 != 0 || B < 1 || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  Grads gr;
  int side = 1;
  long long total = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    gr.acc[l] = nullptr;
    gr.H[l] = hs[l];
    gr.W[l] = ws[l];
    gr.stride[l] = static_cast<float>(1 << (min_level + l));
    if (l < n_levels) {
      if (hs[l] < 1 || ws[l] < 1)
        return static_cast<int>(cudaErrorInvalidValue);
      gr.acc[l] = static_cast<float*>(acc) + total;
      total += static_cast<long long>(B) * hs[l] * ws[l] * C;
      side = std::max(side, std::max(hs[l], ws[l]));
    }
  }
  gr.n_levels = n_levels;
  const long long smem = 4LL * 2 * P * side + 4LL * 4 * P;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(B) * R;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);

  err = cudaMemsetAsync(acc, 0, static_cast<size_t>(total) * sizeof(float),
                        s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdKernel kernel = P <= 8    ? &roi_align_backward_kernel<8>
                           : P <= 16 ? &roi_align_backward_kernel<16>
                                     : &roi_align_backward_kernel<32>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = std::min(kBwdThreads, (C + 31) / 32 * 32);
  kernel<<<dim3(static_cast<unsigned>(blocks)), threads,
           static_cast<size_t>(smem), s>>>(
      gr, static_cast<const float*>(boxes), static_cast<const int*>(lvl),
      static_cast<const __nv_bfloat16*>(dout), R, C, P, sampling, side);
  err = cudaGetLastError();
  if (err != cudaSuccess || out == nullptr) return static_cast<int>(err);
  const long long n8 = total / 8;
  const int grid = static_cast<int>(std::min<long long>((n8 + 255) / 256,
                                                        132LL * 16));
  cast_bf16_kernel<<<grid, 256, 0, s>>>(static_cast<const float*>(acc),
                                        static_cast<__nv_bfloat16*>(out), n8);
  return static_cast<int>(cudaGetLastError());
}

const char* roi_align_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
