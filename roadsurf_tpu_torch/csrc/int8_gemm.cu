// int8 x int8 -> int32 GEMM with the static-int8 epilogue fused: out[m, n] =
// acc[m, n] (int32, raw), or y = acc * mult[n] + bias[n], optional ReLU, as
// bf16 or as int8 clip(round(y), +-127).
//
// Replaces the TPU kernel int8_gemm (roadsurf_tpu/ops/int8_gemm.py:79); the
// wrapper, the plain PyTorch version and the note on what bounds this
// kernel are in roadsurf_tpu_torch/ops/int8_gemm.py.
//
// Grid: one block of 8 warps per 128 x 128 output tile; the K loop walks
// 64-deep slices. Each slice of a (M, K) row-major and of w (K, N) row-major
// is staged through registers into shared memory, w transposed to (n, k) on
// the way (4 x 4 byte blocks through __byte_perm), so that both operands'
// mma fragments are 32-bit loads of 4 consecutive k. While the tensor cores
// work on one slice the next one is already in registers. Each warp owns a
// 64 x 32 sub-tile: 4 x 4 mma.sync.m16n8k32 s8 x s8 -> s32 per 32 k, the
// int32 accumulators stay in registers until the epilogue.
//
// The epilogue rounds explicitly (__fmul_rn, __fadd_rn: no contraction into
// a fused multiply-add) in the plain version's order, so that a value on a
// rounding boundary lands on the same side in both.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kPad = 16;  // bytes of padding a shared-memory row
constexpr int kThreads = 256;

enum Mode { kRaw = 0, kBf16 = 1, kInt8 = 2 };

__device__ __forceinline__ void mma_s8(int* c, const int* a, int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes of row `row`, columns [col, col + 16) of a (rows, cols) row-major
// int8 matrix; zero outside it. `vec`: cols % 16 == 0 and a 16-byte aligned
// base, so whole chunks are one vector load.
__device__ __forceinline__ int4 load16(const int8_t* p, int rows, int cols,
                                       int row, int col, bool vec) {
  if (row >= rows) return make_int4(0, 0, 0, 0);
  const int8_t* src = p + static_cast<size_t>(row) * cols + col;
  if (vec && col + 16 <= cols) return *reinterpret_cast<const int4*>(src);
  int4 v;
  int8_t* b = reinterpret_cast<int8_t*>(&v);
  for (int i = 0; i < 16; ++i) b[i] = col + i < cols ? src[i] : 0;
  return v;
}

// 4 bytes of row `row`, columns [col, col + 4); zero outside. `vec`: cols %
// 4 == 0 and a 4-byte aligned base.
__device__ __forceinline__ int load4(const int8_t* p, int rows, int cols,
                                     int row, int col, bool vec) {
  if (row >= rows) return 0;
  const int8_t* src = p + static_cast<size_t>(row) * cols + col;
  if (vec && col + 4 <= cols) return *reinterpret_cast<const int*>(src);
  unsigned v = 0;
  for (int i = 0; i < 4 && col + i < cols; ++i)
    v |= static_cast<unsigned>(static_cast<uint8_t>(src[i])) << (8 * i);
  return static_cast<int>(v);
}

// (k, n) of 4 x 4 byte block g of a w slice (512 blocks: 16 along k, 32
// along n). A warp takes 4 k-blocks x 8 n-blocks: its loads are whole
// 32-byte runs of 4 rows, and its transposed stores spread over 8 banks.
__device__ __forceinline__ int2 w_block(int g) {
  return make_int2(4 * (g % 4 + 4 * (g / 128)), 4 * ((g / 4) % 32));
}

struct Stage {
  int4 a[2];   // two 16-byte chunks of the a slice
  int w[2][4]; // two 4 x 4 blocks of the w slice, rows k .. k + 3
};

__device__ __forceinline__ void load_stage(Stage& s, const int8_t* a,
                                           const int8_t* w, int M, int K,
                                           int N, int m0, int n0, int k0,
                                           bool vec_a, bool vec_w) {
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;  // 512 chunks: 128 rows x 4
    s.a[i] = load16(a, M, K, m0 + c / 4, k0 + (c % 4) * 16, vec_a);
  }
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int2 kn = w_block(threadIdx.x + i * kThreads);
    #pragma unroll
    for (int r = 0; r < 4; ++r)
      s.w[i][r] = load4(w, K, N, k0 + kn.x + r, n0 + kn.y, vec_w);
  }
}

__device__ __forceinline__ void store_stage(const Stage& s,
                                            int8_t (*As)[kBK + kPad],
                                            int8_t (*Bs)[kBK + kPad]) {
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;
    *reinterpret_cast<int4*>(&As[c / 4][(c % 4) * 16]) = s.a[i];
  }
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int2 kn = w_block(threadIdx.x + i * kThreads);
    const int k = kn.x, n = kn.y;
    const int* r = s.w[i];
    // transpose the 4 x 4 byte block: out[j] = column n + j, rows k .. k + 3
    const int lo01 = __byte_perm(r[0], r[1], 0x5140);
    const int lo23 = __byte_perm(r[2], r[3], 0x5140);
    const int hi01 = __byte_perm(r[0], r[1], 0x7362);
    const int hi23 = __byte_perm(r[2], r[3], 0x7362);
    *reinterpret_cast<int*>(&Bs[n + 0][k]) = __byte_perm(lo01, lo23, 0x5410);
    *reinterpret_cast<int*>(&Bs[n + 1][k]) = __byte_perm(lo01, lo23, 0x7632);
    *reinterpret_cast<int*>(&Bs[n + 2][k]) = __byte_perm(hi01, hi23, 0x5410);
    *reinterpret_cast<int*>(&Bs[n + 3][k]) = __byte_perm(hi01, hi23, 0x7632);
  }
}

__global__ void __launch_bounds__(kThreads)
    int8_gemm_kernel(const int8_t* __restrict__ a,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ mult,
                     const float* __restrict__ bias, void* __restrict__ out,
                     int M, int K, int N, int mode, int relu, bool vec_a,
                     bool vec_w) {
  __shared__ __align__(16) int8_t As[kBM][kBK + kPad];
  __shared__ __align__(16) int8_t Bs[kBN][kBK + kPad];

  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;  // warp sub-tile
  const int g = lane / 4, t = lane % 4;                  // fragment coords

  int acc[4][4][4];
  #pragma unroll
  for (int i = 0; i < 4; ++i)
    #pragma unroll
    for (int j = 0; j < 4; ++j)
      #pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  Stage st;
  const int nk = (K + kBK - 1) / kBK;
  load_stage(st, a, w, M, K, N, m0, n0, 0, vec_a, vec_w);
  store_stage(st, As, Bs);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk)
      load_stage(st, a, w, M, K, N, m0, n0, (kt + 1) * kBK, vec_a, vec_w);
    #pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      int af[4][4], bf[4][2];
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm + i * 16 + g;
        af[i][0] = *reinterpret_cast<const int*>(&As[r][kk + 4 * t]);
        af[i][1] = *reinterpret_cast<const int*>(&As[r + 8][kk + 4 * t]);
        af[i][2] = *reinterpret_cast<const int*>(&As[r][kk + 16 + 4 * t]);
        af[i][3] = *reinterpret_cast<const int*>(&As[r + 8][kk + 16 + 4 * t]);
      }
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn + j * 8 + g;
        bf[j][0] = *reinterpret_cast<const int*>(&Bs[c][kk + 4 * t]);
        bf[j][1] = *reinterpret_cast<const int*>(&Bs[c][kk + 16 + 4 * t]);
      }
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        #pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
    __syncthreads();
    if (kt + 1 < nk) {
      store_stage(st, As, Bs);
      __syncthreads();
    }
  }

  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    #pragma unroll
    for (int j = 0; j < 4; ++j) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + i * 16 + g + (e >= 2 ? 8 : 0);
        const int n = n0 + wn + j * 8 + 2 * t + (e & 1);
        if (m >= M || n >= N) continue;
        const size_t o = static_cast<size_t>(m) * N + n;
        if (mode == kRaw) {
          static_cast<int*>(out)[o] = acc[i][j][e];
          continue;
        }
        float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][e]), mult[n]),
                            bias[n]);
        if (relu) y = fmaxf(y, 0.0f);
        if (mode == kInt8)
          static_cast<int8_t*>(out)[o] = static_cast<int8_t>(
              fminf(fmaxf(rintf(y), -127.0f), 127.0f));
        else
          static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// a (M, K) and w (K, N) int8 row-major; out (M, N): int32 (mode 0), bf16
// (mode 1) or int8 (mode 2); mult, bias (N,) f32, read in modes 1 and 2.
int int8_gemm_run(const void* a, const void* w, const void* mult,
                  const void* bias, void* out, int M, int K, int N, int mode,
                  int relu, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M < 1 || K < 1 || N < 1 || mode < kRaw || mode > kInt8 ||
      (mode != kRaw && (mult == nullptr || bias == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_a = K % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool vec_w = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  int8_gemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(w),
      static_cast<const float*>(mult), static_cast<const float*>(bias), out,
      M, K, N, mode, relu, vec_a, vec_w);
  return static_cast<int>(cudaGetLastError());
}

const char* int8_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
