// int8 x int8 -> int32 GEMM with the static-int8 epilogue fused: out[m, n] =
// acc[m, n] (int32, raw), or y = acc * mult[n] + bias[n], optional ReLU, as
// bf16 or as int8 clip(round(y), +-127).
//
// Replaces the TPU kernel int8_gemm (roadsurf_tpu/ops/int8_gemm.py:79); the
// wrapper, the plain PyTorch version and the note on what bounds this
// kernel are in roadsurf_tpu_torch/ops/int8_gemm.py.
//
// What bounds it on an H100: at the backbone's 1x1 shapes (K <= 2048) the
// bytes, and of those mostly the output (C3 1x1 128>512 at B=64 reads 8 MB
// of a and writes 134 MB of int32); at box FC1 (K = 12544) the int8 tensor
// cores, and in practice the L2 -> SM rate at which the tiles of a and w
// can be fed to them. What the design does about it:
//   * Tensor cores at their full rate: wgmma.mma_async m64nNk32 s8.s8.s32,
//     both operands read from shared memory. A block is one producer warp and
//     two consumer warpgroups, 64 output rows each, over a 128 x BN tile (BN
//     = 64 when N <= 64, so C2's N = 64 is one tile without waste, else 128).
//   * A TMA ring: the producer issues 2-D tensor copies (cp.async.bulk.tensor,
//     128-byte swizzle) of 128-deep K slices of a and of w into a ring of
//     stages in shared memory (96 KB), each stage's bytes completing on a
//     "full" mbarrier; the consumers release a stage on its "empty" mbarrier
//     once the wgmma that read it has retired, with one K slice of wgmma
//     kept in flight. Two blocks an SM, so one block's epilogue overlaps the
//     other's loads and products.
//   * w transposed once a call. Int8 wgmma reads both operands K-major (its
//     transpose bits exist only for 16-bit types) and w arrives (K, N)
//     row-major, so a first kernel writes wt (N, Kp) into the wrapper's
//     scratch, Kp = K rounded up to 16 and the tail zeroed: 2 K N bytes of
//     traffic, 32 KB at C2 and 25.7 MB at FC1 (~10 us of the call there).
//   * Ragged shapes. TMA needs 16-byte aligned bases and row strides: where a
//     is off 16 bytes or K % 16 != 0, a second kernel copies a into (M, Kp)
//     scratch, zero-padded. Tiles past M, N or K are filled with zeros by the
//     TMA unit itself, so the product needs no masks.
//   * The epilogue staged: the accumulators go through the epilogue into a
//     shared-memory tile (the ring, free by then), which each warpgroup then
//     writes with 16-byte coalesced stores (byte stores only on the ragged
//     edge or where N * out bytes % 16 != 0).
//
// The epilogue rounds explicitly (__fmul_rn, __fadd_rn: no contraction into
// a fused multiply-add) in the plain version's order, so that a value on a
// rounding boundary lands on the same side in both.

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bulk_copy.cuh"
#include "smem_cap.cuh"

namespace {

using bulk::mbar_arrive;
using bulk::mbar_expect;
using bulk::mbar_init;
using bulk::mbar_wait;
using bulk::smem_addr;

constexpr int kBM = 128;            // output rows a block: two warpgroups
constexpr int kBK = 128;            // K slice: one 128-byte swizzle row
constexpr int kRingBytes = 98304;   // the stages' shared memory
constexpr int kConsumers = 2;       // consumer warpgroups
constexpr int kThreads = 128 * kConsumers + 32;  // + the producer warp
constexpr int kMaxStages = 4;
constexpr int kPadK = 16;           // Kp: K rounded up to this (TMA strides)

enum Mode { kRaw = 0, kBf16 = 1, kInt8 = 2 };

template <int BN>
struct Tile {
  static constexpr int kABytes = kBM * kBK;
  static constexpr int kStageBytes = kABytes + BN * kBK;
  static constexpr int kStages = kRingBytes / kStageBytes;
  static_assert(kStages >= 2 && kStages <= kMaxStages, "ring");
  static_assert(kABytes % 1024 == 0 && kStageBytes % 1024 == 0, "swizzle");
  // a warpgroup's staged output rows: BN values of up to 4 bytes + 16
  static constexpr int kRowBytes = BN * 4 + 16;
  static_assert(kConsumers * 64 * kRowBytes <= kRingBytes, "epilogue");
};

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), the
// tile 1024-byte aligned (base offset 0); LBO is unused in this layout.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x BN, int32, the warpgroup's accumulator fragment) += a (64 x 32)
// . b (BN x 32)^T, both from shared memory.
template <int BN>
__device__ __forceinline__ void wgmma(int* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma<64>(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<128>(int* d, uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ float epilogue(int acc, const float* mult,
                                          const float* bias, int n, int N,
                                          int relu) {
  if (n >= N) return 0.0f;
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), mult[n]), bias[n]);
  if (relu) y = fmaxf(y, 0.0f);
  return y;
}

__device__ __forceinline__ int8_t requant(float y) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(y), -127.0f), 127.0f));
}

// Block: the 128 x BN output tile blockIdx.x (N tiles fastest, so blocks
// in flight share their a rows in L2). Warps 0-7: two consumer
// warpgroups; warp 8: the producer.
template <int BN>
__global__ void __launch_bounds__(kThreads, 2)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_w,
                     const float* __restrict__ mult,
                     const float* __restrict__ bias, void* __restrict__ out,
                     int M, int K, int N, int mode, int relu) {
  using T = Tile<BN>;
  constexpr int S = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[kMaxStages], empty[kMaxStages];
  // the ring, 1024-byte aligned for the 128-byte swizzle
  unsigned char* ring =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

  const int tiles_n = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * kBM;
  const int n0 = (blockIdx.x % tiles_n) * BN;
  const int nk = (K + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    bulk::fence_init();
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {
    // the producer: slice kt into stage kt % S once the consumers have
    // released the slice that stage held before
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % S;
        if (kt >= S) mbar_wait(&empty[s], (kt / S - 1) & 1);
        unsigned char* st = ring + s * T::kStageBytes;
        mbar_expect(&full[s], T::kStageBytes);
        bulk::tensor_copy_2d(st, &map_a, kt * kBK, m0, &full[s]);
        bulk::tensor_copy_2d(st + T::kABytes, &map_w, kt * kBK, n0,
                             &full[s]);
      }
    }
    return;
  }

  const int wg = warp / 4;  // consumer warpgroup: output rows 64 wg ..
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  const uint32_t ring_addr = smem_addr(ring);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % S;
    mbar_wait(&full[s], (kt / S) & 1);
    const uint32_t a = ring_addr + s * T::kStageBytes + wg * 64 * kBK;
    const uint32_t b = ring_addr + s * T::kStageBytes + T::kABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      wgmma<BN>(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk));
    wgmma_commit();
    // slice kt - 1's products have retired: release its stage
    wgmma_wait<1>();
    if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(kt - 1) % S]);
  }
  wgmma_wait<0>();

  // every consumer is done with the ring: stage the epilogue's output there
  named_sync(1, 128 * kConsumers);
  const int ob = mode == kRaw ? 4 : mode == kBf16 ? 2 : 1;  // out bytes
  unsigned char* rows = ring + wg * 64 * T::kRowBytes;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // fragment layout: d[4j + 2h + e] is row 16 (warp % 4) + lane / 4 +
      // 8h, column 8j + 2 (lane % 4) + e of the warpgroup's 64 x BN tile
      const int r = 16 * (warp % 4) + lane / 4 + 8 * h;
      const int c = 8 * j + 2 * (lane % 4);
      const int v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      unsigned char* dst = rows + r * T::kRowBytes + c * ob;
      if (mode == kRaw) {
        *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
      } else {
        const float y0 = epilogue(v0, mult, bias, n0 + c, N, relu);
        const float y1 = epilogue(v1, mult, bias, n0 + c + 1, N, relu);
        if (mode == kBf16) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __halves2bfloat162(__float2bfloat16_rn(y0),
                                 __float2bfloat16_rn(y1));
        } else {
          dst[0] = static_cast<unsigned char>(requant(y0));
          dst[1] = static_cast<unsigned char>(requant(y1));
        }
      }
    }
  }
  named_sync(2 + wg, 128);

  // the warpgroup's rows to device memory, 16 bytes a thread and store
  const int row0 = m0 + 64 * wg;
  const int n_rows = min(64, M - row0);
  const int valid = min(BN, N - n0) * ob;  // bytes of a row in the tile
  const int chunks = BN * ob / 16;         // 16-byte chunks a tile row
  const size_t ld = static_cast<size_t>(N) * ob;
  const bool vec = ld % 16 == 0;
  for (int i = threadIdx.x % 128; i < 64 * chunks; i += 128) {
    const int r = i / chunks;
    const int b = (i % chunks) * 16;
    if (r >= n_rows || b >= valid) continue;
    const unsigned char* src = rows + r * T::kRowBytes + b;
    unsigned char* dst = static_cast<unsigned char*>(out) +
                         static_cast<size_t>(row0 + r) * ld +
                         static_cast<size_t>(n0) * ob + b;
    if (vec && b + 16 <= valid) {
      *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
    } else {
      for (int e = 0; e < 16 && b + e < valid; ++e) dst[e] = src[e];
    }
  }
}

// wt (N, Kp) = w (K, N)^T, rows zero-padded from K to Kp; 64 x 64 byte
// tiles through shared memory, 4 bytes a thread each way. `vec`: N % 4 ==
// 0 and w 4-byte aligned.
__global__ void __launch_bounds__(256)
    transpose_kernel(const int8_t* __restrict__ w, int8_t* __restrict__ wt,
                     int K, int N, int Kp, bool vec) {
  __shared__ unsigned char t[64][68];  // [k][n]
  const int k0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = threadIdx.x + 256 * j;
    const int r = i / 16, c = 4 * (i % 16);
    const int k = k0 + r, n = n0 + c;
    unsigned v = 0;
    if (k < K && n < N) {
      const int8_t* src = w + static_cast<size_t>(k) * N + n;
      if (vec) {
        v = *reinterpret_cast<const unsigned*>(src);
      } else {
        for (int e = 0; e < 4 && n + e < N; ++e)
          v |= static_cast<unsigned>(static_cast<unsigned char>(src[e]))
               << (8 * e);
      }
    }
    *reinterpret_cast<unsigned*>(&t[r][c]) = v;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = threadIdx.x + 256 * j;
    const int r = i / 16, c = 4 * (i % 16);  // r: n, c: k
    const int n = n0 + r, k = k0 + c;
    if (n < N && k < Kp) {
      const unsigned v = t[c][r] | t[c + 1][r] << 8 | t[c + 2][r] << 16 |
                         static_cast<unsigned>(t[c + 3][r]) << 24;
      *reinterpret_cast<unsigned*>(wt + static_cast<size_t>(n) * Kp + k) = v;
    }
  }
}

// ap (M, Kp) = a (M, K), rows zero-padded; 4 bytes of ap a thread.
__global__ void __launch_bounds__(256)
    pad_kernel(const int8_t* __restrict__ a, int8_t* __restrict__ ap, int M,
               int K, int Kp) {
  const size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) +
                   threadIdx.x;
  const int per_row = Kp / 4;
  if (i >= static_cast<size_t>(M) * per_row) return;
  const size_t m = i / per_row;
  const int k = 4 * static_cast<int>(i % per_row);
  unsigned v = 0;
  for (int e = 0; e < 4 && k + e < K; ++e)
    v |= static_cast<unsigned>(static_cast<unsigned char>(a[m * K + k + e]))
         << (8 * e);
  *reinterpret_cast<unsigned*>(ap + m * Kp + k) = v;
}

// Whether a is read through its zero-padded copy: TMA takes 16-byte
// aligned bases and row strides only.
bool needs_pad(const void* a, int K) {
  return K % kPadK != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0;
}

// The tensor map of a (rows, cols) int8 row-major matrix with row stride
// `ld` bytes, read in boxes of box_rows x 128 bytes, 128-byte swizzle.
bool make_map(CUtensorMap* map, const void* base, int rows, int cols, int ld,
              int box_rows) {
  const bulk::EncodeTiled fn = bulk::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch_gemm(const void* a, int lda, const void* wt, int Kp,
                const float* mult, const float* bias, void* out, int M, int K,
                int N, int mode, int relu, cudaStream_t st) {
  CUtensorMap map_a, map_w;
  if (!make_map(&map_a, a, M, lda, lda, kBM) ||
      !make_map(&map_w, wt, N, Kp, Kp, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kRingBytes + 1024;
  const cudaError_t err = raise_smem_cap(
      reinterpret_cast<const void*>(int8_gemm_kernel<BN>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>((M + kBM - 1) / kBM) *
                          ((N + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int8_gemm_kernel<BN><<<static_cast<unsigned>(tiles), kThreads, smem, st>>>(
      map_a, map_w, mult, bias, out, M, K, N, mode, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// a (M, K) and w (K, N) int8 row-major; out (M, N): int32 (mode 0), bf16
// (mode 1) or int8 (mode 2), 16-byte aligned; mult, bias (N,) f32, read in
// modes 1 and 2. Scratch from the caller: wt, N * Kp bytes (Kp = K rounded
// up to 16), 16-byte aligned; ap, M * Kp bytes, 16-byte aligned, used and
// required only where a is not 16-byte aligned or K % 16 != 0 (needs_pad).
// Three kernels in stream order: the transpose of w, the padding of a where
// needed, the GEMM.
int int8_gemm_run(const void* a, const void* w, const void* mult,
                  const void* bias, void* out, void* wt, void* ap, int M,
                  int K, int N, int mode, int relu, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool pad = needs_pad(a, K);
  const int Kp = (K + kPadK - 1) / kPadK * kPadK;
  if (M < 1 || K < 1 || N < 1 || mode < kRaw || mode > kInt8 ||
      (mode != kRaw && (mult == nullptr || bias == nullptr)) ||
      wt == nullptr || reinterpret_cast<uintptr_t>(wt) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      (pad && (ap == nullptr || reinterpret_cast<uintptr_t>(ap) % 16 != 0)) ||
      (Kp + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec_w = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  transpose_kernel<<<dim3((N + 63) / 64, (Kp + 63) / 64), 256, 0, st>>>(
      static_cast<const int8_t*>(w), static_cast<int8_t*>(wt), K, N, Kp,
      vec_w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* src = a;
  if (pad) {
    const size_t items = static_cast<size_t>(M) * (Kp / 4);
    const size_t blocks = (items + 255) / 256;
    if (blocks > 0x7fffffffULL) return static_cast<int>(cudaErrorInvalidValue);
    pad_kernel<<<static_cast<unsigned>(blocks), 256, 0, st>>>(
        static_cast<const int8_t*>(a), static_cast<int8_t*>(ap), M, K, Kp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = ap;
  }
  const int lda = pad ? Kp : K;
  const float* mu = static_cast<const float*>(mult);
  const float* bi = static_cast<const float*>(bias);
  return N <= 64 ? launch_gemm<64>(src, lda, wt, Kp, mu, bi, out, M, K, N,
                                   mode, relu, st)
                 : launch_gemm<128>(src, lda, wt, Kp, mu, bi, out, M, K, N,
                                    mode, relu, st);
}

const char* int8_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
