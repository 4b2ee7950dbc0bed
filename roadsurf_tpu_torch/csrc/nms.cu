// Greedy non-maximum suppression keep mask over boxes already sorted by
// score (descending, ties by index), f32, as a bitmask and a register sweep.
//
// Replaces the TPU kernel nms_keep_mask (roadsurf_tpu/ops/nms_pallas.py:59,
// _nms_kernel :30); the wrapper, the plain PyTorch version and its mirrors of
// the two phases below are in roadsurf_tpu_torch/ops/nms_kernel.py.
//
// Box i suppresses a later box j iff i is kept, both are valid (score above
// NEG_INF / 2) and inter > t * union, with union = (area_j + area_i) -
// inter: the divisionless test of ops/nms.py::_overlap and of the
// reference's XLA nms_fixed. The TPU kernel tests inter / union > t with a
// division (nms_pallas.py:51), which can decide a pair within an ulp of t
// the other way. Areas, inter, union and t * union are computed with
// explicitly rounded operations in the order of the torch ops, and t is the
// threshold rounded to f32, as torch rounds a Python scalar, so the keep
// mask equals the plain version's bit for bit.
//
// What bounds it on an H100: the greedy scan's chain of dependent decisions,
// not bytes or operations (a problem of N boxes reads 20 N bytes and tests
// at most N^2 / 2 pairs of ~12 f32 operations). The design takes every
// independent piece of work off that chain:
//   1. Pair phase (nms_pair_kernel): every pair's test at once, as 64-bit
//      suppression words. Grid (upper-triangle (row tile, column word)
//      pairs, problem), 64 threads, one row each; the column word's 64 boxes
//      are staged in shared memory. Bit k of word w of row i is set iff
//      j = 64 w + k > i, both are valid and i's overlap with j exceeds t.
//      Words below the diagonal tile (and a row's padding word) are never
//      written and never read.
//   2. Sweep phase (nms_sweep_kernel): one warp per problem, the `removed`
//      bitmask in registers (word w on lane w % 32, slot w / 32). Each
//      64-rank block's rows are copied by one bulk copy (rows are padded to
//      an even count of words, 16 bytes) into a ring of shared memory
//      kRing - 1 blocks ahead, counted on an mbarrier. For each block in
//      order, the lanes take the block's removed word from the lane that
//      holds it and settle its 64 keep decisions in registers, each rank's
//      diagonal word a broadcast read of the ring; then every lane ORs the
//      kept ranks' rows into its later words, 64 masked reads of the ring
//      with no chain between them. No block barrier, and no load from
//      device memory on the chain.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "bulk_copy.cuh"

namespace {

constexpr float kValidAbove = -5e9f;  // NEG_INF / 2, ops/nms_kernel.py
constexpr int kTile = 64;             // ranks a word covers
constexpr int kMaxSmem = 232448;      // bytes of shared memory a block may use
constexpr int kLaneWords = 4;         // removed words a lane holds
constexpr int kMaxWords = 32 * kLaneWords;
constexpr int kSweepWarps = 4;        // problems a sweep block takes, at most
constexpr int kRing = 3;              // 64-rank blocks a sweep stages

typedef unsigned long long u64;

__device__ __forceinline__ float box_area(float x0, float y0, float x1,
                                          float y1) {
  return __fmul_rn(fmaxf(__fsub_rn(x1, x0), 0.0f),
                   fmaxf(__fsub_rn(y1, y0), 0.0f));
}

__global__ void __launch_bounds__(kTile)
    nms_pair_kernel(const float* __restrict__ boxes,
                    const float* __restrict__ scores, u64* __restrict__ words,
                    int N, int nw, float thresh) {
  __shared__ float4 cbox[kTile];  // the column word's boxes
  __shared__ float carea[kTile];
  __shared__ unsigned cvalid[kTile / 32];  // the column word's valid bits

  // blockIdx.x walks the upper triangle row by row: row tile rt holds the
  // column words rt .. nw - 1
  int t = blockIdx.x;
  int rt = 0;
  while (t >= nw - rt) {
    t -= nw - rt;
    ++rt;
  }
  const int cw = rt + t;
  const size_t base = static_cast<size_t>(blockIdx.y) * N;

  const int j = cw * kTile + threadIdx.x;
  int v = 0;
  float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // padding: masked below
  if (j < N) {
    const float* b = boxes + 4 * (base + j);
    c = make_float4(b[0], b[1], b[2], b[3]);
    v = scores[base + j] > kValidAbove;
  }
  cbox[threadIdx.x] = c;
  carea[threadIdx.x] = box_area(c.x, c.y, c.z, c.w);
  const unsigned ballot = __ballot_sync(~0u, v);
  if ((threadIdx.x & 31) == 0) cvalid[threadIdx.x >> 5] = ballot;
  __syncthreads();
  const u64 cvalid_bits =
      static_cast<u64>(cvalid[0]) | static_cast<u64>(cvalid[1]) << 32;

  const int i = rt * kTile + threadIdx.x;
  if (i >= N) return;
  u64 bits = 0;
  if (scores[base + i] > kValidAbove) {
    const float* b = boxes + 4 * (base + i);
    const float bx0 = b[0], by0 = b[1], bx1 = b[2], by1 = b[3];
    const float ba = box_area(bx0, by0, bx1, by1);
#pragma unroll 8
    for (int k = 0; k < kTile; ++k) {
      const float4 o = cbox[k];
      const float iw =
          fmaxf(__fsub_rn(fminf(o.z, bx1), fmaxf(o.x, bx0)), 0.0f);
      const float ih =
          fmaxf(__fsub_rn(fminf(o.w, by1), fmaxf(o.y, by0)), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(carea[k], ba), inter);
      if (inter > __fmul_rn(thresh, uni)) bits |= 1ull << k;
    }
    // only valid later boxes: j > i, and j < N
    bits &= cvalid_bits;
    if (cw == rt) bits &= ~0ull << threadIdx.x << 1;
  }
  words[(base + i) * (nw + (nw & 1)) + cw] = bits;
}

__global__ void __launch_bounds__(32 * kSweepWarps)
    nms_sweep_kernel(const float* __restrict__ scores,
                     const u64* __restrict__ words,
                     unsigned char* __restrict__ keep, int problems, int N,
                     int nw) {
  extern __shared__ __align__(16) u64 rings[];
  __shared__ uint64_t full[kSweepWarps][kRing];  // ring slot s holds its block
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int prob = blockIdx.x * (blockDim.x >> 5) + warp;
  if (prob >= problems) return;  // the whole warp
  const int nwp = nw + (nw & 1);   // words a row holds (16-byte rows)
  const float* sc = scores + static_cast<size_t>(prob) * N;
  const u64* S = words + static_cast<size_t>(prob) * N * nwp;
  unsigned char* kp = keep + static_cast<size_t>(prob) * N;
  // this warp's ring of kRing blocks of 64 rows
  u64* ring = rings + static_cast<size_t>(warp) * kRing * kTile * nwp;
  uint64_t* bar = full[warp];
  if (lane == 0) {
    for (int i = 0; i < kRing; ++i) bulk::mbar_init(&bar[i]);
    bulk::fence_init();
  }
  __syncwarp();

  // block b's rows (contiguous) into ring slot b % kRing: one bulk copy
  auto stage = [&](int b) {
    if (b < nw && lane == 0) {
      const unsigned bytes = 8u * min(kTile, N - b * kTile) * nwp;
      bulk::mbar_expect(&bar[b % kRing], bytes);
      bulk::copy(ring + (b % kRing) * kTile * nwp,
                 S + static_cast<size_t>(b) * kTile * nwp, bytes,
                 &bar[b % kRing]);
    }
  };
  // block b's validity, loaded during block b - 1
  bool v0, v1;
  auto fetch = [&](int b) {
    const int i0 = b * kTile + lane;
    v0 = i0 < N && sc[i0] > kValidAbove;
    v1 = i0 + 32 < N && sc[i0 + 32] > kValidAbove;
  };
  for (int b = 0; b < kRing - 1; ++b) stage(b);
  fetch(0);

  u64 removed[kLaneWords];
#pragma unroll
  for (int s = 0; s < kLaneWords; ++s) removed[s] = 0;
  for (int b = 0; b < nw; ++b) {
    stage(b + kRing - 1);
    bulk::mbar_wait(&bar[b % kRing], (b / kRing) & 1);  // block b landed
    const u64* blk = ring + (b % kRing) * kTile * nwp;
    const int i0 = b * kTile + lane;
    const int i1 = i0 + 32;
    const u64 valid = static_cast<u64>(__ballot_sync(~0u, v0)) |
                      (static_cast<u64>(__ballot_sync(~0u, v1)) << 32);
    // the block's removed word, from the lane that holds it
    u64 r = 0;
#pragma unroll
    for (int s = 0; s < kLaneWords; ++s)
      if (s == b / 32) r = removed[s];
    r = __shfl_sync(~0u, r, b % 32);
    // settle the 64 decisions: every lane takes the same steps, reading
    // each rank's diagonal word (only bits of later ranks) from the ring
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      const u64 d = blk[k * nwp + b];
      if ((valid & ~r) >> k & 1) r |= d;
    }
    const u64 kept = valid & ~r;
    if (i0 < N) kp[i0] = static_cast<unsigned char>(kept >> lane & 1);
    if (i1 < N) kp[i1] = static_cast<unsigned char>(kept >> (lane + 32) & 1);
    if (b + 1 < nw) fetch(b + 1);

    // the kept ranks' rows into the later words, from the ring: 64 loads
    // with no chain between them, each masked by its rank's keep bit
#pragma unroll
    for (int s = 0; s < kLaneWords; ++s) {
      const int w = lane + 32 * s;
      if (32 * s >= nw) break;  // the same on every lane
      if (w > b && w < nw) {
        u64 acc = 0;
#pragma unroll
        for (int k = 0; k < kTile; ++k)
          acc |= blk[k * nwp + w] & (0ull - (kept >> k & 1));
        removed[s] |= acc;
      }
    }
    __syncwarp();  // block b's slot is read before it is staged again
  }
}

int check_sizes(int problems, int N, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (problems < 1 || problems > 65535 || N < 1 || N > kMaxWords * kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" {

// Both launch on `stream` and return cudaGetLastError() (0 = launched).
// boxes (problems, N, 4) f32 XYXY and scores (problems, N) f32, each problem
// sorted by score, descending and stable; words (problems, N, nwp) u64
// scratch, nwp = ceil(N / 64) rounded up to even; keep (problems, N) uint8
// out, 1 = kept. 1 <= N <= 8192 and
// problems <= 65535 (checked by the wrapper).

// The pair phase: writes the words of every row i < N at column words
// >= i / 64.
int nms_pair_words_f32(const void* boxes, const void* scores, void* words,
                       int problems, int N, float thresh, int device,
                       void* stream) {
  const int rc = check_sizes(problems, N, device);
  if (rc != 0) return rc;
  const int nw = (N + kTile - 1) / kTile;
  const dim3 grid(nw * (nw + 1) / 2, problems);
  nms_pair_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<u64*>(words), N, nw, thresh);
  return static_cast<int>(cudaGetLastError());
}

// The sweep phase: reads the pair phase's words, writes keep.
int nms_sweep_words(const void* scores, const void* words, void* keep,
                    int problems, int N, int device, void* stream) {
  const int rc = check_sizes(problems, N, device);
  if (rc != 0) return rc;
  const int nw = (N + kTile - 1) / kTile;
  // a warp's ring: kRing blocks of 64 rows x nw words; as many warps a
  // block as fit its shared memory
  const long long ring = 8LL * kRing * kTile * (nw + (nw & 1));
  const int warps = static_cast<int>(
      std::max(1LL, std::min<long long>(kSweepWarps, kMaxSmem / ring)));
  const long long smem = ring * warps;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (problems + warps - 1) / warps;
  nms_sweep_kernel<<<blocks, 32 * warps, static_cast<size_t>(smem),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const u64*>(words),
      static_cast<unsigned char*>(keep), problems, N, nw);
  return static_cast<int>(cudaGetLastError());
}

const char* nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
