// Greedy non-maximum suppression keep mask over boxes already sorted by
// score (descending, ties by index), one problem per block, f32.
//
// Replaces the TPU kernel nms_keep_mask (roadsurf_tpu/ops/nms_pallas.py:59,
// _nms_kernel :30); the wrapper, the plain PyTorch version and the note on
// what bounds this kernel are in roadsurf_tpu_torch/ops/nms_kernel.py.
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
// Grid: one block per problem; the problem's boxes, areas and keep flags
// live in shared memory (2000 boxes: 42 KB). A loop over rank i runs on
// every thread; when box i is still kept, the threads test it against the
// later boxes j in parallel and end the step with a barrier. A suppressed
// rank writes nothing and skips the barrier.

#include <cuda_runtime.h>

namespace {

constexpr float kValidAbove = -5e9f;  // NEG_INF / 2, ops/nms_kernel.py
constexpr int kMaxSmem = 232448;
constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
    nms_keep_kernel(const float* __restrict__ boxes,
                    const float* __restrict__ scores,
                    unsigned char* __restrict__ keep, int N, float thresh) {
  extern __shared__ float smem[];
  float* x0 = smem;
  float* y0 = x0 + N;
  float* x1 = y0 + N;
  float* y1 = x1 + N;
  float* area = y1 + N;
  unsigned char* k = reinterpret_cast<unsigned char*>(area + N);

  const size_t base = static_cast<size_t>(blockIdx.x) * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const float* b = boxes + 4 * (base + i);
    x0[i] = b[0];
    y0[i] = b[1];
    x1[i] = b[2];
    y1[i] = b[3];
    area[i] = __fmul_rn(fmaxf(__fsub_rn(b[2], b[0]), 0.0f),
                        fmaxf(__fsub_rn(b[3], b[1]), 0.0f));
    k[i] = scores[base + i] > kValidAbove;
  }
  __syncthreads();

  for (int i = 0; i < N; ++i) {
    if (!k[i]) continue;  // the same value on every thread
    const float bx0 = x0[i], by0 = y0[i], bx1 = x1[i], by1 = y1[i];
    const float ba = area[i];
    for (int j = i + 1 + threadIdx.x; j < N; j += blockDim.x) {
      if (!k[j]) continue;
      const float iw =
          fmaxf(__fsub_rn(fminf(x1[j], bx1), fmaxf(x0[j], bx0)), 0.0f);
      const float ih =
          fmaxf(__fsub_rn(fminf(y1[j], by1), fmaxf(y0[j], by0)), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(area[j], ba), inter);
      if (inter > __fmul_rn(thresh, uni)) k[j] = 0;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < N; i += blockDim.x) keep[base + i] = k[i];
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// boxes (problems, N, 4) f32 XYXY and scores (problems, N) f32, each
// problem sorted by score, descending and stable; keep (problems, N)
// uint8 out, 1 = kept. 21 * N bytes of shared memory must fit a block
// (checked by the wrapper).
int nms_keep_mask_f32(const void* boxes, const void* scores, void* keep,
                      int problems, int N, float thresh, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (problems < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = 5LL * N * sizeof(float) + N;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_keep_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = ((N + 31) / 32) * 32;
  if (threads > kThreads) threads = kThreads;
  nms_keep_kernel<<<problems, threads, static_cast<size_t>(smem),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<unsigned char*>(keep), N, thresh);
  return static_cast<int>(cudaGetLastError());
}

const char* nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
