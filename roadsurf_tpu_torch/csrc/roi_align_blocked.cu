// Multilevel ROIAlignV2 (aligned=True) on large maps, adaptive sampling
// (POOLER_SAMPLING_RATIO 0, n = ceil(bin cells) samples per bin, no cap) or
// a fixed s x s grid; bf16 NHWC features -- or int8 ones with one f32 scale
// a level -- in, bf16 (B, R, P, P, C) out, f32 accumulation.
//
// Replaces the TPU kernel roi_align_fused_blocked (roadsurf_tpu/ops/
// roi_align_pallas.py:471) in both its modes; the wrapper and the plain
// PyTorch version are in roadsurf_tpu_torch/ops/roi_align_blocked_kernel.py.
// The device code, the note on what bounds it and its design are in
// roi_align_staged.cuh, which K1 (roi_align.cu) includes too; this file is
// K2's entry point: every sampling mode, P and level side at run time.

#include "roi_align_staged.cuh"

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched); the
// arguments and limits are pooler_run's (roi_align_staged.cuh), sampling 0
// (adaptive) to 16.
int roi_align_blocked_run(const void* f0, const void* f1, const void* f2,
                          const void* f3, int h0, int w0, int h1, int w1,
                          int h2, int w2, int h3, int w3, int n_levels,
                          int min_level, const void* scales,
                          const void* boxes, const void* lvl, void* out,
                          int B, int R, int C, int P, int sampling,
                          int device, void* stream) {
  return pooler_run<false>(f0, f1, f2, f3, h0, w0, h1, w1, h2, w2, h3, w3,
                           n_levels, min_level, scales, boxes, lvl, out, B,
                           R, C, P, sampling, 0, device, stream);
}

const char* roi_align_blocked_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
