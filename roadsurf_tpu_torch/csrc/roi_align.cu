// Multilevel ROIAlignV2 (aligned=True) at a fixed s x s sampling grid, bf16
// NHWC features -- or int8 ones with one f32 scale a level -- in, bf16
// (B, R, P, P, C) out, f32 accumulation.
//
// Replaces the TPU kernel roi_align_fused (roadsurf_tpu/ops/
// roi_align_pallas.py:638) in both its modes; the wrapper, the plain
// PyTorch version and the note on what bounds this kernel are in
// roadsurf_tpu_torch/ops/roi_align_kernel.py.
//
// The device code is K2's (roi_align_staged.cuh, where its design is set
// out): a block per (image, box, band of output rows), warps over output
// columns, 8 channels a lane; the weights first; the box's rows of
// non-zero weight staged through a shared-memory ring by bulk copies on
// mbarriers; the x-pass once per staged row; int8 cells dequantized once a
// staged chunk into a bf16 work buffer. At the fast profile's shapes K2's
// kernel ran 1.8x (bf16 levels) and 2.1x (int8) faster than this kernel's
// earlier design (a block per output row, four 4-byte tap loads a sample
// straight from L2, a convert per tap), so the two share one copy of it.
// This file is K1's entry point: fixed sampling only (s >= 1), with
// kernels compiled for the fast profile's two poolers (P = 7 and 14 at s =
// 2: the per-bin loops and band counts unrolled; 7-11% faster than the
// kernel with P and s at run time on the same inputs), any other P and s at
// run time.
//
// What bounds it now: the latency of each block's chain of chunk copies
// from L2, not the bytes. At the fast profile's shapes a forward's two
// calls take about 2.5x their byte bound (each cell read once) and 1.9x
// the time each box's own cells take at the memory rate; two blocks an SM
// for P = 7 (128 registers) and a ring of four 24 KB slots in place of two
// 48 KB ones each ran no faster.
//
// Sample semantics (reference ops/roi_align.py:48-62): coordinate c = (lo
// + (bin + (s + 0.5) / sampling) * bin_size) / stride - 0.5; it counts iff
// c lies in [-1, dim], is then clamped to [0, dim - 1], and splits between
// floor(c) and min(floor(c) + 1, dim - 1). The weights are computed with
// explicitly rounded operations (no contraction into FMA) in the plain
// version's order, so that a sample on the border of [-1, dim] falls on
// the same side in both.

#include "roi_align_staged.cuh"

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched); the
// arguments and limits are pooler_run's (roi_align_staged.cuh), sampling 1
// to 16.
int roi_align_run(const void* f0, const void* f1, const void* f2,
                  const void* f3, int h0, int w0, int h1, int w1, int h2,
                  int w2, int h3, int w3, int n_levels, int min_level,
                  const void* scales, const void* boxes, const void* lvl,
                  void* out, int B, int R, int C, int P, int sampling,
                  int device, void* stream) {
  return pooler_run<true>(f0, f1, f2, f3, h0, w0, h1, w1, h2, w2, h3, w3,
                          n_levels, min_level, scales, boxes, lvl, out, B, R,
                          C, P, sampling, 1, device, stream);
}

const char* roi_align_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
