// The gradient of multilevel ROIAlignV2 (aligned=True) with respect to the
// levels: d levels (B, H_l, W_l, C) from d pooled (B, R, P, P, C) bf16 or
// float32, at a fixed s x s grid or adaptive sampling (POOLER_SAMPLING_RATIO
// 0, n = ceil(bin cells) samples per bin, no cap). Levels' gradients come out
// in bf16 or float32 from a bf16 d pooled, in float32 from a float32 one (the
// float32 profiles' training step: K1 and K2 in their float32 mode).
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
// make_axis, tap_span, fill_weights), so both passes weigh every sample
// alike, bit for bit.
//
// What bounds it on an H100: bytes -- d pooled read once and the levels'
// gradients written once (chip_smoke.py _k5_work: 0.126 ms for the box
// pooler's call at B=8, 0.096 for the mask pooler's); its separable
// operations take less at f32's rate. The contraction depth is the one to
// three bins that weigh a cell, and the tolerance against the plain
// gradient (1e-5 of its largest value) needs f32 operands, so the sums run
// on the CUDA cores in f32, not on the tensor cores (bf16 or TF32 operands,
// depth 16 or 8). In practice it is bound by latency and issue: every box
// a tile receives costs a chain of weight evaluations (divisions, floors),
// a slice of d pooled read again from L2 for each tile it overlaps, and a
// chain of shared-memory loads and sums. The design is output-stationary,
// one write per output tile:
//   * Grid. A block owns one tile of kTileH rows, kCC channels and as many
//     columns as its consumer threads cover (kCC / 8 threads a column: 8
//     columns at kWideC = 256 channels, where P <= kWideMaxP and a box's
//     slice of all channels fits a ring slot; 32 at kNarrowC = 64) of one
//     level of one image. The grid runs image-major (an image's d pooled,
//     25.5 MB at the box pooler, stays in the 50 MB L2 while its tiles
//     run), within an image the coarse levels first.
//   * Culling. The block scans the image's boxes in ascending index, in
//     windows of kMaxList, and keeps those on its level whose region (the
//     tap span of the first and last bin edges) overlaps the tile: each
//     thread tests its boxes of the window first (their loads overlap),
//     then warp ballots and popcounts compact them into a shared list, in
//     order, with no atomics.
//   * Producers and consumers. Two producer warps take the kept boxes in
//     turn. For a box a producer waits for a free ring slot, issues the
//     box's d pooled slice dP[b, r, :, :, chunk] as one 2-D tensor copy (P *
//     P rows of kCC channels, at most kMaxSlotBytes; larger P, or a float32
//     d pooled's twice the bytes, in parts of whole bin rows) over dout
//     viewed as (B R P P, C), then evaluates the box's weights over the
//     tile only into the slot's zeroed tables: each bin of each axis at the cells of its tap span within the tile's rows
//     or columns (the cells, and the operations, of fill_weights; the
//     level's side as the border, never the tile's), the (bin, cell) items
//     compacted by a warp scan so that the lanes evaluate only those; with
//     each bin's range of rows, each column's range of bins, and the range
//     of bins that weigh the tile's rows. The slot's "full" mbarrier
//     completes on the copy's bytes and the producer's 32 arrivals. Eight
//     consumer warps wait on it, sum, and release the slot on its "empty"
//     mbarrier: no block-wide barrier runs per box, and the weights'
//     latency is off the consumers' path.
//   * Sums in registers. A consumer thread owns one column of the tile and
//     8 channels, every row: per bin row p that weighs the tile, t = sum_q
//     wx[q, x] dP[p, q] over its column's range of bins, then acc[y] +=
//     wy[p, y] t for the tile's rows that bin p weighs (the same rows for
//     every thread: no divergence).
//   * One write. After the last box the block stores its tile once, in bf16
//     or f32, 16 bytes a store; tiles no box touches store zeros.
// No memset, no accumulator in device memory, no cast kernel, no atomics
// into the gradients: each value is summed by one thread in a fixed order
// (boxes ascending, then p, then q), so the result is bitwise the same
// from run to run. Measured (tools/time_kernels.py --kernel k5, NVIDIA
// H100 80GB HBM3 at 700 W; PERF.md section 6): at the YAML's training
// shapes at B=8 the box pooler's gradient takes 0.808 ms and the mask
// pooler's 0.450 ms, 6.4x and 4.7x their byte bounds, where the first
// design (f32 atomics into a zeroed accumulator, then a cast) took 3.09 and
// 1.74 ms in the same call. The first tile design, in which every thread
// evaluated weights between two block-wide barriers a box, took 2.63 ms for
// the box pooler (chip_smoke.py): the weights' latency, not the bytes, set
// its time, and it still leads: each box costs every tile it overlaps a
// chain of weight evaluations and an L2 read of its slice.

#include "roi_align_staged.cuh"

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kProducerWarps = 2;
constexpr int kBwdThreads = 320;  // 32 (kConsumerWarps + kProducerWarps)
constexpr int kTileH = 8;         // rows of a block's output tile
constexpr int kWideC = 256;       // channels of a tile where P <= kWideMaxP
constexpr int kNarrowC = 64;      // channels of a tile otherwise
constexpr int kWideMaxP = 8;
constexpr int kRing = 3;          // ring slots: a d pooled slice, weights
constexpr int kMaxList = 1024;    // boxes a culling window holds
constexpr int kMaxCopyRows = 256;  // TMA's longest box side
constexpr int kMaxSlotBytes = 32768;  // a slot's d pooled slice
constexpr int kConsumers = 32 * kConsumerWarps;
static_assert(kBwdThreads == 32 * (kConsumerWarps + kProducerWarps),
              "block");

struct Levels {
  long long off[kMaxLevels];  // first element of level l's gradient in out
  int H[kMaxLevels];
  int W[kMaxLevels];
  float stride[kMaxLevels];
  int ntx[kMaxLevels];    // tiles across the level
  int start[kMaxLevels];  // level l's first block within an image's blocks
  int count[kMaxLevels];  // level l's blocks an image: tiles x chunks
  int n_levels;
};

// Words of a slot's tables: wy [P][kTileH] and wx [P][kTW] (f32, zeroed
// outside the evaluated cells), each bin's first and last row of non-zero
// weight (int2 [P]), the range of bins that weigh the tile's rows (int2),
// and each column's range of bins of non-zero weight (int2 [kTW]), padded
// to 16 bytes.
__host__ __device__ constexpr int table_words(int P, int kTW) {
  return (P * (kTileH + kTW + 2) + 2 + 2 * kTW + 3) / 4 * 4;
}

// Weights of bins 0 .. P - 1 of axis `a` at the cells of [s0, s0 + n) within
// each bin's tap span (the cells fill_weights of roi_align_staged.cuh
// evaluates, with its operations) into w[bin * n + cell - s0], by one warp:
// lane q finds bin q's cells, a warp scan compacts the (bin, cell) items,
// and each lane evaluates items lane, lane + 32, ... Where a weight is not
// zero, bin_rng[2 bin], bin_rng[2 bin + 1] get the first and last cell, or
// cell_rng[2 (cell - s0)], cell_rng[2 (cell - s0) + 1] the first and last
// bin (whichever is given).
__device__ __forceinline__ void fill_axis(const Axis& a, int P, int s0,
                                          int n, float* w, int* bin_rng,
                                          int* cell_rng, int lane) {
  int first = 0, cells = 0;
  if (lane < P) {
    const int2 t = tap_span(bin_start(a.lo, a.bin, lane),
                            bin_start(a.lo, a.bin, lane + 1), a.inv,
                            static_cast<int>(a.dim));
    first = max(t.x, s0);
    cells = max(0, min(t.y, s0 + n - 1) - first + 1);
  }
  int upto = cells;  // items of bins 0 .. lane
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {
    const int v = __shfl_up_sync(0xffffffffu, upto, o);
    if (lane >= o) upto += v;
  }
  const int total = __shfl_sync(0xffffffffu, upto, 31);
  for (int k0 = 0; k0 < total; k0 += 32) {
    const int k = k0 + lane;
    // the bin of item k: the first with upto > k
    int lo = 0, hi = P - 1;
#pragma unroll
    for (int step = 0; step < 5; ++step) {
      const int mid = (lo + hi) >> 1;
      if (__shfl_sync(0xffffffffu, upto, mid) > k)
        hi = mid;
      else
        lo = min(mid + 1, hi);
    }
    const int i = lo;
    const int cell = __shfl_sync(0xffffffffu, first, i) + k -
                     (__shfl_sync(0xffffffffu, upto, i) -
                      __shfl_sync(0xffffffffu, cells, i));
    if (k >= total) continue;
    const float d = static_cast<float>(cell);
    const float v = a.sampling == 0 ? adaptive_weight(a, i, d)
                                    : fixed_weight(a, i, d);
    w[i * n + cell - s0] = v;
    if (v != 0.0f) {
      if (bin_rng != nullptr) {
        atomicMin(&bin_rng[2 * i], cell);
        atomicMax(&bin_rng[2 * i + 1], cell);
      } else {
        atomicMin(&cell_rng[2 * (cell - s0)], i);
        atomicMax(&cell_rng[2 * (cell - s0) + 1], i);
      }
    }
  }
}

// Block (image, level, tile, channel chunk): see the note at the top.
// part_bins: bin rows p a copy holds (P when the whole slice fits a slot);
// nparts: copies a box. kF32: float32 gradients (else bf16); kDF32: a
// float32 d pooled (else bf16).
template <int kCC, bool kF32, bool kDF32>
__global__ void __launch_bounds__(kBwdThreads, 2)
    roi_align_backward_tile_kernel(const __grid_constant__ CUtensorMap map,
                                   Levels lv, const float* __restrict__ boxes,
                                   const int* __restrict__ lvl,
                                   void* __restrict__ out, int R, int C, int P,
                                   int sampling, int blocks_per_image,
                                   int nchunks, int part_bins, int nparts) {
  constexpr int kGroups = kCC / kLaneC;     // consumer threads a column
  constexpr int kTW = kConsumers / kGroups;  // columns of the tile
  constexpr int kPasses = (kMaxList + kBwdThreads - 1) / kBwdThreads;
  constexpr int kWarps = kBwdThreads / 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // TMA writes to 128-byte aligned shared memory
  unsigned char* smem =
      smem_raw + ((128u - (bulk::smem_addr(smem_raw) & 127u)) & 127u);
  using Elem = typename std::conditional<kDF32, float, __nv_bfloat16>::type;
  const int slot_bytes =
      part_bins * P * kCC * static_cast<int>(sizeof(Elem));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRing * slot_bytes);
  uint64_t* empty = full + kRing;
  const int twords = table_words(P, kTW);
  float* tables = reinterpret_cast<float*>(empty + kRing);
  int* list = reinterpret_cast<int*>(tables + kRing * twords);
  int* warp_kept = list + kMaxList;  // [kPasses][kWarps]

  const int b = blockIdx.x / blocks_per_image;
  const int item = blockIdx.x - b * blocks_per_image;
  // the block's level, read with constant indices
  int l = 0, H = 1, W = 1, ntx = 1, start = 0;
  float stride = 1.0f;
  long long off = 0;
#pragma unroll
  for (int k = 0; k < kMaxLevels; ++k) {
    if (k < lv.n_levels && item >= lv.start[k] &&
        item < lv.start[k] + lv.count[k]) {
      l = k;
      H = lv.H[k];
      W = lv.W[k];
      stride = lv.stride[k];
      ntx = lv.ntx[k];
      start = lv.start[k];
      off = lv.off[k];
    }
  }
  const int tile = (item - start) / nchunks;
  const int c0 = (item - start - tile * nchunks) * kCC;
  const int ty0 = tile / ntx * kTileH;
  const int tx0 = tile % ntx * kTW;
  const float inv = 1.0f / stride;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bool producer = warp >= kConsumerWarps;
  const int g = tid % kGroups;  // consumers: channels c0 + 8 g .. + 7
  const int xl = tid / kGroups;  // consumers: the tile's column
  const int x = tx0 + xl;

  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) {
      // the producer's 32 lanes, and its copy's expect_tx
      bulk::mbar_init(&full[i], 33);
      bulk::mbar_init(&empty[i], kConsumerWarps);
    }
    bulk::fence_init();
  }

  const float* img_boxes = boxes + 4 * static_cast<size_t>(b) * R;
  const int* img_lvl = lvl + static_cast<size_t>(b) * R;
  const long long img_row = static_cast<long long>(b) * R;

  // culling of the window of boxes from w0: those on this level whose
  // region overlaps the tile, in ascending index, into `list` (every thread
  // tests its boxes first, so that their loads overlap); returns their
  // count. Every thread of the block calls it.
  auto cull = [&](int w0) {
    const int w1 = min(R, w0 + kMaxList);
    bool keep[kPasses];
#pragma unroll
    for (int m = 0; m < kPasses; ++m) {
      const int r = w0 + m * kBwdThreads + tid;
      keep[m] = false;
      if (r < w1 && min(max(img_lvl[r], 0), lv.n_levels - 1) == l) {
        const float* bx = img_boxes + 4 * r;
        const float bin_x =
            __fdiv_rn(__fsub_rn(bx[2], bx[0]), static_cast<float>(P));
        const float bin_y =
            __fdiv_rn(__fsub_rn(bx[3], bx[1]), static_cast<float>(P));
        const int2 sx = tap_span(bin_start(bx[0], bin_x, 0),
                                 bin_start(bx[0], bin_x, P), inv, W);
        const int2 sy = tap_span(bin_start(bx[1], bin_y, 0),
                                 bin_start(bx[1], bin_y, P), inv, H);
        keep[m] = sx.x < tx0 + kTW && sx.y >= tx0 &&
                  sy.x < ty0 + kTileH && sy.y >= ty0;
      }
    }
    unsigned kept[kPasses];
#pragma unroll
    for (int m = 0; m < kPasses; ++m) {
      kept[m] = __ballot_sync(0xffffffffu, keep[m]);
      if (lane == 0) warp_kept[m * kWarps + warp] = __popc(kept[m]);
    }
    __syncthreads();
    int n = 0;
#pragma unroll
    for (int m = 0; m < kPasses; ++m) {
      int before = n;
      for (int i = 0; i < kWarps; ++i) {
        const int c = warp_kept[m * kWarps + i];
        before += i < warp ? c : 0;
        n += c;
      }
      if (keep[m])
        list[before + __popc(kept[m] & ((1u << lane) - 1u))] =
            w0 + m * kBwdThreads + tid;
    }
    __syncthreads();
    return n;
  };

  // producers and consumers each run the windows in the same order, with
  // the same block barriers (culling, and the end of a window's items)
  if (producer) {
    int pos = 0;  // ring items before this window
    for (int w0 = 0; w0 < R; w0 += kMaxList) {
      const int items = cull(w0) * nparts;
      // the boxes in turn: the slice's copy, then the weights over the tile
      for (int j = warp - kConsumerWarps; j < items; j += kProducerWarps) {
        const int u = pos + j;
        const int s = u % kRing;
        const int r = list[j / nparts];
        if (u >= kRing) bulk::mbar_wait(&empty[s], (u / kRing - 1) & 1);
        if (lane == 0) {
          bulk::mbar_expect(&full[s], slot_bytes);
          bulk::tensor_copy_2d(
              smem + s * slot_bytes, &map, c0,
              static_cast<int>(((img_row + r) * P + j % nparts * part_bins) *
                               P),
              &full[s]);
        }
        float* wy = tables + s * twords;
        float* wx = wy + P * kTileH;
        int* yr = reinterpret_cast<int*>(wx + P * kTW);
        int* pr = yr + 2 * P;
        int* qr = pr + 2;
        for (int i = lane; i < P * (kTileH + kTW); i += 32) wy[i] = 0.0f;
        for (int i = lane; i < 2 * P; i += 32) yr[i] = i % 2 ? -1 : INT_MAX;
        for (int i = lane; i < 2 * kTW; i += 32) qr[i] = i % 2 ? -1 : P;
        __syncwarp();
        const float* bx = img_boxes + 4 * r;
        const float bin_x =
            __fdiv_rn(__fsub_rn(bx[2], bx[0]), static_cast<float>(P));
        const float bin_y =
            __fdiv_rn(__fsub_rn(bx[3], bx[1]), static_cast<float>(P));
        fill_axis(make_axis(bx[1], bin_y, stride, H, sampling), P, ty0,
                  kTileH, wy, yr, nullptr, lane);
        fill_axis(make_axis(bx[0], bin_x, stride, W, sampling), P, tx0, kTW,
                  wx, nullptr, qr, lane);
        __syncwarp();
        // the bins that weigh the tile's rows
        const unsigned on = __ballot_sync(
            0xffffffffu, lane < P && yr[2 * lane] <= yr[2 * lane + 1]);
        if (lane == 0) {
          pr[0] = on ? __ffs(on) - 1 : P;
          pr[1] = on ? 31 - __clz(on) : -1;
        }
        bulk::mbar_arrive(&full[s]);
      }
      pos += items;
      __syncthreads();  // the window's list is no longer read
    }
    return;
  }

  float acc[kTileH][kLaneC];
#pragma unroll
  for (int i = 0; i < kTileH; ++i)
#pragma unroll
    for (int e = 0; e < kLaneC; ++e) acc[i][e] = 0.0f;
  int pos = 0;  // ring items before this window
  for (int w0 = 0; w0 < R; w0 += kMaxList) {
    const int items = cull(w0) * nparts;
    for (int j = 0; j < items; ++j) {
      const int u = pos + j;
      const int s = u % kRing;
      bulk::mbar_wait(&full[s], (u / kRing) & 1);
      const float* wy = tables + s * twords;
      const float* wx = wy + P * kTileH;
      const int2* yr = reinterpret_cast<const int2*>(wx + P * kTW);
      const int2 pr = yr[P];
      const int2 qc = yr[P + 1 + xl];  // the bins that weigh the column
      const int p0 = (j % nparts) * part_bins;
      const int pa = max(pr.x, p0);
      const int pb = min(pr.y, min(P, p0 + part_bins) - 1);
      const Elem* slice =
          reinterpret_cast<const Elem*>(smem + s * slot_bytes) + g * kLaneC;
      if (qc.x <= qc.y) {
        for (int p = pa; p <= pb; ++p) {
          const int2 ry = yr[p];
          if (ry.x > ry.y) continue;  // bin p weighs none of the rows
          float t[kLaneC];
#pragma unroll
          for (int e = 0; e < kLaneC; ++e) t[e] = 0.0f;
          // bins between qc.x and qc.y that do not weigh this column
          // weigh it 0
          for (int q = qc.x; q <= qc.y; ++q) {
            const float w = wx[q * kTW + xl];
            float v[kLaneC];
            load8(slice + ((p - p0) * P + q) * kCC, v);
#pragma unroll
            for (int e = 0; e < kLaneC; ++e) t[e] += w * v[e];
          }
          const float4 wa = reinterpret_cast<const float4*>(wy)[2 * p];
          const float4 wb = reinterpret_cast<const float4*>(wy)[2 * p + 1];
          const float wr[kTileH] = {wa.x, wa.y, wa.z, wa.w,
                                    wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int i = 0; i < kTileH; ++i) {
            if (ty0 + i < ry.x || ty0 + i > ry.y) continue;
#pragma unroll
            for (int e = 0; e < kLaneC; ++e) acc[i][e] += wr[i] * t[e];
          }
        }
      }
      __syncwarp();
      if (lane == 0) bulk::mbar_arrive(&empty[s]);
    }
      pos += items;
    __syncthreads();  // the window's list is no longer read
  }

  // the one write of the tile
  if (x >= W || c0 + g * kLaneC >= C) return;
#pragma unroll
  for (int i = 0; i < kTileH; ++i) {
    const int y = ty0 + i;
    if (y >= H) break;
    const long long at = off +
                         ((static_cast<long long>(b) * H + y) * W + x) * C +
                         c0 + g * kLaneC;
    if (kF32) {
      float4* dst = reinterpret_cast<float4*>(static_cast<float*>(out) + at);
      dst[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      dst[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    } else {
      uint4 o;
      unsigned* ow = reinterpret_cast<unsigned*>(&o);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 h =
            __floats2bfloat162_rn(acc[i][2 * e], acc[i][2 * e + 1]);
        ow[e] = *reinterpret_cast<const unsigned*>(&h);
      }
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + at) = o;
    }
  }
}

// Launches the kernel of kCC channels a tile that writes `out` in bf16 (or
// f32) from a bf16 (or f32) d pooled on `stream`.
template <int kCC, bool kF32, bool kDF32>
int launch_tile(const CUtensorMap& map, const Levels& lv, long long smem,
                long long blocks, cudaStream_t stream, const void* boxes,
                const void* lvl, void* out, int R, int C, int P, int sampling,
                int per_image, int nchunks, int part_bins, int nparts) {
  if (smem > 48 * 1024) {
    const cudaError_t err = raise_smem_cap(
        reinterpret_cast<const void*>(
            roi_align_backward_tile_kernel<kCC, kF32, kDF32>),
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  roi_align_backward_tile_kernel<kCC, kF32, kDF32>
      <<<dim3(static_cast<unsigned>(blocks)), kBwdThreads,
         static_cast<size_t>(smem), stream>>>(
          map, lv, static_cast<const float*>(boxes),
          static_cast<const int*>(lvl), out, R, C, P, sampling, per_image,
          nchunks, part_bins, nparts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Writes the levels' gradients into `out` (level after level, each (B, h_l,
// w_l, C); float32 when out_f32, else bf16) from d pooled `dout` (B, R, P,
// P, C), float32 when dout_f32 (then out_f32 too), else bf16, for the boxes
// (B, R, 4) f32 XYXY on levels `lvl` (B, R) int32 at strides 2^(min_level +
// l). One launch on `stream`; returns cudaGetLastError() (0 = launched). C a multiple of 8 up to 256, 1 <= P <=
// 32, 0 <= sampling <= 16 (0: adaptive), out and dout 16-byte aligned, B R P
// P < 2^31 (checked by the wrapper; here too: cudaErrorInvalidValue).
int roi_align_backward_run(void* out, int out_f32, int dout_f32, int h0,
                           int w0, int h1, int w1, int h2, int w2, int h3,
                           int w3, int n_levels, int min_level,
                           const void* boxes, const void* lvl,
                           const void* dout, int B, int R,
                           int C, int P, int sampling, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_levels < 1 || n_levels > kMaxLevels || sampling < 0 ||
      sampling > kMaxSampling || P < 1 || P > kMaxOut || C < 8 ||
      C > kMaxC || C % 8 != 0 || B < 1 || R < 1 ||
      static_cast<long long>(B) * R * P * P > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dout) % 16 != 0 ||
      (dout_f32 != 0 && out_f32 == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int esize = dout_f32 != 0 ? 4 : 2;  // bytes of a d pooled value
  const int cc = P <= kWideMaxP ? kWideC : kNarrowC;
  const int tw = kConsumers / (cc / kLaneC);
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  const int nchunks = (C + cc - 1) / cc;
  Levels lv;
  lv.n_levels = n_levels;
  long long total = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.off[l] = total;
    lv.H[l] = hs[l];
    lv.W[l] = ws[l];
    lv.stride[l] = static_cast<float>(1 << (min_level + l));
    lv.ntx[l] = 1;
    lv.count[l] = 0;
    if (l < n_levels) {
      if (hs[l] < 1 || ws[l] < 1)
        return static_cast<int>(cudaErrorInvalidValue);
      total += static_cast<long long>(B) * hs[l] * ws[l] * C;
      lv.ntx[l] = (ws[l] + tw - 1) / tw;
      lv.count[l] = lv.ntx[l] * ((hs[l] + kTileH - 1) / kTileH) * nchunks;
    }
  }
  // an image's blocks, the coarsest level first
  long long per_image = 0;
  for (int l = kMaxLevels - 1; l >= 0; --l) {
    lv.start[l] = static_cast<int>(std::min(per_image, 0x7fffffffLL));
    per_image += lv.count[l];
  }
  const long long blocks = per_image * B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);

  // a slot holds whole bin rows of the slice: all P where they fit
  const int rows = std::min(kMaxCopyRows, kMaxSlotBytes / (cc * esize));
  const int part_bins = std::max(1, std::min(P, rows / P));
  const int nparts = (P + part_bins - 1) / part_bins;
  const long long smem =
      128 + kRing * (static_cast<long long>(part_bins) * P * cc * esize + 16 +
                     4LL * table_words(P, tw)) +
      4LL * (kMaxList + (kMaxList + kBwdThreads - 1) / kBwdThreads *
                            (kBwdThreads / 32));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);

  // d pooled as (B R P P, C) rows, copied cc channels by part_bins * P rows
  // at a time; channels past C read as zeros
  const bulk::EncodeTiled encode = bulk::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(B) * R * P * P};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(C) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(cc),
                             static_cast<cuuint32_t>(part_bins * P)};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&map,
             dout_f32 != 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             2,
             const_cast<void*>(dout), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per = static_cast<int>(per_image);
  // (channels a tile, f32 gradients, f32 d pooled): a bf16 d pooled gives
  // bf16 or f32 gradients, a f32 one f32 gradients
  auto run = [&](auto launcher) {
    return launcher(map, lv, smem, blocks, st, boxes, lvl, out, R, C, P,
                    sampling, per, nchunks, part_bins, nparts);
  };
  if (cc == kWideC)
    return dout_f32 ? run(launch_tile<kWideC, true, true>)
           : out_f32 ? run(launch_tile<kWideC, true, false>)
                     : run(launch_tile<kWideC, false, false>);
  return dout_f32 ? run(launch_tile<kNarrowC, true, true>)
         : out_f32 ? run(launch_tile<kNarrowC, true, false>)
                   : run(launch_tile<kNarrowC, false, false>);
}

const char* roi_align_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
