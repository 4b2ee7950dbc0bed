// ViTDet's attention with decomposed relative position, windowed or global,
// in one pass: softmax((q * scale) k^T + rel_h[i, row(j)] + rel_w[i, col(j)])
// v for every head of every window, scores in f32, never in device memory.
//
// Replaces no TPU kernel: the JAX package has no ViT. ViTDet (detectron2
// projects/ViTDet, modeling/backbone/vit.py) attends within 14x14 windows of
// the 64x64 token grid in 8 of its 12 blocks and over all 4096 tokens in the
// other 4. Materialised, one global block's scores are 12 x 4096^2 values a
// tile (403 MB in bf16); writing them, adding the relative-position bias,
// taking the softmax and reading them back moves >= 6 GB a tile over the
// four global blocks. The wrapper, its checks and the plain PyTorch version
// are in roadsurf_tpu_torch/ops/attention.py.
//
// Layouts (bf16, contiguous): qkv (B, Hp, Wp, 3, heads, 64), the qkv
// linear's output over the (padded) token grid; rel_h and rel_w (B, Hp, Wp,
// heads, ws), each token's q (unscaled) against the window's relative-
// position table of rows and of columns (ops/attention.py::rel_tables);
// out (B, Hp, Wp, heads, 64). A window of side ws is the token block
// (wy*ws + iy, wx*ws + ix); the global attention is one window of side
// Hp = Wp. Key j = (row(j), col(j)) = (j / ws, j % ws) of its window, as
// detectron2's window_partition orders it; a padded token is a key like any
// other.
//
// What bounds it on an H100. The global block (a window of 64 x 64): the
// tensor cores and, as much, the softmax. It does 4 * 4096^2 * 64 FLOPs a
// head for 6 * 4096 * 64 * 2 bytes, ~1365 FLOP/B against the card's 295;
// and at head dim 64 a score's two products (256 FLOPs) take the tensor
// cores as long as its exp2 takes the SM's 16 special-function lanes, with
// about six more instructions a score around it (the relative terms, the
// running max, the sum, P's rounding), so the softmax has to run beside
// the products, not between them. A 14 x 14 window: the bytes (~65
// FLOP/B) and its softmax, each item reading ~90 KB and computing for a few
// microseconds.
//
// The design, one kernel for both, its tiling chosen by ws (sm_90a):
//   * Persistent, warp-specialised blocks, one an SM, each walking work
//     items (R query rows of a window, one head). Two consumer warpgroups,
//     each on a 64-row query tile, and a producer warpgroup whose registers
//     setmaxnreg gives to the consumers (40 against 232): one thread loads
//     Q, K and V by 4-D TMA boxes (64 head-dim values x columns x rows of
//     the window, one image) from a tensor map over qkv, in the 128-byte
//     swizzle that wgmma reads, into a ring whose stages the consumers
//     release; two warps copy the item's rows of rel_h and rel_w (cp.async)
//     beside its Q; one thread stores each item's output, which the
//     consumers leave in its Q slot, by one TMA store. Q slots and table
//     buffers come in pairs, so the next item loads while this one computes.
//   * The products by wgmma: S = Q K^T as m64nNk16, Q from registers (loaded
//     once a tile by ldmatrix), K from shared memory; O += P V as m64n64k16,
//     P from registers (the scores' accumulator fragment is the A fragment),
//     V from shared memory transposed. Each step issues its scores with the
//     previous step's P V, so the softmax runs while P V does, into a second
//     P buffer (else ptxas waits for the P V before the softmax); on the row
//     path the two consumers take turns issuing (named barriers), so one's
//     softmax runs beside the other's products.
//   * Row path (ws == 64, the global block at 1024 px): a key step is two
//     grid rows, 128 keys, through a ring of three stages (K and V, 32 KB).
//     A query's column term rel_w[i, col] is the same at every step: it stays
//     in registers (x log2 e) for the whole item; the row terms are one value
//     a query, step and grid row, read from the staged rel_h rows.
//   * Window path (ws < 64): a key step is R rows of the window, R the
//     largest divisor of ws with R * ws <= 208 keys whose Q slots and tables
//     fit in shared memory, so ViTDet's 14 x 14 window is one step: an item (a window and head) loads its 196 keys and
//     values once (one box each), and each 64-query tile's scores against
//     all of them come from one wgmma chain (n = 208) with no online
//     rescaling; padding is on the query side (four tiles for 196). Each
//     accumulator column's (row, col) in the window comes from a table built
//     once a block (no division in the score loop); the slots past R * ws
//     are masked, and V's rows there zeroed, so that 0 x garbage cannot give
//     NaN. Larger windows take ws / R steps through the ring of two.
// No branch surrounds a wgmma (ptxas would serialise them): the warpgroup
// index is broadcast from lane 0, the waits branch uniformly and the
// releases are predicated. Scores, the running max and sums in f32; P
// rounded to bf16 for P V; the output in bf16.

#include <algorithm>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bulk_copy.cuh"
#include "smem_cap.cuh"

namespace {

using bulk::mbar_expect;
using bulk::mbar_init;
using bulk::smem_addr;

constexpr int kD = 64;                      // head dim
constexpr int kRowBytes = kD * 2;           // a token's q, k or v
constexpr int kTile = 64;                   // query rows a consumer tile
constexpr int kTileBytes = kTile * kRowBytes;
constexpr int kConsumers = 2;               // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kMaxWs = 64;
constexpr int kRowKeys = 128;               // row path: keys a step
constexpr int kWinKeys = 208;               // window path: key slots a step
// the ring's stages: the row path's (32 KB each), the window path's (52 KB)
__host__ __device__ constexpr int stages_of(bool row) { return row ? 3 : 2; }
constexpr int kStagers = 64;                // producer threads staging tables
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;

struct Params {
  const unsigned short* rel_h;
  const unsigned short* rel_w;
  unsigned short* out;
  int Hp, Wp, ws, heads, nwx, nw;
  int R;         // window rows a key step, and a work item's query rows
  int nsteps;    // key steps a window: ws / R
  int tiles;     // 64-row query tiles a work item
  int passes;    // query tiles a consumer: ceil(tiles / 2)
  int ts;        // a staged table row's stride, in bf16
  int items;     // work items: ws / R query blocks x heads x windows
  float scale_log2;  // head_dim^-0.5 * log2(e)
};

// byte offsets into the block's shared memory (1024-byte aligned): two Q
// slots at 0, then the ring's stages (K then V, KN rows each), two buffers
// of the staged table rows (rel_h, then rel_w) and, on the window path, the
// key slots' (row, col)
struct Layout {
  int qslot, stages, tables, table, slots, bytes;
};

__host__ __device__ inline Layout layout(int KN, bool row, int tiles,
                                         int ts) {
  Layout L{};
  L.qslot = tiles * kTileBytes;
  L.stages = 2 * L.qslot;
  L.tables = L.stages + stages_of(row) * 2 * KN * kRowBytes;
  L.table = tiles * kTile * ts * 2;
  L.slots = L.tables + 2 * 2 * L.table;
  L.bytes = L.slots + (row ? 0 : KN * 2);
  return L;
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The waits and releases, written so that ptxas sees no divergence around
// the consumers' wgmma (which it would otherwise serialise): the wait's loop
// branches uniformly (bra.uni; a warp's lanes read one phase) and traps
// after 2^31 cycles as bulk::mbar_wait does; the release is one predicated
// arrival, no branch.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n .reg .b64 t0, t1;\n"
      " mov.u64 t0, %%clock64;\n"
      "LAB_WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @p bra.uni LAB_DONE;\n"
      " mov.u64 t1, %%clock64;\n"
      " sub.s64 t1, t1, t0;\n"
      " setp.gt.s64 p, t1, 2147483648;\n"
      " @p trap;\n"
      " bra.uni LAB_WAIT;\n"
      "LAB_DONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %1, 0;\n"
      " @p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(static_cast<int>(pred))
      : "memory");
}

// a 4-byte copy to shared memory, in flight until cp_async_wait_all
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// an arrival on `bar` once this thread's cp.async copies so far have landed
// (counted among the barrier's expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// 4-D TMA store of the box at (c0, c1, c2, c3) of `map` from shared memory
// (128-byte aligned, in the map's swizzle), then the waits for its reads of
// shared memory and for its writes
__device__ __forceinline__ void tensor_store_4d(const CUtensorMap* map,
                                                const void* src, int c0,
                                                int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// shared-memory writes of this thread before the async proxy (wgmma) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// wgmma descriptors of a tile in the 128-byte swizzle (rows of 128 bytes,
// 8-row groups 1024 bytes apart, the swizzle's phase from the address).
// K-major (K for S = Q K^T; the leading offset unused): the k-th 16 values
// of each row start 32 k bytes in. MN-major (V for P V, n = the head dim,
// one 128-byte row): both offsets 1024, the stride between 8-key groups.
__device__ __forceinline__ uint64_t k_major_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ uint64_t mn_major_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d (64 x n, f32, the warpgroup's accumulator fragment: d[4j + 2h + e] is
// row 16 (warp % 4) + lane / 4 + 8h, column 8j + 2 (lane % 4) + e) += a (64
// x 16, bf16 pairs in registers, mma.m16n8k16's A fragment a warp) . b (16
// x n from shared memory by `desc`, K-major or, with kTransB, MN-major);
// d's input is ignored where !accumulate.
template <int kTransB>
__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_n128(float* d, const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_n208(float* d, const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %109, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103"
      "}, {%104, %105, %106, %107}, %108, p, 1, 1, %110;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate), "n"(kTransB));
}


template <int KN>
__device__ __forceinline__ void wgmma_scores(float* d, const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
  if constexpr (KN == 128)
    wgmma_n128<0>(d, a, desc, accumulate);
  else
    wgmma_n208<0>(d, a, desc, accumulate);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats as a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_f32(unsigned short h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

// a compile-time buffer index, for the lambdas of the kernel's loop
template <int V>
struct Buf {
  static constexpr int value = V;
};

// byte address of 16-byte chunk `chunk` of row `row` of a tile in the
// 128-byte swizzle, the tile 1024-byte aligned
__device__ __forceinline__ uint32_t swz(uint32_t tile, int row, int chunk) {
  return tile + row * kRowBytes + ((chunk ^ (row & 7)) << 4);
}

// A persistent block: work items blockIdx.x, + gridDim.x, ...; an item is
// R query rows of one window (the fastest), one head, one window of B * nw.
// Warps 0-7: two consumer warpgroups; warps 8-11: the producer, which loads
// the next item's queries and keys while the consumers compute.
template <int KN, bool kRow>
__global__ void __launch_bounds__(kThreads, 1)
    rel_attention_fwd_kernel(const __grid_constant__ CUtensorMap map,
                             const __grid_constant__ CUtensorMap map_out,
                             const Params p) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int kStages = stages_of(kRow);
  __shared__ uint64_t full[kStages], empty[kStages], qfull[2], qempty[2],
      ofull[2];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const Layout L = layout(KN, kRow, p.tiles, p.ts);
  // the warp and warpgroup, broadcast from lane 0 so that ptxas knows them
  // uniform across a warp
  const int warp = __shfl_sync(0xffffffff, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int box_bytes = p.R * p.ws * kRowBytes;
  // ring items a work item: one where the window is one step (every pass
  // reads it), else a step a pass
  const int nkv = p.nsteps == 1 ? 1 : p.passes * p.nsteps;
  const int qblocks = p.ws / p.R;
  // a work item's first query row in its window, head, image and window
  auto decode = [&](int item, int& qrow0, int& h, int& b, int& wy, int& wx) {
    qrow0 = item % qblocks * p.R;
    item /= qblocks;
    h = item % p.heads;
    const int w = item / p.heads;
    b = w / p.nw;
    const int wi = w - b * p.nw;
    wy = wi / p.nwx;
    wx = wi - wy * p.nwx;
  };

  const int nq = p.R * p.ws;  // an item's queries
  // an item's table buffer (rel_h's rows, then rel_w's), one a Q slot
  auto table = [&](int qs) {
    return reinterpret_cast<unsigned short*>(smem + L.tables +
                                             qs * 2 * L.table);
  };
  // the token (into B * Hp * Wp) of an item's query or key n
  auto token = [&](long long base, int n) {
    const int iy = n / p.ws;
    return base + static_cast<long long>(iy) * p.Wp + (n - iy * p.ws);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&qfull[i], 1 + kStagers);
      mbar_init(&qempty[i], 1);
      mbar_init(&ofull[i], 128 * kConsumers);
    }
    bulk::fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // the producer warpgroup, with its registers given to the consumers:
    // warp 8 loads, warp 9 stores, warps 10 and 11 stage the tables
    regs_dec<kProducerRegs>();
    if (warp == 4 * kConsumers && lane == 0) {
      // each item's queries into its Q slot once the slot's last item has
      // been stored, then its key steps into the ring, a stage once both
      // consumers have released what it held
      int kv = 0, q = 0;
      for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++q) {
        int qrow0, h, b, wy, wx;
        decode(item, qrow0, h, b, wy, wx);
        const int x0 = wx * p.ws, y0 = wy * p.ws;
        const int qs = q & 1;
        if (q >= 2) mbar_wait(&qempty[qs], ((q >> 1) - 1) & 1);
        mbar_expect(&qfull[qs], box_bytes);
        bulk::tensor_copy_4d(smem + qs * L.qslot, &map, h * kD, x0,
                             y0 + qrow0, b, &qfull[qs]);
        for (int i = 0; i < nkv; ++i, ++kv) {
          const int s = kv % kStages;
          if (kv >= kStages) mbar_wait(&empty[s], (kv / kStages - 1) & 1);
          const int ky = y0 + (i % p.nsteps) * p.R;
          unsigned char* st = smem + L.stages + s * 2 * KN * kRowBytes;
          mbar_expect(&full[s], 2 * box_bytes);
          bulk::tensor_copy_4d(st, &map, (p.heads + h) * kD, x0, ky, b,
                               &full[s]);
          bulk::tensor_copy_4d(st + KN * kRowBytes, &map,
                               (2 * p.heads + h) * kD, x0, ky, b, &full[s]);
        }
      }
    } else if (warp == 4 * kConsumers + 1 && lane == 0) {
      // each item's output, which the consumers leave in its Q slot, by one
      // TMA store; the slot is free once the store has read it
      int q = 0;
      for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++q) {
        int qrow0, h, b, wy, wx;
        decode(item, qrow0, h, b, wy, wx);
        const int qs = q & 1;
        mbar_wait(&ofull[qs], (q >> 1) & 1);
        tensor_store_4d(&map_out, smem + qs * L.qslot, h * kD, wx * p.ws,
                        wy * p.ws + qrow0, b);
        bulk_store_wait_read();
        bulk::mbar_arrive(&qempty[qs]);
      }
      bulk_store_wait();
    } else if (warp >= 4 * kConsumers + 2) {
      // each item's rows of rel_h and rel_w into its Q slot's table buffer
      // (cp.async, 4 bytes a copy), completing on the slot's qfull: a row
      // a thread at a time
      const int t = threadIdx.x - 128 * (kConsumers + 1) + kStagers;
      const int words = p.ws / 2;
      int q = 0;
      for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++q) {
        int qrow0, h, b, wy, wx;
        decode(item, qrow0, h, b, wy, wx);
        const int qs = q & 1;
        if (q >= 2) mbar_wait(&qempty[qs], ((q >> 1) - 1) & 1);
        const long long base =
            (static_cast<long long>(b) * p.Hp + wy * p.ws) * p.Wp +
            wx * p.ws;
        unsigned short* th = table(qs);
        unsigned short* tw = th + L.table / 2;
        for (int r = t; r < nq; r += kStagers) {
          const long long off =
              (token(base, qrow0 * p.ws + r) * p.heads + h) * p.ws;
          for (int k2 = 0; k2 < words; ++k2) {
            cp_async4(th + r * p.ts + 2 * k2, p.rel_h + off + 2 * k2);
            cp_async4(tw + r * p.ts + 2 * k2, p.rel_w + off + 2 * k2);
          }
        }
        cp_async_arrive(&qfull[qs]);
      }
    }
    return;
  }

  regs_inc<kConsumerRegs>();
  const int g = lane / 4, t4 = lane % 4;
  const int wr = 16 * (warp % 4);  // the warp's first row of its tile
  const bool leader = threadIdx.x % 128 == 0;  // releases the stages
  const unsigned short* slots =
      reinterpret_cast<const unsigned short*>(smem + L.slots);

  if (!kRow) {
    // each key slot's (row, col) in the step's rows, and V's rows past the
    // step's keys zeroed in every stage (the TMA never writes them)
    unsigned short* sl = reinterpret_cast<unsigned short*>(smem + L.slots);
    for (int k = threadIdx.x; k < KN; k += 128 * kConsumers) {
      const int r = k / p.ws;
      sl[k] = k < nq ? static_cast<unsigned short>((r << 8) | (k - r * p.ws))
                     : 0;
    }
    const int pad = (KN - nq) * kRowBytes / 16;
    for (int s = 0; s < kStages; ++s) {
      uint4* v = reinterpret_cast<uint4*>(smem + L.stages +
                                          s * 2 * KN * kRowBytes +
                                          (KN + nq) * kRowBytes);
      for (int i = threadIdx.x; i < pad; i += 128 * kConsumers)
        v[i] = make_uint4(0, 0, 0, 0);
    }
    fence_proxy_async();
  }

  // the slot table and V's zeroed rows before any consumer reads them
  named_sync(1, 128 * kConsumers);

  const uint32_t sRing = smem_addr(smem) + L.stages;
  // the consumers' turns at issuing their products (row path): consumer w
  // waits on barrier 2 + w and hands the turn to the other; the first turn
  // is consumer 0's, and consumer 1 hands over no turn after its last
  constexpr int kPair = 128 * kConsumers;
  auto turn_begin = [&]() {
    if (kRow) named_sync(2 + wg, kPair);
  };
  auto turn_end = [&](bool last) {
    if (kRow && !(last && wg == 1)) named_arrive(2 + (wg ^ 1), kPair);
  };
  if (kRow && wg == 1) named_arrive(2, kPair);

  int kv = 0, q = 0;  // ring items and Q slots taken so far
  for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++q) {
    const bool last_item = item + gridDim.x >= p.items;
    const unsigned short* tab_h = table(q & 1);
    const unsigned short* tab_w = tab_h + L.table / 2;

    mbar_wait(&qfull[q & 1], (q >> 1) & 1);
    const uint32_t sQ = smem_addr(smem) + (q & 1) * L.qslot;
    // the row path's column term, x log2(e), for the thread's two rows of
    // its tile (the consumer's only tile there): in registers for every
    // step
    float rw[kRow ? 32 : 1];
    if constexpr (kRow) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint32_t* src = reinterpret_cast<const uint32_t*>(
            tab_w + (wg * kTile + wr + g + 8 * hh) * p.ts + 2 * t4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t pair = src[4 * j];
          rw[4 * j + 2 * hh] = bf16_f32(pair & 0xffff) * kLog2e;
          rw[4 * j + 2 * hh + 1] = bf16_f32(pair >> 16) * kLog2e;
        }
      }
    }

    for (int pass = 0; pass < p.passes; ++pass) {
      // a consumer whose tile lies past the item's queries (the window path
      // at an odd number of tiles) computes the last tile again and stores
      // nothing: no branch around the wgmma, which ptxas would serialise
      const int tile = 2 * pass + wg;
      const int ctile = tile < p.tiles ? tile : p.tiles - 1;
      uint32_t qf[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        ldmatrix_x4(swz(sQ + ctile * kTileBytes, wr + (lane & 15),
                        2 * ks + (lane >> 4)),
                    qf[ks]);
      // the thread's two rows in the item's staged tables
      const int row0 = ctile * kTile + wr + g;
      float o[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      float s[KN / 2];
      // P in bf16, the A fragments of P V; two on the row path, so that a
      // step's P is written while the previous one's P V still reads its own
      // (else ptxas waits for that P V before the softmax)
      constexpr int kP = kRow ? 2 : 1;
      uint32_t pf[kP][KN / 16][4];
      float corr[2], sum[2];

      // the ring's item of this pass's key step; one item where the window is
      // one step
      auto ring = [&](int step) {
        return kv + (p.nsteps == 1 ? 0 : pass * p.nsteps + step);
      };
      auto issue_scores = [&](uint32_t sK) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_scores<KN>(s, qf[ks], k_major_desc(sK + 32 * ks), ks);
        wgmma_commit();
      };
      auto issue_pv = [&](auto b, uint32_t sV) {
        constexpr int kb = decltype(b)::value;
#pragma unroll
        for (int kk = 0; kk < KN / 16; ++kk)
          wgmma_n64<1>(o, pf[kb][kk], mn_major_desc(sV + kk * 2048), 1);
        wgmma_commit();
      };
      // the relative-position terms and the online softmax of step `step`'s
      // scores, in log2 units: s becomes the probabilities, corr the old
      // max's factor, sum the thread's part of each row's new mass (maxima
      // and sums in four partials a row, for the latency)
      auto softmax = [&](int step) {
        // the row path's key step is kRowsStep grid rows, each with its own
        // row term; the window path's row terms are in the bias
        constexpr int kRowsStep = kRow ? KN / kMaxWs : 1;
        float mx[2][4], rh[2][kRowsStep] = {};
#pragma unroll
        for (int q = 0; q < 4; ++q) mx[0][q] = mx[1][q] = -INFINITY;
        if constexpr (kRow) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int rs = 0; rs < kRowsStep; ++rs)
              rh[hh][rs] = bf16_f32(tab_h[(row0 + 8 * hh) * p.ts +
                                          step * kRowsStep + rs]) *
                           kLog2e;
          // the accumulator's column 8j + .. is key column (8j + ..) % 64 of
          // grid row j / 8 of the step
#pragma unroll
          for (int i = 0; i < KN / 2; ++i) {
            s[i] = fmaf(s[i], p.scale_log2, rw[i % 32]);
            const int q = (i >> 5) * 2 + ((i >> 2) & 1);
            mx[(i >> 1) & 1][q] = fmaxf(mx[(i >> 1) & 1][q], s[i]);
          }
        } else {
          const int nk = p.R * p.ws;
          const unsigned short* th0 = tab_h + row0 * p.ts + step * p.R;
          const unsigned short* th1 = th0 + 8 * p.ts;
          const unsigned short* tw0 = tab_w + row0 * p.ts;
          const unsigned short* tw1 = tw0 + 8 * p.ts;
#pragma unroll
          for (int j = 0; j < KN / 8; ++j) {
            const int k = 8 * j + 2 * t4;
            const uint32_t pair =
                *reinterpret_cast<const uint32_t*>(slots + k);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const uint32_t sl = e ? pair >> 16 : pair & 0xffff;
              const int r = sl >> 8, c = sl & 0xff;
              const float b0 = (bf16_f32(th0[r]) + bf16_f32(tw0[c])) * kLog2e;
              const float b1 = (bf16_f32(th1[r]) + bf16_f32(tw1[c])) * kLog2e;
              const bool valid = k + e < nk;
              float& x0 = s[4 * j + e];
              float& x1 = s[4 * j + 2 + e];
              x0 = valid ? fmaf(x0, p.scale_log2, b0) : -INFINITY;
              x1 = valid ? fmaf(x1, p.scale_log2, b1) : -INFINITY;
              mx[0][j & 3] = fmaxf(mx[0][j & 3], x0);
              mx[1][j & 3] = fmaxf(mx[1][j & 3], x1);
            }
          }
        }
        float off[2][kRowsStep];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float top;
          if constexpr (kRow) {
            // each grid row's maximum with its row term (two partials a row)
            top = -INFINITY;
#pragma unroll
            for (int rs = 0; rs < kRowsStep; ++rs)
              top = fmaxf(top, fmaxf(mx[hh][2 * rs], mx[hh][2 * rs + 1]) +
                                   rh[hh][rs]);
          } else {
            top = fmaxf(fmaxf(mx[hh][0], mx[hh][1]),
                        fmaxf(mx[hh][2], mx[hh][3]));
          }
          top = fmaxf(top, __shfl_xor_sync(0xffffffff, top, 1));
          top = fmaxf(top, __shfl_xor_sync(0xffffffff, top, 2));
          const float m_new = fmaxf(m[hh], top);
          corr[hh] = ex2(m[hh] - m_new);
          m[hh] = m_new;
#pragma unroll
          for (int rs = 0; rs < kRowsStep; ++rs)
            off[hh][rs] = rh[hh][rs] - m_new;
        }
        float part[2][4] = {};
#pragma unroll
        for (int i = 0; i < KN / 2; ++i) {
          const int hh = (i >> 1) & 1;
          s[i] = ex2(s[i] + off[hh][kRow ? i / 32 : 0]);
          part[hh][(i >> 2) & 3] += s[i];
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          sum[hh] = (part[hh][0] + part[hh][1]) + (part[hh][2] + part[hh][3]);
      };
      // P in bf16 into buffer b: the accumulator's columns 16 kk.. are the A
      // fragment
      auto pack = [&](auto b) {
        constexpr int kb = decltype(b)::value;
#pragma unroll
        for (int kk = 0; kk < KN / 16; ++kk) {
          pf[kb][kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
          pf[kb][kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          pf[kb][kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          pf[kb][kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
      };
      // once the previous P V has retired: O and l by the old max's factor
      auto rescale = [&]() {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          l[hh] = l[hh] * corr[hh] + sum[hh];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            o[4 * j + 2 * hh] *= corr[hh];
            o[4 * j + 2 * hh + 1] *= corr[hh];
          }
        }
      };
      using B0 = Buf<0>;
      using B1 = Buf<1>;

      // step 0's scores
      int st = ring(0) % kStages;
      mbar_wait(&full[st], (ring(0) / kStages) & 1);
      uint32_t sK = sRing + st * 2 * KN * kRowBytes;
      turn_begin();
      wgmma_fence();
      issue_scores(sK);
      turn_end(false);
      wgmma_wait<0>();
      softmax(0);
      rescale();
      pack(B0{});

      // the next step's stage, once the producer has filled it
      auto next = [&](int step) {
        const int it = ring(step);
        st = it % kStages;
        mbar_wait(&full[st], (it / kStages) & 1);
        sK = sRing + st * 2 * KN * kRowBytes;
      };
      if constexpr (kRow) {
        // each further step: once the step before last's P V has retired
        // (waited for here, behind the stage's wait, so that ptxas cannot
        // hoist it into the softmax) O is rescaled; then the step's scores
        // and the previous step's P V are issued together, and the softmax
        // runs while P V does, its P into the other buffer (b)
        auto body = [&](int step, auto b) {
          const int prev_st = st;
          const uint32_t prev_v = sK + KN * kRowBytes;
          next(step);
          turn_begin();
          wgmma_fence();
          issue_scores(sK);
          issue_pv(Buf<1 - decltype(b)::value>{}, prev_v);
          turn_end(false);
          wgmma_wait<1>();
          softmax(step);
          pack(b);
          wgmma_wait<0>();
          arrive_if(&empty[prev_st], leader);
          rescale();
        };
        int step = 1;
        for (; step + 1 < p.nsteps; step += 2) {
          body(step, B1{});
          body(step + 1, B0{});
        }
        if (step < p.nsteps) body(step, B1{});
        // the last step's P V, from the buffer of its parity
        turn_begin();
        if (p.nsteps % 2) {
          wgmma_fence();
          issue_pv(B0{}, sK + KN * kRowBytes);
        } else {
          wgmma_fence();
          issue_pv(B1{}, sK + KN * kRowBytes);
        }
        turn_end(last_item && pass == p.passes - 1);
      } else {
        // each further step after the previous P V (fewer registers live:
        // the window path's scores are 104 a thread)
        for (int step = 1; step < p.nsteps; ++step) {
          wgmma_fence();
          issue_pv(B0{}, sK + KN * kRowBytes);
          wgmma_wait<0>();
          arrive_if(&empty[st], leader);
          next(step);
          wgmma_fence();
          issue_scores(sK);
          wgmma_wait<0>();
          softmax(step);
          rescale();
          pack(B0{});
        }
        wgmma_fence();
        issue_pv(B0{}, sK + KN * kRowBytes);
      }
      wgmma_wait<0>();
      // a one-step window's stage serves every pass: released after the last
      arrive_if(&empty[st], leader && (p.nsteps > 1 || pass == p.passes - 1));

      // O / l in bf16 into the tile's rows of the Q slot (this consumer
      // read them last), in the 128-byte swizzle of the item's TMA store;
      // a tile past the item's queries writes nothing
      const uint32_t sO = sQ + tile * kTileBytes;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float sl = l[hh];
        sl += __shfl_xor_sync(0xffffffff, sl, 1);
        sl += __shfl_xor_sync(0xffffffff, sl, 2);
        const float inv = 1.f / sl;
        const int r = wr + g + 8 * hh;
        if (tile < p.tiles) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            st_shared(swz(sO, r, j) + 4 * t4,
                      pack_bf16(o[4 * j + 2 * hh] * inv,
                                o[4 * j + 2 * hh + 1] * inv));
        }
      }
    }
    // the item's output is in its Q slot: the storer's turn
    fence_proxy_async();
    bulk::mbar_arrive(&ofull[q & 1]);
    kv += nkv;
  }
}

// The tensor map of qkv as (3 heads 64, Wp, Hp, B) (row_heads = 3 heads),
// or of out as (heads 64, Wp, Hp, B) (row_heads = heads), in boxes of 64
// head-dim values x ws columns x R rows x one image, 128-byte swizzle;
// boxes past the grid's edge are filled with zeros.
bool make_map(CUtensorMap* map, const void* base, int B, int Hp, int Wp,
              int row_heads, int ws, int R) {
  const bulk::EncodeTiled fn = bulk::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t row = 1ull * row_heads * kD;  // values of a token
  const cuuint64_t dims[4] = {row, static_cast<cuuint64_t>(Wp),
                              static_cast<cuuint64_t>(Hp),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {row * 2, row * 2 * Wp, row * 2 * Wp * Hp};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kD),
                             static_cast<cuuint32_t>(ws),
                             static_cast<cuuint32_t>(R), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a block's dynamic shared memory: the layout and its 1024-byte alignment
int smem_bytes(int KN, bool row, int tiles, int ts) {
  return layout(KN, row, tiles, ts).bytes + 1024;
}

template <int KN, bool kRow>
cudaError_t launch(const CUtensorMap& map, const CUtensorMap& map_out,
                   const Params& p, int blocks, cudaStream_t stream) {
  const int smem = smem_bytes(KN, kRow, p.tiles, p.ts);
  const cudaError_t err = raise_smem_cap(
      reinterpret_cast<const void*>(rel_attention_fwd_kernel<KN, kRow>),
      smem);
  if (err != cudaSuccess) return err;
  rel_attention_fwd_kernel<KN, kRow>
      <<<blocks, kThreads, smem, stream>>>(map, map_out, p);
  return cudaGetLastError();
}

// the device's SMs and a block's shared memory at most (less the kernel's
// static barriers), read once a device
int sm_count(int device) {
  static int counts[kMaxDevices];
  if (counts[device] == 0 &&
      cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    return 0;
  return counts[device];
}

int smem_cap(int device) {
  static int caps[kMaxDevices];
  if (caps[device] == 0 &&
      cudaDeviceGetAttribute(&caps[device],
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return caps[device] - 256;
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched). qkv,
// rel_h, rel_w and out as the layouts above, head dim 64; B >= 1; Hp and Wp
// multiples of ws; ws even and at most 64 (64: the row path, else the
// window path); qkv and out 16-byte aligned (the bases of their tensor
// maps), rel_h and rel_w 4-byte aligned (checked by the wrapper, which
// allocates out, and refused here too).
int rel_attention_bf16(const void* qkv, const void* rel_h, const void* rel_w,
                       void* out, int B, int Hp, int Wp, int ws, int heads,
                       float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices || B < 1 || heads < 1 || ws < 2 ||
      ws > kMaxWs || ws % 2 || Hp % ws || Wp % ws || Hp < ws || Wp < ws ||
      !aligned16(qkv) ||
      reinterpret_cast<std::uintptr_t>(rel_h) % 4 ||
      reinterpret_cast<std::uintptr_t>(rel_w) % 4 ||
      !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool row = ws == kMaxWs;
  Params p;
  p.rel_h = static_cast<const unsigned short*>(rel_h);
  p.rel_w = static_cast<const unsigned short*>(rel_w);
  p.out = static_cast<unsigned short*>(out);
  p.Hp = Hp;
  p.Wp = Wp;
  p.ws = ws;
  p.heads = heads;
  p.nwx = Wp / ws;
  p.nw = (Hp / ws) * p.nwx;
  p.ts = (ws / 2) % 2 ? ws : ws + 2;
  // the window path's rows a step: the most (a divisor of ws, at most
  // kWinKeys keys) whose tiles' Q slots and tables leave room in shared
  // memory; one row always does
  const int cap = smem_cap(device);
  auto tiles_of = [&](int r) { return (r * ws + kTile - 1) / kTile; };
  p.R = row ? kRowKeys / kMaxWs : 1;
  if (!row)
    for (int r = 2; r <= ws; ++r)
      if (ws % r == 0 && r * ws <= kWinKeys &&
          smem_bytes(kWinKeys, false, tiles_of(r), p.ts) <= cap)
        p.R = r;
  p.nsteps = ws / p.R;
  p.tiles = tiles_of(p.R);
  p.passes = (p.tiles + 1) / 2;
  p.scale_log2 = scale * kLog2e;
  const long long windows = static_cast<long long>(B) * p.nw;
  const long long items = windows * heads * p.nsteps;
  const int sms = sm_count(device);
  if (windows > 65535 || items > 0x7fffffffLL || sms == 0 ||
      smem_bytes(row ? kRowKeys : kWinKeys, row, p.tiles, p.ts) > cap)
    return static_cast<int>(cudaErrorInvalidValue);
  p.items = static_cast<int>(items);
  CUtensorMap map, map_out;
  if (!make_map(&map, qkv, B, Hp, Wp, 3 * heads, ws, p.R) ||
      !make_map(&map_out, out, B, Hp, Wp, heads, ws, p.R))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>(std::min<long long>(items, sms));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      row ? launch<kRowKeys, true>(map, map_out, p, blocks, s)
          : launch<kWinKeys, false>(map, map_out, p, blocks, s));
}

const char* rel_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
