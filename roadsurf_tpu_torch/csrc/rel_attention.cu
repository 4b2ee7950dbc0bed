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
// What bounds it on an H100: operations. A global block does 4 * 4096^2 *
// 64 FLOPs a head for 6 * 4096 * 64 * 2 bytes of q, k, v, o and the tables,
// ~1365 FLOP/B, far above the card's 295 (a 14x14 window: ~65 FLOP/B, below
// it, but windows are 12% of the attention's FLOPs). The design is the
// flash-attention loop with mma.sync (m16n8k16, bf16 in, f32 accumulate): a
// block of 4 warps takes 128 queries of one head of one window (32 a warp,
// so each K and V fragment read from shared memory feeds two row tiles),
// keeps their q in registers, and walks the window's keys 64 at a time,
// double-buffered with cp.async, 16-byte chunks XOR-swizzled against bank
// conflicts for ldmatrix. Each 64-key step adds the two relative-position
// terms to the f32 scores from the block's rows of rel_h and rel_w, staged
// once in shared memory, then runs the online softmax (exp2, the max and
// sum per row) and accumulates P v with P rounded to bf16. Where the window
// is 64 tokens wide (the global block at 1024 px) a 64-key step is one row
// of keys: the row term is one value a query and step and the column term
// a bf16 pair a load; elsewhere each key's row and column come from a
// multiply-high division and the last step masks the keys past the window.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 64;                  // head dim
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMT = 2;                  // 16-row tiles a warp
constexpr int kBM = kWarps * kMT * 16;  // 128 queries a block
constexpr int kBN = 64;                 // keys a step
constexpr int kMaxWs = 64;              // a window's side, at most
// a table row in shared memory, in bf16: 36 words, so that the 8 rows one
// load instruction touches start 4 banks apart
constexpr int kTs = 72;
constexpr int kTileBytes = kBN * kD * 2;               // a K or V tile
constexpr int kQBytes = kBM * kD * 2;
constexpr int kTableBytes = kBM * kTs * 2;
constexpr int kSmemBytes = kQBytes + 4 * kTileBytes + 2 * kTableBytes;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;

struct Params {
  const unsigned short* qkv;
  const unsigned short* rel_h;
  const unsigned short* rel_w;
  unsigned short* out;
  int Hp, Wp, ws, heads, nwx, nw, N;
  unsigned magic;       // ceil(2^32 / ws): n / ws == umulhi(n, magic)
  float scale_log2;     // head_dim^-0.5 * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a 16-byte (or `bytes`) copy to shared memory; zeros where !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// byte offset of 16-byte chunk `chunk` of row `row` of a [rows][64] bf16
// tile, the chunk XOR-swizzled by the row
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// token index (into B * Hp * Wp) of the window's n-th token
__device__ __forceinline__ long long token(const Params& p, long long base,
                                           int n) {
  const int iy = __umulhi(static_cast<unsigned>(n), p.magic);
  return base + static_cast<long long>(iy) * p.Wp + (n - iy * p.ws);
}

// the 64 keys from `kb * 64` of K (which 1) or V (which 2) into a tile
__device__ __forceinline__ void load_kv(const Params& p, long long base,
                                        int h, int kb, int which,
                                        uint32_t tile) {
  const int row_elems = 3 * p.heads * kD;
  const unsigned short* col = p.qkv + (which * p.heads + h) * kD;
#pragma unroll
  for (int i = 0; i < kBN * 8 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 3, chunk = idx & 7;
    const int j = kb * kBN + r;
    const bool valid = j < p.N;
    const unsigned short* src =
        valid ? col + token(p, base, j) * row_elems + chunk * 8 : p.qkv;
    cp_async16(tile + swz(r, chunk), src, valid);
  }
}

template <bool kRowPerStep>
__global__ void __launch_bounds__(kThreads, 2)
    rel_attention_fwd_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sK = sQ + kQBytes;                  // two tiles
  const uint32_t sV = sK + 2 * kTileBytes;           // two tiles
  unsigned short* tab_h =
      reinterpret_cast<unsigned short*>(smem + kQBytes + 4 * kTileBytes);
  unsigned short* tab_w = tab_h + kBM * kTs;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int w = blockIdx.z;
  const int b = w / p.nw, wi = w - b * p.nw;
  const int wy = wi / p.nwx, wx = wi - wy * p.nwx;
  const long long base =
      (static_cast<long long>(b) * p.Hp + wy * p.ws) * p.Wp + wx * p.ws;
  const int row_elems = 3 * p.heads * kD;
  const int nkb = (p.N + kBN - 1) / kBN;

  // the block's queries, their two tables, and the first keys: group 0
#pragma unroll
  for (int i = 0; i < kBM * 8 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 3, chunk = idx & 7;
    const int n = m0 + r;
    const bool valid = n < p.N;
    const unsigned short* src =
        valid ? p.qkv + token(p, base, n) * row_elems + h * kD + chunk * 8
              : p.qkv;
    cp_async16(sQ + swz(r, chunk), src, valid);
  }
  {
    const int words = p.ws >> 1;
    for (int idx = threadIdx.x; idx < kBM * words; idx += kThreads) {
      const int r = idx / words, k2 = idx - r * words;
      const int n = m0 + r;
      const bool valid = n < p.N;
      const long long off =
          valid ? (token(p, base, n) * p.heads + h) * p.ws + 2 * k2 : 0;
      cp_async4(smem_u32(tab_h + r * kTs + 2 * k2), p.rel_h + off, valid);
      cp_async4(smem_u32(tab_w + r * kTs + 2 * k2), p.rel_w + off, valid);
    }
  }
  load_kv(p, base, h, 0, 1, sK);
  load_kv(p, base, h, 0, 2, sV);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[kMT][4][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      ldmatrix_x4(sQ + swz(warp * 32 + mt * 16 + (lane & 15),
                           2 * ks + (lane >> 4)),
                  qf[mt][ks]);

  float o[kMT][8][4];
  float m[kMT][2], l[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][dt][e] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int kb = 0; kb < nkb; ++kb) {
    const int buf = kb & 1;
    if (kb + 1 < nkb) {
      load_kv(p, base, h, kb + 1, 1, sK + (buf ^ 1) * kTileBytes);
      load_kv(p, base, h, kb + 1, 2, sV + (buf ^ 1) * kTileBytes);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t tK = sK + buf * kTileBytes, tV = sV + buf * kTileBytes;

    // S = Q K^T
    float s[kMT][8][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(tK + swz(np * 16 + ((lane >> 4) & 1) * 8 + (lane & 7),
                             2 * ks + ((lane >> 3) & 1)),
                    kf);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma(s[mt][2 * np], qf[mt][ks], kf[0], kf[1]);
          mma(s[mt][2 * np + 1], qf[mt][ks], kf[2], kf[3]);
        }
      }

    // the relative-position terms, in log2 units, then the online softmax
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = warp * 32 + mt * 16 + hf * 8 + g;
        const unsigned short* th = tab_h + r * kTs;
        const unsigned short* tw = tab_w + r * kTs;
        float mx = -INFINITY;
        if (kRowPerStep) {
          const float rh = bf16_f32(th[kb]);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const uint32_t pair =
                *reinterpret_cast<const uint32_t*>(tw + nt * 8 + 2 * t4);
            const float rw0 = bf16_f32(pair & 0xffff);
            const float rw1 = bf16_f32(pair >> 16);
            float& x0 = s[mt][nt][2 * hf];
            float& x1 = s[mt][nt][2 * hf + 1];
            x0 = fmaf(x0, p.scale_log2, (rh + rw0) * kLog2e);
            x1 = fmaf(x1, p.scale_log2, (rh + rw1) * kLog2e);
            mx = fmaxf(mx, fmaxf(x0, x1));
          }
        } else {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = kb * kBN + nt * 8 + 2 * t4 + e;
              const int kh = __umulhi(static_cast<unsigned>(j), p.magic);
              const int kw = j - kh * p.ws;
              float& x = s[mt][nt][2 * hf + e];
              x = j < p.N ? fmaf(x, p.scale_log2,
                                 (bf16_f32(th[kh]) + bf16_f32(tw[kw])) *
                                     kLog2e)
                          : -INFINITY;
              mx = fmaxf(mx, x);
            }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
        const float m_new = fmaxf(m[mt][hf], mx);
        const float corr = ex2(m[mt][hf] - m_new);
        m[mt][hf] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[mt][nt][2 * hf + e];
            x = ex2(x - m_new);
            sum += x;
          }
        l[mt][hf] = l[mt][hf] * corr + sum;
#pragma unroll
        for (int dt = 0; dt < 8; ++dt) {
          o[mt][dt][2 * hf] *= corr;
          o[mt][dt][2 * hf + 1] *= corr;
        }
      }

    // O += P V, P in bf16
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(
            tV + swz(kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7),
                     2 * dp + (lane >> 4)),
            vf);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma(o[mt][2 * dp], pa[mt], vf[0], vf[1]);
          mma(o[mt][2 * dp + 1], pa[mt], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();
  }

  // O / l, in bf16, to each query's token
  const int out_elems = p.heads * kD;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float sum = l[mt][hf];
      sum += __shfl_xor_sync(0xffffffff, sum, 1);
      sum += __shfl_xor_sync(0xffffffff, sum, 2);
      const float inv = 1.f / sum;
      const int n = m0 + warp * 32 + mt * 16 + hf * 8 + g;
      if (n >= p.N) continue;
      unsigned short* dst =
          p.out + token(p, base, n) * out_elems + h * kD + 2 * t4;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
        *reinterpret_cast<uint32_t*>(dst + dt * 8) = pack_bf16(
            o[mt][dt][2 * hf] * inv, o[mt][dt][2 * hf + 1] * inv);
    }
}

template <bool kRowPerStep>
cudaError_t launch(const Params& p, int windows, int device,
                   cudaStream_t stream) {
  static bool ready[kMaxDevices];
  if (!ready[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        rel_attention_fwd_kernel<kRowPerStep>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  const dim3 grid((p.N + kBM - 1) / kBM, p.heads, windows);
  rel_attention_fwd_kernel<kRowPerStep>
      <<<grid, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 = launched). qkv,
// rel_h, rel_w and out as the layouts above, head dim 64; B >= 1; Hp and Wp
// multiples of ws; ws even and at most 64; qkv and out 16-byte aligned
// (checked by the wrapper, refused here too).
int rel_attention_bf16(const void* qkv, const void* rel_h, const void* rel_w,
                       void* out, int B, int Hp, int Wp, int ws, int heads,
                       float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices || B < 1 || heads < 1 || ws < 2 ||
      ws > kMaxWs || ws % 2 || Hp % ws || Wp % ws || Hp < ws || Wp < ws ||
      !aligned16(qkv) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.qkv = static_cast<const unsigned short*>(qkv);
  p.rel_h = static_cast<const unsigned short*>(rel_h);
  p.rel_w = static_cast<const unsigned short*>(rel_w);
  p.out = static_cast<unsigned short*>(out);
  p.Hp = Hp;
  p.Wp = Wp;
  p.ws = ws;
  p.heads = heads;
  p.nwx = Wp / ws;
  p.nw = (Hp / ws) * p.nwx;
  p.N = ws * ws;
  p.magic = static_cast<unsigned>((0x100000000ull + ws - 1) / ws);
  p.scale_log2 = scale * kLog2e;
  const long long windows = static_cast<long long>(B) * p.nw;
  if (windows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      ws == kBN ? launch<true>(p, static_cast<int>(windows), device, s)
                : launch<false>(p, static_cast<int>(windows), device, s));
}

const char* rel_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
