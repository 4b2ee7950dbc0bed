"""K4, the int8 GEMM of the PyTorch port (``ops/int8_gemm.py``): its plain
version against the JAX package's Pallas ``int8_gemm`` in interpret mode,
on the cases of ``tests/test_int8_gemm.py``, and its wrapper's rules.

Tolerances: the raw int32 product exact; the bf16 epilogue within 2⁻⁷
relative (the reference's own bound: bf16 output rounding, and the
reference's interpreted epilogue may contract ``acc·mult + bias`` into one
rounding); the folded requantize to int8 exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roadsurf_tpu.ops.int8_gemm import int8_gemm as j_int8_gemm
from roadsurf_tpu_torch.ops import cuda_build
from roadsurf_tpu_torch.ops.int8_gemm import _check, int8_gemm, \
    int8_gemm_ref

torch.set_num_threads(1)


def _ints(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("M,K,N,bm,bn,bk", [
    (64, 128, 128, 32, 128, 64),     # multi-step K accumulation
    (96, 192, 160, 512, 256, 512),   # non-pow2 dims, clamped tiles
    (256, 256, 64, 128, 64, 128),    # multi-block M grid
])
def test_raw_int32_exact(M, K, N, bm, bn, bk):
    rng = np.random.default_rng(0)
    a, w = _ints(rng, (M, K)), _ints(rng, (K, N))
    ref = np.asarray(j_int8_gemm(jnp.asarray(a), jnp.asarray(w), bm=bm,
                                 bn=bn, bk=bk, interpret=True))
    got = int8_gemm(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ w.astype(np.int64))


def test_epilogue_bf16():
    rng = np.random.default_rng(1)
    a, w = _ints(rng, (64, 128)), _ints(rng, (128, 128))
    mult = rng.uniform(0.001, 0.01, 128).astype(np.float32)
    bias = rng.normal(size=128).astype(np.float32)
    ref = np.asarray(j_int8_gemm(jnp.asarray(a), jnp.asarray(w),
                                 jnp.asarray(mult), jnp.asarray(bias),
                                 relu=True, bm=32, bn=128, bk=64,
                                 interpret=True), np.float32)
    got = int8_gemm(torch.from_numpy(a), torch.from_numpy(w),
                    torch.from_numpy(mult), torch.from_numpy(bias), relu=True)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert (got >= 0).all()
    assert np.max(np.abs(got - ref) / (np.abs(ref) + 1e-3)) < 2 ** -7


def test_requantize_folded_exact():
    """quant.py's streaming form folded into the epilogue:
    round((acc·mult + bias)/sa_out) as mult/sa_out, bias/sa_out."""
    rng = np.random.default_rng(2)
    a, w = _ints(rng, (96, 192)), _ints(rng, (192, 160))
    mult = rng.uniform(0.001, 0.01, 160).astype(np.float32)
    bias = rng.normal(size=160).astype(np.float32)
    sa = np.float32(0.07)
    ref = np.asarray(j_int8_gemm(jnp.asarray(a), jnp.asarray(w),
                                 jnp.asarray(mult / sa),
                                 jnp.asarray(bias / sa), relu=True,
                                 quantize=True, interpret=True))
    got = int8_gemm(torch.from_numpy(a), torch.from_numpy(w),
                    torch.from_numpy(mult / sa), torch.from_numpy(bias / sa),
                    relu=True, quantize=True)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)


def test_k4_is_built_with_the_other_kernels_and_needs_no_nvcc_to_import():
    """The module imported above without nvcc (nothing builds at import);
    ``cuda_build`` builds ``csrc/int8_gemm.cu`` beside the poolers, NMS,
    the poolers' gradient, the conv epilogue, the ViT's attention and
    the LayerNorm."""
    assert cuda_build.SOURCES == ("roi_align", "roi_align_blocked", "nms",
                                  "int8_gemm", "roi_align_backward",
                                  "bias_act", "rel_attention", "layer_norm")
    assert (cuda_build.CSRC / "int8_gemm.cu").exists()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """The checks a CUDA call goes through, on meta tensors."""
    a = torch.empty((64, 32), dtype=torch.int8, device="meta")
    w = torch.empty((32, 16), dtype=torch.int8, device="meta")
    v = torch.empty(16, device="meta")
    _check(a, w, None, None)
    _check(a, w, v, v)
    _check(a, w, v, None)
    with pytest.raises(TypeError):
        _check(a.float(), w, None, None)
    with pytest.raises(ValueError):
        _check(a, w[:31], None, None)
    with pytest.raises(ValueError):
        _check(a.t(), w.t(), None, None)
    with pytest.raises(ValueError):
        _check(a, w, v[:15], None)
    with pytest.raises(ValueError):
        _check(a, w, v.double(), None)
    with pytest.raises(ValueError, match="bias needs mult"):
        _check(a, w, None, v)
    with pytest.raises(ValueError, match="quantize needs mult"):
        int8_gemm(torch.zeros((2, 2), dtype=torch.int8),
                  torch.zeros((2, 2), dtype=torch.int8), quantize=True)
    assert int8_gemm.launches == 0


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(_ints(rng, (5, 7)))
    w = torch.from_numpy(_ints(rng, (7, 3)))
    mult = torch.full((3,), 0.01)
    for kw in ({}, {"mult": mult}, {"mult": mult, "quantize": True}):
        torch.testing.assert_close(int8_gemm(a, w, **kw),
                                   int8_gemm_ref(a, w, **kw), rtol=0, atol=0)
    assert int8_gemm.launches == 0


# ---------------------------------------------------------------------------
# numpy mirrors of the index arithmetic of csrc/int8_gemm.cu: the transpose
# of w and the padding of a into the scratch the wrapper allocates, the
# tiles the TMA unit reads (zero past the matrices), and the epilogue's
# stores; held against the plain version on ragged shapes

from roadsurf_tpu_torch.ops.int8_gemm import KERNEL, PAD_K, needs_pad, \
    padded_k  # noqa: E402

# (M, K, N): K not a slice multiple (8- and 16-aligned), K and N off
# TMA's 16-byte rule, N = 8, N over two tiles with a ragged last one
RAGGED = [(200, 72, 64), (130, 80, 192), (300, 100, 24), (256, 128, 8),
          (129, 256, 130)]


def _transpose_mirror(w, Kp):
    """transpose_kernel: 64 x 64 byte tiles, 4 bytes a thread each way;
    returns wt (N, Kp) and how often each of its bytes was written."""
    K, N = w.shape
    wt = np.full((N, Kp), 0x55, np.int8)
    writes = np.zeros((N, Kp), np.int32)
    for k0 in range(0, Kp, 64):
        for n0 in range(0, N, 64):
            t = np.zeros((64, 68), np.int8)
            for i in range(1024):
                r, c = i // 16, 4 * (i % 16)
                k, n = k0 + r, n0 + c
                if k < K and n < N:
                    v = w[k, n:min(n + 4, N)]
                    t[r, c:c + len(v)] = v
            for i in range(1024):
                r, c = i // 16, 4 * (i % 16)
                n, k = n0 + r, k0 + c
                if n < N and k < Kp:
                    wt[n, k:k + 4] = t[c:c + 4, r]
                    writes[n, k:k + 4] += 1
    return wt, writes


def _pad_mirror(a, Kp):
    """pad_kernel: 4 bytes of ap (M, Kp) a thread."""
    M, K = a.shape
    ap = np.full((M, Kp), 0x55, np.int8)
    writes = np.zeros((M, Kp), np.int32)
    for i in range(M * (Kp // 4)):
        m, k = i // (Kp // 4), 4 * (i % (Kp // 4))
        v = np.zeros(4, np.int8)
        v[:max(0, min(4, K - k))] = a[m, k:min(k + 4, K)]
        ap[m, k:k + 4] = v
        writes[m, k:k + 4] += 1
    return ap, writes


def _box(x, r0, c0, rows, cols=128):
    """A TMA box of a (dim1, dim0) map: zero past its extent."""
    out = np.zeros((rows, cols), np.int64)
    part = x[r0:r0 + rows, c0:c0 + cols]
    out[:part.shape[0], :part.shape[1]] = part
    return out


@pytest.mark.parametrize("M,K,N", RAGGED)
def test_k4_scratch_layouts_and_tiles_give_the_plain_product(M, K, N):
    """w's transpose and a's padded copy hold every byte of the operands
    once, zeros past K; the kernel's 128 x BN tiles, summed over 128-deep
    K slices of TMA boxes, give the plain version's int32 product."""
    rng = np.random.default_rng(M + K + N)
    a, w = _ints(rng, (M, K)), _ints(rng, (K, N))
    Kp = padded_k(K)
    assert Kp % PAD_K == 0 and K <= Kp < K + PAD_K
    wt, writes = _transpose_mirror(w, Kp)
    assert (writes == 1).all()
    np.testing.assert_array_equal(wt[:, :K], w.T)
    assert not wt[:, K:].any()
    pad = K % PAD_K != 0
    if pad:
        ap, writes = _pad_mirror(a, Kp)
        assert (writes == 1).all()
        np.testing.assert_array_equal(ap[:, :K], a)
        assert not ap[:, K:].any()
    src, cols = (ap, Kp) if pad else (a, K)
    BM, BK = KERNEL["kBM"], KERNEL["kBK"]
    BN = 64 if N <= 64 else 128
    tiles_n = -(-N // BN)
    acc = np.full((M, N), -1, np.int64)
    for blk in range(-(-M // BM) * tiles_n):
        m0, n0 = (blk // tiles_n) * BM, (blk % tiles_n) * BN
        t = np.zeros((BM, BN), np.int64)
        for kt in range(-(-K // BK)):
            t += _box(src[:, :cols], m0, kt * BK, BM) \
                @ _box(wt, n0, kt * BK, BN).T
        acc[m0:m0 + BM, n0:n0 + BN] = t[:M - m0, :N - n0]
    ref = int8_gemm_ref(torch.from_numpy(a), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(acc, ref)


@pytest.mark.parametrize("M,K,N", RAGGED + [(262144 // 64, 256, 64)])
@pytest.mark.parametrize("ob", [4, 2, 1])
def test_k4_epilogue_stores_write_each_output_byte_once(M, K, N, ob):
    """The epilogue's stores: each consumer warpgroup writes its 64 staged
    rows in 16-byte chunks of the tile row, whole chunks as 16-byte
    vectors only where the out row stride keeps them aligned, the ragged
    chunk byte by byte; every output byte once, and the staged tile fits
    the ring the products are done with."""
    BM, ring = KERNEL["kBM"], KERNEL["kRingBytes"]
    BN = 64 if N <= 64 else 128
    stages = ring // (BM * KERNEL["kBK"] + BN * KERNEL["kBK"])
    assert 2 <= stages <= KERNEL["kMaxStages"]
    assert KERNEL["kConsumers"] * 64 * (BN * 4 + 16) <= ring
    ld = N * ob
    vec = ld % 16 == 0
    writes = np.zeros(M * ld, np.int32)
    tiles_n = -(-N // BN)
    chunks = BN * ob // 16
    for blk in range(-(-M // BM) * tiles_n):
        m0, n0 = (blk // tiles_n) * BM, (blk % tiles_n) * BN
        valid = min(BN, N - n0) * ob
        for wg in range(KERNEL["kConsumers"]):
            row0 = m0 + 64 * wg
            n_rows = min(64, M - row0)
            for i in range(64 * chunks):
                r, b = i // chunks, (i % chunks) * 16
                if r >= n_rows or b >= valid:
                    continue
                at = (row0 + r) * ld + n0 * ob + b
                if vec and b + 16 <= valid:
                    assert at % 16 == 0
                writes[at:at + min(16, valid - b)] += 1
    assert (writes == 1).all()


def test_k4_pads_a_where_tma_cannot_read_it():
    """TMA takes 16-byte aligned bases and row strides: K = 72 and 100, or
    a view 4 bytes into its storage, go through the padded copy; the main
    shapes' K (multiples of 16, fresh allocations) do not."""
    base = torch.zeros(64 * 80 + 16, dtype=torch.int8)
    aligned = base[(-base.data_ptr()) % 16:][:64 * 80].view(64, 80)
    assert aligned.data_ptr() % 16 == 0 and not needs_pad(aligned)
    assert needs_pad(base[(-base.data_ptr()) % 16 + 4:][:64 * 80]
                     .view(64, 80))
    for K in (72, 100):
        assert needs_pad(torch.zeros((4, K), dtype=torch.int8))
    assert [padded_k(K) for K in (72, 80, 100, 128, 12544)] == \
        [80, 80, 112, 128, 12544]
    src = (cuda_build.CSRC / "int8_gemm.cu").read_text()
    assert "K % kPadK != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0" \
        in src
