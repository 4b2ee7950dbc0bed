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
    ``cuda_build`` builds ``csrc/int8_gemm.cu`` beside the poolers and
    NMS."""
    assert cuda_build.SOURCES == ("roi_align", "roi_align_blocked", "nms",
                                  "int8_gemm")
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
