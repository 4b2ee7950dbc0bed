"""The frozen category copy and the trace's reduction, on known names and
synthetic events."""

import pytest
import torch

from portbench.trace import WINDOW, category, summarize


@pytest.mark.parametrize("name,cat", [
    ("roi_align_staged_kernel<7, 2>", "roi_align"),
    ("roi_align_backward_tile_kernel", "roi_align_backward"),
    ("nms_pair_kernel", "nms"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32", "conv"),
    ("void cudnn::engines_precompiled::nhwcToNchwKernel", "conv"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", "conv"),
    ("cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm>", "gemm"),
    ("ampere_sgemm_128x64_tn", "gemm"),
    ("void at::native::(anonymous namespace)::radixSortKVInPlace", "sort/top-k"),
    ("Memcpy HtoD (Pinned -> Device)", "copy"),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy"
     "_kernel_cuda>", "copy"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "AddFunctor<float>>", "elementwise"),
    ("void at::native::reduce_kernel<512, 1>", "other"),
])
def test_category(name, cat):
    assert category(name) == cat


class Ev:
    def __init__(self, name, t0, t1, dev=False, user=False):
        self._n, self._s, self._d = name, t0, t1 - t0
        self._dev, self._u = dev, user

    def name(self):
        return self._n

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._dev \
            else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def is_user_annotation(self):
        return self._u


def test_summarize():
    ms = 1_000_000
    events = [
        Ev(WINDOW, 0, 100 * ms, user=True),
        Ev("engine.dispatch", 0, 30 * ms, user=True),
        Ev("engine.drain", 30 * ms, 100 * ms, user=True),
        Ev("aten::conv2d", 1 * ms, 2 * ms),                 # host op: no span
        Ev("implicit_gemm_conv", -5 * ms, 20 * ms, dev=True),   # clipped
        Ev("roi_align_staged_kernel", 10 * ms, 25 * ms, dev=True),
        Ev("vectorized_elementwise_kernel", 40 * ms, 90 * ms, dev=True),
    ]
    s = summarize(events)
    assert s["window_s"] == pytest.approx(0.1)
    assert s["busy_s"] == pytest.approx(0.075)    # [0,25] and [40,90]
    assert s["by_category"]["conv"] == pytest.approx(0.020)
    assert s["launches"] == {"conv": 1, "roi_align": 1, "elementwise": 1}
    # gaps: [25, 40] begins while dispatching, [90, 100] while draining
    assert dict(s["idle_gaps"]) == pytest.approx({"engine.dispatch": 0.015,
                                                  "engine.drain": 0.010})
    assert s["device_ops"][0][0] == "vectorized_elementwise_kernel"
    assert summarize(events[1:]) is None
