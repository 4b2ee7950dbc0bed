from . import attention as _attention
from . import bias_act as _epilogue
from . import layer_norm as _layer_norm
from .int8_gemm import int8_gemm
from .nms import batched_nms_fixed, nms_fixed, nms_scan, nms_sweep
from .nms_kernel import nms_keep_mask
from .roi_align import roi_align_multilevel
from .roi_align_backward_kernel import roi_align_backward
from .roi_align_blocked_kernel import roi_align_fused_blocked
from .roi_align_kernel import roi_align_fused

__all__ = ["int8_gemm", "roi_align_multilevel", "nms_fixed", "nms_sweep",
           "batched_nms_fixed", "nms_scan", "launch_counts",
           "reset_launch_counts", "add_launch_counts", "COUNTERS"]

# count name -> (kernel wrapper, attribute): each wrapper adds one where it
# launches its kernel, the poolers per mode of their levels (K5 per type of
# its d pooled); the conv epilogue's, the attention's and the LayerNorm's
# counts are on their modules
COUNTERS = {"roi_align": (roi_align_fused, "launches"),
            "roi_align_int8": (roi_align_fused, "launches_int8"),
            "roi_align_f32": (roi_align_fused, "launches_f32"),
            "roi_align_blocked": (roi_align_fused_blocked, "launches"),
            "roi_align_blocked_int8": (roi_align_fused_blocked,
                                       "launches_int8"),
            "roi_align_blocked_f32": (roi_align_fused_blocked,
                                      "launches_f32"),
            "nms": (nms_keep_mask, "launches"),
            "int8_gemm": (int8_gemm, "launches"),
            "roi_align_backward": (roi_align_backward, "launches"),
            "roi_align_backward_f32": (roi_align_backward, "launches_f32"),
            "bias_act": (_epilogue, "launches"),
            "rel_attention": (_attention, "launches"),
            "layer_norm": (_layer_norm, "launches")}


def launch_counts() -> dict:
    """This process's kernel launches so far, by count name."""
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def reset_launch_counts() -> None:
    """Set every count to 0, the attention's launches by path
    (``attention.path_launches``) among them."""
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)
    for p in _attention.path_launches:
        _attention.path_launches[p] = 0


def add_launch_counts(delta: dict) -> None:
    """Add ``delta`` ({count name: n}) to the counts: a CUDA graph's replay
    adds the launches its capture recorded (``utils/graphs.py``)."""
    for name, n in delta.items():
        fn, attr = COUNTERS[name]
        setattr(fn, attr, getattr(fn, attr) + n)
