from .int8_gemm import int8_gemm
from .nms import batched_nms_fixed, nms_fixed, nms_sweep
from .nms_kernel import nms_keep_mask
from .roi_align import roi_align_multilevel
from .roi_align_backward_kernel import roi_align_backward
from .roi_align_blocked_kernel import roi_align_fused_blocked
from .roi_align_kernel import roi_align_fused

__all__ = ["int8_gemm", "roi_align_multilevel", "nms_fixed", "nms_sweep",
           "batched_nms_fixed", "launch_counts", "reset_launch_counts",
           "COUNTERS"]

# count name -> (kernel wrapper, attribute): each wrapper adds one where it
# launches its kernel, the poolers per mode of their levels
COUNTERS = {"roi_align": (roi_align_fused, "launches"),
            "roi_align_int8": (roi_align_fused, "launches_int8"),
            "roi_align_blocked": (roi_align_fused_blocked, "launches"),
            "roi_align_blocked_int8": (roi_align_fused_blocked,
                                       "launches_int8"),
            "nms": (nms_keep_mask, "launches"),
            "int8_gemm": (int8_gemm, "launches"),
            "roi_align_backward": (roi_align_backward, "launches")}


def launch_counts() -> dict:
    """This process's kernel launches so far, by count name."""
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def reset_launch_counts() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)
