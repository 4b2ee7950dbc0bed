from .int8_gemm import int8_gemm
from .nms import batched_nms_fixed, nms_fixed, nms_sweep
from .roi_align import roi_align_multilevel

__all__ = ["int8_gemm", "roi_align_multilevel", "nms_fixed", "nms_sweep",
           "batched_nms_fixed"]
