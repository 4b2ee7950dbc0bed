from .config import ModelConfig, dense_profile, fast_profile, \
    from_detectron2_yaml
from .mask_rcnn import forward_inference, init_params
from .quant import prepare_quantized

__all__ = [
    "ModelConfig", "fast_profile", "dense_profile", "from_detectron2_yaml",
    "init_params", "forward_inference", "prepare_quantized",
]
