"""The family of detectron2's Mask R-CNN R50-FPN, the default of a
configuration without a ``"family"`` key: the weights and the class pin
of ``modelgen.py``, the plain reference of ``reference.py`` and the work
counts of ``work.py``, bound here by name and not copied."""

from portbench.modelgen import PIN_TILES, pin_classes, weights
from portbench.reference import run
from portbench.work import forward_flops, nms_bytes, pooler_bytes

__all__ = ["NARROW", "PIN_TILES", "forward_flops", "nms_bytes",
           "pin_classes", "pooler_bytes", "run", "weights"]

# the widths of the CPU tests' narrow runs (portbench/tests/conftest.py)
NARROW = {"stem_out": 8, "res2_out": 32, "fpn_channels": 16,
          "box_fc_dim": 32, "mask_conv_dim": 16}
