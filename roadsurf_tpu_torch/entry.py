"""Entry points of the port: the one-card forward check and the
multi-card dry run, the counterparts of the reference package's
``__graft_entry__.entry`` and ``dryrun_multichip``."""

from __future__ import annotations

import numpy as np
import torch

from .models.config import fast_profile
from .models.mask_rcnn import forward_inference, init_params
from .parallel.dryrun import dryrun_multigpu
from .utils.device import compute_dtype, resolve_device
from .utils.weights import from_jax_params, state_to

__all__ = ["entry", "dryrun_multigpu"]

IMAGES = (8, 256, 256, 3)       # the reference's example tiles


def entry(device="cuda") -> tuple:
    """Returns ``(fn, (state, images))``: ``fn(state, images)`` is the
    inference forward of the flagship model (Mask R-CNN R50-FPN,
    ``fast_profile()`` at its own defaults, masks as logits) on
    ``device``, ``state`` its weights from ``init_params`` seeded 0,
    prepared there, and ``images`` 8 random 256 px uint8 tiles from a
    seeded generator (the reference's are unseeded). Raises without a
    card unless it is given ``device="cpu"``."""
    dev = resolve_device(device)
    cfg = fast_profile()
    state = state_to(from_jax_params(init_params(
        cfg, torch.Generator().manual_seed(0))), dev, compute_dtype(cfg))
    images = np.random.default_rng(0).integers(0, 255, IMAGES,
                                               dtype=np.uint8)

    def fn(state, images):
        return forward_inference(state, images, cfg, device=dev)

    return fn, (state, images)
