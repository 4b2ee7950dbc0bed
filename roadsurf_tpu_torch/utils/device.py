"""Device selection shared by the port's entry points."""

from __future__ import annotations

import functools

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    CUDA device is present, so an entry point never carries on on the CPU
    by accident. The CPU is used only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is present; "
            "pass device='cpu' explicitly to run the plain PyTorch path")
    return dev


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32


@functools.lru_cache(maxsize=None)
def device_constant(value, device: torch.device, dtype: torch.dtype
                    ) -> torch.Tensor:
    """``torch.tensor(value, dtype=dtype)`` on ``device``, made at the first
    call for (value, device, dtype) and shared by every later one; ``value``
    a number or a tuple. The forward and the training step take their
    small constants from here: a host-to-device copy synchronises the host,
    which a CUDA graph's capture does not allow, so the warm-up before a
    capture (``utils/graphs.py``) makes them. Never written to."""
    return torch.tensor(value, dtype=dtype).to(device)
