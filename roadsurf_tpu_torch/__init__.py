"""PyTorch/CUDA port of the roadsurf Mask R-CNN tile-inference path.

Mirrors the layout and names of the JAX package (``models/``, ``ops/``,
``engine/``, ``utils/``) but imports none of it: the JAX package is the
reference this port is held against, by the ``tests/test_torch_port_*.py``
parity tests on the CPU and by ``chip_smoke.py`` on an NVIDIA H100.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``
and raises when no CUDA device is present; pass ``device="cpu"`` to run the
plain PyTorch versions of the kernels on the CPU.
"""
