"""ompi_tpu_torch — the PyTorch/CUDA port of ompi_tpu for NVIDIA Hopper.

It mirrors the JAX package's layout (``ops/attention.py``,
``parallel/ring.py``, ``models/transformer.py``) and imports neither JAX nor
anything of ``ompi_tpu``.  Every Pallas kernel of the JAX package becomes a
kernel written by hand for Hopper under ``csrc/``, built by ``_build`` at
first use; each has a plain PyTorch version beside it that runs when the
tensors lie on the CPU.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
