"""PyTorch/CUDA port of the DSBP serving system for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package never imports it
(nor JAX).  Entry points run on the CUDA card unless the caller names the
CPU explicitly (``device="cpu"``), where every kernel wrapper runs its
plain PyTorch version instead.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's choice, else the
    CUDA card.  Never falls back to the CPU on its own — a missing card is
    an error, so a run can never be mistaken for a GPU run."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    return torch.device("cuda")
