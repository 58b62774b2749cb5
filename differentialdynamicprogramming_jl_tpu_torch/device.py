"""Where the port's entry points and factories put their tensors.

A ``torch.Tensor`` keeps its device: a CPU tensor is the caller's request for
the CPU, where the kernels' plain versions run. Anything else (a numpy
array, a list, a float), and a factory's ``device=None``, goes to the CUDA
card. Without a card that raises: nothing falls back to the CPU unasked.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card: pass CPU tensors, or device='cpu', to run the "
            "plain PyTorch versions on the CPU")
    return torch.device("cuda")


def like(value, ref: torch.Tensor, dtype=None) -> torch.Tensor:
    """``value`` as a tensor of ``ref``'s dtype (or ``dtype``): a tensor
    keeps its device, anything else goes to ``ref``'s. How an entry point
    brings its other inputs to the device of the one that decides it."""
    dtype = ref.dtype if dtype is None else dtype
    if isinstance(value, torch.Tensor):
        return value.to(dtype)
    return torch.as_tensor(value, dtype=dtype, device=ref.device)


def as_tensor(value, dtype=None) -> torch.Tensor:
    """A tensor as it is (cast to ``dtype`` if given); anything else as a
    tensor on the CUDA card."""
    if isinstance(value, torch.Tensor):
        return value if dtype is None else value.to(dtype)
    return torch.as_tensor(value, dtype=dtype, device=resolve())
