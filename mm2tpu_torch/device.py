"""Explicit device selection: the caller names the device, nothing falls
back from one to the other."""
from __future__ import annotations

from typing import Union

import torch

DEVICES = ("cuda", "cpu")


def resolve_device(name: Union[str, torch.device]) -> torch.device:
    """`"cuda"` (the current CUDA device) or `"cpu"`. `"cuda"` without a
    visible CUDA device raises; there is no automatic choice."""
    kind = name.type if isinstance(name, torch.device) else str(name)
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False (no CUDA device or a CPU-only PyTorch build); use "
                "--device cpu for the plain PyTorch path")
        if isinstance(name, torch.device) and name.index is not None:
            return name
        return torch.device("cuda", torch.cuda.current_device())
    if kind == "cpu":
        return torch.device("cpu")
    raise ValueError("unknown device %r (expected one of %s)"
                     % (name, ", ".join(DEVICES)))
