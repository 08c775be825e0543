"""Device selection for the port's entry points.

Entry points take ``device=`` and default to ``"cuda"``. Asking for CUDA on
a host without a CUDA device raises: nothing quietly carries on on the CPU.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it is CUDA and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def on_device(x, device: torch.device) -> torch.Tensor:
    """``x`` (a tensor, or an array) as a tensor on ``device``; a tensor
    already there is returned as it is (no copy)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)
