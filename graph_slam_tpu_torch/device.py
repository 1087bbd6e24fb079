"""The port's default device: the CUDA card, unless the caller names another.

Every entry point that creates tensors takes ``device=None`` and passes it
through ``resolve``. ``None`` means the card; without one it raises, and
never steps down to the CPU. A caller that wants the CPU says
``device="cpu"``, as the CPU tests do. Functions that take tensors follow
their inputs' device and do not come here.
"""

from __future__ import annotations

import torch

__all__ = ["resolve"]


def resolve(device=None) -> torch.device:
    """``None`` -> ``cuda`` (or a RuntimeError naming the missing card);
    anything else -> ``torch.device(device)``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "graph_slam_tpu_torch runs on a CUDA card by default and "
                "torch.cuda.is_available() is False: no CUDA card; pass "
                "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
