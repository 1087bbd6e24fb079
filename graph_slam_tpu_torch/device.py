"""The port's default device: the CUDA card, unless the caller names another.

Every entry point that creates tensors takes ``device=None`` and passes it
through ``resolve``. ``None`` means the card; without one it raises, and
never steps down to the CPU. A caller that wants the CPU says
``device="cpu"``, as the CPU tests do. Functions that take tensors follow
their inputs' device and do not come here.

``upload`` and ``to_host`` move host arrays to a device and tensors back
with as few host syncs as they can: one for a whole group of reads.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve", "upload", "to_host"]


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


def upload(x, device, dtype=None) -> torch.Tensor:
    """A host array -> a tensor on ``device`` (its dtype kept unless
    ``dtype`` is given). On a card the copy goes through pinned memory and
    does not block the host."""
    t = torch.as_tensor(np.asarray(x))
    if dtype is not None:
        t = t.to(dtype)
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def to_host(tree):
    """Tensors nested in tuples, lists and NamedTuples -> numpy arrays in
    the same structure (copies, never views of the tensors), with one host
    sync for all of them: every card tensor is copied into pinned memory
    without blocking, then the stream is synchronised once. Other leaves
    pass through."""
    pending = []

    def start(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                pending.append(x)
                return x.to("cpu", non_blocking=True)
            return x.detach().clone()
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(start(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(start(v) for v in x)
        return x

    def finish(x):
        if isinstance(x, torch.Tensor):
            return x.numpy()
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(finish(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(finish(v) for v in x)
        return x

    out = start(tree)
    if pending:
        torch.cuda.current_stream(pending[0].device).synchronize()
    return finish(out)
