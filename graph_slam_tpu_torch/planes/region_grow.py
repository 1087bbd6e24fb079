"""Intensity-gated flood fill for the plane region grow (port of
``planes/pallas_grow.py``).

``region_grow`` runs ``steps`` of

    mask <- (mask | shiftL(mask) & sm_l | shiftR(mask) & sm_r
                  | shiftU(mask) & sm_u | shiftD(mask) & sm_d) & member

from ``seed & member``, with zero-filled shifts (nothing wraps across an
edge). Seeds and members are (H, W) or (P, H, W); the four smoothness gates
are (H, W), shared by all planes.

- On CUDA tensors it launches the hand-written Hopper kernel
  ``csrc/region_grow.cu`` (all steps in one launch, masks bit-packed in
  shared memory), or raises.
- On CPU tensors it runs ``region_grow_torch``, the plain version: the same
  function as a loop of torch shift-and-mask passes.

``region_grow.launches`` counts kernel launches, so a run can show that its
main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["region_grow", "region_grow_torch"]

# opt-in shared memory of one block on sm_90 (227 KB)
_MAX_SMEM = 232448


def _shift(x, delta: int, dim: int):
    """Zero-filled shift of a bool tensor by ``delta`` along ``dim``."""
    n = x.shape[dim]
    idx = torch.arange(n, device=x.device)
    ok = idx >= delta if delta > 0 else idx < n + delta
    shape = [1] * x.dim()
    shape[dim] = n
    return torch.roll(x, delta, dims=dim) & ok.reshape(shape)


def region_grow_torch(seed, member, sm_l, sm_r, sm_u, sm_d, steps: int = 64):
    """Plain torch flood fill; bool (..., H, W) in and out."""
    mask = seed & member
    for _ in range(steps):
        grown = ((_shift(mask, 1, -1) & sm_l) | (_shift(mask, -1, -1) & sm_r)
                 | (_shift(mask, 1, -2) & sm_u) | (_shift(mask, -1, -2) & sm_d))
        mask = (mask | grown) & member
    return mask


@functools.lru_cache(maxsize=None)
def _kernel_lib():
    from ..kernels import build

    lib = build.library("region_grow")
    lib.region_grow_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.region_grow_launch.restype = ctypes.c_int
    lib.region_grow_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.region_grow_smem_bytes.restype = ctypes.c_longlong
    return lib


def _as_bytes(x):
    return x.view(torch.uint8) if x.dtype == torch.bool else x


def _launch(seed, member, gates, steps: int):
    """The CUDA kernel on (P, H, W) seed/member and four (H, W) gates."""
    P, H, W = seed.shape
    dev = seed.device
    for name, t, shape in (("seed", seed, (P, H, W)),
                           ("member", member, (P, H, W)),
                           *((f"gate {k}", g, (H, W))
                             for k, g in enumerate(gates))):
        if t.device != dev:
            raise ValueError(f"region_grow: {name} is on {t.device}, "
                             f"seed on {dev}")
        if t.dtype not in (torch.bool, torch.uint8):
            raise TypeError(f"region_grow: {name} must be bool or uint8, "
                            f"got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"region_grow: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"region_grow: {name} must be contiguous")
    if steps < 0:
        raise ValueError(f"region_grow: steps must be >= 0, got {steps}")
    out = torch.empty((P, H, W), dtype=torch.bool, device=dev)
    if P == 0 or H == 0 or W == 0:
        return out
    lib = _kernel_lib()
    smem = lib.region_grow_smem_bytes(H, W)
    if smem > _MAX_SMEM:
        raise ValueError(f"region_grow: a {H}x{W} plane needs {smem} bytes "
                         f"of shared memory, more than {_MAX_SMEM}")
    gates_u8 = torch.stack([_as_bytes(g) for g in gates])
    packed = torch.empty(4 * H * ((W + 31) // 32), dtype=torch.int32,
                         device=dev)
    with torch.cuda.device(dev):
        rc = lib.region_grow_launch(
            _as_bytes(seed).data_ptr(), _as_bytes(member).data_ptr(),
            gates_u8.data_ptr(), packed.data_ptr(), out.data_ptr(),
            P, H, W, steps, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"region_grow: CUDA kernel launch failed with "
                           f"cudaError {rc}")
    region_grow.launches += 1
    return out


def region_grow(seed, member, sm_l, sm_r, sm_u, sm_d, steps: int = 64):
    """Flood fill ``seed`` within ``member`` gated by the smoothness masks.

    ``seed``/``member`` bool (H, W) or (P, H, W); gates bool (H, W).
    Returns bool of the seed's shape. CPU tensors take the plain version;
    CUDA tensors the kernel, whose failures raise.
    """
    dev = seed.device
    if dev.type == "cpu":
        return region_grow_torch(seed, member, sm_l, sm_r, sm_u, sm_d, steps)
    if dev.type != "cuda":
        raise ValueError(f"region_grow: no kernel for device {dev}")
    if seed.dim() == 2:
        return _launch(seed[None], member[None], (sm_l, sm_r, sm_u, sm_d),
                       steps)[0]
    return _launch(seed, member, (sm_l, sm_r, sm_u, sm_d), steps)


region_grow.launches = 0
