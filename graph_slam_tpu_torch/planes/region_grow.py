"""Intensity-gated flood fill for the plane region grow (port of
``planes/pallas_grow.py``).

``region_grow`` runs ``steps`` of

    mask <- (mask | shiftL(mask) & sm_l | shiftR(mask) & sm_r
                  | shiftU(mask) & sm_u | shiftD(mask) & sm_d) & member

from ``seed & member``, with zero-filled shifts (nothing wraps across an
edge). Seeds and members are (H, W) or (P, H, W); the four smoothness gates
are (H, W), shared by all planes.

- On CUDA tensors it launches the hand-written Hopper kernel
  ``csrc/region_grow.cu``: one launch, a thread-block cluster of C blocks
  per plane, each block holding a band of the plane's rows and K ghost
  rows on either side bit-packed in shared memory, the blocks exchanging
  rows every K steps; or it raises.
- On CPU tensors it runs ``region_grow_torch``, the plain version: the same
  function as a loop of torch shift-and-mask passes.

The kernel's index arithmetic (words per row, bands, shared memory, block
size, the choice of C) lives here, where the CPU tests reach it.

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
_MAX_THREADS = 1024
# blocks per plane: 8 is the largest cluster every sm_90 card schedules
CLUSTER_SIZES = (1, 2, 4, 8)
# a plane of at most this many packed words goes to one block
_ONE_BLOCK_WORDS = 256
# steps between two exchanges of a cluster's blocks, at most
_MAX_SUB_STEPS = 8
# a cluster whose shortest band allows fewer steps between exchanges than
# this pays a cluster barrier too often to beat one block
_MIN_SUB_STEPS = 4


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


def words_per_row(W: int) -> int:
    """32-pixel words of one bit-packed row; bits beyond W are padding."""
    return (W + 31) // 32


def band_rows(H: int, C: int) -> int:
    """Rows of one block's band when H rows are cut into C bands."""
    return -(-H // C)


def band(H: int, C: int, rank: int) -> tuple[int, int]:
    """Rows [r0, r1) of the block of ``rank``; short or empty at the end
    where C does not divide H."""
    r0 = min(rank * band_rows(H, C), H)
    return r0, min(r0 + band_rows(H, C), H)


def shortest_band(H: int, C: int) -> int:
    """Rows of the last band that is not empty."""
    rows = band_rows(H, C)
    return H - rows * (-(-H // rows) - 1)


def sub_steps(H: int, W: int, C: int) -> int:
    """Steps between two exchanges of a cluster's blocks: as many ghost rows
    a block keeps on each side of its band. At most ``_MAX_SUB_STEPS``, at
    most the rows of the shortest band that is not empty (a block's ghost
    rows come from one neighbour), and 1 for a single block."""
    if C == 1:
        return 1
    K = max(1, min(_MAX_SUB_STEPS, shortest_band(H, C)))
    while K > 1 and smem_bytes(H, W, C, K) > _MAX_SMEM:
        K -= 1
    return K


def smem_bytes(H: int, W: int, C: int, K: int = 1) -> int:
    """Shared memory of one block: mask twice and four gates of a band and
    its 2K ghost rows, K staged rows for each side and exchange parity, two
    exit flags."""
    wpr = words_per_row(W)
    return 4 * (6 * (band_rows(H, C) + 2 * K) * wpr + 4 * K * wpr + 2)


def block_threads(H: int, W: int, C: int, K: int = 1) -> int:
    """Threads of a block: one per word of the rows a step computes (the
    band and its ghost rows less the outer two), or, for more words than a
    block has threads, whole rows in as few equal passes as cover them; a
    multiple of 32."""
    wpr = words_per_row(W)
    rows = band_rows(H, C) + 2 * K - 2
    passes = -(-rows // (_MAX_THREADS // wpr))
    per_pass = -(-rows // passes)
    return max(128, 32 * -(-per_pass * wpr // 32))


def cluster_size(H: int, W: int) -> int:
    """Blocks per plane: the widest cluster, or one block where the whole
    plane is at most ``_ONE_BLOCK_WORDS`` packed words or the cluster's
    shortest band has fewer than ``_MIN_SUB_STEPS`` rows (a step of one
    block costs a block barrier, a fraction of a cluster barrier); in
    either case at least the narrowest whose band fits a block's shared
    memory."""
    fits = [C for C in CLUSTER_SIZES if smem_bytes(H, W, C) <= _MAX_SMEM]
    if not fits:
        raise ValueError(
            f"region_grow: a {H}x{W} plane needs "
            f"{smem_bytes(H, W, CLUSTER_SIZES[-1])} bytes of shared memory "
            f"a block even cut into {CLUSTER_SIZES[-1]} bands, more than "
            f"{_MAX_SMEM}")
    if fits[0] == 1 and (H * words_per_row(W) <= _ONE_BLOCK_WORDS
                         or shortest_band(H, fits[-1]) < _MIN_SUB_STEPS):
        return 1
    return fits[-1]


@functools.lru_cache(maxsize=None)
def _kernel_lib():
    from ..kernels import build

    lib = build.library("region_grow")
    lib.region_grow_launch.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.region_grow_launch.restype = ctypes.c_int
    lib.region_grow_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.region_grow_smem_bytes.restype = ctypes.c_longlong
    lib.region_grow_max_active_clusters.argtypes = [ctypes.c_int] * 5
    lib.region_grow_max_active_clusters.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _plan(H: int, W: int, cluster, steps_between, device_index: int):
    """(C, K, threads) for an (H, W) plane on that device: the wrapper's
    choice unless ``cluster``/``steps_between`` force one, after asking the
    device whether it can run such a cluster at all."""
    if W > 32 * _MAX_THREADS:
        raise ValueError(f"region_grow: W = {W} is wider than "
                         f"{32 * _MAX_THREADS} pixels")
    C = cluster_size(H, W) if cluster is None else cluster
    K = sub_steps(H, W, C) if steps_between is None else steps_between
    if K < 1 or (C > 1 and K > shortest_band(H, C)):
        raise ValueError(f"region_grow: {K} steps between exchanges, but the "
                         f"shortest of {C} bands of {H} rows has "
                         f"{shortest_band(H, C)}")
    smem = smem_bytes(H, W, C, K)
    if smem > _MAX_SMEM:
        raise ValueError(f"region_grow: a {H}x{W} plane in {C} bands needs "
                         f"{smem} bytes of shared memory a block, more than "
                         f"{_MAX_SMEM}")
    threads = block_threads(H, W, C, K)
    with torch.cuda.device(device_index):
        n = _kernel_lib().region_grow_max_active_clusters(H, W, C, K, threads)
    if n <= 0:
        raise RuntimeError(
            f"region_grow: the device cannot schedule a cluster of {C} "
            f"blocks of {threads} threads and {smem} bytes of shared memory "
            f"(cudaOccupancyMaxActiveClusters gave {n})")
    return C, K, threads


def _launch(seed, member, gates, steps: int, cluster=None,
            steps_between=None):
    """The CUDA kernel on checked (P, H, W) seed/member and four (H, W)
    gates; ``cluster`` and ``steps_between`` override the wrapper's choice
    of blocks per plane and of steps between their exchanges."""
    P, H, W = seed.shape
    dev = seed.device
    out = torch.empty((P, H, W), dtype=torch.bool, device=dev)
    if P == 0 or H == 0 or W == 0:
        return out
    current = torch.cuda.current_device()
    index = current if dev.index is None else dev.index
    C, K, threads = _plan(H, W, cluster, steps_between, index)
    if index != current:
        torch.cuda.set_device(index)
    try:
        rc = _kernel_lib().region_grow_launch(
            seed.data_ptr(), member.data_ptr(), gates[0].data_ptr(),
            gates[1].data_ptr(), gates[2].data_ptr(), gates[3].data_ptr(),
            out.data_ptr(), P, H, W, steps, C, K, threads,
            torch.cuda.current_stream(index).cuda_stream)
    finally:
        if index != current:
            torch.cuda.set_device(current)
    if rc != 0:
        raise RuntimeError(f"region_grow: CUDA kernel launch failed with "
                           f"cudaError {rc}")
    region_grow.launches += 1
    return out


def _check(seed, member, gates, steps):
    """Raise on what the kernel does not take, naming the caller's argument
    and the shape the caller passed."""
    shape = seed.shape
    if len(shape) not in (2, 3):
        raise ValueError(f"region_grow: seed must be (H, W) or (P, H, W), "
                         f"got shape {tuple(shape)}")
    plane = shape[-2:]
    dev = seed.device
    for name, t, want in (("seed", seed, shape), ("member", member, shape),
                          ("sm_l", gates[0], plane), ("sm_r", gates[1], plane),
                          ("sm_u", gates[2], plane), ("sm_d", gates[3], plane)):
        if (t.device == dev and t.shape == want and t.is_contiguous()
                and (t.dtype is torch.bool or t.dtype is torch.uint8)):
            continue
        if t.device != dev:
            raise ValueError(f"region_grow: {name} is on {t.device}, "
                             f"seed on {dev}")
        if t.dtype not in (torch.bool, torch.uint8):
            raise TypeError(f"region_grow: {name} must be bool or uint8, "
                            f"got {t.dtype}")
        if t.shape != want:
            raise ValueError(f"region_grow: {name} has shape "
                             f"{tuple(t.shape)}, expected {tuple(want)}")
        raise ValueError(f"region_grow: {name} of shape {tuple(t.shape)} "
                         f"must be contiguous")
    if steps < 0:
        raise ValueError(f"region_grow: steps must be >= 0, got {steps}")


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
    gates = (sm_l, sm_r, sm_u, sm_d)
    _check(seed, member, gates, steps)
    if seed.dim() == 2:
        return _launch(seed[None], member[None], gates, steps)[0]
    return _launch(seed, member, gates, steps)


region_grow.launches = 0
