"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA device (a CUDA kernel has no CPU mode) and
skips without one. The file imports no JAX, so on a machine with a card and
no JAX it runs on its own:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q
"""

import sys

import numpy as np
import pytest
import torch

from graph_slam_tpu_torch.planes.region_grow import (region_grow,
                                                     region_grow_torch)

grow = sys.modules["graph_slam_tpu_torch.planes.region_grow"]

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _grow_inputs(P, h, w, seed):
    r = np.random.default_rng(seed)
    member = r.random((P, h, w)) < 0.7
    seeds = np.zeros((P, h, w), bool)
    seeds[:, h // 2 - 2:h // 2 + 2, w // 2 - 2:w // 2 + 2] = True
    seeds[-1, :, 0] = True                  # a seed on the left edge
    gates = [r.random((h, w)) < 0.95 for _ in range(4)]
    return [torch.as_tensor(a) for a in (seeds, member, *gates)]


def _held_to_plain_version(args, steps, cluster=None, steps_between=None):
    """One launch, on the card, bit-equal to the plain version there."""
    dev = _cuda()
    args = [a.to(dev) for a in args]
    before = region_grow.launches
    if cluster is None:
        out = region_grow(*args, steps=steps)
    else:
        out = grow._launch(args[0], args[1], args[2:], steps, cluster=cluster,
                           steps_between=steps_between)
    torch.cuda.synchronize()
    assert region_grow.launches == before + 1
    assert out.dtype == torch.bool and out.shape == args[0].shape
    ref = region_grow_torch(*[a != 0 for a in args], steps=steps)
    assert torch.equal(out, ref)
    return out


@pytest.mark.parametrize("shape", [(8, 144, 176), (8, 480, 640), (3, 61, 97),
                                   (1, 33, 32), (2, 5, 1000), (2, 7, 20)])
@pytest.mark.parametrize("steps", [0, 1, 64])
def test_region_grow_kernel_matches_plain_version(shape, steps):
    _held_to_plain_version(_grow_inputs(*shape, seed=sum(shape) + steps), steps)


@pytest.mark.parametrize("shape", [(2, 13, 1), (2, 5, 20), (2, 13, 31),
                                   (2, 3, 33), (2, 21, 97), (2, 13, 176),
                                   (2, 144, 176), (1, 480, 640)])
@pytest.mark.parametrize("cluster", grow.CLUSTER_SIZES)
@pytest.mark.parametrize("steps", [0, 1, 64, 200])
def test_region_grow_kernel_bands(shape, cluster, steps):
    """Every cluster size on planes whose rows it does not divide, that have
    fewer rows than blocks, and whose width is off the 16-byte path."""
    args = _grow_inputs(*shape, seed=sum(shape) + steps)
    if grow.smem_bytes(*shape[1:], cluster) > grow._MAX_SMEM:
        with pytest.raises(ValueError, match="shared memory"):
            _held_to_plain_version(args, steps, cluster=cluster)
        return
    _held_to_plain_version(args, steps, cluster=cluster)


@pytest.mark.parametrize("shape,cluster", [((1, 480, 640), 8),
                                           ((2, 144, 176), 2),
                                           ((2, 41, 80), 4)])
@pytest.mark.parametrize("steps_between", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("steps", [5, 64])
def test_region_grow_kernel_steps_between_exchanges(shape, cluster,
                                                    steps_between, steps):
    _held_to_plain_version(_grow_inputs(*shape, seed=sum(shape) + steps),
                           steps, cluster=cluster, steps_between=steps_between)


@pytest.mark.parametrize("cluster", [None, 8])
def test_region_grow_kernel_more_planes_than_clusters_fit(cluster):
    _held_to_plain_version(_grow_inputs(300, 144, 176, seed=5), 64,
                           cluster=cluster)


def test_region_grow_kernel_large_plane_fits_in_eight_bands():
    assert grow.cluster_size(1200, 1600) == 8
    out = _held_to_plain_version(_grow_inputs(1, 1200, 1600, seed=0), 64)
    assert bool(out.any())


def test_region_grow_kernel_separate_byte_gates_and_unaligned_views():
    """Gates that are four tensors of their own, bytes other than 0 and 1,
    and inputs that start off a 16-byte boundary (the scalar path)."""
    dev = _cuda()
    P, h, w = 2, 48, 64
    args = _grow_inputs(P, h, w, seed=3)
    r = np.random.default_rng(4)
    spacer = []
    byte_args = []
    for a in args:
        scale = torch.as_tensor(r.integers(1, 256, a.shape), dtype=torch.uint8)
        byte_args.append((a.to(torch.uint8) * scale).to(dev))
        spacer.append(torch.empty(int(r.integers(1, 999)), device=dev))
    _held_to_plain_version(byte_args, 64)
    shifted = []
    for a in byte_args:
        buf = torch.empty(a.numel() + 1, dtype=torch.uint8, device=dev)
        buf[1:] = a.reshape(-1)
        shifted.append(buf[1:].view(a.shape))
        assert shifted[-1].data_ptr() % 16 != 0
    _held_to_plain_version(shifted, 64)


def test_region_grow_kernel_shared_memory_matches_the_wrapper():
    _cuda()
    lib = grow._kernel_lib()
    for h, w in [(480, 640), (144, 176), (1200, 1600), (5, 1000), (13, 31)]:
        for c in grow.CLUSTER_SIZES:
            for k in (1, grow.sub_steps(h, w, c)):
                assert lib.region_grow_smem_bytes(h, w, c, k) == \
                    grow.smem_bytes(h, w, c, k)


def test_region_grow_kernel_single_plane_no_wraparound():
    dev = _cuda()
    h, w = 24, 40
    seed = torch.zeros(h, w, dtype=torch.bool, device=dev)
    seed[:, 0] = True
    member = torch.ones(h, w, dtype=torch.bool, device=dev)
    closed = [torch.zeros(h, w, dtype=torch.bool, device=dev)] * 4
    out = region_grow(seed, member, *closed, steps=8)
    torch.cuda.synchronize()
    assert out.shape == (h, w)
    assert torch.equal(out, seed)


def test_region_grow_kernel_rejects_bad_inputs():
    dev = _cuda()
    args = [a.to(dev) for a in _grow_inputs(2, 16, 16, seed=0)]
    with pytest.raises(TypeError):
        region_grow(args[0].float(), *args[1:], steps=4)
    with pytest.raises(ValueError):
        region_grow(args[0], args[1][:1], *args[2:], steps=4)
    with pytest.raises(ValueError):
        region_grow(args[0], args[1].transpose(1, 2), *args[2:], steps=4)
    with pytest.raises(ValueError, match="shared memory"):
        region_grow(*[a.to(dev) for a in _grow_inputs(1, 2400, 3200, seed=0)],
                    steps=1)
    big = [a.to(dev) for a in _grow_inputs(1, 1200, 1600, seed=0)]
    with pytest.raises(ValueError, match="shared memory"):
        grow._launch(big[0], big[1], big[2:], 1, cluster=4)
