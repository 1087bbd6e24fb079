"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA device (a CUDA kernel has no CPU mode) and
skips without one. The file imports no JAX, so on a machine with a card and
no JAX it runs on its own:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from graph_slam_tpu_torch.planes.region_grow import (region_grow,
                                                     region_grow_torch)

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


@pytest.mark.parametrize("shape", [(8, 144, 176), (8, 480, 640), (3, 61, 97),
                                   (1, 33, 32), (2, 5, 1000), (2, 7, 20)])
@pytest.mark.parametrize("steps", [0, 1, 64])
def test_region_grow_kernel_matches_plain_version(shape, steps):
    dev = _cuda()
    args = _grow_inputs(*shape, seed=sum(shape) + steps)
    before = region_grow.launches
    out = region_grow(*[a.to(dev) for a in args], steps=steps)
    torch.cuda.synchronize()
    assert region_grow.launches == before + 1
    assert out.dtype == torch.bool and out.shape == shape
    np.testing.assert_array_equal(out.cpu().numpy(),
                                  region_grow_torch(*args, steps=steps).numpy())


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
        region_grow(*[a.to(dev) for a in _grow_inputs(1, 1200, 1600, seed=0)],
                    steps=1)
