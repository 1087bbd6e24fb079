"""The port's region grow against the JAX package's flood fills.

On the CPU ``region_grow`` runs its plain version ``region_grow_torch``;
both must be bit-equal to ``region_grow_xla``, to the Pallas kernel in
interpret mode, and, batched over planes, to ``_region_grow_batch`` (the
cases of ``tests/test_pallas_kernels.py`` plus P = 3). The CUDA kernel is
held bit-equal to the plain version in ``test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import torch

from graph_slam_tpu.planes.pallas_grow import (region_grow_pallas,
                                               region_grow_xla)
from graph_slam_tpu.planes.propagation import _region_grow_batch
from graph_slam_tpu_torch.planes.region_grow import (region_grow,
                                                     region_grow_torch)

torch.set_num_threads(1)


def _scene(seed=0, h=60, w=90, planes=None):
    r = np.random.default_rng(seed)
    lead = () if planes is None else (planes,)
    member = r.random((*lead, h, w)) < 0.7
    seed_m = np.zeros((*lead, h, w), bool)
    seed_m[..., h // 2 - 2:h // 2 + 2, w // 2 - 2:w // 2 + 2] = True
    if planes is not None:
        seed_m[1] = np.roll(seed_m[1], (h // 4, w // 3), axis=(0, 1))
        seed_m[-1, :, 0] = True     # a seed on the left edge
    sm = [r.random((h, w)) < 0.95 for _ in range(4)]
    return [seed_m, member, *sm]


def _torch(args):
    return [torch.as_tensor(a) for a in args]


def _jax(args):
    return [jnp.asarray(a) for a in args]


def _dispatched(args, steps):
    """``region_grow`` on CPU tensors: the plain version, no launch."""
    before = region_grow.launches
    out = region_grow(*_torch(args), steps=steps)
    assert region_grow.launches == before
    np.testing.assert_array_equal(
        out.numpy(), region_grow_torch(*_torch(args), steps=steps).numpy())
    return out.numpy()


def test_matches_xla_and_pallas_reference():
    args = _scene()
    out = _dispatched(args, 40)
    np.testing.assert_array_equal(
        out, np.asarray(region_grow_xla(*_jax(args), steps=40)))
    np.testing.assert_array_equal(
        out, np.asarray(region_grow_pallas(*_jax(args), steps=40,
                                           interpret=True)))


def test_fixed_point_containment():
    args = _scene(seed=1)
    out = _dispatched(args, 64)
    seed_m, member = args[0], args[1]
    assert np.all(out[seed_m & member])
    assert not np.any(out & ~member)
    np.testing.assert_array_equal(
        out, np.asarray(region_grow_xla(*_jax(args), steps=64)))


def test_no_edge_wraparound():
    h, w = 24, 40
    member = np.ones((h, w), bool)
    seed = np.zeros((h, w), bool)
    seed[:, 0] = True
    sm = [np.zeros((h, w), bool) for _ in range(4)]
    args = [seed, member, *sm]
    out = _dispatched(args, 8)
    assert not np.any(out[:, 1:])
    np.testing.assert_array_equal(
        out, np.asarray(region_grow_xla(*_jax(args), steps=8)))


def test_batched_planes_match_region_grow_batch():
    args = _scene(seed=2, planes=3)
    out = _dispatched(args, 64)
    ref = np.asarray(_region_grow_batch(*_jax(args), steps=64))
    np.testing.assert_array_equal(out, ref)
