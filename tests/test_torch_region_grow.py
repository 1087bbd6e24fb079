"""The port's region grow against the JAX package's flood fills.

On the CPU ``region_grow`` runs its plain version ``region_grow_torch``;
both must be bit-equal to ``region_grow_xla``, to the Pallas kernel in
interpret mode, and, batched over planes, to ``_region_grow_batch`` (the
cases of ``tests/test_pallas_kernels.py`` plus P = 3). The CUDA kernel is
held bit-equal to the plain version on the card in
``test_torch_kernels_cuda.py``; here a numpy emulation of its arithmetic
(packed words, bands, halo exchange, early exit) is.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
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


# -- the CUDA kernel's arithmetic, emulated in numpy ------------------------
#
# The kernel cannot run without a card, so its design is held to the plain
# version here: bits packed 32 to a word (by the kernel's own byte-to-bit
# multiplications on the wide path), carries across words, C bands that each
# step K ghost rows on either side themselves and exchange them every K
# steps through slots double-buffered by the exchange's parity, padding bits
# and rows outside the image zero, and the cluster-wide stamped early exit.
# Band, word, step and shared-memory arithmetic come from the wrapper's own
# functions.

grow = sys.modules["graph_slam_tpu_torch.planes.region_grow"]
U32 = np.uint32


def _nonzero4(x):
    """``nonzero4`` of the kernel: the 4 bytes of each word -> 4 bits."""
    t = (((x & U32(0x7f7f7f7f)) + U32(0x7f7f7f7f)) | x) & U32(0x80808080)
    return (((t >> U32(7)) * U32(0x00204081)) >> U32(21)) & U32(0xf)


def _spread4(b):
    """``spread4`` of the kernel: 4 bits -> 4 bytes of 0/1."""
    return ((b & U32(0xf)) * U32(0x00204081)) & U32(0x01010101)


def _pack(a, W):
    """(rows, W) bytes -> (rows, wpr) words, bit b of word k = column 32k+b."""
    rows, wpr = a.shape[0], grow.words_per_row(W)
    if W % 16 == 0:     # the wide path: 16-byte chunks, two to a word
        padded = np.zeros((rows, 32 * wpr), np.uint8)
        padded[:, :W] = a
        n = _nonzero4(padded.view("<u4").reshape(rows, 2 * wpr, 4))
        half = (n[..., 0] | (n[..., 1] << U32(4)) | (n[..., 2] << U32(8))
                | (n[..., 3] << U32(12)))
        return half[:, 0::2] | (half[:, 1::2] << U32(16))
    bits = np.zeros((rows, 32 * wpr), U32)
    bits[:, :W] = a != 0
    return (bits.reshape(rows, wpr, 32) << np.arange(32, dtype=U32)).sum(
        -1, dtype=U32)


def _unpack(words, W):
    rows, wpr = words.shape
    if W % 16 == 0:
        half = np.stack([words & U32(0xffff), words >> U32(16)], -1).reshape(
            rows, 2 * wpr)[:, :W // 16]
        quads = np.stack([_spread4(half >> U32(s)) for s in (0, 4, 8, 12)], -1)
        return np.ascontiguousarray(quads.astype("<u4")).view(np.uint8).reshape(
            rows, W)
    bits = (words[:, :, None] >> np.arange(32, dtype=U32)) & U32(1)
    return bits.reshape(rows, 32 * wpr)[:, :W].astype(np.uint8)


def _pack_image_rows(a, y_first, rows, W):
    """Image rows [y_first, y_first + rows) packed; rows outside are 0."""
    ext = np.zeros((rows, W), np.uint8)
    lo, hi = max(y_first, 0), min(y_first + rows, a.shape[0])
    if hi > lo:
        ext[lo - y_first:hi - y_first] = a[lo:hi]
    return _pack(ext, W)


def _step(c, gl, gr, gu, gd):
    """One step on packed rows, the gates with member folded in; the first
    and last row of the result are not valid (their outer neighbours are
    missing) and are returned 0."""
    zero = np.zeros((c.shape[0], 1), U32)
    left = (c << U32(1)) | np.concatenate([zero, c[:, :-1] >> U32(31)], 1)
    right = (c >> U32(1)) | np.concatenate([c[:, 1:] << U32(31), zero], 1)
    n = np.zeros_like(c)
    n[1:-1] = (c[1:-1] | (left[1:-1] & gl[1:-1]) | (right[1:-1] & gr[1:-1])
               | (c[:-2] & gu[1:-1]) | (c[2:] & gd[1:-1]))
    return n


def _emulate_plane(seed, member, gates, steps, C, K=None):
    """One cluster: returns the (H, W) byte mask and the steps it ran."""
    H, W = seed.shape
    wpr = grow.words_per_row(W)
    K = grow.sub_steps(H, W, C) if K is None else K
    E = grow.band_rows(H, C) + 2 * K
    blocks = []
    for rank in range(C):
        r0, r1 = grow.band(H, C, rank)
        assert r1 == r0 or r1 - r0 >= K or C == 1
        packed = [_pack_image_rows(a, r0 - K, E, W)
                  for a in (seed, member, *gates)]
        blocks.append(dict(
            r0=r0, rows=r1 - r0, cur=packed[0] & packed[1],
            nxt=np.zeros_like(packed[0]),
            gates=[g & packed[1] for g in packed[2:]],   # member folded in
            live=(r1 - r0 + 2 * K) if r1 > r0 else 0,
            stage=np.zeros((2, 2, K, wpr), U32),   # [parity][top, bottom]
            flag=np.zeros(2, U32)))
    assert sum(b["rows"] for b in blocks) == H
    assert 4 * (6 * E * wpr + 4 * K * wpr + 2) == grow.smem_bytes(H, W, C, K)

    done, ran, group = 0, 0, 0
    while done < steps:
        par = group & 1
        kk = 1 if group == 0 else min(K, steps - done)
        ran += kk
        for rank, b in enumerate(blocks):
            changed = False
            for j in range(1, kk + 1):
                lo, hi = j, b["live"] - j       # rows this step computes
                if hi <= lo:
                    continue
                n = b["nxt"]                    # its other rows stay stale
                window = slice(lo - 1, hi + 1)
                n[lo:hi] = _step(b["cur"][window],
                                 *(g[window] for g in b["gates"]))[1:-1]
                if j == kk:     # the band's rows, in the exchange's last step
                    changed = bool((n[lo:hi] != b["cur"][lo:hi]).any())
                b["cur"], b["nxt"] = n, b["cur"]
            if b["rows"]:
                own = b["cur"][K:K + b["rows"]]
                if rank > 0:
                    blocks[rank - 1]["stage"][par, 1] = own[:K]
                if b["r0"] + b["rows"] < H:
                    blocks[rank + 1]["stage"][par, 0] = own[-K:]
            if changed:
                for other in blocks:
                    other["flag"][par] = group + 1
        # the exchange's one cluster barrier
        go_on = {int(b["flag"][par]) == group + 1 for b in blocks}
        assert len(go_on) == 1              # every block leaves together
        if not go_on.pop():
            break
        done += kk
        if done < steps:
            for rank, b in enumerate(blocks):
                if b["rows"] and rank > 0:
                    b["cur"][:K] = b["stage"][par, 0]
                if b["rows"] and b["r0"] + b["rows"] < H:
                    b["cur"][K + b["rows"]:2 * K + b["rows"]] = \
                        b["stage"][par, 1]
        group += 1
    out = np.concatenate([_unpack(b["cur"][K:K + b["rows"]], W)
                          for b in blocks])
    return out, ran


@pytest.mark.parametrize("steps", [0, 1, 64])
@pytest.mark.parametrize("C", grow.CLUSTER_SIZES)
@pytest.mark.parametrize("h,w", [(13, 1), (5, 20), (13, 31), (3, 33),
                                 (21, 97), (13, 176), (6, 64), (40, 48)])
def test_kernel_arithmetic_emulated_matches_plain_version(h, w, C, steps):
    r = np.random.default_rng(1000 * h + 10 * w + C + steps)
    P = 2
    member = (r.random((P, h, w)) < 0.75) * r.integers(1, 256, (P, h, w))
    seed = np.zeros((P, h, w), np.int64)
    seed[0, h // 2, w // 2] = 7
    seed[1, :, 0] = 255                     # a seed on the left edge
    seed[1, -1, -1] = 1
    gates = [(r.random((h, w)) < 0.9) * r.integers(1, 256, (h, w))
             for _ in range(4)]
    seed, member = seed.astype(np.uint8), member.astype(np.uint8)
    gates = [g.astype(np.uint8) for g in gates]
    ref = region_grow_torch(*[torch.as_tensor(a != 0)
                              for a in (seed, member, *gates)],
                            steps=steps).numpy()
    for p in range(P):
        out, ran = _emulate_plane(seed[p], member[p], gates, steps, C)
        np.testing.assert_array_equal(out, ref[p].astype(np.uint8))
        assert ran <= steps


@pytest.mark.parametrize("K", [1, 2, 3, 4])
@pytest.mark.parametrize("steps", [5, 64])
def test_emulated_steps_between_exchanges(K, steps):
    """Any number of steps between exchanges gives the plain version's
    answer, also where the last exchange is cut short by ``steps``."""
    h, w, C = 37, 80, 4
    r = np.random.default_rng(K + steps)
    member = (r.random((h, w)) < 0.8).astype(np.uint8)
    seed = np.zeros((h, w), np.uint8)
    seed[h // 2, w // 2] = seed[0, 0] = 1
    gates = [(r.random((h, w)) < 0.95).astype(np.uint8) for _ in range(4)]
    ref = region_grow_torch(*[torch.as_tensor(a != 0)
                              for a in (seed, member, *gates)],
                            steps=steps).numpy()
    out, _ = _emulate_plane(seed, member, gates, steps, C, K=K)
    np.testing.assert_array_equal(out, ref.astype(np.uint8))


def test_emulated_early_exit_is_exact():
    """A fill that reaches its fixed point early stops at the first
    exchange whose last step changed nothing, in every cluster size, with
    the full answer."""
    h, w = 12, 40
    member = np.ones((h, w), np.uint8)
    seed = np.zeros((h, w), np.uint8)
    seed[0, 0] = 1
    gates = [np.ones((h, w), np.uint8) for _ in range(4)]
    last_change = (h - 1) + (w - 1)
    for C in grow.CLUSTER_SIZES:
        K = grow.sub_steps(h, w, C)
        out, ran = _emulate_plane(seed, member, gates, 200, C)
        assert out.all()
        assert ran == 1 + K * -(-last_change // K)    # exchanges at 1, 1+K, ..


@pytest.mark.parametrize("h,w", [(480, 640), (144, 176), (1200, 1600),
                                 (61, 97), (5, 1000), (1, 1)])
def test_launch_plan_arithmetic(h, w):
    C = grow.cluster_size(h, w)
    assert C in grow.CLUSTER_SIZES
    assert grow.smem_bytes(h, w, C, grow.sub_steps(h, w, C)) <= grow._MAX_SMEM
    for c in grow.CLUSTER_SIZES:
        bands = [grow.band(h, c, r) for r in range(c)]
        assert bands[0][0] == 0 and bands[-1][1] == h
        assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
        assert all(0 <= r1 - r0 <= grow.band_rows(h, c) for r0, r1 in bands)
        K = grow.sub_steps(h, w, c)
        assert 1 <= K <= grow._MAX_SUB_STEPS
        assert all(r1 - r0 >= K for r0, r1 in bands if r1 > r0) or c == 1
        threads = grow.block_threads(h, w, c, K)
        assert threads % 32 == 0
        assert grow.words_per_row(w) <= threads <= grow._MAX_THREADS


def test_launch_plan_sizes_and_limits():
    # a 640x480 band of 60 rows and 2 * 8 ghost rows: 6 arrays of 76 * 20
    # words, 4 * 8 staged rows and two flags
    assert grow.sub_steps(480, 640, 8) == 8
    assert grow.smem_bytes(480, 640, 8, 8) == 4 * (6 * 76 * 20 + 32 * 20 + 2)
    assert grow.cluster_size(480, 640) == 8     # several blocks on a plane
    assert grow.cluster_size(144, 176) == 8
    assert grow.cluster_size(24, 40) == 1       # 48 words: one block
    assert grow.cluster_size(20, 4000) == 1     # bands of 3 rows: one block
    assert grow.cluster_size(1200, 1600) == 8   # fits only cut into 8 bands
    with pytest.raises(ValueError, match="shared memory"):
        grow.cluster_size(2400, 3200)


def test_checks_name_the_callers_argument_and_shape():
    h, w = 6, 8
    ok = torch.zeros(h, w, dtype=torch.bool)
    gates = [ok] * 4
    grow._check(ok, ok, gates, 4)
    grow._check(ok[None], ok[None], gates, 4)
    with pytest.raises(ValueError, match=r"member has shape \(1, 6, 8\), "
                                         r"expected \(6, 8\)"):
        grow._check(ok, ok[None], gates, 4)
    with pytest.raises(ValueError, match=r"sm_u has shape \(8, 6\)"):
        grow._check(ok, ok, [ok, ok, ok.T.contiguous(), ok], 4)
    with pytest.raises(ValueError, match=r"sm_r of shape \(6, 8\) must be "
                                         r"contiguous"):
        grow._check(ok, ok, [ok, torch.zeros(w, h, dtype=torch.bool).T, ok,
                             ok], 4)
    with pytest.raises(TypeError, match="seed must be bool or uint8"):
        grow._check(ok.float(), ok, gates, 4)
    with pytest.raises(ValueError, match=r"seed must be \(H, W\) or "
                                         r"\(P, H, W\), got shape \(8,\)"):
        grow._check(ok[0], ok, gates, 4)
    with pytest.raises(ValueError, match="steps must be >= 0"):
        grow._check(ok, ok, gates, -1)
