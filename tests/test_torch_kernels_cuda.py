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


def test_log_depth_preintegration_on_the_card_matches_the_oracle():
    """The log-depth preintegration on CUDA against the sequential oracle
    on the CPU, on a padded 64-sample window (float64; the two orders of
    evaluation agree to roundoff)."""
    from graph_slam_tpu_torch import imu

    dev = _cuda()
    r = np.random.default_rng(0)
    acc = r.normal(size=(64, 3)) + np.array([0.0, 0.0, 9.81])
    gyr = r.normal(size=(64, 3)) * 0.5
    dt = np.full(64, 0.005)
    dt[45:] = 0.0
    b = r.normal(size=6) * 0.02
    cpu = imu.vn100_params(device="cpu")
    ref = imu.integrate_segment_scan(imu.init_preint(b, cpu, device="cpu"),
                                     acc, gyr, dt, cpu)
    card = imu.vn100_params(device=dev)
    out = imu.integrate_segment(imu.init_preint(b, card, device=dev),
                                acc, gyr, dt, card)
    for f in ref._fields:
        a, c = getattr(out, f), getattr(ref, f)
        assert a.device.type == "cuda"
        np.testing.assert_allclose(a.cpu().numpy(), c.numpy(),
                                   rtol=1e-9 if f == "cov" else 0,
                                   atol=1e-300 if f == "cov" else 1e-10,
                                   err_msg=f)


@pytest.mark.parametrize("window", [None, 8])
def test_run_vio_on_the_card_matches_the_cpu(window):
    """A small VIO scan replay on CUDA against the same replay on the CPU
    (float64, atol 1e-8: cuSOLVER's QR and the card's atomics sum in
    another order)."""
    from graph_slam_tpu_torch.datasets import make_vio_plane_scenario
    from graph_slam_tpu_torch.pipelines import VioConfig, run_vio

    dev = _cuda()
    cfg = VioConfig(engine="scan", plane_mode="off", optimize_step=10,
                    max_imu_window=32, window=window,
                    final_batch=True)
    runs = []
    for device in ("cpu", dev):
        log, times, stream, params, _, _ = make_vio_plane_scenario(
            60, fail_every=20, render=False, device=device)
        runs.append(run_vio(log, times, stream, params, cfg=cfg,
                            device=device))
    cpu_run, card_run = runs
    assert card_run.values.pose_t.device.type == "cuda"
    assert (card_run.n_imu_factors, card_run.n_vo_edges) == \
        (cpu_run.n_imu_factors, cpu_run.n_vo_edges) == (59, 57)
    n = len(cpu_run.seq_ids)
    for f in ("pose_R", "pose_t", "vel", "bias"):
        np.testing.assert_allclose(
            getattr(card_run.values, f)[:n].cpu().numpy(),
            getattr(cpu_run.values, f)[:n].numpy(), rtol=0, atol=1e-8,
            err_msg=f)
    for a, b in zip(card_run.chi2_log.rows, cpu_run.chi2_log.rows):
        assert a[:2] == b[:2]
        assert abs(a[3] - b[3]) <= 1e-8 * max(1.0, abs(b[3]))


def test_imu_jacobian_on_the_card_is_finite_at_identity():
    """The IMU row's closed-form Jacobian on CUDA at identity rotations
    (``logmap`` on its Taylor branch, zero residual): finite and equal to
    the CPU's."""
    from graph_slam_tpu_torch.graph import factors

    dev = _cuda()
    out = []
    for device in ("cpu", dev):
        eye = torch.eye(3, dtype=torch.float64, device=device).expand(2, 3, 3)
        z3 = torch.zeros(2, 3, dtype=torch.float64, device=device)
        z6 = torch.zeros(2, 6, dtype=torch.float64, device=device)
        g = torch.tensor([0.0, 0.0, -9.81], dtype=torch.float64,
                         device=device).expand(2, 3)
        H = torch.full((2, 3, 3), 0.01, dtype=torch.float64, device=device)
        rows = factors._ImuRows(eye, z3, z3, z6, eye, 0.5 * g * 0.01,
                                g * 0.1, z6, eye, z3, z3, H, H, H, H, H, z6,
                                torch.full((2,), 0.1, dtype=torch.float64,
                                           device=device), g)
        parts = factors._imu_parts(rows)
        assert float(parts.e.abs().max()) < 1e-12
        out.append(factors._imu_jacobian(rows, parts).cpu())
    assert bool(torch.isfinite(out[1]).all())
    np.testing.assert_allclose(out[1].numpy(), out[0].numpy(), rtol=0,
                               atol=1e-12)


def _to(x, device):
    if isinstance(x, tuple):
        return type(x)(*(_to(f, device) for f in x))
    return x.to(device)


def _max_diff(a, b, n):
    return max(float((getattr(a, f)[:n].cpu() - getattr(b, f)[:n].cpu())
                     .abs().max()) for f in ("pose_R", "pose_t", "vel",
                                             "bias"))


def test_windowed_gn_and_lm_on_the_card_match_the_cpu_from_perturbed_values():
    """The fixed-lag step (window 16, two GN iterations) and the final LM on
    CUDA against the CPU, from a 60-frame replay's values with frames
    moved by 0.01 rad / m, so that both take real steps (the replay itself
    is exact). Float64; atol 1e-9 for the step and 1e-8 for the LM, whose
    dense Cholesky factors sum in another order on the card."""
    from graph_slam_tpu_torch.core import so3
    from graph_slam_tpu_torch.datasets import make_vio_plane_scenario
    from graph_slam_tpu_torch.graph import LMParams, lm_optimize, total_error
    from graph_slam_tpu_torch.graph.online import window_graph, windowed_gn
    from graph_slam_tpu_torch.pipelines import VioConfig, run_vio
    from graph_slam_tpu_torch.graph.online import (_window_caps,
                                                   _window_starts)

    dev = _cuda()
    log, times, stream, params, _, _ = make_vio_plane_scenario(
        60, fail_every=20, render=False, device=dev)
    res = run_vio(log, times, stream, params, device=dev,
                  cfg=VioConfig(engine="scan", plane_mode="off", window=16,
                                max_imu_window=64, final_batch=False))
    n, W = len(res.seq_ids), 16
    r = np.random.default_rng(0)

    def perturbed(lo):
        v = _to(res.values, "cpu")
        v.pose_R[lo:n] = so3.expmap(torch.as_tensor(
            r.normal(size=(n - lo, 3)) * 0.01)) @ v.pose_R[lo:n]
        v.pose_t[lo:n] += torch.as_tensor(r.normal(size=(n - lo, 3)) * 0.01)
        v.vel[lo:n] += torch.as_tensor(r.normal(size=(n - lo, 3)) * 0.01)
        return v

    vw, v0 = perturbed(n - W), perturbed(1)   # the window; all but frame 0

    caps = _window_caps(res.graph, W)
    starts = _window_starts({"prior_pose": 1, "prior_vel": 1,
                             "prior_bias": 1, "between": len(log),
                             "imu": n - 1}, caps)
    gn, lm = [], []
    for device in (dev, "cpu"):
        graph, values = _to(res.graph, device), _to(vw, device)
        win = window_graph(graph, starts, caps)
        e0 = float(total_error(win, values))
        gn.append((e0,) + windowed_gn(win, values, [n - W] * 3 + [0, 0],
                                      (W, W, W), 1e-6, 2))
        lm.append(lm_optimize(graph, _to(v0, device), LMParams()))
    (e0, v_card, e_card), (_, v_cpu, e_cpu) = gn
    assert v_card.pose_t.device.type == dev.type
    assert float(e_card) <= 1e-3 * e0, (e0, float(e_card))   # real steps
    assert abs(float(e_card) - float(e_cpu)) <= 1e-9 * max(1.0, float(e_cpu))
    assert _max_diff(v_card, v_cpu, n) <= 1e-9
    # frames before the window stay where they were
    assert torch.equal(v_card.pose_t[:n - W].cpu(), vw.pose_t[:n - W])
    assert lm[0].iterations == lm[1].iterations
    assert float(lm[0].error) <= 1e-12 * float(total_error(res.graph,
                                                           _to(v0, dev)))
    assert _max_diff(lm[0].values, lm[1].values, n) <= 1e-8


def test_rescue_replay_on_the_card_matches_the_cpu():
    """The plane-rescue replay (200 frames, every 20th VO edge failed,
    SR4000 frames of the two-plane room) on CUDA against the CPU, float64:
    the RANSAC uniforms are drawn on the CPU for both, so the counts are
    equal; positions atol 1e-8 m and chi2 1e-8 relative. Every prediction
    launched the region grow once on the card."""
    from graph_slam_tpu_torch.datasets import make_vio_plane_scenario
    from graph_slam_tpu_torch.pipelines import VioConfig, run_vio

    dev = _cuda()
    cfg = VioConfig(engine="scan", plane_mode="rescue", optimize_step=10,
                    max_imu_window=64, window=16, final_batch=False)
    log, times, stream, params, frames, K = make_vio_plane_scenario(
        200, fail_every=20, render="lazy", device=dev)
    runs = []
    for device in ("cpu", dev):
        before = region_grow.launches
        runs.append(run_vio(log, times, stream, params, frames=frames,
                            intrinsics=K, cfg=cfg, device=device))
        launched = region_grow.launches - before
    cpu_run, card_run = runs
    assert card_run.values.pose_t.device.type == "cuda"
    assert card_run.timers["rescue_step"]["calls"] == 9
    assert launched == card_run.plane_stack.n_predict > 0
    counts = [(r.n_plane_factors, len(r.plane_book.world), r.n_imu_factors,
               r.n_vo_edges) for r in runs]
    assert counts[0] == counts[1] and counts[0][0] > 0
    n = len(cpu_run.seq_ids)
    np.testing.assert_allclose(card_run.values.pose_t[:n].cpu().numpy(),
                               cpu_run.values.pose_t[:n].numpy(), rtol=0,
                               atol=1e-8)
    for a, b in zip(card_run.chi2_log.rows, cpu_run.chi2_log.rows):
        assert a[:2] == b[:2]
        assert abs(a[3] - b[3]) <= 1e-8 * max(1.0, abs(b[3]))


@pytest.mark.parametrize("mode,window,rescues", [("rescue", 16, 9),
                                                ("always", None, 199)])
def test_online_rescue_on_the_card_matches_the_cpu(mode, window, rescues):
    """The online engine's plane replay (200 frames, every 20th VO edge
    failed, SR4000 frames of the two-plane room) on CUDA against the CPU,
    float64: counts equal, positions atol 1e-8 m, chi2 1e-8 relative; the
    rescue runs on each failed new frame, or with ``plane_mode="always"``
    on every new frame (there with the full-arena dense update), and every
    prediction launched the region grow once on the card."""
    from graph_slam_tpu_torch.datasets import make_vio_plane_scenario
    from graph_slam_tpu_torch.pipelines import VioConfig, run_vio

    dev = _cuda()
    cfg = VioConfig(engine="online", plane_mode=mode, optimize_step=10,
                    max_imu_window=64, bucket=64, window=window,
                    final_batch=False)
    log, times, stream, params, frames, K = make_vio_plane_scenario(
        200, fail_every=20, render="lazy", device=dev)
    runs = []
    for device in ("cpu", dev):
        before = region_grow.launches
        runs.append(run_vio(log, times, stream, params, frames=frames,
                            intrinsics=K, cfg=cfg, device=device))
        launched = region_grow.launches - before
    cpu_run, card_run = runs
    assert card_run.values.pose_t.device.type == "cuda"
    assert card_run.timers["rescue_step"]["calls"] == rescues
    assert launched == card_run.plane_stack.n_predict > 0
    counts = [(r.n_plane_factors, len(r.plane_book.world), r.n_imu_factors,
               r.n_vo_edges, r.plane_stack.n_predict) for r in runs]
    assert counts[0] == counts[1] and counts[0][0] > 0
    n = len(cpu_run.seq_ids)
    np.testing.assert_allclose(card_run.values.pose_t[:n].cpu().numpy(),
                               cpu_run.values.pose_t[:n].numpy(), rtol=0,
                               atol=1e-8)
    for a, b in zip(card_run.chi2_log.rows, cpu_run.chi2_log.rows):
        assert a[:2] == b[:2]
        assert abs(a[3] - b[3]) <= 1e-8 * max(1.0, abs(b[3]))


def test_online_plane_free_replay_on_the_card_matches_the_cpu():
    """The online fast path (no plane stack, the chi2 gate on) with the
    default full-arena dense update on CUDA against the CPU, float64."""
    from graph_slam_tpu_torch.datasets import make_vio_plane_scenario
    from graph_slam_tpu_torch.pipelines import VioConfig, run_vio

    dev = _cuda()
    cfg = VioConfig(plane_mode="off", optimize_step=10, max_imu_window=32,
                    bucket=64, chi2_vro_gate=True, final_batch=True)
    runs = []
    for device in ("cpu", dev):
        log, times, stream, params, _, _ = make_vio_plane_scenario(
            60, fail_every=20, render=False, device=device)
        runs.append(run_vio(log, times, stream, params, cfg=cfg,
                            device=device))
    cpu_run, card_run = runs
    assert card_run.values.pose_t.device.type == "cuda"
    assert card_run.timers["fused_frame"]["calls"] == 59
    assert (card_run.n_imu_factors, card_run.n_vo_edges) == \
        (cpu_run.n_imu_factors, cpu_run.n_vo_edges)
    n = len(cpu_run.seq_ids)
    for f in ("pose_R", "pose_t", "vel", "bias"):
        np.testing.assert_allclose(
            getattr(card_run.values, f)[:n].cpu().numpy(),
            getattr(cpu_run.values, f)[:n].numpy(), rtol=0, atol=1e-8,
            err_msg=f)
    for a, b in zip(card_run.chi2_log.rows, cpu_run.chi2_log.rows):
        assert a[:2] == b[:2]
        assert abs(a[3] - b[3]) <= 1e-8 * max(1.0, abs(b[3]))


def test_plane_extraction_on_the_card_matches_the_cpu():
    """RANSAC extraction of a rendered SR4000 frame with the same draw on
    the card and on the CPU: masks bit-equal, parameters 1e-9 (float64)."""
    from graph_slam_tpu_torch.config import SR4000
    from graph_slam_tpu_torch.datasets.synthetic import _render_plane_frame
    from graph_slam_tpu_torch.planes import extract_plane_node

    dev = _cuda()
    scene = [(np.array([0.0, 0.0, 1.0, -4.0]), 150.0),
             (np.array([0.0, 1.0, 0.0, -0.8]), 80.0)]
    _, depth = _render_plane_frame(SR4000, np.eye(3),
                                       np.array([0.05, 0.0, 0.1]), scene,
                                       noise=0.002, seed=1)
    dets = [extract_plane_node((0, 0, 1), SR4000, depth, device=d,
                               dtype=torch.float64) for d in ("cpu", dev)]
    assert len(dets[0]) == len(dets[1]) == 2
    np.testing.assert_array_equal(dets[1].masks, dets[0].masks)
    np.testing.assert_allclose(dets[1].params, dets[0].params, atol=1e-9)


def test_plane_jacobian_on_the_card_matches_the_cpu():
    """The plane factor's closed-form Jacobian on CUDA, coincident normals
    included, in float64 and float32: finite and equal to the CPU's."""
    from graph_slam_tpu_torch.core import so3
    from graph_slam_tpu_torch.graph import factors

    dev = _cuda()
    r = np.random.default_rng(0)
    R = so3.expmap(torch.as_tensor(r.normal(size=(6, 3)) * 0.5))
    t = torch.as_tensor(r.normal(size=(6, 3)))
    n = torch.nn.functional.normalize(torch.as_tensor(r.normal(size=(6, 3))),
                                      dim=-1)
    L = torch.cat([n, torch.as_tensor(r.normal(size=(6, 1)))], -1)
    n_p = (R.transpose(-1, -2) @ n[..., None])[..., 0]
    meas = torch.cat([n_p, (L[:, 3] + (n * t).sum(-1))[:, None]], -1)
    meas[3:, :3] = torch.nn.functional.normalize(
        meas[3:, :3] + 0.05 * torch.as_tensor(r.normal(size=(3, 3))), dim=-1)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        out = [factors._plane_jacobian(factors._PlaneRows(
            *(x.to(device, dtype) for x in (R, t, L, meas)))).cpu()
            for device in ("cpu", dev)]
        assert bool(torch.isfinite(out[1]).all())
        np.testing.assert_allclose(out[1].numpy(), out[0].numpy(), rtol=0,
                                   atol=tol)


# -- the pose-graph backend on the card (no hand kernel: cuSOLVER, cuBLAS
# and torch's scatter-adds), float64, card against CPU --------------------


def _graph_to(x, device):
    if isinstance(x, tuple):
        return type(x)(*(_graph_to(f, device) for f in x))
    return x.to(device)


def _corrupted_sphere(n=120, n_bad=8, seed=7):
    """A sphere with ``n_bad`` loop closures replaced by garbage (the
    reference's ``tests/test_pcm.py`` scenario), on the CPU."""
    from graph_slam_tpu_torch.datasets import make_sphere_graph
    from graph_slam_tpu_torch.datasets.synthetic import _so3_exp

    graph, values, _ = make_sphere_graph(n, 3.0, seed=0, bucket=64,
                                         dtype=torch.float64, device="cpu")
    bt = graph.between
    act, i, j = bt.active.numpy(), bt.i.numpy(), bt.j.numpy()
    idx = np.flatnonzero(act)
    loops = idx[(j[idx] - i[idx]) > 1]
    rng = np.random.default_rng(seed)
    bad = rng.choice(loops, size=n_bad, replace=False)
    R, t = bt.meas_R.clone(), bt.meas_t.clone()
    for e in bad:
        R[e] = torch.as_tensor(_so3_exp(rng.normal(size=3)))
        t[e] = torch.as_tensor(rng.normal(size=3) * 3.0)
    return graph._replace(between=bt._replace(meas_R=R, meas_t=t)), values, \
        bad


def test_pcm_on_the_card_matches_the_cpu():
    from graph_slam_tpu_torch.graph import pcm_mask

    dev = _cuda()
    graph, values, bad = _corrupted_sphere()
    cpu = pcm_mask(graph, values)
    card = pcm_mask(_graph_to(graph, dev), _graph_to(values, dev))
    np.testing.assert_array_equal(card.accepted, cpu.accepted)
    np.testing.assert_array_equal(card.clique_rows, cpu.clique_rows)
    np.testing.assert_allclose(card.m2, cpu.m2, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(card.m2_odo, cpu.m2_odo, rtol=1e-9)
    assert not card.accepted[bad].any()


def test_chordal_and_gnc_on_the_card_match_the_cpu():
    from graph_slam_tpu_torch.graph import chordal_initialize, gnc_optimize

    dev = _cuda()
    graph, values, bad = _corrupted_sphere()
    cand = (graph.between.j - graph.between.i) != 1
    outs = []
    for d in ("cpu", dev):
        g, v = _graph_to(graph, d), _graph_to(values, d)
        res = gnc_optimize(g, v, candidates=cand.to(d), kind="tls",
                           solver="pcg", damping=1e-3)
        outs.append((chordal_initialize(g, v), res))
    (ch_cpu, g_cpu), (ch, g_card) = outs
    for f in ("pose_R", "pose_t"):
        np.testing.assert_allclose(getattr(ch, f).cpu().numpy(),
                                   getattr(ch_cpu, f).numpy(), atol=1e-9)
        np.testing.assert_allclose(getattr(g_card.values, f).cpu().numpy(),
                                   getattr(g_cpu.values, f).numpy(),
                                   atol=1e-9)
    np.testing.assert_array_equal(g_card.inliers.cpu().numpy(),
                                  g_cpu.inliers.numpy())
    assert not g_card.inliers.cpu().numpy()[bad].any()


def test_lm_optimize_g2o_and_marginalization_on_the_card_match_the_cpu():
    from graph_slam_tpu_torch.datasets import make_sphere_graph
    from graph_slam_tpu_torch.graph import (gn_optimize, lm_optimize_g2o,
                                            marginalize_poses, total_error)

    dev = _cuda()
    graph, values, _ = make_sphere_graph(100, 4.0, seed=1, bucket=64,
                                         dtype=torch.float64, device="cpu")
    h_cpu = lm_optimize_g2o(graph, values).history.numpy()
    h = lm_optimize_g2o(_graph_to(graph, dev), _graph_to(values, dev)) \
        .history.cpu().numpy()
    np.testing.assert_allclose(h, h_cpu, rtol=1e-9)
    full = gn_optimize(graph, values, iterations=10, damping=1e-9).values
    drop = np.arange(1, 99, 2)
    m_cpu = marginalize_poses(graph, full, drop)
    m = marginalize_poses(_graph_to(graph, dev), _graph_to(full, dev), drop)
    assert m[2] == m_cpu[2]
    for name in ("prior_pose", "between"):
        for a, c in zip(getattr(m[0], name), getattr(m_cpu[0], name)):
            np.testing.assert_allclose(a.cpu().numpy(), c.numpy(),
                                       rtol=1e-9, atol=1e-9)
    e, e_cpu = float(total_error(*m[:2])), float(total_error(*m_cpu[:2]))
    assert abs(e - e_cpu) <= 1e-9 * e_cpu


def test_solvers_on_the_card_match_the_cpu():
    """The gather path, both banded solvers and the fleet's per-graph CG."""
    from graph_slam_tpu_torch.datasets import make_sphere_graph
    from graph_slam_tpu_torch.graph import (band_halfwidth,
                                            banded_direct_gn_optimize,
                                            banded_gn_optimize,
                                            build_incidence, gn_optimize,
                                            gn_optimize_many, stack_pytrees)

    dev = _cuda()
    pairs = [make_sphere_graph(60, 3.0, seed=s, bucket=4,
                               dtype=torch.float64, device="cpu")[:2]
             for s in range(3)]
    g, v = pairs[0]
    W = band_halfwidth(g)
    runs = {
        "gather": lambda g, v: gn_optimize(
            g, v, iterations=4, solver="pcg", pcg_iters=100, damping=1e-6,
            inc=build_incidence(g, v)).values,
        "banded": lambda g, v: banded_gn_optimize(
            g, v, iterations=4, band_w=W, damping=1e-6, pcg_iters=100)[0],
        "banded_direct": lambda g, v: banded_direct_gn_optimize(
            g, v, iterations=4, band_w=W, damping=1e-6)[0],
    }
    for name, run in runs.items():
        cpu = run(g, v).pose_t.numpy()
        card = run(_graph_to(g, dev), _graph_to(v, dev)).pose_t.cpu().numpy()
        np.testing.assert_allclose(card, cpu, atol=1e-9, err_msg=name)
    graphs = stack_pytrees([_graph_to(x, dev) for x, _ in pairs])
    arenas = stack_pytrees([_graph_to(y, dev) for _, y in pairs])
    fleet = gn_optimize_many(graphs, arenas, iterations=5, solver="pcg",
                             damping=1e-3, pcg_iters=30)
    for k, (gk, vk) in enumerate(pairs):
        single = gn_optimize(gk, vk, iterations=5, solver="pcg",
                             damping=1e-3, pcg_iters=30)
        np.testing.assert_allclose(fleet.values.pose_t[k].cpu().numpy(),
                                   single.values.pose_t.numpy(), atol=1e-9)


def test_lm_optimize_over_the_gather_pcg_on_the_card_matches_the_cpu():
    """``lm_optimize(inc=)`` on the 40-pose sphere of the CPU parity test
    (``test_torch_solvers.py``), float64."""
    from graph_slam_tpu_torch.datasets import make_sphere_graph
    from graph_slam_tpu_torch.graph import (LMParams, build_incidence,
                                            lm_optimize)

    dev = _cuda()
    g, v, _ = make_sphere_graph(40, 3.0, seed=2, bucket=8,
                                dtype=torch.float64, device="cpu")
    p = LMParams(solver="pcg")
    cpu = lm_optimize(g, v, p, inc=build_incidence(g, v))
    gd, vd = _graph_to(g, dev), _graph_to(v, dev)
    card = lm_optimize(gd, vd, p, inc=build_incidence(gd, vd))
    assert card.values.pose_t.is_cuda
    assert card.iterations == cpu.iterations
    assert abs(float(card.error) - float(cpu.error)) <= 1e-9 * float(cpu.error)
    np.testing.assert_allclose(card.values.pose_t.cpu().numpy(),
                               cpu.values.pose_t.numpy(), atol=1e-9)
    np.testing.assert_allclose(card.values.pose_R.cpu().numpy(),
                               cpu.values.pose_R.numpy(), atol=1e-9)


def test_sqrt_schur_step_and_linearize_blocks_on_the_card_match_the_cpu():
    """A bundle-adjustment graph in float64: its linearized blocks (the
    projection rows through the camera's clamps) and one square-root Schur
    step, whose reduced system the card assembles with atomic adds."""
    from graph_slam_tpu_torch.datasets import make_ba_graph
    from graph_slam_tpu_torch.graph import (build_point_obs, layout_of,
                                            linearize_blocks,
                                            sqrt_schur_gn_step)

    dev = _cuda()
    g, v, _ = make_ba_graph(12, 400, seed=3, dtype=torch.float64,
                            device="cpu", bucket=64)
    gd, vd = _graph_to(g, dev), _graph_to(v, dev)
    for (r, J, c), (rd, Jd, cd) in zip(linearize_blocks(g, v),
                                       linearize_blocks(gd, vd)):
        assert torch.equal(cd.cpu(), c)
        for a, b in ((rd, r), (Jd, J)):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                       atol=1e-9 * float(b.abs().max()))
    tabs = [torch.as_tensor(t) for t in build_point_obs(
        g, layout_of(v).point_cap)]
    cpu = sqrt_schur_gn_step(g, v, *tabs, 1e-3, chunk=128)
    card = sqrt_schur_gn_step(gd, vd, *[t.to(dev) for t in tabs], 1e-3,
                              chunk=128)
    for f in ("pose_R", "pose_t", "point"):
        np.testing.assert_allclose(getattr(card, f).cpu().numpy(),
                                   getattr(cpu, f).numpy(), rtol=0,
                                   atol=1e-9, err_msg=f)


# ------------------------------------------------- the visual frontend
def _room_frames(n, path=1000):
    """The first frames of ``chip_smoke.py``'s 640 x 480 box room."""
    import frontend_reference_ate as fra
    from graph_slam_tpu_torch.config import RS435

    tex, rays = fra.room_scene(RS435)
    R, t = fra.room_path(path)
    return RS435, [tuple(x.numpy() for x in fra.render_room_frame(
        RS435, R[k], t[k], tex, rays)) for k in range(n)]


@pytest.mark.parametrize("extractor", ["harris", "sift"])
def test_extractor_on_the_card_matches_the_cpu_at_640x480(extractor):
    """One 640 x 480 frame through each extractor on the card and on the
    CPU: the same keypoints, each with its descriptor within 1e-5 (float32
    sums in another order). Two keypoints whose responses agree to ~1e-6
    may trade slots in the top-k, so the keypoints are held as a set and
    each descriptor at its keypoint."""
    from graph_slam_tpu_torch.vision import get_extractor

    dev = _cuda()
    K, frames = _room_frames(1)
    img, depth = frames[0]
    fn = get_extractor(extractor)
    cpu = fn(K, img, depth, device="cpu")
    card = fn(K, img, depth, device=dev)
    assert card.uv.device.type == "cuda"
    assert int(cpu.valid.sum()) > 200

    uv, desc, pts3, valid = (x.cpu().numpy() for x in card)
    uv_c, desc_c, pts3_c, valid_c = (x.numpy() for x in cpu)
    assert sorted(map(tuple, uv)) == sorted(map(tuple, uv_c))
    for i in range(len(uv)):
        same = np.nonzero((uv_c == uv[i]).all(1))[0]
        err = np.abs(desc_c[same] - desc[i]).max(1)
        j = same[np.argmin(err)]
        assert err.min() < 1e-5, (i, uv[i], err.min())
        assert valid[i] == valid_c[j]
        np.testing.assert_allclose(pts3[i], pts3_c[j], atol=1e-5)


def test_frontend_convolutions_run_without_tf32(monkeypatch):
    """Every cuDNN convolution of the extractors runs with TF32 off while
    torch's default (TF32 allowed) stands outside them; a convolution on
    the card agrees with a float64 one to float32 rounding, which TF32's
    10-bit mantissa would miss by ~1e-3."""
    import torch.nn.functional as F

    from graph_slam_tpu_torch.vision import extract_features, sift_features
    from graph_slam_tpu_torch.vision.features import conv2

    dev = _cuda()
    assert torch.backends.cudnn.allow_tf32          # torch's default
    seen = []
    plain = F.conv2d

    def recording(*args, **kw):
        seen.append(torch.backends.cudnn.allow_tf32)
        return plain(*args, **kw)

    monkeypatch.setattr(F, "conv2d", recording)
    K, frames = _room_frames(1)
    img, depth = (torch.as_tensor(x, device=dev) for x in frames[0])
    extract_features(K, img, depth)
    sift_features(K, img, depth)
    assert len(seen) > 40 and not any(seen)
    assert torch.backends.cudnn.allow_tf32           # restored
    monkeypatch.undo()

    r = np.random.default_rng(0)
    x = r.uniform(0, 255, (480, 640))
    k = r.normal(size=(5, 5))
    card = conv2(torch.as_tensor(x, dtype=torch.float32, device=dev),
                 torch.as_tensor(k, dtype=torch.float32, device=dev))
    exact = conv2(torch.as_tensor(x), torch.as_tensor(k))
    err = float((card.cpu().double() - exact).abs().max()
                / exact.abs().max())
    assert err < 1e-5, err


def test_matchers_on_the_card_match_the_cpu():
    """The same features and the same keyed draws on the card and on the
    CPU: pairwise and batched RANSAC and PnP give the same inliers and
    transforms within 1e-5."""
    from graph_slam_tpu_torch.vision import (Cal3DS2, extract_features,
                                             match_frames_device,
                                             match_one_to_many, pnp_ransac)
    from graph_slam_tpu_torch.vision.features import stack_frames

    dev = _cuda()
    K, frames = _room_frames(5)
    cpu = [extract_features(K, i, d, device="cpu") for i, d in frames]
    card = [type(f)(*(x.to(dev) for x in f)) for f in cpu]
    for a, b in ((match_frames_device((0,), cpu[0], cpu[2]),
                  match_frames_device((0,), card[0], card[2])),
                 (match_one_to_many((1,), cpu[4], stack_frames(cpu[:3])),
                  match_one_to_many((1,), card[4], stack_frames(card[:3])))):
        R, t, info, n, ok = a
        Rd, td, infod, nd, okd = b
        assert torch.equal(okd.cpu(), ok) and torch.equal(nd.cpu(), n)
        assert bool(ok.all())
        for x, y in ((Rd, R), (td, t)):
            np.testing.assert_allclose(x.cpu().numpy(), y.numpy(), atol=1e-5)
        np.testing.assert_allclose(infod.cpu().numpy(), info.numpy(),
                                   rtol=1e-5, atol=1e-5 * float(
                                       info.abs().max()))
    cal = Cal3DS2.make(K.fx, K.fy, K.cx, K.cy, device="cpu")
    pts, uv = cpu[0].pts3.double(), cpu[2].uv.double()
    valid = cpu[0].valid & cpu[2].valid
    Rp, tp, mp, okp = pnp_ransac((2,), pts, uv, valid, cal)
    Rq, tq, mq, okq = pnp_ransac((2,), pts.to(dev), uv.to(dev),
                                 valid.to(dev), Cal3DS2.make(
                                     K.fx, K.fy, K.cx, K.cy, device=dev))
    assert bool(okq) == bool(okp) and torch.equal(mq.cpu(), mp)
    np.testing.assert_allclose(tq.cpu().numpy(), tp.numpy(), atol=1e-6)


def test_online_slam_on_the_card_matches_the_cpu():
    """Twelve 640 x 480 frames of the box room through ``OnlineSlam``
    (global tier on) on the card and on the CPU: the same statuses and
    edges, trajectories within 1e-5 m."""
    from graph_slam_tpu_torch.config import SlamParams
    from graph_slam_tpu_torch.pipelines import OnlineSlam

    _cuda()
    K, frames = _room_frames(12)
    runs = []
    for device in (None, "cpu"):
        slam = OnlineSlam(cam=K, params=SlamParams(optimize_step=3),
                          global_loop_k=2, global_loop_min_gap=3,
                          device=device)
        st = [slam.process_frame(i, d, seq_id=k)
              for k, (i, d) in enumerate(frames)]
        slam.optimize()
        runs.append((slam, st))
    (card, st_card), (cpu, st_cpu) = runs
    assert card.og.values.pose_t.device.type == "cuda"
    assert st_card == st_cpu and card.num_keyframes >= 6
    lc, lp = card.vro_log(), cpu.vro_log()
    np.testing.assert_array_equal(lc.id_from, lp.id_from)
    np.testing.assert_array_equal(lc.id_to, lp.id_to)
    np.testing.assert_allclose(card.trajectory()[1], cpu.trajectory()[1],
                               atol=1e-5)


def _room_volume(device, n, n_frames):
    """``n_frames`` 640 x 480 box-room frames fused into an n^3 grid over
    the room on ``device`` (float64 poses, as ``fuse_trajectory`` gives)."""
    import frontend_reference_ate as fra
    from graph_slam_tpu_torch.mapping import tsdf

    K, frames = _room_frames(n_frames)
    R, t = fra.room_path(1000)
    vol = tsdf.make_volume((-4.0, -2.0, -4.0), 8.0, n, device=device)
    for k, (_, depth) in enumerate(frames):
        tsdf.integrate(vol, K, torch.as_tensor(depth, device=vol.tsdf.device),
                       torch.as_tensor(R[k], device=vol.tsdf.device),
                       torch.as_tensor(t[k], device=vol.tsdf.device))
    return vol


def test_tsdf_integrate_on_the_card_matches_the_cpu(monkeypatch):
    """Ten box-room frames into a 128^3 grid on the card (in slabs of 16
    planes) and on the CPU: the weights differ on at most 1e-4 of the
    voxels (a voxel whose pixel lies at a centre +- 0.5 may round to
    another pixel), the tsdf within 1e-5 where both updated."""
    from graph_slam_tpu_torch.mapping import tsdf

    _cuda()
    monkeypatch.setattr(tsdf, "SLAB_VOXELS", 16 * 128 * 128)
    card = _room_volume(None, 128, 10)
    monkeypatch.undo()
    cpu = _room_volume("cpu", 128, 10)
    assert card.tsdf.device.type == "cuda"
    wc, wp = card.weight.cpu(), cpu.weight
    flips = int((wc != wp).sum())
    assert flips <= 1e-4 * wp.numel(), flips
    both = (wc > 0) & (wp > 0) & (wc == wp)
    assert int(both.sum()) > 0.01 * wp.numel()
    assert float((card.tsdf.cpu() - cpu.tsdf)[both].abs().max()) <= 1e-5


def test_tsdf_candidate_mask_on_the_card_matches_numpy():
    """The device candidate cubes and their corner values equal numpy's
    on the same fused volume, and so does the extracted mesh."""
    from graph_slam_tpu_torch.mapping import tsdf

    _cuda()
    vol = _room_volume(None, 96, 6)
    tsdf_h, wgt_h = vol.tsdf.cpu().numpy(), vol.weight.cpu().numpy()
    cubes, values = tsdf.candidate_cubes(vol, 1.0)
    assert cubes.device.type == "cuda"
    n = tsdf_h.shape[0]
    vals8 = np.stack([tsdf._shifted(tsdf_h.astype(np.float64), c, n)
                      for c in tsdf._CORNERS])
    wt8 = np.stack([tsdf._shifted(wgt_h, c, n) for c in tsdf._CORNERS])
    cand = (wt8 >= 1.0).all(0) & (vals8 < 0).any(0) & (vals8 >= 0).any(0)
    np.testing.assert_array_equal(cubes.cpu().numpy(), np.argwhere(cand))
    np.testing.assert_array_equal(values.cpu().numpy().astype(np.float64),
                                  vals8[:, cand].T)
    V, F = tsdf.extract_mesh(vol)
    Vn, Fn = tsdf.extract_mesh_numpy(tsdf_h, wgt_h, vol.origin.cpu().numpy(),
                                     vol.voxel.cpu().numpy())
    assert len(F) > 1000
    np.testing.assert_array_equal(V, Vn)
    np.testing.assert_array_equal(F, Fn)


def test_cli_slam_on_the_card_matches_the_in_process_run(tmp_path):
    """``slam`` through ``cli.main`` on the card over a ``.gsf`` store of
    twelve box-room frames against ``OnlineSlam`` on the card fed the
    decoded frames: statuses and trajectory within 1e-6 m."""
    import contextlib
    import io

    from graph_slam_tpu_torch import cli
    from graph_slam_tpu_torch.config import RS435, SlamParams
    from graph_slam_tpu_torch.io import FrameStore, read_trajectory
    from graph_slam_tpu_torch.pipelines import OnlineSlam

    _cuda()
    _, frames = _room_frames(12)
    store = FrameStore(str(tmp_path / "frames"))
    for k, (i, d) in enumerate(frames):
        store.save(k, i, d)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["slam", "--camera", "rs435", "--global-loop-k", "2",
                  "--frames", str(tmp_path / "frames"), "--out-dir",
                  str(tmp_path / "out")])
    slam = OnlineSlam(cam=RS435, params=SlamParams(), global_loop_k=2)
    counts = {}
    for k in range(12):
        st = slam.process_frame(*store(k), seq_id=k)
        counts[st] = counts.get(st, 0) + 1
    slam.optimize()
    summary = " ".join(f"{k}={v}" for k, v in sorted(counts.items()))
    assert f"frames=12 keyframes={slam.num_keyframes} [{summary}]" in \
        buf.getvalue()
    got = read_trajectory(str(tmp_path / "out" / "trajectory.log"))
    _, t, q, seqs = slam.trajectory()
    np.testing.assert_array_equal(got.seq, seqs)
    np.testing.assert_allclose(got.t, t, atol=1e-6)
    np.testing.assert_allclose(got.quat, q, atol=1e-6)


# -- multi-device solving (graph_slam_tpu_torch.parallel) ----------------------


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [y for v in x for y in _leaves(v)]
    return [np.asarray(x, dtype=np.float64)]


def _held(a, b, tol):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        np.testing.assert_allclose(x, y, rtol=tol, atol=tol)


def test_sharded_gn_on_two_gloo_ranks_sharing_the_card_matches_the_cpu():
    """Dense GN and PCG-60 on the 48-pose sphere (float64): two gloo ranks
    on one card against two on the CPU within 1e-9, both card ranks
    bit-equal."""
    from graph_slam_tpu_torch.datasets import make_sphere_graph
    from graph_slam_tpu_torch.parallel import launch, sharded_gn
    from graph_slam_tpu_torch.parallel.launch import run_calls

    _cuda()
    g, v, _ = make_sphere_graph(n_poses=48, edges_per_pose=3.0, seed=0,
                                dtype=torch.float64, bucket=16, device="cpu")
    calls = [(sharded_gn, (g, v), dict(iterations=6, damping=1e-4,
                                       solver=solver, pcg_iters=60))
             for solver in ("dense", "pcg")]
    before = launch.region_grow_launches
    card = launch(2, run_calls, calls, backend="gloo", timeout=300)
    assert launch.region_grow_launches == before    # the ranks sent 0
    cpu = launch(2, run_calls, calls, device="cpu", timeout=300)
    _held(card[1], card[0], 0.0)
    _held(card[0], cpu[0], 1e-9)


def test_sharded_ba_sqrt_on_one_nccl_rank_matches_the_in_process_solve():
    """The landmark-sharded square-root BA on a one-rank NCCL group against
    ``ba_gn_optimize_sqrt`` on the card in this process (121 landmarks,
    float64, within 1e-9)."""
    from graph_slam_tpu_torch.datasets import make_ba_graph
    from graph_slam_tpu_torch.graph.ba_solve import ba_gn_optimize_sqrt
    from graph_slam_tpu_torch.parallel import launch, sharded_ba_sqrt

    dev = _cuda()
    g, v, _ = make_ba_graph(n_poses=8, n_points=121, obs_per_point=3, seed=4,
                            dtype=torch.float64, bucket=1, device=dev)
    kw = dict(iterations=6, damping=1e-3, chunk=16)
    got = launch(1, sharded_ba_sqrt, g, v, timeout=300, **kw)[0]
    vals, err = ba_gn_optimize_sqrt(g, v, **kw)
    _held(got, (tuple(x.cpu() for x in vals), err.cpu()), 1e-9)


def test_launch_refuses_more_nccl_ranks_than_cards():
    from graph_slam_tpu_torch.parallel import launch, sharded_gn

    _cuda()
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="needs .* CUDA cards"):
        launch(n, sharded_gn)
