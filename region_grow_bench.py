#!/usr/bin/env python3
"""Time the region-grow kernel on one CUDA card, alone or against another
design of it.

    python3 region_grow_bench.py [--baseline old_region_grow.cu]
                                 [--rounds 3] [--reps 200] [--ptxas]

Cases: the four shapes ``chip_smoke.py`` times (64 steps, random members
above the percolation threshold, so all 64 steps run), (8, 480, 640) with
every gate closed (one step, then the exit), and the seed, member and gates
of rendered frames of each camera (the fill exits early).

For each case it prints one JSON line with

- ``us``: CUDA events around ``--reps`` calls of the wrapper in a row, what
  a caller pays a call, the wrapper's host work included where that is the
  slower side;
- ``device_us``: the same launches replayed from a CUDA graph, so the host
  is out of the way: the kernel with its launch gap;
- ``host_us``: the host's clock over the same calls without waiting for
  the card: the wrapper's own work where the card keeps up;
- ``by_cluster``: ``us`` and ``device_us`` for every cluster size that fits,
  and ``by_steps_between`` for 1, 2, 4 and 8 steps between exchanges at the
  chosen cluster size, which is how the wrapper's choices were made;
- ``bound_us``: bytes over the card's memory rate, and ``floor_us``: an
  estimate of the latency floor, one launch plus steps that ran times the
  cost of a step that moves next to no data, both measured by this script's
  ``empty`` case (a fill of 0 and of 200 steps on one small plane);
  ``floor_us_exchange_every_step`` is the same with a cluster barrier in
  every step, what the floor would be without ghost rows.

With ``--baseline`` it also builds a source that has the first design's C
interface (``region_grow_launch(seed, member, gates[4,H,W], packed, out, P,
H, W, steps, stream)``, one block per plane; ``git show
5074bcb:graph_slam_tpu_torch/csrc/region_grow.cu``) and times both in turns
(baseline, new, new, baseline) ``--rounds`` times, the baseline through the
wrapper it had (a ``torch.stack`` of the gates and two ``torch.empty``).
``--ptxas`` prints what ``nvcc -Xptxas -v`` says of the committed source.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _host_time_us(fn, reps):
    """Mean microseconds of host time per call, the card not waited for."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e6 / reps


def _host_parts(grow, a, steps, reps):
    """Where the wrapper's host time goes: its checks, its allocation, its
    look-ups and the C call (attribute, launch, error check), each alone."""
    import torch

    P, h, w = a[0].shape
    index = torch.cuda.current_device()
    C, K, threads = grow._plan(h, w, None, None, index)
    out = torch.empty((P, h, w), dtype=torch.bool, device="cuda")
    lib = grow._kernel_lib()
    stream = torch.cuda.current_stream(index).cuda_stream
    ptrs = [t.data_ptr() for t in a] + [out.data_ptr()]
    return {
        "check": _host_time_us(lambda: grow._check(a[0], a[1], a[2:], steps),
                               reps),
        "empty": _host_time_us(lambda: torch.empty(
            (P, h, w), dtype=torch.bool, device="cuda"), reps),
        "plan_and_device": _host_time_us(lambda: (
            torch.cuda.current_device(),
            grow._plan(h, w, None, None, index)), reps),
        "stream": _host_time_us(
            lambda: torch.cuda.current_stream(index).cuda_stream, reps),
        "data_ptrs": _host_time_us(
            lambda: [t.data_ptr() for t in a] + [out.data_ptr()], reps),
        "c_call": _host_time_us(lambda: lib.region_grow_launch(
            *ptrs, P, h, w, steps, C, K, threads, stream), reps)}


def _baseline_wrapper(source):
    """Build ``source`` and return the first design's wrapper around it."""
    import torch

    from graph_slam_tpu_torch.kernels import build

    out_dir = tempfile.mkdtemp(prefix="region_grow_baseline_")
    lib_path = os.path.join(out_dir, "libbaseline.so")
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib_path,
                    source], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.region_grow_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.region_grow_launch.restype = ctypes.c_int

    def as_bytes(x):
        return x.view(torch.uint8) if x.dtype == torch.bool else x

    def region_grow(seed, member, *gates, steps=64):
        P, H, W = seed.shape
        out = torch.empty((P, H, W), dtype=torch.bool, device=seed.device)
        gates_u8 = torch.stack([as_bytes(g) for g in gates])
        packed = torch.empty(4 * H * ((W + 31) // 32), dtype=torch.int32,
                             device=seed.device)
        rc = lib.region_grow_launch(
            as_bytes(seed).data_ptr(), as_bytes(member).data_ptr(),
            gates_u8.data_ptr(), packed.data_ptr(), out.data_ptr(), P, H, W,
            steps, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline launch failed: cudaError {rc}")
        return out

    return region_grow


def _ptxas():
    from graph_slam_tpu_torch.kernels import build

    src = os.path.join(build.CSRC, "region_grow.cu")
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, "lib.so"), src], capture_output=True, text=True,
            check=True)
    lines = [ln for ln in proc.stderr.splitlines()
             if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    _emit({"case": "ptxas", "lines": lines})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="CUDA source with the first design's "
                                       "C interface to time in turns")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--graph-reps", type=int, default=50)
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("region_grow_bench: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from graph_slam_tpu_torch.planes.region_grow import (region_grow,
                                                         region_grow_torch)

    grow = chip_smoke._grow_module()
    graph_us = chip_smoke._cuda_graph_time_us
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    if args.ptxas:
        _ptxas()
    baseline = _baseline_wrapper(args.baseline) if args.baseline else None

    # launch and barrier costs for the latency floor: 0 steps and 200 steps
    # that all run on one small plane (a snake that grows one pixel a step),
    # with the wrapper's steps between exchanges and with an exchange, so a
    # cluster barrier, every step
    h, w = 64, 512
    member = torch.ones(1, h, w, dtype=torch.bool, device="cuda")
    seed = torch.zeros_like(member)
    seed[0, 0, 0] = True
    shut = torch.zeros(h, w, dtype=torch.bool, device="cuda")
    snake = [~shut, shut, shut, shut]      # grow from the left pixel only

    def snake_us(steps, C, K=None):
        return graph_us(lambda: grow._launch(seed, member, snake, steps,
                                             cluster=C, steps_between=K),
                        args.graph_reps)

    costs = {}
    for C in grow.CLUSTER_SIZES:
        t0 = snake_us(0, C)
        costs[C] = {"steps_between": grow.sub_steps(h, w, C), "launch_us": t0,
                    "step_us": (snake_us(200, C) - t0) / 200,
                    "step_us_exchange_every_step":
                        (snake_us(200, C, 1) - snake_us(0, C, 1)) / 200}
    _emit({"case": "empty", "shape": [1, h, w], "by_cluster": costs})

    cases = [("live64 " + "x".join(map(str, shape)),
              chip_smoke._grow_inputs(*shape, seed=10 + k), 64)
             for k, shape in enumerate(chip_smoke.GROW_SHAPES
                                       + [(4, 240, 320)])]
    live = chip_smoke._grow_inputs(8, 480, 640, seed=11)
    cases.append(("closed 8x480x640",
                  live[:2] + [torch.zeros_like(g) for g in live[2:]], 64))
    for shape, (frame_args, steps) in sorted(
            chip_smoke.real_frame_grow_inputs().items()):
        cases.append(("frames " + "x".join(map(str, shape)), frame_args,
                      steps))

    for name, a, steps in cases:
        P, h, w = a[0].shape
        ref = region_grow_torch(*a, steps=steps)
        out = region_grow(*a, steps=steps)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), name
        chosen = grow.cluster_size(h, w)
        chosen_k = grow.sub_steps(h, w, chosen)
        steps_run = chip_smoke.grow_steps_run(a, steps)
        row = {"case": name, "shape": [P, h, w], "steps_run": steps_run,
               "cluster": chosen, "steps_between": chosen_k,
               "bound_us": chip_smoke.grow_bound_us(P, h, w),
               "floor_us": costs[chosen]["launch_us"]
               + steps_run * costs[chosen]["step_us"],
               "floor_us_exchange_every_step": costs[chosen]["launch_us"]
               + steps_run * costs[chosen]["step_us_exchange_every_step"],
               "by_cluster": {}, "by_steps_between": {}}
        for C in grow.CLUSTER_SIZES:
            if grow.smem_bytes(h, w, C) > grow._MAX_SMEM:
                continue

            def forced(C=C):
                return grow._launch(a[0], a[1], a[2:], steps, cluster=C)

            assert torch.equal(forced(), ref), (name, C)
            K = grow.sub_steps(h, w, C)
            row["by_cluster"][C] = {
                "steps_between": K, "threads": grow.block_threads(h, w, C, K),
                "us": chip_smoke._cuda_time_us(forced, args.reps),
                "device_us": graph_us(forced, args.graph_reps)}
        for K in (1, 2, 4, 8, 16):
            if (chosen == 1 or K > grow.shortest_band(h, chosen)
                    or grow.smem_bytes(h, w, chosen, K) > grow._MAX_SMEM):
                continue

            def forced_k(K=K):
                return grow._launch(a[0], a[1], a[2:], steps, cluster=chosen,
                                    steps_between=K)

            assert torch.equal(forced_k(), ref), (name, K)
            row["by_steps_between"][K] = {
                "threads": grow.block_threads(h, w, chosen, K),
                "device_us": graph_us(forced_k, args.graph_reps)}

        def new():
            return region_grow(*a, steps=steps)

        row["us"] = chip_smoke._cuda_time_us(new, args.reps)
        row["device_us"] = graph_us(new, args.graph_reps)
        row["host_us"] = _host_time_us(new, args.reps)
        if name.startswith("frames"):
            row["host_parts_us"] = _host_parts(grow, a, steps, args.reps)
        if baseline is not None:
            def old():
                return baseline(*a, steps=steps)

            assert torch.equal(old(), ref), (name, "baseline")
            turns = []
            for _ in range(args.rounds):
                turns.append({
                    "baseline_us": [chip_smoke._cuda_time_us(old, args.reps)],
                    "new_us": [chip_smoke._cuda_time_us(new, args.reps),
                               chip_smoke._cuda_time_us(new, args.reps)]})
                turns[-1]["baseline_us"].append(
                    chip_smoke._cuda_time_us(old, args.reps))
            row["turns"] = turns
            row["baseline_device_us"] = graph_us(old, args.graph_reps)
        _emit(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
