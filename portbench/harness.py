"""Run one cell of the port's benchmark once.

Everything a cell needs is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration and traffic; the files are

- ``configs/<config>.json``: the problem's sizes, its source and its
  numerics;
- ``traffic/<traffic>.json``: the solve loop's parameters, and in
  ``driver`` the solve loop that reads them;
- ``drivers/<driver>.py``: the solve loop (set-up, one solve, the
  reference comparison);
- ``workloads/<cell>.json``: the cell's configuration, traffic, chips and
  the limits of its correctness numbers;
- ``metrics/<metric>.py``: one reader a metric, ``read(ctx)`` returning a
  number or None (nothing to read: the metric is left out).

A run is: set-up (imports, the card, inputs from the seed, the program's
graph, one warm solve), then either the measured window (``--trace 0``:
solves back to back from the cell's starts, in an order drawn from the
seed, for ``--seconds``) or a profiled stretch of whole solves (``--trace
1``), then the comparison of every solve's answer with the plain
reference, and the result line.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "graph_slam_tpu")


class Refused(Exception):
    """The run cannot give a result (no card, a forbidden module)."""


def process_age_s():
    """Seconds since this process started, from /proc (10 ms ticks);
    None where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return None


def forbidden_modules(modules=None):
    """Top-level names of loaded modules that no run may load: the part
    before the first dot, compared whole."""
    mods = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in mods}
                  & set(FORBIDDEN))


def load_json(base, *parts):
    with open(Path(base).joinpath(*parts)) as f:
        return json.load(f)


def load_module(base, kind, name):
    path = Path(base) / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``<root>/BENCHMARK.json`` with its files, found by
    name under ``<root>/portbench``, loaded."""

    def __init__(self, root, name):
        root = Path(root)
        spec = load_json(root, "BENCHMARK.json")
        base = self.base = root / HERE.name
        entries = {w["name"]: w for w in spec["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(entries)})")
        entry = entries[name]
        self.name = name
        self.chips = int(entry["chips"])
        self.workload = load_json(base, "workloads", f"{name}.json")
        for key in ("config", "traffic", "chips"):
            if self.workload[key] != entry[key]:
                raise ValueError(f"workloads/{name}.json says {key} = "
                                 f"{self.workload[key]!r}, BENCHMARK.json "
                                 f"{entry[key]!r}")
        self.config = load_json(base, "configs", f"{entry['config']}.json")
        self.traffic = load_json(base, "traffic", f"{entry['traffic']}.json")
        self.driver = load_module(base, "drivers", self.traffic["driver"])
        self.limits = self.workload["limits"]

        def mine(m):
            return "workloads" not in m or name in m["workloads"]

        self.end_to_end = [m for m in spec["end_to_end"] if mine(m)]
        self.per_layer = [m for m in spec["per_layer"] if mine(m)]


class Context:
    """What a driver's set-up, solves and check see."""

    def __init__(self, cell, seed, device, tmpdir):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.device = device
        self.tmpdir = tmpdir
        self.phases = {}

    def timed(self, phase, fn, *args, **kwargs):
        """Run ``fn`` with the card synchronised after it, adding its wall
        time to ``phases[phase]``."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self.sync()
        self.phases[phase] = self.phases.get(phase, 0.0) \
            + time.perf_counter() - t0
        return out

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize()


def solve_order(seed, starts):
    """The starts in the order a run visits them, without end: each round
    of ``starts`` solves is a permutation of them drawn from the seed."""
    import numpy as np

    r = np.random.default_rng([seed % (1 << 64), 7])
    while True:
        yield from (int(k) for k in r.permutation(starts))


def _window(ctx, state, seconds):
    """Solves back to back for ``seconds``: (records, window seconds)."""
    order = solve_order(ctx.seed, ctx.traffic["starts"])
    recs = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    t = t0
    while t < deadline:
        k = next(order)
        s = time.perf_counter()
        out = ctx.cell.driver.solve(ctx, state, k)
        t = time.perf_counter()
        out.update(start=k, seconds=t - s)
        recs.append(out)
    return recs, t - t0


def _traced(ctx, state):
    """A profiled stretch of ``trace_solves`` whole solves after one
    profiled warm-up solve: (records, trace summary)."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    from . import spans, trace

    n = int(ctx.traffic["trace_solves"])
    order = solve_order(ctx.seed, ctx.traffic["starts"])
    acts = [ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    got = {}

    def ready(prof):
        got["events"] = trace.export_events(prof)

    recs = []
    sched = schedule(wait=0, warmup=1, active=n)
    with spans.wrapped(ctx.traffic.get("spans", [])), \
            profile(activities=acts, on_trace_ready=ready,
                    schedule=sched) as prof:
        for i in range(n + 1):
            k = next(order)
            s = time.perf_counter()
            with record_function(trace.SOLVE_SPAN):
                out = ctx.cell.driver.solve(ctx, state, k)
            t = time.perf_counter()
            if i:
                out.update(start=k, seconds=t - s)
                recs.append(out)
            prof.step()
    summary = trace.summarize(got.get("events", []),
                              host_ops=tuple(ctx.traffic.get("host_ops", ())))
    return recs, summary


def compare_all(ctx, state, *rec_lists, on_reference=None):
    """Each list's solves compared with the reference, which runs once a
    start: for each list, one {name: number} per solve.
    ``on_reference(k, ref)`` sees each reference answer."""
    out = [[] for _ in rec_lists]
    for k in sorted({r["start"] for recs in rec_lists for r in recs}):
        ref = ctx.cell.driver.reference(ctx, state, k)
        if on_reference is not None:
            on_reference(k, ref)
        for nums, recs in zip(out, rec_lists):
            nums += [ctx.cell.driver.compare(ctx, state, r, ref)
                     for r in recs if r["start"] == k]
        del ref
    return out


def worst(nums, names):
    """The worst of each number over the solves; a NaN is the worst."""
    w = {k: 0.0 for k in names}
    for n in nums:
        for k in names:
            v = float(n[k])
            if not w[k] >= v:
                w[k] = v
    return w


def check(ctx, state, recs):
    """Hold every solve's answer to the reference: (numbers {name:
    (value, limit)}, failed solves). A number is the worst over the
    solves; a solve fails where any of its numbers is above its limit or
    not a number."""
    limits = ctx.cell.limits
    (nums,) = compare_all(ctx, state, recs)
    failed = sum(any(not float(n[k]) <= lim for k, lim in limits.items())
                 for n in nums)
    w = worst(nums, limits)
    return {k: (w[k], limits[k]) for k in limits}, failed


def _device_info(device, chips):
    import torch

    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def run(argv_args, *, root=CHECKOUT, device=None, require_card=True,
        t_start=None):
    """One run of one cell; returns its result line as a dict.

    ``root`` (a directory holding ``BENCHMARK.json`` and ``portbench/``),
    ``device`` and ``require_card=False`` are for the CPU tests, which
    drive the whole run at a small size; a benchmark run takes none."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(root, argv_args.workload)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    cache = CHECKOUT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    import tempfile

    import torch

    if require_card:
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is False: this "
                          "benchmark runs on a CUDA card")
        if torch.cuda.device_count() < cell.chips:
            raise Refused(f"{cell.name} needs {cell.chips} cards, "
                          f"torch.cuda.device_count() is "
                          f"{torch.cuda.device_count()}")
    dev = torch.device(device or "cuda")
    with tempfile.TemporaryDirectory(prefix="portbench_") as tmp:
        ctx = Context(cell, argv_args.seed, dev, tmp)
        if dev.type == "cuda":
            torch.zeros(1, device=dev)
            torch.cuda.synchronize()
        ctx.phases["import_and_card_s"] = time.perf_counter() - t_start
        state = cell.driver.setup(ctx)
        t_window = time.perf_counter()
        setup_s = t_window - t_start
        if argv_args.trace:
            recs, summary = _traced(ctx, state)
            window_s = summary["window_s"] if summary else 0.0
        else:
            recs, window_s = _window(ctx, state, argv_args.seconds)
            summary = None
        devinfo = _device_info(dev, cell.chips)
        if summary is not None:
            devinfo["busy_s"] = summary["busy_s"]
            devinfo["window_s"] = summary["window_s"]
        cell.driver.release(ctx, state)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        numbers, failed = check(ctx, state, recs)

    mctx = {"config": cell.config, "traffic": cell.traffic,
            "solves": recs, "window_s": window_s, "setup_s": setup_s,
            "trace": summary}
    metrics = {}
    for m in (cell.per_layer if argv_args.trace else cell.end_to_end):
        v = load_module(cell.base, "metrics", m["name"]).read(mctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct = failed == 0 and all(v <= lim for v, lim in numbers.values())
    result = {"correct": correct, "attempted": len(recs), "failed": failed,
              "metrics": metrics, "device": devinfo}
    if recs:
        ms = sorted(r["seconds"] * 1e3 for r in recs)
        result["solve_ms_spread"] = {"min": ms[0], "median": ms[len(ms) // 2],
                                     "max": ms[-1]}
    if summary is not None:
        from .trace import breakdown

        result["breakdown"] = breakdown(summary)
    result["setup_parts"] = ctx.phases
    bad = forbidden_modules()
    if bad:
        raise Refused(f"modules loaded that no run may load: {bad}")
    # a number that is not finite (a NaN answer) is written as null
    result["checks"] = {k: {"value": v if math.isfinite(v) else None,
                            "limit": lim} for k, (v, lim) in numbers.items()}
    return result


def emit(result, out=sys.stdout, err=sys.stderr):
    """The check lines last on stderr, the result line last on stdout."""
    for k, c in result["checks"].items():
        ok = "ok" if c["value"] is not None and c["value"] <= c["limit"] \
            else "FAIL"
        print(f"check {k} = {c['value']!r} limit {c['limit']!r} {ok}",
              file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()

