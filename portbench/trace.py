"""Reduce a ``torch.profiler`` chrome trace to what the per-layer readers
and the result's ``breakdown`` need.

Device operations are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events; the window is the span from the start of the first
to the end of the last benchmark ``solve`` span (``record_function``), so
it holds whole solves. A device operation's launching host op is found by
its correlation id: the runtime or driver call with that id lies inside
the host op on the same thread.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
SOLVE_SPAN = "portbench.solve"


def export_events(prof):
    """The profiler's chrome-trace events, through a file in the
    temporary directory that is removed at once."""
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events, host_ops=("aten::linalg_cholesky_ex",)):
    """A dict of the traced window (seconds throughout): ``window_s``,
    ``busy_s`` (the union of device operations), ``device_s`` (their summed
    durations), ``launches`` (kernels), ``solves``, ``ops`` {name:
    [seconds, count]}, ``host_ops`` {name: {"count", "device_s"}} for the
    host ops named in ``host_ops`` (the device time of what each launched)
    and ``idle`` {what the host was doing: seconds} over the window's
    idle gaps. None when the trace holds no solve span."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    solves = [e for e in xs if e.get("name") == SOLVE_SPAN
              and e.get("cat") in HOST_CATS]
    if not solves:
        return None
    w0 = min(e["ts"] for e in solves)
    w1 = max(e["ts"] + e["dur"] for e in solves)
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS
           and w0 <= e["ts"] < w1]
    ops = defaultdict(lambda: [0.0, 0])
    for e in dev:
        ops[e["name"]][0] += e["dur"] * 1e-6
        ops[e["name"]][1] += 1
    busy = _union([(e["ts"], min(e["ts"] + e["dur"], w1)) for e in dev])
    out = {"window_s": (w1 - w0) * 1e-6,
           "busy_s": sum(e - s for s, e in busy) * 1e-6,
           "device_s": sum(e["dur"] for e in dev) * 1e-6,
           "launches": sum(1 for e in dev if e["cat"] == "kernel"),
           "solves": len(solves), "ops": dict(ops)}

    # device time of the operations each named host op launched
    by_corr = defaultdict(float)
    for e in dev:
        c = e.get("args", {}).get("correlation")
        if c is not None:
            by_corr[c] += e["dur"] * 1e-6
    launches = defaultdict(list)
    for e in xs:
        if e.get("cat") in LAUNCH_CATS:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launches[e.get("tid")].append((e["ts"], c))
    for v in launches.values():
        v.sort()
    out["host_ops"] = {}
    for name in host_ops:
        count, dev_s = 0, 0.0
        for e in xs:
            if e.get("name") != name or e.get("cat") != "cpu_op" \
                    or not w0 <= e["ts"] < w1:
                continue
            count += 1
            lst = launches.get(e.get("tid"), [])
            k = bisect.bisect_left(lst, (e["ts"], -1))
            while k < len(lst) and lst[k][0] <= e["ts"] + e["dur"]:
                dev_s += by_corr.get(lst[k][1], 0.0)
                k += 1
        out["host_ops"][name] = {"count": count, "device_s": dev_s}

    # idle gaps, named by the innermost benchmark span and host op around
    # each gap's middle
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    tid = solves[0].get("tid")
    host = sorted(((e["ts"], -e["dur"], e["name"], e["cat"]) for e in xs
                   if e.get("cat") in HOST_CATS and e.get("tid") == tid
                   and e["ts"] < w1 and e["ts"] + e["dur"] > w0),
                  key=lambda h: h[:2])
    idle = defaultdict(float)
    stack, i = [], 0
    for s, e in gaps:            # in time order; host ops nest on a thread
        mid = 0.5 * (s + e)
        while i < len(host) and host[i][0] <= mid:
            h0, neg, name, cat = host[i]
            while stack and stack[-1][0] <= h0:
                stack.pop()
            stack.append((h0 - neg, name, cat))
            i += 1
        while stack and stack[-1][0] < mid:
            stack.pop()
        span = next((n for _, n, c in reversed(stack)
                     if c == "user_annotation" and n.startswith(
                         "portbench.")), "no span")
        op = next((n for _, n, c in reversed(stack) if c == "cpu_op"),
                  "python")
        idle[f"{span} | {op}"] += (e - s) * 1e-6
    out["idle"] = dict(idle)
    return out


def breakdown(summary, top=10):
    """The result's ``breakdown``: the device operations that took most
    time and the idle gaps by what the host was doing, in seconds."""
    ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1][0])[:top]
    idle = sorted(summary["idle"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k[:200], v[0]] for k, v in ops],
            "idle_gaps": [[k[:200], v] for k, v in idle]}
