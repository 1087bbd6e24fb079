"""Read the numbers that set a cell's correctness limits.

    python3 portbench/calibrate.py --workload <name> --seeds 11 12 ... \
        [--control-seeds 11 12 13] [--control JSON ...] \
        [--iterations N] [--out FILE]

For each seed, in one process: the cell's set-up, one solve of the program
from each start, and the comparison with the float64 reference (the
program's readings, the lower ends of the limits). For each control seed,
each control held to the same reference (the upper ends). A control is
the configuration's ``control`` block, or each ``--control`` given, and
names one of

- ``program_options``: keyword arguments of the program's solve that
  switch on a lower-precision path of its own;
- ``float32_matmul_precision``: the program's solves under
  ``torch.set_float32_matmul_precision`` (``"high"``: TF32), the switch
  the port leaves to the application;
- ``reference_dtype``: the reference put in the program's place in the
  precision below the configuration's (``reference_options``: further
  keyword arguments of the driver's ``reference``, such as the precision
  of its reduced system or of its rows).

``--iterations`` overrides the traffic's trip count on both sides (where
the traffic has one), and each line records the reference's chi2 after
each step where its driver reports it (``history``). Prints one JSON
line per seed and writes them all to ``--out``. The benchmark's runs do
not run this.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


@contextlib.contextmanager
def matmul_precision(mode):
    import torch

    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(mode or old)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def readings(cell, seed, controls, device):
    """One seed's readings: the program's numbers (the worst over one solve
    from each start) and each control's in ``controls``."""
    import tempfile

    import torch

    ctx = harness.Context(cell, seed, device, None)
    line = {"seed": seed, "workload": cell.name, "program": {},
            "control": []}
    drv = cell.driver
    with tempfile.TemporaryDirectory(prefix="portbench_cal_") as tmp:
        ctx.tmpdir = tmp
        state = drv.setup(ctx)
        starts = range(cell.traffic["starts"])

        def solves(**options):
            with matmul_precision(options.pop("float32_matmul_precision",
                                              None)):
                return [dict(drv.solve(ctx, state, k, **options), start=k)
                        for k in starts]

        recs = solves()
        ctl = [solves(**c.get("program_options", {}), **(
            {"float32_matmul_precision": c["float32_matmul_precision"]}
            if "float32_matmul_precision" in c else {}))
            if "reference_dtype" not in c else None for c in controls]
        drv.release(ctx, state)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        for i, c in enumerate(controls):
            if ctl[i] is None:
                ctl[i] = [dict(drv.reference(
                    ctx, state, k, dtype=getattr(torch, c["reference_dtype"]),
                    **c.get("reference_options", {})), start=k)
                    for k in starts]

        refs = {}
        lists = harness.compare_all(
            ctx, state, recs, *ctl,
            on_reference=lambda k, r: refs.__setitem__(k, r))
    names = list(cell.limits)
    line["program"] = harness.worst(lists[0], names)
    line["control"] = [harness.worst(x, names) for x in lists[1:]]
    line["program_chi2"] = [r["chi2"] for r in recs]
    line["reference_chi2"] = [refs[k]["chi2"] for k in starts]
    if "history" in refs[0]:
        line["reference_history"] = [refs[k]["history"] for k in starts]
    if "lm_iterations" in recs[0]:
        line["program_iterations"] = [r["lm_iterations"] for r in recs]
        line["reference_iterations"] = [refs[k]["iterations"]
                                        for k in starts]
    line["control_chi2"] = [[r["chi2"] for r in x] for x in ctl]
    return line


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=())
    p.add_argument("--control", action="append", default=[],
                   help="a control block as JSON (repeatable)")
    p.add_argument("--iterations", type=int)
    p.add_argument("--out")
    a = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell(harness.CHECKOUT, a.workload)
    if a.iterations:
        cell.traffic = {**cell.traffic, "iterations": a.iterations}
    controls = [json.loads(c) for c in a.control] or [cell.config["control"]]
    lines = []
    for seed in a.seeds:
        t0 = time.perf_counter()
        line = readings(cell, seed, controls if seed in a.control_seeds
                        else [], torch.device("cuda"))
        line["controls"] = controls if seed in a.control_seeds else []
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        lines.append(line)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        with open(a.out, "w") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
