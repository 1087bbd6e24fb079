"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Exits 2 without a result where the run cannot give one: no CUDA card,
fewer cards than the cell asks for, or a module loaded that no run may
load (``jax``, ``jaxlib``, ``flax``, ``graph_slam_tpu``).
"""

import time

T_TOP = time.perf_counter()

import os  # noqa: E402

# one host thread for numpy's and torch's CPU work: a run is one process
# whose host side is the Python loop that launches the card's work
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    age = harness.process_age_s()
    t_start = T_TOP if age is None else min(
        T_TOP, time.perf_counter() - age)
    try:
        result = harness.run(args, t_start=t_start)
    except harness.Refused as e:
        print(f"portbench: no result: {e}", file=sys.stderr)
        return 2
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
