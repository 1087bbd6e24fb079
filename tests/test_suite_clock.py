"""The per-worker thread cap and the per-test time limit of suite_clock."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import suite_clock


@pytest.mark.parametrize("cpus, workers, threads", [
    (8, 0, None), (8, 1, 8), (8, 3, 2), (8, 6, 1), (4, 16, 1), (96, 6, 16),
])
def test_worker_threads(cpus, workers, threads):
    assert suite_clock.worker_threads(cpus, workers) == threads


def test_a_worker_starts_each_pool_at_its_share():
    # A fresh interpreter, as an xdist worker starts, with the caps of this
    # process taken out of its environment.
    env = {k: v for k, v in os.environ.items() if k not in
           ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")}
    workers = os.cpu_count() or 1
    env["PYTEST_XDIST_WORKER_COUNT"] = str(workers)
    probe = ("import json, suite_clock, torch, scipy.linalg\n"
             "from threadpoolctl import threadpool_info\n"
             "print(json.dumps([torch.get_num_threads()]"
             " + [p['num_threads'] for p in threadpool_info()]))")
    out = subprocess.run([sys.executable, "-c", probe], env=env, check=True,
                         cwd=Path(__file__).parent, capture_output=True,
                         text=True).stdout
    threads = json.loads(out.splitlines()[-1])
    assert len(threads) >= 3  # torch, numpy's and scipy's OpenBLAS
    assert set(threads) == {suite_clock.worker_threads(workers, workers)}


def test_overrunning_code_fails_with_the_limit():
    start = time.monotonic()
    with pytest.raises(pytest.fail.Exception, match="time limit of 0.2 s"):
        with suite_clock.time_limit(0.2):
            time.sleep(5)
    assert time.monotonic() - start < 2


def test_each_test_runs_under_the_limit_and_an_inner_one_keeps_it():
    handler = signal.getsignal(signal.SIGALRM)
    before = signal.getitimer(signal.ITIMER_REAL)[0]
    assert 0 < before <= suite_clock.TEST_TIME_LIMIT
    with suite_clock.time_limit(5):
        pass
    assert 0 < signal.getitimer(signal.ITIMER_REAL)[0] <= before
    assert signal.getsignal(signal.SIGALRM) is handler


def test_an_outer_limit_that_ran_out_inside_fires_after():
    start = time.monotonic()
    with pytest.raises(pytest.fail.Exception, match="time limit of 0.3 s"):
        with suite_clock.time_limit(0.3):
            with suite_clock.time_limit(5):
                time.sleep(0.5)
            time.sleep(5)
    assert time.monotonic() - start < 2
