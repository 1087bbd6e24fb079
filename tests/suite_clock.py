"""Keep a parallel tier-1 run inside its clock.

The root ``conftest.py`` loads this plugin before ``tests/conftest.py``
imports torch, so the thread caps below are in place when each library
starts its pools.

- Under pytest-xdist each worker gets its share of the CPUs
  (``WORKER_THREADS``) for torch and the BLAS libraries, so N workers do not
  each spin a machine-sized pool. Outside xdist nothing is capped. XLA's CPU
  client is left as it is: jaxlib sizes its pool to at least the device
  count, 8 virtual devices here, whatever ``NPROC`` or
  ``--xla_cpu_multi_thread_eigen`` say.
- Every test has one time limit (``TEST_TIME_LIMIT``): a test that overruns
  it fails alone and the worker goes on with the next test. A hang inside
  compiled code, where no Python signal handler runs, still dumps every
  thread's traceback to stderr at the limit.

Blind spots of the limit: an alarm that fires in pytest's or xdist's own code
between a test's phases (while a report is sent, say) ends the run with an
internal error instead of a failed test; one that fires while a
module-scoped fixture is set up errors every test of that module.
"""

import contextlib
import faulthandler
import os
import signal
import sys
import time

import pytest


def worker_threads(cpus, workers):
    """Threads for each of ``workers`` xdist workers on ``cpus`` CPUs.

    At least one; None outside xdist (``workers`` 0), where nothing is capped.
    """
    return max(1, cpus // workers) if workers else None


WORKER_THREADS = worker_threads(
    os.cpu_count() or 1, int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0")))
if WORKER_THREADS is not None:
    # Read by torch's OpenMP and MKL pools and by scipy's OpenBLAS (which
    # jax's CPU LAPACK calls) when each is first loaded.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(WORKER_THREADS)
    # numpy, with its own OpenBLAS, is already imported when this file runs.
    from threadpoolctl import threadpool_limits

    threadpool_limits(WORKER_THREADS)

# Seconds one test may take, fixtures included: over twice the slowest test
# or module fixture measured under ``-n 6`` (154 s on 8 CPUs).
TEST_TIME_LIMIT = 600

_stderr = None


@contextlib.contextmanager
def time_limit(seconds):
    """Fail the enclosed code once it has run ``seconds``.

    An enclosing limit is held while the code runs and re-armed on exit with
    what was left of it, at least a millisecond, so it still fires if it ran
    out meanwhile.
    """
    def overrun(signum, frame):
        pytest.fail(f"test overran the suite's time limit of {seconds} s",
                    pytrace=False)

    old_handler = signal.signal(signal.SIGALRM, overrun)
    start = time.monotonic()
    outer, _ = signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old_handler)
        if outer:
            left = outer - (time.monotonic() - start)
            signal.setitimer(signal.ITIMER_REAL, max(left, 1e-3))


def pytest_configure(config):
    # stderr itself is captured while a test runs.
    global _stderr
    _stderr = os.dup(sys.__stderr__.fileno())


def pytest_unconfigure(config):
    os.close(_stderr)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    faulthandler.dump_traceback_later(TEST_TIME_LIMIT, file=_stderr)
    try:
        with time_limit(TEST_TIME_LIMIT):
            return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()
