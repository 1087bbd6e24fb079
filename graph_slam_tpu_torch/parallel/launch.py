"""The port's process model for multi-device solving: one process a rank.

The JAX package runs ``shard_map`` in one process over N devices; the
PyTorch idiom is SPMD over a ``torch.distributed`` process group.
``launch(n, fn, *args)`` starts ``n`` ranks with the ``spawn`` start method
(``fork`` is unsafe once CUDA or threads exist), joins them in one group
through a rendezvous file in a fresh temporary directory (no fixed TCP port
that processes side by side could collide on), calls ``fn(mesh, *args,
**kwargs)`` on every rank with its ``sharding.Mesh`` and returns every
rank's result, moved to numpy by ``device.to_host``, in rank order.

Devices and backends:

- ``device=None`` is the card: rank r runs on card r, and the ranks reduce
  over NCCL. NCCL refuses two ranks on one card, so fewer cards than ranks
  raises and names the count, unless the caller passes ``backend="gloo"``:
  then ranks share cards (rank r on card r mod count) and every reduction
  goes through host memory. The JAX package's ``make_mesh`` silently takes
  fewer devices than asked; ``launch`` never runs fewer ranks than asked.
- ``device="cpu"``: gloo ranks on the CPU, each with ``cpu_count // n``
  threads.

Every process joins the group over the loopback interface
(``GLOO_SOCKET_IFNAME`` and ``NCCL_SOCKET_IFNAME`` default to ``lo``): the
ranks of one launch share one host.

Tensors anywhere in ``args``/``kwargs`` (in tuples, lists, dicts and
NamedTuples) travel as CPU tensors and arrive on the rank's device; other
arguments are pickled as they are. ``fn`` must be a module-level function
of ``graph_slam_tpu_torch``, so that a rank imports the port and nothing
else (a test module imports JAX); ``run_calls`` runs several such calls in
one launch.

A rank's exception is raised again in the parent, with the rank's
traceback as its cause. A rank that has not returned within ``timeout``
seconds of the start is killed with every other rank and the parent raises
``TimeoutError``; a rank that dies without a result raises
``RuntimeError``. No rank outlives ``launch``.

Each rank sends back its ``region_grow.launches`` beside its result, and
``launch.region_grow_launches`` adds them up over every call of ``launch``
in this process: the ranks' kernel launches, which the parent's own
``region_grow.launches`` cannot see.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import sys
import tempfile
import time
import traceback

import torch

from ..device import resolve, to_host

__all__ = ["launch", "run_calls"]

_PORT = "graph_slam_tpu_torch"
_GRACE_S = 10.0      # a rank that has sent its result gets this long to exit


class _RemoteTraceback(Exception):
    """The traceback of a rank's exception, as text (the cause of the
    exception ``launch`` raises again)."""

    def __str__(self):
        return self.args[0]


def _tree(fn, x):
    """``fn`` over the leaves of nested tuples, lists, dicts and
    NamedTuples."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_tree(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_tree(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: _tree(fn, v) for k, v in x.items()}
    return fn(x)


def _check_port_function(fn):
    mod = getattr(fn, "__module__", None) or ""
    qual = getattr(fn, "__qualname__", "")
    owner = sys.modules.get(mod)
    if not (mod == _PORT or mod.startswith(_PORT + ".")) \
            or getattr(owner, qual, None) is not fn:
        raise ValueError(
            f"launch: fn must be a module-level function of {_PORT} (a "
            f"rank imports it by name), not {fn!r}")


def _backend(n: int, device: torch.device, backend):
    if device.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"launch: ranks on the CPU reduce over gloo, "
                             f"not {backend!r}")
        return "gloo"
    if device.type != "cuda":
        raise ValueError(f"launch: no ranks on a {device.type!r} device")
    backend = backend or "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"launch: backend must be 'nccl' or 'gloo', not "
                         f"{backend!r}")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("launch: no CUDA card; pass device='cpu' to run "
                           "the ranks on the CPU")
    if backend == "nccl" and n > count:
        raise ValueError(
            f"launch({n}) over NCCL needs {n} CUDA cards, one a rank, and "
            f"torch.cuda.device_count() is {count}: NCCL refuses two ranks "
            "on one card; pass backend='gloo' to let ranks share cards")
    return backend


def run_calls(mesh, calls):
    """``[(fn, args, kwargs), ...]`` -> ``[fn(mesh, *args, **kwargs),
    ...]``, in order on this rank: several port functions in one launch
    (one start-up of the ranks for all of them)."""
    out = []
    for fn, args, kwargs in calls:
        _check_port_function(fn)
        out.append(fn(mesh, *args, **kwargs))
    return out


def _rank_main(rank, n, tmp, device_type, backend, timeout, results):
    """One rank: join the group, run the call in ``tmp``, send ``(rank, ok,
    payload)``: ``(result, region_grow launches)`` or the exception."""
    import torch.distributed as dist

    from ..planes.region_grow import region_grow
    from .sharding import make_mesh

    try:
        with open(os.path.join(tmp, "call.pkl"), "rb") as f:
            fn, args, kwargs = pickle.load(f)
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        if device_type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(tmp, "rendezvous"),
            rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=timeout))
        args, kwargs = _tree(lambda x: x.to(device)
                             if isinstance(x, torch.Tensor) else x,
                             (args, kwargs))
        out = to_host(fn(make_mesh(n, device=device), *args, **kwargs))
        results.put((rank, True, (out, region_grow.launches)))
    except Exception as exc:  # the rank's boundary: report, never swallow
        tb = traceback.format_exc()
        try:
            blob = pickle.dumps(exc)
        except Exception:  # an exception that cannot cross processes
            blob = None
        results.put((rank, False, (blob, tb)))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _raise_rank_error(rank, blob, tb):
    cause = _RemoteTraceback(f"\n\nrank {rank} failed:\n{tb}")
    exc = pickle.loads(blob) if blob is not None else RuntimeError(
        f"rank {rank} raised an exception that cannot be pickled")
    raise exc from cause


def _collect(procs, results, timeout):
    out = [None] * len(procs)
    pending = set(range(len(procs)))
    deadline = time.monotonic() + timeout
    while pending:
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError(
                f"launch: rank(s) {sorted(pending)} did not finish within "
                f"{timeout} s; every rank was killed")
        try:
            rank, ok, payload = results.get(timeout=min(left, 1.0))
        except queue_mod.Empty:
            dead = [r for r in pending if not procs[r].is_alive()]
            if dead:
                try:    # a result sent just before the exit may be in flight
                    rank, ok, payload = results.get(timeout=2.0)
                except queue_mod.Empty:
                    r = dead[0]
                    raise RuntimeError(
                        f"launch: rank {r} exited with code "
                        f"{procs[r].exitcode} without a result") from None
            else:
                continue
        if not ok:
            _raise_rank_error(rank, *payload)
        out[rank] = payload
        pending.discard(rank)
    return out


def launch(n: int, fn, *args, device=None, backend=None,
           timeout: float = 1800.0, **kwargs):
    """Run ``fn(mesh, *args, **kwargs)`` on ``n`` ranks; every rank's result
    as numpy, in rank order (see the module docstring)."""
    if n < 1:
        raise ValueError(f"launch: n must be >= 1, not {n}")
    _check_port_function(fn)
    device = resolve(device)
    backend = _backend(n, device, backend)
    call = (fn, *_tree(lambda x: x.cpu() if isinstance(x, torch.Tensor)
                       else x, (args, kwargs)))
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="launch-") as tmp:
        # the call goes through a file: a start-up pipe holding more than
        # its buffer blocks Process.start() until the rank has imported
        # everything, which would start the ranks one after another
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump(call, f)
        procs = [ctx.Process(target=_rank_main, name=f"rank-{r}",
                             args=(r, n, tmp, device.type, backend, timeout,
                                   results),
                             daemon=True)
                 for r in range(n)]
        for p in procs:
            p.start()
        done = False
        try:
            out = _collect(procs, results, timeout)
            done = True
        finally:
            for p in procs:
                if done:
                    p.join(_GRACE_S)
                if p.is_alive():
                    p.kill()
                p.join()
            results.close()
    launch.region_grow_launches += sum(k for _, k in out)
    return [result for result, _ in out]


launch.region_grow_launches = 0
