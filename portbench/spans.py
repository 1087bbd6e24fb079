"""Benchmark spans around the program's calls into its layers.

In a traced run only, each ``[module, attribute, span]`` of a traffic
file's ``spans`` wraps that function of the program in a
``record_function`` span of that name, for the run's profile; the
originals come back when the stretch ends. A name the program no longer
has is skipped: the spans name the idle gaps of ``breakdown`` and feed no
metric.
"""

from __future__ import annotations

import contextlib
import functools
import importlib


@contextlib.contextmanager
def wrapped(table):
    from torch.profiler import record_function

    saved = []
    try:
        for modname, attr, span in table:
            mod = importlib.import_module(modname)
            fn = getattr(mod, attr, None)
            if not callable(fn):
                continue

            def w(*a, _fn=fn, _span=span, **k):
                with record_function(_span):
                    return _fn(*a, **k)

            setattr(mod, attr, functools.wraps(fn)(w))
            saved.append((mod, attr, fn))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)
