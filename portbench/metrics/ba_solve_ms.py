"""ba_solve_ms: a bundle-adjustment solve, from its call to its final chi2 on
the host, as the window over the solves it completed (host clock)."""

from portbench.stats import ms_per_solve as read  # noqa: F401
