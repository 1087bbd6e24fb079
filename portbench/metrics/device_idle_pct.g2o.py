"""device_idle_pct.g2o: the card's idle share over a traced stretch of whole
pose-graph solves."""

from portbench.stats import device_idle_pct as read  # noqa: F401
