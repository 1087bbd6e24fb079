"""device_idle_pct.ba: the card's idle share over a traced stretch of whole
bundle-adjustment solves."""

from portbench.stats import device_idle_pct as read  # noqa: F401
