"""device_ms_per_iter.ba: device time of a traced stretch of bundle-adjustment
solves over the Gauss-Newton steps they ran."""

from portbench.stats import device_ms_per_iter as read  # noqa: F401
