"""device_ms_per_iter.g2o: device time of a traced stretch of pose-graph
solves over the LM iterations they ran."""

from portbench.stats import device_ms_per_iter as read  # noqa: F401
