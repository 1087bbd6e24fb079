"""launches_per_iter.g2o: kernels launched in a traced stretch of pose-graph
solves over the LM iterations they ran."""

from portbench.stats import launches_per_iter as read  # noqa: F401
