"""launches_per_iter.ba: kernels launched in a traced stretch of
bundle-adjustment solves over the Gauss-Newton steps they ran."""

from portbench.stats import launches_per_iter as read  # noqa: F401
