"""Noise models of the port (``graph_slam_tpu/noise`` counterpart)."""

from .models import (ROBUST_HUBER, ROBUST_NONE, huber_weight,
                     isotropic_sqrt_info, sqrt_info_from_covariance,
                     sqrt_info_from_information, sqrt_info_from_sigmas)

__all__ = ["sqrt_info_from_sigmas", "sqrt_info_from_information",
           "sqrt_info_from_covariance", "isotropic_sqrt_info", "huber_weight",
           "ROBUST_NONE", "ROBUST_HUBER"]
