"""Noise models as square-root-information matrices (port of
``noise/models.py``).

Every model is a dense square-root information ``S`` with
``S^T S = Lambda``, so all factor tables whiten with ``S @ e`` and chi2 is
GTSAM's ``0.5 * ||whitened||^2``. Robust (Huber) re-weighting follows
GTSAM's m-estimator semantics, per factor row.
"""

from __future__ import annotations

import torch

from ..device import resolve

__all__ = [
    "sqrt_info_from_sigmas",
    "sqrt_info_from_information",
    "sqrt_info_from_covariance",
    "isotropic_sqrt_info",
    "huber_weight",
    "ROBUST_NONE",
    "ROBUST_HUBER",
]

ROBUST_NONE = 0
ROBUST_HUBER = 1


def sqrt_info_from_sigmas(sigmas):
    """Diagonal::Sigmas — S = diag(1/sigma), batched over leading axes."""
    return torch.diag_embed(1.0 / sigmas)


def isotropic_sqrt_info(dim: int, sigma, *, dtype=torch.float64,
                        device=None):
    """Isotropic::Sigma — S = I/sigma."""
    return torch.eye(dim, dtype=dtype, device=resolve(device)) / sigma


def sqrt_info_from_information(info):
    """Gaussian::Information — upper-triangular S = chol(Lambda)^T."""
    return torch.linalg.cholesky(info).transpose(-1, -2)


def sqrt_info_from_covariance(cov):
    """Gaussian::Covariance — S = L^-1 with cov = L L^T."""
    L = torch.linalg.cholesky(cov)
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype,
                    device=cov.device).expand_as(cov)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def huber_weight(d, k):
    """GTSAM mEstimator::Huber weight: w = 1 for |d| <= k else k/|d|.

    ``d`` is the whitened residual norm (Mahalanobis distance).
    """
    ad = torch.abs(d)
    return torch.where(ad <= k, torch.ones_like(ad),
                       k / torch.where(ad > 0, ad, torch.ones_like(ad)))
