"""Chi-square quantile utility — a copy of ``graph_slam_tpu/utils/chi2.py``
(importing it would import jax through ``graph_slam_tpu/__init__.py``).

Reference counterpart: ``utils::chi2(dof, alpha)`` via boost math
(the reference's ``gtsam/chi2.h:17-26``), used for gating residuals. Uses
scipy when available, otherwise the Wilson–Hilferty normal approximation.
"""

from __future__ import annotations

import math

__all__ = ["chi2_quantile"]

try:  # scipy when installed, else the approximation below
    from scipy.stats import chi2 as _chi2

    def chi2_quantile(dof: int, alpha: float) -> float:
        """Upper-alpha quantile: P(X > q) = alpha for X ~ chi2(dof)."""
        return float(_chi2.ppf(1.0 - alpha, dof))

except Exception:  # pragma: no cover

    def _norm_ppf(p: float) -> float:
        # Acklam's rational approximation
        a = [-3.969683028665376e01, 2.209460984245205e02,
             -2.759285104469687e02, 1.383577518672690e02,
             -3.066479806614716e01, 2.506628277459239e00]
        b = [-5.447609879822406e01, 1.615858368580409e02,
             -1.556989798598866e02, 6.680131188771972e01,
             -1.328068155288572e01]
        c = [-7.784894002430293e-03, -3.223964580411365e-01,
             -2.400758277161838e00, -2.549732539343734e00,
             4.374664141464968e00, 2.938163982698783e00]
        d = [7.784695709041462e-03, 3.224671290700398e-01,
             2.445134137142996e00, 3.754408661907416e00]
        plow = 0.02425
        if p < plow:
            q = math.sqrt(-2 * math.log(p))
            return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
                   ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
        if p > 1 - plow:
            q = math.sqrt(-2 * math.log(1 - p))
            return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
                   ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
        q = p - 0.5
        r = q * q
        return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
               (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)

    def chi2_quantile(dof: int, alpha: float) -> float:
        z = _norm_ppf(1.0 - alpha)
        h = 2.0 / (9.0 * dof)
        return dof * (1.0 - h + z * math.sqrt(h)) ** 3
