"""Plane landmark association and covariance plumbing for plane factors
(port of ``planes/association.py``).

- candidate window: landmarks seen in the last ``lookback`` nodes;
- match test: the world landmark transformed into the observation frame,
  normal alignment cos(angle) >= cos(10 deg) and |delta d| <= 0.2, with
  the sign flip when the normals face opposite ways;
- an unmatched observation allocates a new landmark whose world value is
  the body-frame plane pushed through the inverse pose;
- covariance projection camera -> IMU with the transform's tangent
  Jacobian (``transform_plane_cov``), in closed form.

``PlaneLandmarkBook`` is host bookkeeping in numpy, as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import se3
from . import oriented_plane

__all__ = ["PlaneLandmarkBook", "transform_plane_cov", "match_plane",
           "plane_to_world"]

_COS_10_DEG = float(np.cos(10.0 * np.pi / 180.0))


def _transform_jacobian(plane, R, t):
    """3x3 tangent Jacobian of ``oriented_plane.transform`` wrt the plane.

    With B = basis(n), B' = basis(R^T n), a tangent perturbation
    (xi_n, xi_d) maps to

        xi'_n = B'^T R^T B xi_n        (normal chart-to-chart rotation)
        xi'_d = t^T B xi_n + xi_d      (d' = d + n . t)
    """
    n = plane[..., :3]
    B = oriented_plane.basis(n)
    n_out = torch.einsum("...ji,...j->...i", R, n)
    B_out = oriented_plane.basis(n_out)
    Jn = torch.einsum("...ia,...ji,...jb->...ab", B_out, R, B)   # (2, 2)
    Jd = torch.einsum("...i,...ib->...b", t, B)                   # (2,)
    top = torch.cat([Jn, torch.zeros_like(Jn[..., :1])], dim=-1)
    bot = torch.cat([Jd, torch.ones_like(Jd[..., :1])], dim=-1)[..., None, :]
    return torch.cat([top, bot], dim=-2)


def transform_plane_cov(plane, cov3, pose: se3.Pose):
    """Push plane(s) and their (2+1) tangent covariance through a pose:
    ``S_upj = J S_upi J^T`` with the closed-form tangent Jacobian.
    Broadcasts over the planes' leading axes."""
    J = _transform_jacobian(plane, pose.R, pose.t)
    out = oriented_plane.transform(plane, pose.R, pose.t)
    return out, J @ cov3 @ J.transpose(-1, -2)


def plane_to_world(plane_body, pose_world: se3.Pose):
    """Body-frame plane -> world landmark: transform by the inverse pose."""
    inv = se3.inverse(pose_world)
    return oriented_plane.transform(plane_body, inv.R, inv.t)


def match_plane(plane_obs, landmark_world_list, pose_world: se3.Pose,
                cos_thresh: float = _COS_10_DEG, d_thresh: float = 0.2):
    """Index of the matching landmark, or -1 (a host int).

    ``plane_obs`` is in the observation (body) frame; each candidate world
    landmark is transformed into that frame and compared by normal angle
    and distance offset, with the sign flip.
    """
    if len(landmark_world_list) == 0:
        return -1
    cands = torch.stack(list(landmark_world_list))
    k = len(landmark_world_list)
    pred = oriented_plane.transform(cands, pose_world.R.expand(k, 3, 3),
                                    pose_world.t.expand(k, 3))
    ni = torch.as_tensor(plane_obs, dtype=pred.dtype, device=pred.device)
    cosa = pred[:, :3] @ ni[:3]
    sign = torch.where(cosa < 0, -1.0, 1.0).to(cosa.dtype)
    cosa = cosa * sign
    dd = torch.abs(sign * ni[3] - pred[:, 3])
    ok = (cosa >= cos_thresh) & (dd <= d_thresh)
    score = torch.where(ok, cosa, torch.full_like(cosa, -torch.inf))
    best = int(torch.argmax(score))
    return best if bool(ok[best]) else -1


def _host(x):
    """A pose block or plane as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


@dataclasses.dataclass
class PlaneLandmarkBook:
    """Host-side landmark registry: ids, last-seen node, counts, window."""

    lookback: int = 7

    def __post_init__(self):
        self.world: list[np.ndarray] = []      # initial world plane values
        self.last_seen: list[int] = []
        self.seen_count: list[int] = []
        self.node_landmarks: dict[int, list[int]] = {}

    def candidates(self, node_id: int) -> list[int]:
        """Landmark ids observed in the last ``lookback`` nodes."""
        out: list[int] = []
        for nid in range(max(0, node_id - self.lookback), node_id + 1):
            for lid in self.node_landmarks.get(nid, []):
                if lid not in out:
                    out.append(lid)
        return out

    def observe(self, node_id: int, lid: int) -> None:
        """Record a re-observation of a known landmark (propagation-carried
        ids skip the geometric match)."""
        self.last_seen[lid] = node_id
        self.seen_count[lid] += 1
        self.node_landmarks.setdefault(node_id, []).append(lid)

    def associate(self, node_id: int, plane_body, pose_world: se3.Pose,
                  cos_thresh: float = _COS_10_DEG,
                  d_thresh: float = 0.2) -> tuple[int, bool]:
        """``(landmark_id, is_new)`` for a body-frame observation, in numpy
        (the candidate set is the few landmarks of the lookback window);
        the same test as ``match_plane``. ``pose_world`` may hold numpy
        arrays or tensors."""
        cand_ids = self.candidates(node_id)
        R = _host(pose_world.R)
        t = _host(pose_world.t)
        ni = _host(plane_body)
        best, best_cos = -1, -np.inf
        for lid_ in cand_ids:
            w = self.world[lid_]
            # oriented_plane.transform(w, R, t): n' = R^T n, d' = d + n.t
            n_pred = R.T @ w[:3]
            d_pred = w[3] + w[:3] @ t
            c = float(n_pred @ ni[:3])
            sign = -1.0 if c < 0 else 1.0
            c *= sign
            if (c >= cos_thresh and abs(sign * ni[3] - d_pred) <= d_thresh
                    and c > best_cos):
                best, best_cos = lid_, c
        if best >= 0:
            self.observe(node_id, best)
            return best, False
        lid = len(self.world)
        # plane_to_world in numpy: transform by the inverse pose
        # (Ri, ti) = (R^T, -R^T t) -> n_w = R n, d_w = d - n . (R^T t)
        w = np.concatenate([R @ ni[:3], [ni[3] - ni[:3] @ (R.T @ t)]])
        self.world.append(w)
        self.last_seen.append(node_id)
        self.seen_count.append(1)
        self.node_landmarks.setdefault(node_id, []).append(lid)
        return lid, True
