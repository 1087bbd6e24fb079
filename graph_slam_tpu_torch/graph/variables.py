"""Variable arena: struct-of-arrays Values with padded shapes (port of
``graph/variables.py``).

One tensor per variable kind plus live counts. The global tangent vector
is laid out by capacity:

    [ poses (6 each) | vels (3) | biases (6) | planes (3) | points (3) ]
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3
from ..device import resolve
from ..planes import oriented_plane

__all__ = ["VariableArena", "TangentLayout", "layout_of", "used_slot_mask",
           "retract_all", "empty_arena"]


class VariableArena(NamedTuple):
    pose_R: torch.Tensor  # (Px, 3, 3)
    pose_t: torch.Tensor  # (Px, 3)
    vel: torch.Tensor     # (Pv, 3)
    bias: torch.Tensor    # (Pb, 6) — (acc, gyro), GTSAM imuBias order
    plane: torch.Tensor   # (Pl, 4) — (n, d), unit normal
    point: torch.Tensor   # (Pq, 3)
    num_poses: torch.Tensor   # 0-d int64 — live counts (<= capacity)
    num_vels: torch.Tensor
    num_biases: torch.Tensor
    num_planes: torch.Tensor
    num_points: torch.Tensor

    @property
    def poses(self) -> se3.Pose:
        return se3.Pose(self.pose_R, self.pose_t)


class TangentLayout(NamedTuple):
    """Global-tangent layout computed from arena capacities."""

    pose_cap: int
    vel_cap: int
    bias_cap: int
    plane_cap: int
    point_cap: int

    @property
    def pose_off(self) -> int:
        return 0

    @property
    def vel_off(self) -> int:
        return 6 * self.pose_cap

    @property
    def bias_off(self) -> int:
        return self.vel_off + 3 * self.vel_cap

    @property
    def plane_off(self) -> int:
        return self.bias_off + 6 * self.bias_cap

    @property
    def point_off(self) -> int:
        return self.plane_off + 3 * self.plane_cap

    @property
    def dim(self) -> int:
        return self.point_off + 3 * self.point_cap

    def pose_cols(self, idx):
        """(F,) pose indices -> (F, 6) global tangent columns."""
        return self.pose_off + 6 * idx[..., None] + torch.arange(
            6, device=idx.device)

    def vel_cols(self, idx):
        return self.vel_off + 3 * idx[..., None] + torch.arange(
            3, device=idx.device)

    def bias_cols(self, idx):
        return self.bias_off + 6 * idx[..., None] + torch.arange(
            6, device=idx.device)

    def plane_cols(self, idx):
        return self.plane_off + 3 * idx[..., None] + torch.arange(
            3, device=idx.device)

    def point_cols(self, idx):
        return self.point_off + 3 * idx[..., None] + torch.arange(
            3, device=idx.device)


def layout_of(values: VariableArena) -> TangentLayout:
    return TangentLayout(
        pose_cap=values.pose_R.shape[0],
        vel_cap=values.vel.shape[0],
        bias_cap=values.bias.shape[0],
        plane_cap=values.plane.shape[0],
        point_cap=values.point.shape[0],
    )


def used_slot_mask(values: VariableArena):
    """(dim,) 1.0 where the tangent slot belongs to a live variable."""
    lay = layout_of(values)
    dev = values.pose_t.device

    def block(cap, n, width):
        live = torch.arange(cap, device=dev) < n
        return torch.repeat_interleave(live, width)

    return torch.cat([
        block(lay.pose_cap, values.num_poses, 6),
        block(lay.vel_cap, values.num_vels, 3),
        block(lay.bias_cap, values.num_biases, 6),
        block(lay.plane_cap, values.num_planes, 3),
        block(lay.point_cap, values.num_points, 3),
    ]).to(values.pose_t.dtype)


def retract_all(values: VariableArena, delta) -> VariableArena:
    """Apply a global tangent step (GTSAM ``Values::retract``).

    Poses by SE(3) expmap retraction, planes by the sphere chart, the rest
    additively. Padded slots get zero delta and pass through unchanged.
    """
    lay = layout_of(values)
    d = delta
    dp = d[lay.pose_off:lay.pose_off + 6 * lay.pose_cap].reshape(lay.pose_cap, 6)
    dv = d[lay.vel_off:lay.vel_off + 3 * lay.vel_cap].reshape(lay.vel_cap, 3)
    db = d[lay.bias_off:lay.bias_off + 6 * lay.bias_cap].reshape(lay.bias_cap, 6)
    dl = d[lay.plane_off:lay.plane_off + 3 * lay.plane_cap].reshape(
        lay.plane_cap, 3)
    dq = d[lay.point_off:lay.point_off + 3 * lay.point_cap].reshape(
        lay.point_cap, 3)

    new_pose = se3.retract(se3.Pose(values.pose_R, values.pose_t), dp)
    return values._replace(
        pose_R=new_pose.R,
        pose_t=new_pose.t,
        vel=values.vel + dv,
        bias=values.bias + db,
        plane=oriented_plane.retract(values.plane, dl),
        point=values.point + dq,
    )


def empty_arena(pose_cap: int, vel_cap: int = 0, bias_cap: int = 0,
                plane_cap: int = 0, point_cap: int = 0, *,
                dtype=torch.float64, device=None) -> VariableArena:
    device = resolve(device)

    def z(*shape):
        return torch.zeros(*shape, dtype=dtype, device=device)

    plane0 = z(plane_cap, 4)
    plane0[:, 2] = 1.0  # valid unit normal placeholder

    def count():
        return torch.zeros((), dtype=torch.int64, device=device)

    return VariableArena(
        pose_R=torch.eye(3, dtype=dtype, device=device).repeat(pose_cap, 1, 1),
        pose_t=z(pose_cap, 3), vel=z(vel_cap, 3), bias=z(bias_cap, 6),
        plane=plane0, point=z(point_cap, 3),
        num_poses=count(), num_vels=count(), num_biases=count(),
        num_planes=count(), num_points=count(),
    )
