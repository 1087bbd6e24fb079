"""IMU measurement streams: log readers, timestamp sync, static init — a
copy of ``graph_slam_tpu/imu/streams.py`` (numpy).

- VN-100 log format ``t ax ay az gx gy gz yaw pitch roll``, storing
  (gyro, accel) rows plus the RPY stream.
- raw MEMS integer logs with LSB->SI conversion and frame-id based sync
  detection.
- nearest-neighbor timestamp sync (``setStartPoint``/``findIndexAt``).
- static initialization: gravity direction from the averaged
  accelerometer and the prior bias from a static window.

Tables load through the native runtime (``native.parse_table``) when it is
built, with ``numpy.loadtxt`` as the fallback.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .presets import mems_accel_lsb_to_ms2, mems_gyro_lsb_to_rad

__all__ = ["ImuStream", "read_vn100_log", "read_mems_log", "find_index_at",
           "mems_frame_times", "static_bias_estimate",
           "gravity_aligning_rotation"]


@dataclasses.dataclass
class ImuStream:
    """Columnar IMU measurements at (approximately) fixed rate."""

    t: np.ndarray      # (N,) timestamps (s)
    acc: np.ndarray    # (N, 3) m/s^2
    gyr: np.ndarray    # (N, 3) rad/s
    dt: float          # nominal sample period
    rpy: np.ndarray | None = None  # (N, 3) device attitude stream, if any
    start: int = 0     # sync offset (setStartPoint)

    def __len__(self) -> int:
        return len(self.t)

    def set_start_time(self, t0: float) -> int:
        """Nearest-sample sync to an external clock (setStartPoint)."""
        idx = find_index_at(self.t, t0)
        if idx < 0:
            raise ValueError(f"cannot sync to t={t0}")
        self.start = idx
        return idx

    def window(self, i: int, j: int):
        """Measurement rows for interval [i, j) relative to the sync start."""
        lo = self.start + i
        hi = min(self.start + j, len(self.t))
        return self.acc[lo:hi], self.gyr[lo:hi]


def _load_table(path: str, n_cols: int) -> np.ndarray:
    """Numeric-table load through the native runtime (readImuData role,
    imu_vn100.cpp:78-105), numpy fallback when it is not built."""
    from .. import native

    data = native.parse_table(path, n_cols)
    if data is None:
        data = np.loadtxt(path)
        if data.ndim == 1:
            data = data[None, :]
    return data


def read_vn100_log(path: str) -> ImuStream:
    data = _load_table(path, 10)
    t = data[:, 0]
    acc = data[:, 1:4]
    gyr = data[:, 4:7]
    rpy = data[:, 7:10][:, ::-1]  # file order yaw pitch roll -> (r, p, y)
    return ImuStream(t=t, acc=acc, gyr=gyr, dt=1.0 / 200.0, rpy=rpy)


def read_mems_log(path: str, dt: float = 0.01) -> ImuStream:
    """Raw integer MEMS log: columns ``frame_id gx gy gz ax ay az`` (LSB)."""
    data = _load_table(path, 7)
    frame_id = data[:, 0]
    gyr = mems_gyro_lsb_to_rad(data[:, 1:4])
    acc = mems_accel_lsb_to_ms2(data[:, 4:7])
    t = np.arange(len(data)) * dt
    s = ImuStream(t=t, acc=acc, gyr=gyr, dt=dt)
    # sync point: first wrap/jump in the recorded frame ids
    jumps = np.nonzero(np.diff(frame_id) < 0)[0]
    if len(jumps):
        s.start = int(jumps[0]) + 1
    return s


def mems_frame_times(elapsed_ms, seqs=None, dt: float = 0.01,
                     start_index: int = 0) -> dict:
    """Per-frame timestamps from the MEMS rig's elapsed-time records.

    Missing or <20 ms -> 34 ms (nominal frame period), 100-150 ms ->
    doubled, >=150 ms -> x1.5, then ``round(elapsed / 10)`` IMU samples
    (10 ms each). Returns ``{seq: timestamp}`` on the stream's absolute
    time axis (``start_index`` = the stream's frame-id sync offset).
    """
    elapsed_ms = list(elapsed_ms)
    seqs = list(range(len(elapsed_ms))) if seqs is None else list(seqs)
    times = {}
    idx = 0
    for k, s in enumerate(seqs):
        e = float(elapsed_ms[k]) if k < len(elapsed_ms) else 34.0
        if e < 20.0:
            e = 34.0
        elif 100.0 < e < 150.0:
            e *= 2.0
        elif e >= 150.0:
            e *= 1.5
        idx += int(e / 10.0 + 0.5)
        times[s] = (start_index + idx) * dt
    return times


def find_index_at(timestamps: np.ndarray, t: float, start: int = 0) -> int:
    """Nearest-sample index for time ``t`` (findIndexAt).

    Returns -1 when ``t`` is past the last timestamp, like the reference.
    """
    ts = timestamps[start:]
    if len(ts) == 0 or ts[-1] < t:
        return -1
    i = int(np.searchsorted(ts, t, side="right"))
    if i == 0:
        return 0
    if i >= len(ts):
        return len(ts) - 1
    return i - 1 if (t - ts[i - 1]) <= (ts[i] - t) else i


def static_bias_estimate(stream: ImuStream, n_static: int,
                         gravity_mag: float = 9.81):
    """Prior bias from an initial static window.

    Gyro bias = mean rate; accel bias = mean specific force minus the
    gravity reaction along its own direction.
    """
    acc = stream.acc[:n_static]
    gyr = stream.gyr[:n_static]
    bg = gyr.mean(axis=0)
    a_mean = acc.mean(axis=0)
    g_dir = a_mean / np.linalg.norm(a_mean)
    ba = a_mean - g_dir * gravity_mag
    return np.concatenate([ba, bg]), g_dir


def gravity_aligning_rotation(acc_dir):
    """Rotation taking the measured gravity direction to +z
    (``CGraphGT::initFromImu``)."""
    fv = np.asarray(acc_dir, np.float64)
    fv = fv / np.linalg.norm(fv)
    tv = np.array([0.0, 0.0, 1.0])
    c = float(np.dot(fv, tv))
    if c > 1.0 - 1e-12:
        return np.eye(3)
    if c < -1.0 + 1e-12:
        return np.diag([1.0, -1.0, -1.0])
    w = np.cross(fv, tv)
    w = w / np.linalg.norm(w)
    ang = np.arccos(np.clip(c, -1.0, 1.0))
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    return np.eye(3) + np.sin(ang) * W + (1 - np.cos(ang)) * (W @ W)
