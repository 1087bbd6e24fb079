"""ctypes bindings for the native IO runtime (``gst_native.cpp``) — a copy
of ``graph_slam_tpu/native/__init__.py`` with the port's build rule.

The library is compiled on first use with ``g++`` (it exposes a C ABI; no
pybind11) into ``graph_slam_tpu_torch/_build/libgst_native-<hash>.so``,
named by a hash of the source, the flags, the compiler's version and the
host's machine and C library, as ``kernels/build.py`` names the CUDA
libraries: an edited source or another toolchain or host rebuilds, an
unchanged one loads what is there. Every entry point has a pure Python/numpy fallback at its call
site, so the package works without a toolchain; ``available()`` says
whether the library loaded. These are host IO paths: no device work.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import tempfile

import numpy as np

__all__ = ["available", "library_path", "parse_vro_log", "write_vro_log",
           "parse_table", "read_frame_u16", "read_frames_u16",
           "write_cloud_ascii"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "gst_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_FLAGS = ["-O2", "-shared", "-fPIC"]
_LIB = None


@functools.lru_cache(maxsize=1)
def _toolchain() -> bytes:
    """``g++ --version`` and the host's machine and C library, so that a
    library built elsewhere is never picked up."""
    try:
        ver = subprocess.run(["g++", "--version"], capture_output=True,
                             timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        ver = b""
    return ver + " ".join([platform.machine(), *platform.libc_ver()]).encode()


def library_path() -> str:
    """Where the library of ``gst_native.cpp`` lives (built or not)."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()
                                + _toolchain())
    return os.path.join(_BUILD_DIR,
                        f"libgst_native-{digest.hexdigest()[:16]}.so")


def _build() -> str | None:
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # compile to a private name, then rename: a concurrent or interrupted
    # build never leaves a partial library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC, "-lpthread"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    path = _build()
    if path is None:
        _LIB = False
        return False
    try:
        lib = ctypes.CDLL(path)
        _bind(lib)
    except (OSError, AttributeError):
        _LIB = False
        return False
    _LIB = lib
    return lib


def _bind(lib) -> None:
    lib.gst_parse_vro_log.restype = ctypes.c_long
    lib.gst_parse_vro_log.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_long]
    lib.gst_write_vro_log.restype = ctypes.c_long
    lib.gst_write_vro_log.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_long]
    lib.gst_parse_table.restype = ctypes.c_long
    lib.gst_parse_table.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_long,
        ctypes.c_long]
    lib.gst_read_frame_u16.restype = ctypes.c_long
    lib.gst_read_frame_u16.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_ushort)]
    lib.gst_read_frames_u16.restype = ctypes.c_long
    lib.gst_read_frames_u16.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.POINTER(ctypes.c_ushort), ctypes.c_long]
    lib.gst_write_cloud_ascii.restype = ctypes.c_long
    lib.gst_write_cloud_ascii.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long, ctypes.c_int]


def available() -> bool:
    return bool(_load())


def parse_vro_log(path: str, max_records: int = 1 << 22):
    """(n, 29) float64 array of VRO records, or None if native unavailable."""
    lib = _load()
    if not lib:
        return None
    # upper-bound record count by file size / minimal record length
    try:
        cap = min(max_records, max(os.path.getsize(path) // 40, 1))
    except OSError:
        return None
    out = np.empty((cap, 29), np.float64)
    n = lib.gst_parse_vro_log(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cap)
    if n < 0:
        return None
    return out[:n]


def parse_table(path: str, n_cols: int, max_rows: int = 1 << 24):
    """(n, n_cols) float64 table parsed line-by-line (each line's first
    ``n_cols`` numbers; shorter lines skipped), or None if native
    unavailable. The trajectory-log / IMU-log reader (readTraj,
    readImuData roles)."""
    lib = _load()
    if not lib:
        return None
    try:
        # a minimal row is ~2 chars per number ("0 ") plus the newline
        cap = min(max_rows, max(os.path.getsize(path) // (2 * n_cols), 1))
    except OSError:
        return None
    out = np.empty((cap, n_cols), np.float64)
    n = lib.gst_parse_table(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_cols, cap)
    if n < 0:
        return None
    return out[:n]


def write_vro_log(path: str, data: np.ndarray) -> bool:
    lib = _load()
    if not lib:
        return False
    data = np.ascontiguousarray(data, np.float64)
    n = lib.gst_write_vro_log(
        path.encode(), data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(data))
    return n == len(data)


def read_frame_u16(path: str, w: int, h: int):
    """(h, w) uint16 frame or None (native-unavailable / short read)."""
    lib = _load()
    if not lib:
        return None
    out = np.empty((h, w), np.uint16)
    got = lib.gst_read_frame_u16(
        path.encode(), w, h,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ushort)))
    if got != w * h:
        return None
    return out


def write_cloud_ascii(path: str, header: str, points, colors,
                      mode: int) -> bool:
    """Native ASCII point-cloud body writer (savePCDFile / PLY role).

    ``mode``: 0 = xyz, 1 = xyz + packed-u32 rgb (PCD), 2 = xyz + r g b
    (PLY). Returns False when the native runtime is unavailable — callers
    fall back to the Python row loop.
    """
    lib = _load()
    if not lib:
        return False
    pts = np.ascontiguousarray(points, np.float32)
    n = len(pts)
    if mode in (1, 2):
        rgb = np.ascontiguousarray(colors, np.uint8)
        rgb_p = rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
    else:
        rgb_p = ctypes.POINTER(ctypes.c_ubyte)()
    got = lib.gst_write_cloud_ascii(
        path.encode(), header.encode(),
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), rgb_p, n,
        mode)
    return got == n


def read_frames_u16(paths, w: int, h: int, n_threads: int = 8):
    """(n, h, w) uint16 batch loaded with the pthread fan-out, or None."""
    lib = _load()
    if not lib:
        return None
    n = len(paths)
    out = np.empty((n, h, w), np.uint16)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    fails = lib.gst_read_frames_u16(
        arr, n, w, h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ushort)),
        n_threads)
    if fails != 0:
        return None
    return out
