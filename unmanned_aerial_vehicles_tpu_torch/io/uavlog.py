"""Streaming binary flight-log ("uavlog"): ctypes binding and NumPy
fallback (port of ``io/uavlog.py``).

The rosbag-recording role (the analyser's is ``flight_log`` and
``metrics.tracking``). A recording is a fixed-schema frame log written by
the port's ``native/uavlog.cpp`` (buffered appends, crash-safe: a torn
final frame is dropped on read), built with ``g++`` into the package's
git-ignored ``_build/native/`` at first use, with a byte-identical NumPy
implementation where no compiler is present.

Format UAVLOG01 (little-endian):
``magic[8] | u32 n_channels | per channel (u32 name_len, name, u32 width) |
frames (n x total_width f32, row-major)``.

Use ``UavLogWriter`` for streaming appends from a host control loop, or
``write_uavlog`` to dump a finished rollout dict (tensors or arrays);
``read_uavlog`` returns ``{channel: (T, width) float32}`` numpy arrays
(width-1 channels squeeze to ``(T,)``).
"""

from __future__ import annotations

import ctypes
import struct
import subprocess

import numpy as np

from .fast_csv import build_native

MAGIC = b"UAVLOG01"

_lib = None
_lib_failed = False


def _get_lib():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        lib = ctypes.CDLL(str(build_native("uavlog.cpp", "libuavlog.so")))
        lib.uavlog_open_writer.restype = ctypes.c_void_p
        lib.uavlog_open_writer.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.uavlog_append.restype = ctypes.c_long
        lib.uavlog_append.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ]
        lib.uavlog_flush.restype = ctypes.c_long
        lib.uavlog_flush.argtypes = [ctypes.c_void_p]
        lib.uavlog_close.restype = ctypes.c_long
        lib.uavlog_close.argtypes = [ctypes.c_void_p]
        lib.uavlog_info.restype = ctypes.c_long
        lib.uavlog_info.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long,
        ]
        lib.uavlog_read.restype = ctypes.c_long
        lib.uavlog_read.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ]
        _lib = lib
    except (OSError, subprocess.CalledProcessError):
        _lib_failed = True
        _lib = None
    return _lib


def native_available() -> bool:
    return _get_lib() is not None


def _host(v) -> np.ndarray:
    """A numpy view of an array or a tensor on any device."""
    if hasattr(v, "detach"):
        v = v.detach().cpu()
    return np.asarray(v)


def _normalize_channels(channels) -> list:
    """-> [(name, width)]; accepts dict or sequence of pairs."""
    items = list(channels.items()) if isinstance(channels, dict) else list(channels)
    out = []
    for name, width in items:
        width = int(width)
        if not name or ":" in name or "," in name or width <= 0:
            raise ValueError(f"bad channel {name!r}:{width}")
        out.append((str(name), width))
    if not out:
        raise ValueError("at least one channel required")
    return out


def _spec_string(channels: list) -> str:
    return ",".join(f"{n}:{w}" for n, w in channels)


def _header_bytes(channels: list) -> bytes:
    parts = [MAGIC, struct.pack("<I", len(channels))]
    for name, width in channels:
        nb = name.encode()
        parts.append(struct.pack("<I", len(nb)) + nb + struct.pack("<I", width))
    return b"".join(parts)


class UavLogWriter:
    """Streaming frame recorder (context manager).

    ``channels``: ``{name: width}`` in frame order. ``append`` takes a dict
    of per-channel values — scalars / ``(w,)`` rows for one frame, or
    ``(T, w)`` blocks for T frames — and writes them as packed f32 frames.
    """

    def __init__(self, path: str, channels):
        self.path = path
        self.channels = _normalize_channels(channels)
        self.width = sum(w for _, w in self.channels)
        self.frames = 0
        self._lib = _get_lib()
        self._handle = None
        self._file = None
        if self._lib is not None:
            self._handle = self._lib.uavlog_open_writer(
                path.encode(), _spec_string(self.channels).encode()
            )
        if self._handle is None:
            self._lib = None  # pure-python fallback
            self._file = open(path, "wb")
            self._file.write(_header_bytes(self.channels))

    def _pack(self, frame: dict) -> np.ndarray:
        cols = []
        T = None
        for name, w in self.channels:
            if name not in frame:
                raise KeyError(f"channel {name!r} missing from frame")
            arr = _host(frame[name]).astype(np.float32, copy=False)
            if arr.ndim == 0:
                arr = arr.reshape(1, 1)
            elif arr.ndim == 1:
                # (w,) = one frame; (T,) = T frames of a width-1 channel
                arr = arr.reshape(1, w) if arr.shape[0] == w and w > 1 \
                    else arr.reshape(-1, 1)
            if arr.shape[1] != w:
                raise ValueError(
                    f"channel {name!r}: expected width {w}, got {arr.shape}"
                )
            if T is None:
                T = arr.shape[0]
            elif arr.shape[0] != T:
                raise ValueError("channels disagree on frame count")
            cols.append(arr)
        return np.ascontiguousarray(np.concatenate(cols, axis=1))

    def append(self, frame: dict) -> int:
        """Append one frame (or a (T, w) block per channel); returns total
        frames written."""
        block = self._pack(frame)
        n = block.shape[0]
        if self._lib is not None:
            got = self._lib.uavlog_append(
                self._handle,
                block.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                n,
            )
            if got < 0:
                # the native writer rolled the file back to the last
                # complete frame; the recording remains appendable
                raise IOError(f"uavlog append failed on {self.path}")
            self.frames = int(got)
        else:
            pos = self._file.tell()
            try:
                self._file.write(block.tobytes())
            except OSError:
                # mirror the native writer: roll back to the last complete
                # frame so no torn frame is left mid-file
                self._file.flush()
                self._file.seek(pos)
                self._file.truncate(pos)
                raise
            self.frames += n
        return self.frames

    def flush(self) -> None:
        if self._lib is not None:
            self._lib.uavlog_flush(self._handle)
        else:
            self._file.flush()

    def close(self) -> int:
        if self._lib is not None:
            if self._handle is not None:
                self._lib.uavlog_close(self._handle)
                self._handle = None
        elif self._file is not None:
            self._file.close()
            self._file = None
        return self.frames

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _read_header(f) -> list:
    if f.read(8) != MAGIC:
        raise ValueError("not a UAVLOG01 file")
    (n_channels,) = struct.unpack("<I", f.read(4))
    if not 0 < n_channels <= 4096:
        raise ValueError("corrupt uavlog header")
    channels = []
    for _ in range(n_channels):
        (name_len,) = struct.unpack("<I", f.read(4))
        name = f.read(name_len).decode()
        (width,) = struct.unpack("<I", f.read(4))
        channels.append((name, width))
    return channels


def read_uavlog(path: str) -> dict:
    """-> ``{channel: float32 array (T, w), or (T,) when w == 1}``."""
    with open(path, "rb") as f:
        channels = _read_header(f)
        header = f.tell()
    width = sum(w for _, w in channels)

    lib = _get_lib()
    if lib is not None:
        spec = ctypes.create_string_buffer(8192)
        frames = lib.uavlog_info(path.encode(), spec, len(spec))
        if frames >= 0:
            flat = np.empty((max(int(frames), 1), width), np.float32)
            got = lib.uavlog_read(
                path.encode(),
                flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                frames,
            )
            if got >= 0:
                flat = flat[: int(got)]
                return _split(flat, channels)
        # fall through to numpy on any native error
    raw = np.fromfile(path, np.float32, offset=header)
    frames = raw.shape[0] // width  # torn final frame dropped
    return _split(raw[: frames * width].reshape(frames, width), channels)


def _split(flat: np.ndarray, channels: list) -> dict:
    out = {}
    col = 0
    for name, w in channels:
        block = flat[:, col : col + w]
        out[name] = block[:, 0] if w == 1 else block
        col += w
    return out


def write_uavlog(path: str, outs: dict) -> int:
    """Dump a finished rollout dict as one uavlog.

    Keeps every entry whose leading dimension matches the tick count of
    ``state`` (per-tick channels, flattened to 2-D); run-level entries
    (``final_state``, scalars, metadata) belong in the npz format instead.
    Returns the number of frames written.
    """
    arrays = {k: _host(v) for k, v in outs.items()}
    if "state" not in arrays:
        raise ValueError("rollout dict has no 'state' channel")
    T = arrays["state"].shape[0]
    # known run-level outputs: their leading dimension can coincidentally
    # equal T (e.g. final_state (12,) when T == 12) — never per-tick data
    run_level = {"final_state", "final_covariance", "final_dataset"}
    channels, frame = [], {}
    for k, v in arrays.items():
        if v.ndim == 0 or v.shape[0] != T or k in run_level:
            continue
        flat = v.reshape(T, -1).astype(np.float32)
        channels.append((k, flat.shape[1]))
        frame[k] = flat
    with UavLogWriter(path, channels) as w:
        w.append(frame)
        return w.frames
