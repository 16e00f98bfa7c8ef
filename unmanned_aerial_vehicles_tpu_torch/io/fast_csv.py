"""ctypes binding for the native CSV parser, with a NumPy fallback (port of
``io/fast_csv.py``).

The shared library is built with ``g++`` from the port's own
``native/csv_loader.cpp`` at first use, into the package's git-ignored
``_build/native/<hash of the source>/``. Any failure (no compiler, a
failed build or load) falls back to ``numpy.genfromtxt``, which gives the
same values.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
NATIVE_SRC = _PKG / "native"
NATIVE_BUILD = _PKG / "_build" / "native"


def build_native(source: str, library: str) -> Path:
    """``native/<source>`` compiled into ``_build/native/<hash>/<library>``
    (once: the hash is the source's). The compiler writes a temporary file
    that is renamed into place, so processes building at once do not see a
    partial library."""
    src = NATIVE_SRC / source
    out_dir = NATIVE_BUILD / hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    target = out_dir / library
    if not target.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        try:
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, str(src)],
                           check=True, capture_output=True)
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return target


_lib = None
_lib_failed = False


def _get_lib():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        lib = ctypes.CDLL(str(build_native("csv_loader.cpp", "libuavcsv.so")))
        lib.uav_parse_csv.restype = ctypes.c_long
        lib.uav_parse_csv.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_long,
            ctypes.c_long,
            ctypes.c_int,
        ]
        lib.uav_count_rows.restype = ctypes.c_long
        lib.uav_count_rows.argtypes = [ctypes.c_char_p, ctypes.c_int]
        _lib = lib
    except (OSError, subprocess.CalledProcessError):
        _lib_failed = True
        _lib = None
    return _lib


def native_available() -> bool:
    return _get_lib() is not None


def load_numeric_csv(path: str, n_cols: int, skip_header: int = 1) -> np.ndarray:
    """Parse an all-numeric CSV into ``(rows, n_cols)`` float64: the native
    single-pass parser where it is available, ``numpy.genfromtxt``
    otherwise."""
    lib = _get_lib()
    if lib is not None:
        pathb = path.encode()
        n_rows = lib.uav_count_rows(pathb, skip_header)
        if n_rows > 0:
            out = np.empty((n_rows, n_cols), np.float64)
            got = lib.uav_parse_csv(
                pathb,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                n_rows,
                n_cols,
                skip_header,
            )
            if got >= 0:
                return out[:got]
        # fall through to numpy on any native error
    data = np.genfromtxt(path, delimiter=",", skip_header=skip_header, dtype=np.float64)
    return np.atleast_2d(data)
