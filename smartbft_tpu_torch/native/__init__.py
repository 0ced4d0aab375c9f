"""Native (C++) host helpers, loaded via ctypes with Python fallbacks.

The WAL's frame append and CRC32C (``crc32c.cc``, ``wal_frame.cc``) and
the Ed25519 point decompression (``ed25519_fp.cc``) run in C++.  The
library is compiled with ``g++`` on first use into
``smartbft_tpu_torch/_build/`` (git-ignored) and cached there; a build
failure falls back to the pure-Python implementations, so neither the WAL
nor the Ed25519 host half hard-depends on a toolchain.  (The CUDA kernels
are built separately, by :mod:`smartbft_tpu_torch.csrc`, and never fall
back.)
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_LIB_NAME = "libsmartbft_native.so"
_SOURCES = ["crc32c.cc", "wal_frame.cc", "ed25519_fp.cc"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _build_lib(lib_path: str) -> bool:
    srcs = [os.path.join(_DIR, s) for s in _SOURCES]
    if not all(os.path.exists(s) for s in srcs):
        return False
    tmp = lib_path + f".tmp.{os.getpid()}"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, *srcs]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib_path)
        return True
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _stale(lib_path: str) -> bool:
    try:
        lib_mtime = os.path.getmtime(lib_path)
    except OSError:
        return True
    for s in _SOURCES:
        try:
            if os.path.getmtime(os.path.join(_DIR, s)) > lib_mtime:
                return True
        except OSError:
            pass  # source pruned from the deploy — the built lib stands
    return False


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None on failure."""
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:  # lock-free hot path
        return _lib
    with _lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        if os.environ.get("SMARTBFT_NO_NATIVE"):
            return None
        os.makedirs(_BUILD_DIR, exist_ok=True)
        lib_path = os.path.join(_BUILD_DIR, _LIB_NAME)
        if _stale(lib_path) and not _build_lib(lib_path):
            return None
        try:
            lib = ctypes.CDLL(lib_path, use_errno=True)
            lib.smartbft_crc32c_update.restype = ctypes.c_uint32
            lib.smartbft_crc32c_update.argtypes = [
                ctypes.c_uint32,
                ctypes.c_char_p,
                ctypes.c_size_t,
            ]
            lib.smartbft_wal_append.restype = ctypes.c_long
            lib.smartbft_wal_append.argtypes = [
                ctypes.c_int,
                ctypes.c_char_p,
                ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.c_int,
                ctypes.c_int,
            ]
            lib.smartbft_ed_decompress.restype = ctypes.c_int
            lib.smartbft_ed_decompress.argtypes = [ctypes.c_char_p,
                                                   ctypes.c_char_p]
            _lib = lib
        except (OSError, AttributeError):
            _lib = None
        return _lib


# ---------------------------------------------------------------------------
# crc32c
# ---------------------------------------------------------------------------

_PY_TABLE: Optional[list[int]] = None


def _py_table() -> list[int]:
    global _PY_TABLE
    if _PY_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ (poly if c & 1 else 0)
            table.append(c)
        _PY_TABLE = table
    return _PY_TABLE


def _crc32c_update_py(crc: int, data: bytes) -> int:
    table = _py_table()
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c_update(crc: int, data: bytes) -> int:
    """Castagnoli CRC with Go ``crc32.Update`` chaining semantics."""
    lib = load()
    if lib is not None:
        return lib.smartbft_crc32c_update(crc, data, len(data))
    return _crc32c_update_py(crc, data)


def using_native() -> bool:
    return load() is not None


# ---------------------------------------------------------------------------
# WAL frame append
# ---------------------------------------------------------------------------

def wal_append(fd: int, payload: bytes, crc: int, update_crc: bool,
               do_sync: bool = True) -> Optional[tuple[int, int]]:
    """One-call frame append: pack + CRC + write + fdatasync.

    Returns (frame_size, new_crc) or None when the native library is
    unavailable (caller falls back to the Python path).  Raises OSError on
    an I/O failure, mirroring what the Python path would raise.
    """
    lib = load()
    if lib is None:
        return None
    crc_io = ctypes.c_uint32(crc)
    n = lib.smartbft_wal_append(
        fd, payload, len(payload), ctypes.byref(crc_io),
        1 if update_crc else 0, 1 if do_sync else 0,
    )
    if n < 0:
        raise OSError(ctypes.get_errno(), "wal: native append failed")
    return int(n), int(crc_io.value)


# ---------------------------------------------------------------------------
# Ed25519 point decompression (ed25519_fp.cc)
# ---------------------------------------------------------------------------

def ed_available() -> bool:
    return load() is not None


def ed_decompress(comp: bytes) -> Optional[tuple[int, int]]:
    """RFC 8032 decompression of a 32-byte encoding; (x, y) ints, or None
    when the encoding is invalid.  Needs the native library
    (:func:`ed_available`)."""
    out = ctypes.create_string_buffer(64)
    if load().smartbft_ed_decompress(comp, out) == 0:
        return None
    raw = out.raw
    return (int.from_bytes(raw[:32], "little"),
            int.from_bytes(raw[32:], "little"))
