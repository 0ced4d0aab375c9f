"""Native (C++) host helpers, loaded via ctypes with Python fallbacks.

The WAL's frame append and CRC32C (``crc32c.cc``, ``wal_frame.cc``), the
Ed25519 point decompression (``ed25519_fp.cc``) and the BLS12-381 group
arithmetic (``bls381.cc``) run in C++.  The
library is compiled with ``g++`` on first use into
``smartbft_tpu_torch/_build/`` (git-ignored) and cached there; a build
failure falls back to the pure-Python implementations, so neither the WAL
nor the Ed25519 and BLS12-381 host halves hard-depend on a toolchain.
(The CUDA kernels are built separately, by :mod:`smartbft_tpu_torch.csrc`,
and never fall back.)
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
_SOURCES = ["crc32c.cc", "wal_frame.cc", "bls381.cc", "ed25519_fp.cc"]

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
            buf, sz = ctypes.c_char_p, ctypes.c_size_t
            for name in ("smartbft_bls_g1_mul", "smartbft_bls_g1_mul_glv",
                         "smartbft_bls_g2_mul"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [buf, sz, buf, ctypes.c_char_p]
            for name in ("smartbft_bls_g1_sum", "smartbft_bls_g2_sum"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [buf, sz, ctypes.c_char_p]
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
# BLS12-381 group arithmetic (bls381.cc)
#
# Points cross the boundary as big-endian byte buffers: G1 affine = x||y
# (96B), G2 affine = x_c0||x_c1||y_c0||y_c1 (192B); infinity is rc=0.
# Python-side points use the same representation as crypto/bls12381.py:
# G1 = (x, y) ints, G2 = ((x0, x1), (y0, y1)), None = infinity.
# ---------------------------------------------------------------------------

def bls_available() -> bool:
    return load() is not None


def _g1_bytes(pt) -> bytes:
    if pt is None:
        return b"\x00" * 96
    return pt[0].to_bytes(48, "big") + pt[1].to_bytes(48, "big")


def _g1_point(rc: int, out) -> Optional[tuple]:
    if rc == 0:
        return None
    raw = bytes(out)
    return (int.from_bytes(raw[:48], "big"), int.from_bytes(raw[48:96], "big"))


def _g2_bytes(pt) -> bytes:
    if pt is None:
        return b"\x00" * 192
    (x0, x1), (y0, y1) = pt
    return (x0.to_bytes(48, "big") + x1.to_bytes(48, "big")
            + y0.to_bytes(48, "big") + y1.to_bytes(48, "big"))


def _g2_point(rc: int, out) -> Optional[tuple]:
    if rc == 0:
        return None
    raw = bytes(out)
    c = [int.from_bytes(raw[i * 48:(i + 1) * 48], "big") for i in range(4)]
    return ((c[0], c[1]), (c[2], c[3]))


def _scalar(k: int) -> bytes:
    return k.to_bytes(max(1, (k.bit_length() + 7) // 8), "big")


def bls_g1_mul(k: int, pt) -> Optional[tuple]:
    """k * P on G1 (affine ints); None = infinity.  k taken as given."""
    scalar = _scalar(k)
    out = ctypes.create_string_buffer(96)
    rc = load().smartbft_bls_g1_mul(scalar, len(scalar), _g1_bytes(pt), out)
    return _g1_point(rc, out.raw)


def bls_g1_mul_torsion(k: int, pt) -> Optional[tuple]:
    """GLV-accelerated k * P, ONLY for P in the r-torsion subgroup (a
    hash-to-curve output or a validated key).  The endomorphism identity
    phi(P) = lambda*P fails off the subgroup, so subgroup checks and
    cofactor clearing must call :func:`bls_g1_mul` instead."""
    scalar = _scalar(k)
    out = ctypes.create_string_buffer(96)
    rc = load().smartbft_bls_g1_mul_glv(scalar, len(scalar), _g1_bytes(pt),
                                        out)
    return _g1_point(rc, out.raw)


def bls_g1_sum(points) -> Optional[tuple]:
    pts = [p for p in points if p is not None]
    if not pts:
        return None
    blob = b"".join(_g1_bytes(p) for p in pts)
    out = ctypes.create_string_buffer(96)
    rc = load().smartbft_bls_g1_sum(blob, len(pts), out)
    return _g1_point(rc, out.raw)


def bls_g2_mul(k: int, pt) -> Optional[tuple]:
    scalar = _scalar(k)
    out = ctypes.create_string_buffer(192)
    rc = load().smartbft_bls_g2_mul(scalar, len(scalar), _g2_bytes(pt), out)
    return _g2_point(rc, out.raw)


def bls_g2_sum(points) -> Optional[tuple]:
    pts = [p for p in points if p is not None]
    if not pts:
        return None
    blob = b"".join(_g2_bytes(p) for p in pts)
    out = ctypes.create_string_buffer(192)
    rc = load().smartbft_bls_g2_sum(blob, len(pts), out)
    return _g2_point(rc, out.raw)


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
