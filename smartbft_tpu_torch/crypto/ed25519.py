"""Ed25519 (RFC 8032), host half: keys, signing, the integer reference
verify, point decompression and the marshalling of verify items.

Everything here is Python ints and bytes on the host.  The batched
verification runs in the CUDA kernels of :mod:`.cuda_ed25519` (registered
keys, comb tables) and :mod:`.cuda_eddsa` (any key).  Verification is
cofactorless, as in Go's crypto/ed25519: [S]B == R + [h]A with h =
SHA-512(R || A || M) mod L, S < L, and R, A decoded by RFC 8032 §5.1.3
(y < p; x = 0 with the sign bit set is invalid).

R decompression (a square root mod p) runs once per signature and is the
host-prep hot spot of the batch path; it runs in the native helper
(``native/ed25519_fp.cc``) when that builds, else in Python.
"""

from __future__ import annotations

import functools
import hashlib
import secrets

import numpy as np

from .. import native

# --- curve constants (RFC 8032 §5.1) ---------------------------------------

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, -1, P)) % P
BY = (4 * pow(5, -1, P)) % P
BX = 15112221349535400772501151409588531511454012693041857206046113283949847762202
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1) mod p


# ---------------------------------------------------------------------------
# host-side reference arithmetic (Python ints) — keygen, sign, CPU verify
# ---------------------------------------------------------------------------

def _aff_add(p1, p2):
    """Affine Edwards addition over GF(P); (0, 1) is the identity.  The
    a = -1 formula is complete on this curve (d is not a square)."""
    x1, y1 = p1
    x2, y2 = p2
    den = D * x1 * x2 * y1 * y2 % P
    return ((x1 * y2 + x2 * y1) * pow(1 + den, -1, P) % P,
            (y1 * y2 + x1 * x2) * pow(1 - den, -1, P) % P)


def scalar_mult_int(k: int, point):
    """Double-and-add with Python ints (host-side; keygen/sign/verify)."""
    acc = (0, 1)
    addend = point
    while k:
        if k & 1:
            acc = _aff_add(acc, addend)
        addend = _aff_add(addend, addend)
        k >>= 1
    return acc


def compress(point) -> bytes:
    x, y = point
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _decompress_py(data: bytes):
    """RFC 8032 §5.1.3 in Python ints (the path without the native
    library)."""
    val = int.from_bytes(data, "little")
    sign = val >> 255
    y = val & ((1 << 255) - 1)
    if y >= P:
        return None
    yy = y * y % P
    u = (yy - 1) % P
    v = (D * yy + 1) % P
    # candidate root of u/v: (u*v^3) * (u*v^7)^((p-5)/8)
    x = u * pow(v, 3, P) * pow(u * pow(v, 7, P) % P, (P - 5) // 8, P) % P
    if v * x * x % P != u:
        x = x * SQRT_M1 % P
        if v * x * x % P != u:
            return None
    if x == 0 and sign:
        return None
    if x & 1 != sign:
        x = P - x
    return (x, y)


def decompress(data: bytes):
    """32-byte encoding -> affine point, or None if invalid."""
    if len(data) != 32:
        return None
    if native.ed_available():
        return native.ed_decompress(data)
    return _decompress_py(data)


def _clamp(raw: bytes) -> int:
    a = bytearray(raw)
    a[0] &= 248
    a[31] &= 127
    a[31] |= 64
    return int.from_bytes(bytes(a), "little")


def keygen(seed: bytes | None = None):
    """Returns (private_key_bytes, public_key_bytes).  Deterministic with a
    seed, and the same keys as the JAX package derives from that seed."""
    if seed is None:
        priv = secrets.token_bytes(32)
    else:
        priv = hashlib.sha256(b"ed25519-keygen" + seed).digest()
    h = hashlib.sha512(priv).digest()
    return priv, compress(scalar_mult_int(_clamp(h[:32]), (BX, BY)))


@functools.lru_cache(maxsize=256)
def _expand_key(priv: bytes) -> tuple[int, bytes, bytes]:
    """(clamped scalar, prefix, public key), fixed per private key."""
    h = hashlib.sha512(priv).digest()
    a = _clamp(h[:32])
    return a, h[32:], compress(scalar_mult_int(a, (BX, BY)))


def sign(priv: bytes, msg: bytes) -> bytes:
    """RFC 8032 §5.1.6 deterministic signature; returns 64 bytes R || S."""
    a, prefix, pub = _expand_key(priv)
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L
    r_enc = compress(scalar_mult_int(r, (BX, BY)))
    k = int.from_bytes(
        hashlib.sha512(r_enc + pub + msg).digest(), "little") % L
    s = (r + k * a) % L
    return r_enc + s.to_bytes(32, "little")


def binding_hash(r_enc: bytes, pub: bytes, msg: bytes) -> int:
    """h = SHA-512(R || A || M) mod L."""
    return int.from_bytes(
        hashlib.sha512(r_enc + pub + msg).digest(), "little") % L


def verify_int(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """Pure-Python Ed25519 verify: the reference every device path is held
    to, and the host engine's arithmetic."""
    if len(sig) != 64:
        return False
    a_pt = decompress(pub)
    r_pt = decompress(sig[:32])
    if a_pt is None or r_pt is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    k = binding_hash(sig[:32], pub, msg)
    lhs = scalar_mult_int(s, (BX, BY))
    rhs = _aff_add(r_pt, scalar_mult_int(k, a_pt))
    return lhs == rhs


# ---------------------------------------------------------------------------
# scheme API (uniform surface the verify engines/providers program against)
# ---------------------------------------------------------------------------

try:  # native signing fast path: RFC 8032 is deterministic, so OpenSSL
    # gives byte-identical signatures to the pure-Python sign()
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey as _CgEd25519,
    )

    @functools.lru_cache(maxsize=256)
    def _cg_key(priv: bytes):
        return _CgEd25519.from_private_bytes(priv)

    def _sign_native(priv: bytes, msg: bytes) -> bytes:
        return _cg_key(priv).sign(msg)
except Exception as _exc:  # pragma: no cover — wheel absent/broken
    import logging as _logging

    _logging.getLogger("smartbft_tpu_torch.crypto").warning(
        "native Ed25519 signer unavailable (%s); falling back to the "
        "pure-Python signer", _exc,
    )
    _sign_native = None


def sign_raw(priv: bytes, msg: bytes) -> bytes:
    if _sign_native is not None:
        return _sign_native(priv, msg)
    return sign(priv, msg)


def make_item(msg: bytes, sig: bytes, pub: bytes):
    return (msg, sig, pub)


def verify_item(item) -> bool:
    msg, sig, pub = item
    return verify_int(pub, msg, sig)


@functools.lru_cache(maxsize=1024)
def _decompress_pub(pub: bytes):
    """Signer keys come from the small static membership set: memoize their
    decompression.  R's stays uncached — unique per signature."""
    return decompress(pub)


def verify_inputs(items) -> tuple[np.ndarray, ...]:
    """[(msg, sig64, pub32), ...] -> the generic kernel's inputs: six (B, 32)
    uint8 little-endian arrays s, h, rx, ry, ax, ay and a (B,) int32 host
    flag ``ok``, 0 where a signature or key does not decode (those lanes
    carry identity coordinates).  ``s`` is passed as sent: the kernel
    checks s < L itself."""
    n = len(items)
    s8, h8, rx8, ry8, ax8, ay8 = (np.zeros((n, 32), np.uint8)
                                  for _ in range(6))
    ry8[:, 0] = 1  # identity placeholder for invalid lanes
    ay8[:, 0] = 1
    ok = np.zeros(n, np.int32)
    for i, (msg, sig, pub) in enumerate(items):
        if len(sig) != 64:
            continue
        r_pt = decompress(sig[:32])
        a_pt = _decompress_pub(pub)
        if r_pt is None or a_pt is None:
            continue
        s8[i] = np.frombuffer(sig[32:], np.uint8)
        h8[i] = np.frombuffer(
            binding_hash(sig[:32], pub, msg).to_bytes(32, "little"), np.uint8)
        for dst, v in ((rx8, r_pt[0]), (ry8, r_pt[1]),
                       (ax8, a_pt[0]), (ay8, a_pt[1])):
            dst[i] = np.frombuffer(v.to_bytes(32, "little"), np.uint8)
        ok[i] = 1
    return s8, h8, rx8, ry8, ax8, ay8, ok
