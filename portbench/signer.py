"""Keys and signatures the benchmark makes from its seed.

Signing is OpenSSL through the ``cryptography`` wheel: RFC 6979
deterministic ECDSA for P-256 and RFC 8032 Ed25519, so one seed always
gives the same bytes.  Large pools are signed by a few spawned worker
processes.  The output is the program's wire format: a P-256 public key
is the affine point (x, y) and a signature r || s (32 bytes each,
big-endian); an Ed25519 key is its 32-byte encoding, a signature 64 bytes.
"""

from __future__ import annotations

import hashlib
import multiprocessing
import os

P256_N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551


def keys(scheme: str, seed: int, n: int) -> list[tuple]:
    """``n`` (private, public) pairs of ``scheme`` made from ``seed``."""
    out = []
    for i in range(n):
        raw = hashlib.sha256(b"portbench|%s|%d|%d"
                             % (scheme.encode(), seed, i)).digest()
        if scheme == "p256":
            from cryptography.hazmat.primitives.asymmetric import ec

            d = int.from_bytes(raw, "big") % (P256_N - 1) + 1
            pn = ec.derive_private_key(d, ec.SECP256R1()) \
                .public_key().public_numbers()
            out.append((d, (pn.x, pn.y)))
        elif scheme == "ed25519":
            from cryptography.hazmat.primitives.asymmetric.ed25519 import (
                Ed25519PrivateKey,
            )

            pub = Ed25519PrivateKey.from_private_bytes(raw).public_key() \
                .public_bytes_raw()
            out.append((raw, pub))
        else:
            raise ValueError(f"unknown scheme {scheme!r}")
    return out


def sign_many(scheme: str, private, msgs) -> list[bytes]:
    """Signatures of one key over ``msgs``, in order."""
    if scheme == "p256":
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric import ec
        from cryptography.hazmat.primitives.asymmetric.utils import (
            decode_dss_signature,
        )

        key = ec.derive_private_key(private, ec.SECP256R1())
        algo = ec.ECDSA(hashes.SHA256(), deterministic_signing=True)
        out = []
        for m in msgs:
            r, s = decode_dss_signature(key.sign(m, algo))
            out.append(r.to_bytes(32, "big") + s.to_bytes(32, "big"))
        return out
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
    )

    key = Ed25519PrivateKey.from_private_bytes(private)
    return [key.sign(m) for m in msgs]


def _sign_job(job) -> list[bytes]:
    return sign_many(*job)


def sign_jobs(jobs: list[tuple], workers: int) -> list[list[bytes]]:
    """``jobs``: (scheme, private, msgs) each; their signatures in order.
    With ``workers`` > 1 the jobs run in that many spawned processes,
    which are joined before this returns."""
    if workers <= 1 or len(jobs) <= 1:
        return [_sign_job(j) for j in jobs]
    ctx = multiprocessing.get_context("spawn")
    pool = ctx.Pool(min(workers, len(jobs)))
    try:
        out = pool.map(_sign_job, jobs, chunksize=1)
    finally:
        pool.close()
        pool.join()
    return out


def default_workers() -> int:
    return max(1, min(8, (os.cpu_count() or 1)))


def forge(scheme: str, sig: bytes) -> bytes:
    """``sig`` with the lowest bit of its s flipped: a signature that
    decodes and passes the range checks, and is invalid."""
    b = bytearray(sig)
    b[63 if scheme == "p256" else 32] ^= 1
    return bytes(b)
