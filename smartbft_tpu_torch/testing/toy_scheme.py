"""Toy signature scheme: the verify plane without the bignum bill.

A scheme-shaped module (same surface as ``crypto.p256`` / ``crypto.
ed25519``: keygen / sign_raw / make_item / verify_inputs / verify_kernel /
verify_item) whose batched verify is four uint32 adds and a compare — one
torch expression on tensors — so consensus-level tests can run the REAL
provider stack (digest binding, aux transport, coalescer slicing,
breaker/fault contract) at any size in milliseconds.

NOT cryptography: the "signature" of ``msg`` under key ``k`` is
``blake2b128(msg) + k (mod 2^32, per word)`` and the public key IS the
private key.  Forgery is trivial by design — what the tests need is a
deterministic valid/invalid distinction a device kernel can check.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..crypto.provider import CryptoProvider

#: signature length (4 uint32 words)
SIG_BYTES = 16


def _digest_words(data: bytes) -> np.ndarray:
    h = hashlib.blake2b(bytes(data), digest_size=SIG_BYTES).digest()
    return np.frombuffer(h, dtype=np.uint32).copy()


def keygen(seed: bytes):
    """(private, public) — identical by construction (toy!)."""
    k = int.from_bytes(hashlib.blake2b(bytes(seed), digest_size=4).digest(),
                       "little")
    return k, k


def sign_raw(sk, data: bytes) -> bytes:
    words = _digest_words(data) + np.uint32(sk & 0xFFFFFFFF)
    return words.tobytes()


def sign(sk, data: bytes) -> bytes:  # alt-surface parity with real schemes
    return sign_raw(sk, data)


def make_item(msg: bytes, sig: bytes, pub) -> tuple:
    return (bytes(msg), bytes(sig), int(pub))


def verify_item(item) -> bool:
    """Host-side single-item verify (HostVerifyEngine / fallback path)."""
    msg, sig, pub = item
    return bytes(sig) == sign_raw(pub, msg)


def verify_inputs(items):
    """(digest words (n, 4), sig words (n, 4), key (n,)) uint32 arrays."""
    n = len(items)
    d = np.zeros((n, 4), np.uint32)
    s = np.zeros((n, 4), np.uint32)
    k = np.zeros((n,), np.uint32)
    for i, (msg, sig, pub) in enumerate(items):
        d[i] = _digest_words(msg)
        if len(sig) == SIG_BYTES:
            s[i] = np.frombuffer(bytes(sig), np.uint32)
        # wrong-length signatures leave the zero row: verifies False unless
        # the digest+key happens to be zero (2^-128)
        k[i] = np.uint32(int(pub) & 0xFFFFFFFF)
    return d, s, k


def verify_kernel(d, s, k):
    """Batched verify on tensors; rank-generic like the real schemes
    (leading batch dims pass through, the word axis is last).  Takes the
    uint32 arrays of :func:`verify_inputs` (numpy or torch, on any
    device) and returns a bool tensor.  The sum wraps mod 2^32: the words
    are widened to int64 and masked, since torch has no uint32 add."""
    import torch

    d, s, k = (torch.as_tensor(a).to(torch.int64) for a in (d, s, k))
    expect = (d + k[..., None]) & 0xFFFFFFFF
    return torch.all(s == expect, dim=-1)


class ToyCryptoProvider(CryptoProvider):
    """CryptoProvider over the toy scheme — full Signer/Verifier surface
    (digest binding, aux transport, batch/async coalesced paths) with a
    millisecond batched verify."""

    scheme = None  # the module object itself; assigned right below


import sys as _sys

ToyCryptoProvider.scheme = _sys.modules[__name__]
