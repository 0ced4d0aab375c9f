"""The benchmark's plain reference: what `correct` is decided against.

Pure Python (hashlib and ints).  It imports nothing of the program under
test and takes nothing the program made: it works the signed bytes, the
digests and the verdicts out again from the inputs the benchmark made.

* the wire encodings the checks need (a proposal, a consenter's signed
  message, a batch of requests), written from the codec's rules: ints
  are 8-byte big-endian, bytes and strings a 4-byte big-endian length and
  the data, lists a 4-byte count and the elements, fields in order;
* P-256 ECDSA-SHA256 and Ed25519 (RFC 8032) verification;
* the chained ledger digest and the commit quorum of a group of n.
"""

from __future__ import annotations

import hashlib
import struct

_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")

# ---------------------------------------------------------------------------
# wire encodings
# ---------------------------------------------------------------------------


def enc_bytes(b: bytes) -> bytes:
    return _U32.pack(len(b)) + b


def enc_str(s: str) -> bytes:
    return enc_bytes(s.encode("utf-8"))


def enc_ids(ids) -> bytes:
    """A list of uint64 (the prepare witnesses a commit signature binds)."""
    return _U32.pack(len(ids)) + b"".join(_U64.pack(i) for i in ids)


def proposal_bytes(header: bytes, payload: bytes, metadata: bytes,
                   verification_sequence: int) -> bytes:
    return (enc_bytes(header) + enc_bytes(payload) + enc_bytes(metadata)
            + _U64.pack(verification_sequence))


def proposal_digest(header: bytes, payload: bytes, metadata: bytes,
                    verification_sequence: int) -> str:
    """Hex SHA-256 of the proposal's canonical encoding."""
    return hashlib.sha256(proposal_bytes(
        header, payload, metadata, verification_sequence)).hexdigest()


def consenter_sig_msg(digest_hex: str, aux: bytes) -> bytes:
    """The bytes a consenter signs for its commit vote."""
    return enc_str(digest_hex) + enc_bytes(aux)


def split_consenter_sig_msg(msg: bytes) -> tuple[str, bytes]:
    """(digest hex, aux) of a signed commit message; ValueError if the
    bytes are not exactly one such message."""
    n = _U32.unpack_from(msg, 0)[0]
    digest = msg[4:4 + n].decode("utf-8")
    off = 4 + n
    m = _U32.unpack_from(msg, off)[0]
    aux = msg[off + 4:off + 4 + m]
    if off + 4 + m != len(msg) or len(aux) != m:
        raise ValueError("not one consenter signature message")
    return digest, aux


def request_bytes(client_id: str, request_id: str, payload: bytes) -> bytes:
    return enc_str(client_id) + enc_str(request_id) + enc_bytes(payload)


def decode_batch(payload: bytes) -> list[tuple[str, str, bytes]]:
    """A committed batch -> its requests as (client, request id, payload)."""
    count = _U32.unpack_from(payload, 0)[0]
    off, out = 4, []
    for _ in range(count):
        n = _U32.unpack_from(payload, off)[0]
        raw = payload[off + 4:off + 4 + n]
        off += 4 + n
        fields, p = [], 0
        for _ in range(3):
            m = _U32.unpack_from(raw, p)[0]
            fields.append(raw[p + 4:p + 4 + m])
            p += 4 + m
        if p != len(raw):
            raise ValueError("trailing bytes in a request")
        out.append((fields[0].decode(), fields[1].decode(), fields[2]))
    if off != len(payload):
        raise ValueError("trailing bytes in a batch")
    return out


# ---------------------------------------------------------------------------
# ledgers and quorums
# ---------------------------------------------------------------------------

CHAIN_SEED = b"\x00" * 32


def chain_digest(entries) -> bytes:
    """SHA-256 chain over (payload, metadata) of each committed decision."""
    h = CHAIN_SEED
    for payload, metadata in entries:
        h = hashlib.sha256(h + payload + metadata).digest()
    return h


def quorum(n: int) -> tuple[int, int]:
    """(Q, f) of a group of n: f = (n - 1) // 3, Q = ceil((n + f + 1) / 2)."""
    f = (n - 1) // 3
    return -(-(n + f + 1) // 2), f


# ---------------------------------------------------------------------------
# P-256 ECDSA (FIPS 186-4), Jacobian coordinates, a = -3
# ---------------------------------------------------------------------------

P256_P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
P256_N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
P256_B = 0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B
P256_G = (0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
          0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5)
_INF = (1, 1, 0)


def _jdbl(pt):
    x, y, z = pt
    p = P256_P
    if z == 0 or y == 0:
        return _INF
    delta = z * z % p
    gamma = y * y % p
    beta = x * gamma % p
    alpha = 3 * (x - delta) * (x + delta) % p
    x3 = (alpha * alpha - 8 * beta) % p
    z3 = ((y + z) * (y + z) - gamma - delta) % p
    y3 = (alpha * (4 * beta - x3) - 8 * gamma * gamma) % p
    return x3, y3, z3


def _jadd(a, b):
    p = P256_P
    x1, y1, z1 = a
    x2, y2, z2 = b
    if z1 == 0:
        return b
    if z2 == 0:
        return a
    z1z1, z2z2 = z1 * z1 % p, z2 * z2 % p
    u1, u2 = x1 * z2z2 % p, x2 * z1z1 % p
    s1, s2 = y1 * z2 * z2z2 % p, y2 * z1 * z1z1 % p
    if u1 == u2:
        return _jdbl(a) if s1 == s2 else _INF
    h, r = (u2 - u1) % p, (s2 - s1) % p
    hh = h * h % p
    hhh = h * hh % p
    v = u1 * hh % p
    x3 = (r * r - hhh - 2 * v) % p
    y3 = (r * (v - x3) - s1 * hhh) % p
    return x3, y3, z1 * z2 * h % p


def p256_on_curve(pub) -> bool:
    x, y = pub
    p = P256_P
    return 0 <= x < p and 0 <= y < p \
        and (y * y - x * x * x + 3 * x - P256_B) % p == 0


def p256_verify(pub, msg: bytes, sig: bytes) -> bool:
    """ECDSA-SHA256 over P-256; ``sig`` is r || s, 32 bytes each, big-endian;
    ``pub`` the affine point (x, y)."""
    if len(sig) != 64 or not p256_on_curve(pub):
        return False
    n = P256_N
    r, s = int.from_bytes(sig[:32], "big"), int.from_bytes(sig[32:], "big")
    if not (1 <= r < n and 1 <= s < n):
        return False
    e = int.from_bytes(hashlib.sha256(msg).digest(), "big")
    w = pow(s, -1, n)
    u1, u2 = e * w % n, r * w % n
    g, q = P256_G + (1,), tuple(pub) + (1,)
    gq = _jadd(g, q)
    acc = _INF
    for i in range(255, -1, -1):
        acc = _jdbl(acc)
        pick = ((u1 >> i) & 1) | (((u2 >> i) & 1) << 1)
        if pick:
            acc = _jadd(acc, (g, q, gq)[pick - 1])
    x, _, z = acc
    if z == 0:
        return False
    zi = pow(z, -1, P256_P)
    return x * zi * zi % P256_P % n == r


# ---------------------------------------------------------------------------
# Ed25519 (RFC 8032 section 5.1), extended coordinates, a = -1
# ---------------------------------------------------------------------------

ED_P = 2**255 - 19
ED_L = 2**252 + 27742317777372353535851937790883648493
ED_D = -121665 * pow(121666, -1, ED_P) % ED_P
_ED_SQRT_M1 = pow(2, (ED_P - 1) // 4, ED_P)
_ED_BY = 4 * pow(5, -1, ED_P) % ED_P


def _ed_recover_x(y: int, sign: int):
    p = ED_P
    if y >= p:
        return None
    x2 = (y * y - 1) * pow(ED_D * y * y + 1, -1, p) % p
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (p + 3) // 8, p)
    if (x * x - x2) % p:
        x = x * _ED_SQRT_M1 % p
    if (x * x - x2) % p:
        return None
    if x & 1 != sign:
        x = p - x
    return x


def ed_decode_point(data: bytes):
    """32-byte encoding -> extended point, or None."""
    if len(data) != 32:
        return None
    val = int.from_bytes(data, "little")
    y = val & ((1 << 255) - 1)
    x = _ed_recover_x(y, val >> 255)
    if x is None:
        return None
    return x, y, 1, x * y % ED_P


_ED_B = (_ed_recover_x(_ED_BY, 0), _ED_BY, 1,
         _ed_recover_x(_ED_BY, 0) * _ED_BY % ED_P)
_ED_ID = (0, 1, 1, 0)


def _ed_add(a, b):
    p = ED_P
    x1, y1, z1, t1 = a
    x2, y2, z2, t2 = b
    aa = (y1 - x1) * (y2 - x2) % p
    bb = (y1 + x1) * (y2 + x2) % p
    cc = 2 * t1 * t2 * ED_D % p
    dd = 2 * z1 * z2 % p
    e, f, g, h = bb - aa, dd - cc, dd + cc, bb + aa
    return e * f % p, g * h % p, f * g % p, e * h % p


def _ed_equal(a, b) -> bool:
    p = ED_P
    return (a[0] * b[2] - b[0] * a[2]) % p == 0 \
        and (a[1] * b[2] - b[1] * a[2]) % p == 0


def ed25519_verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """[S]B == R + [k]A with k = SHA-512(R || A || M) mod L, S < L."""
    if len(sig) != 64:
        return False
    a_pt, r_pt = ed_decode_point(pub), ed_decode_point(sig[:32])
    if a_pt is None or r_pt is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= ED_L:
        return False
    k = int.from_bytes(hashlib.sha512(sig[:32] + pub + msg).digest(),
                       "little") % ED_L
    neg_a = ((-a_pt[0]) % ED_P, a_pt[1], 1, (-a_pt[3]) % ED_P)
    table = (_ED_B, neg_a, _ed_add(_ED_B, neg_a))
    acc = _ED_ID
    for i in range(255, -1, -1):
        acc = _ed_add(acc, acc)
        pick = ((s >> i) & 1) | (((k >> i) & 1) << 1)
        if pick:
            acc = _ed_add(acc, table[pick - 1])
    return _ed_equal(acc, r_pt)


VERIFY = {"p256": p256_verify, "ed25519": ed25519_verify}
