"""Host limb helpers and a plain-torch Montgomery field.

Two layouts meet here:

* The JAX package's 16-bit limbs (little-endian, numpy ``uint32``), kept
  for the host helpers (:func:`to_limbs`, :func:`from_limbs`,
  :func:`batch_to_limbs`) so values carry across unchanged.
* The plain-torch field :class:`TorchMont`, which the plain versions of
  the CUDA kernels run on.  A field element is a ``(..., n)`` int64
  tensor of 16-bit limbs: every partial product fits 32 bits, a product
  column of 16 of them fits 36, and the low-half product by N' fits 56, so
  all of Montgomery's arithmetic stays exact in int64 without a carry
  per partial product.  R = 2**(16 n), exactly as the JAX package and the
  CUDA kernels (32-bit words) use it, so every Montgomery value is the
  same number in all three: n = 16 for the 256-bit moduli, 24 for the
  381-bit BLS12-381 field.

A product is one outer product, one skewed column sum and one carry pass
per stage (:func:`normalize`), which keeps the op count per field product
near 100 torch ops whatever the batch size.  Independent products of one
dataflow level are stacked along a leading axis (:func:`grp`) and run as
one call, the level-scheduling of the JAX package's kernels.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
NL = 16  # limbs of a 256-bit value


# ---------------------------------------------------------------------------
# host <-> limb conversion (the JAX package's 16-bit layout)
# ---------------------------------------------------------------------------

def to_limbs(x: int, nlimbs: int) -> np.ndarray:
    """Python int -> little-endian 16-bit limb vector (numpy uint32)."""
    if x < 0:
        raise ValueError("negative")
    out = np.zeros(nlimbs, dtype=np.uint32)
    for i in range(nlimbs):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    if x:
        raise ValueError("overflow: value does not fit in %d limbs" % nlimbs)
    return out


def from_limbs(arr) -> int:
    """Limb vector (1-D) -> Python int.  Host-side only."""
    a = np.asarray(arr, dtype=np.uint64)
    x = 0
    for i in range(a.shape[-1] - 1, -1, -1):
        x = (x << LIMB_BITS) | int(a[i])
    return x


def batch_to_limbs(xs, nlimbs: int) -> np.ndarray:
    """List of Python ints -> (B, nlimbs) uint32."""
    return np.stack([to_limbs(x, nlimbs) for x in xs])


def to_words(x: int) -> np.ndarray:
    """Python int < 2**256 -> (8,) uint32 little-endian 32-bit words, the
    CUDA kernels' limb layout."""
    return np.frombuffer(x.to_bytes(32, "little"), dtype=np.uint32).copy()


def from_words(arr) -> int:
    """(8,) 32-bit words -> Python int."""
    return int.from_bytes(np.asarray(arr, np.uint32).tobytes(), "little")


# ---------------------------------------------------------------------------
# tensor layout conversions
# ---------------------------------------------------------------------------

def bytes_to_limbs(a: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 little-endian bytes -> (..., 16) int64 limbs."""
    a = a.to(torch.int64)
    return a[..., 0::2] | (a[..., 1::2] << 8)


def words_to_limbs(a: torch.Tensor) -> torch.Tensor:
    """(..., 8) uint32/int32 words -> (..., 16) int64 16-bit limbs."""
    w = a.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & LIMB_MASK, w >> LIMB_BITS], dim=-1).flatten(-2)


def int_to_limbs(x: int, device) -> torch.Tensor:
    return torch.as_tensor(to_limbs(x, NL).astype(np.int64), device=device)


# ---------------------------------------------------------------------------
# carry handling
# ---------------------------------------------------------------------------

def _passes(bound_bits: int) -> int:
    """Local carry passes that bring columns below 2**bound_bits down to
    limbs <= 2**16 (each pass keeps 16 bits and moves the rest up)."""
    bound, n = (1 << bound_bits) - 1, 0
    while bound > (1 << LIMB_BITS):
        bound = LIMB_MASK + (bound >> LIMB_BITS)
        n += 1
    return n


_SHIFTS: dict = {}


def _shifts(m: int, device) -> torch.Tensor:
    key = (m, str(device))
    sh = _SHIFTS.get(key)
    if sh is None:
        sh = _SHIFTS[key] = torch.arange(m, dtype=torch.int64, device=device)
    return sh


def normalize(x: torch.Tensor, bound_bits: int):
    """(..., m) non-negative columns below 2**bound_bits -> (limbs, carry).

    ``limbs`` is the (..., m) 16-bit normal form of the value mod
    2**(16m); ``carry`` is the (...,) integer carried out of the top.
    After the local passes every limb is at most 2**16, so what is left is
    a chain of 0/1 carries.  Those resolve in one word addition: limb i
    generates a carry when it equals 2**16 and propagates one when it
    equals 2**16 - 1, which is bit i of X + Y with X = generate|propagate
    and Y = generate; the carry into limb i is bit i of (X + Y) ^ X ^ Y.
    """
    m = x.shape[-1]
    carry = torch.zeros_like(x[..., 0])
    for _ in range(_passes(bound_bits)):
        hi = x >> LIMB_BITS
        carry = carry + hi[..., -1]
        x = (x & LIMB_MASK) + F.pad(hi[..., :-1], (1, 0))
    sh = _shifts(m, x.device)
    g = x >> LIMB_BITS
    p = (x == LIMB_MASK).to(torch.int64)
    X = ((g | p) << sh).sum(-1)
    Y = (g << sh).sum(-1)
    S = X + Y
    cin = (((S ^ X ^ Y)[..., None]) >> sh) & 1
    return (x + cin) & LIMB_MASK, carry + ((S >> m) & 1)


def _cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product columns of (..., n) x (..., n) limbs: (..., 2n-1),
    unnormalized.  The (n, n) outer product is skewed so that row i moves
    right by i, and the column sums fall out of one reduction."""
    a, b = torch.broadcast_tensors(a, b)
    n = a.shape[-1]
    lead = a.shape[:-1]
    prod = a[..., :, None] * b[..., None, :]
    skew = F.pad(prod, (0, n)).reshape(*lead, 2 * n * n)
    return skew[..., : n * (2 * n - 1)].reshape(*lead, n, 2 * n - 1).sum(-2)


def grp(op, pairs):
    """Run k independent binary ops as ONE stacked call."""
    xs = torch.broadcast_tensors(*[x for pr in pairs for x in pr])
    return op(torch.stack(xs[0::2]), torch.stack(xs[1::2])).unbind(0)


def grp1(op, items):
    return op(torch.stack(torch.broadcast_tensors(*items))).unbind(0)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(-1)


def geq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a >= b for (..., 16) limbs: the carry out of a + (2**256 - b)."""
    x = a + (LIMB_MASK - b)
    x = torch.cat([x[..., :1] + 1, x[..., 1:]], dim=-1)
    return normalize(x, 18)[1] > 0


def add_raw(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain a + b -> (..., 17) limbs."""
    s = F.pad(a + b, (0, 1))
    return normalize(s, 17)[0]


class TorchMont:
    """Montgomery arithmetic mod an odd modulus below R = 2**(16 nlimbs):
    16 limbs (R = 2**256) for P-256 and Ed25519, 24 (R = 2**384) for the
    BLS12-381 base field.

    Every method takes and returns (..., nlimbs) int64 limb tensors; inputs
    to :meth:`mul` must be below R and their product below N*R (true for
    any value below N times any value below R), outputs are below N.

    Headroom: a product column sums at most nlimbs partial products below
    2**32, so below 2**37 for 24 limbs; :meth:`redc` takes a sum of up to
    ``terms`` such column arrays (2**40 for 9 terms), whose low half times
    N' stays below 2**61 in int64.
    """

    def __init__(self, modulus: int, device, nlimbs: int = NL):
        self.n = n = nlimbs
        R = 1 << (LIMB_BITS * n)
        self.R = R
        self.modulus = modulus
        self.device = torch.device(device)
        self.N = self.limbs(modulus)
        self.Np = self.limbs((-pow(modulus, -1, R)) % R)
        # 2**(16(n+1)) - N over n+1 limbs: adding it carries out iff the
        # value >= N
        self.NC = torch.as_tensor(
            to_limbs((1 << (LIMB_BITS * (n + 1))) - modulus, n + 1)
            .astype(np.int64), device=self.device)
        self.R2 = self.limbs((R * R) % modulus)
        self.one = self.limbs(R % modulus)
        self.raw_one = self.limbs(1)

    def limbs(self, x: int) -> torch.Tensor:
        """A Python int below R as (nlimbs,) int64 limbs on the device."""
        return torch.as_tensor(to_limbs(x, self.n).astype(np.int64),
                               device=self.device)

    def encode(self, x: int) -> torch.Tensor:
        return self.limbs((x * self.R) % self.modulus)

    def _cond_sub(self, t: torch.Tensor) -> torch.Tensor:
        """(..., n+1) value below 2N -> (..., n) value below N."""
        d, c = normalize(t + self.NC, 18)
        return torch.where((c > 0)[..., None], d[..., :self.n],
                           t[..., :self.n])

    def redc(self, T: torch.Tensor, terms: int = 1) -> torch.Tensor:
        """Montgomery reduction (T + m N) / R, below N, of product columns
        T (..., 2n - 1) that sum ``terms`` products of values below N; the
        value must stay below N R (``terms`` < R / N)."""
        n = self.n
        nb = (n - 1).bit_length()
        tb = 2 * LIMB_BITS + nb + (terms - 1).bit_length()  # T < 2**tb
        m_cols = _cols(T[..., :n], self.Np)[..., :n]     # < 2**(tb+16+nb)
        m, _ = normalize(m_cols, tb + LIMB_BITS + nb + 1)  # m = T N' mod R
        s = F.pad(T + _cols(m, self.N), (0, 2))          # < 2**(tb+1)
        s, _ = normalize(s, tb + 2)
        return self._cond_sub(s[..., n:])                # (T + mN) / R

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.redc(_cols(a, b))

    def sqr(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, a)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = torch.broadcast_tensors(a, b)
        s = F.pad(a + b, (0, 1))
        both, carry = normalize(torch.stack([s, s + self.NC]), 19)
        return torch.where((carry[1] > 0)[..., None], both[1, ..., :self.n],
                           both[0, ..., :self.n])

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = torch.broadcast_tensors(a, b)
        x = a + (LIMB_MASK - b)
        x = torch.cat([x[..., :1] + 1, x[..., 1:]], dim=-1)  # a - b + R
        both, carry = normalize(torch.stack([x, x + self.N]), 19)
        return torch.where((carry[0] > 0)[..., None], both[0], both[1])

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return self.sub(torch.zeros_like(a), a)

    def pow(self, a: torch.Tensor, e: int) -> torch.Tensor:
        """a^e for a Python-int exponent e > 0, Montgomery in and out:
        left-to-right square-and-multiply."""
        acc = a
        for bit in bin(e)[3:]:
            acc = self.sqr(acc)
            if bit == "1":
                acc = self.mul(acc, a)
        return acc

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """a^-1 by Fermat (the modulus is prime); 0 maps to 0."""
        return self.pow(a, self.modulus - 2)
