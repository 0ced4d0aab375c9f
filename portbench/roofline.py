"""The least time one H100 could take to verify a batch of signatures.

Bound = max(32-bit multiply-adds / (SMs x multiply-adds a clock x clock),
bytes / HBM bandwidth).  The work a signature needs is frozen here, for
each verify the benchmark's cells run, so that it stays the same whatever
kernel later does the verify:

* multiply-adds: the modular products and squarings one verify needs,
  each weighed by the 32-bit multiply-adds of an 8-word product and its
  reduction (:data:`IMADS`).  The counts are the mean over 1,024 lanes,
  one in 64 with a flipped s (which passes the range checks and does the
  whole walk), of the comb verify's formulas at a 256-entry, 8-tooth comb
  over affine table points: the P-256 comb with u1, u2 worked out by
  Montgomery products mod n, and the Ed25519 comb with R's curve check.
* bytes: each input read once and each output written once, per
  signature; and per launch the generator's comb table and the table of
  every registered key (256 entries of three 8-word coordinates).
"""

from __future__ import annotations

#: int32 multiply-adds a Hopper SM issues per clock (half the fp32 rate)
IMAD_PER_SM_CLOCK = 64
#: SMs and the boost clock of an H100 SXM (NVIDIA data sheet)
H100_SMS = 132
H100_CLOCK_HZ = 1.98e9
#: HBM3 bandwidth of an H100 SXM (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12

#: 32-bit multiply-adds of one 8-word modular product, by modulus and
#: kind: a*b is 64 wide products, a*a 36, a 32 x 32 -> 64-bit product
#: counting two.  Montgomery reduction mod n adds per word q = t0 * n0inv
#: (one) and q * n (8 wide products); mod the P-256 p it needs none (the
#: words of p are 0, 1 and 2^32 - 1); mod 2^255 - 19 it is a fold of the
#: high eight words times 38 (8 wide products).
IMADS = {"p_mul": 2 * 64, "p_sqr": 2 * 36,
         "n_mul": 2 * 64 + 8 * (1 + 2 * 8), "n_sqr": 2 * 36 + 8 * (1 + 2 * 8),
         "ed_mul": 2 * 64 + 2 * 8, "ed_sqr": 2 * 36 + 2 * 8}

#: products and squarings one signature's verify needs, by verify
OPS_PER_SIG = {
    "p256_comb": {"n_mul": 72.0, "n_sqr": 252.0, "p_mul": 1123.458,
                  "p_sqr": 92.992},
    "ed25519_comb": {"ed_mul": 597.833, "ed_sqr": 125.987},
}
#: bytes a signature reads and writes: P-256 e, r, s (32 each), its key
#: index and its verdict (4 each); Ed25519 s, h, R's x and y (32 each),
#: its host flag, its key index and its verdict (4 each)
BYTES_PER_SIG = {"p256_comb": 3 * 32 + 4 + 4, "ed25519_comb": 4 * 32 + 3 * 4}
#: one comb table: 256 entries of three 8-word coordinates
TABLE_BYTES = 256 * 3 * 8 * 4


def imads_per_sig(verify: str) -> float:
    return sum(IMADS[k] * v for k, v in OPS_PER_SIG[verify].items())


def bound_s(verify: str, sigs: int, launches: int, keys: int) -> float:
    """Seconds the card needs at least for ``sigs`` signatures in
    ``launches`` launches against ``keys`` registered keys."""
    ops_s = sigs * imads_per_sig(verify) / (
        H100_SMS * IMAD_PER_SM_CLOCK * H100_CLOCK_HZ)
    mem_s = (sigs * BYTES_PER_SIG[verify]
             + launches * (keys + 1) * TABLE_BYTES) / HBM_BYTES_PER_S
    return max(ops_s, mem_s)
