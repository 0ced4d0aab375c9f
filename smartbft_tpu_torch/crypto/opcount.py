"""The modular products and squarings a verify needs, counted from its
inputs: the work behind the bound ``chip_smoke.py`` reports for each
kernel (``mont_ops`` in each kernel module).

Every kernel walks an accumulator through doublings and additions of
table points.  The count is the kernels' formulas less what the verify
does not need: nothing while the accumulator is the identity (a doubling
of it is the identity, the first addition a copy), nothing for adding the
identity (a zero digit), fewer products where a point has Z = 1, and an
output's T (extended Edwards coordinates) only where an addition reads it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: what an addition adds to the accumulator: the identity (a zero digit),
#: an affine point (Z = 1) or a projective one; ``DBL`` marks a doubling
IDENT, AFFINE, PROJ = 0, 1, 2
DBL = None


@dataclasses.dataclass(frozen=True)
class Formulas:
    """Products and squarings of one curve's point formulas."""

    dbl: tuple  # (squarings, products) of a doubling
    dbl_affine: tuple  # the same where Z = 1
    add: tuple  # products of an addition with 0, 1 or 2 points at Z = 1
    t: int = 0  # the product of an output's T, apart


#: add-2008-hwcd-3 / dbl-2008-hwcd (a = -1): Z1·Z2 is a doubling where
#: either Z is 1, Z² is free where Z is 1, T is one product more
EDWARDS = Formulas(dbl=(4, 3), dbl_affine=(3, 3), add=(8, 7, 7), t=1)
#: RCB15 (a = -3): Algorithm 4 (12 products + 2 by b), Algorithm 5 where
#: one Z is 1 (11 + 2), and 10 where both are; Algorithm 6 (3 squarings,
#: 8 products + 2 by b), where Z = 1 less Z², X·Z, Y·Z and b·Z²
WEIERSTRASS = Formulas(dbl=(3, 10), dbl_affine=(2, 7), add=(14, 13, 10))


def walk_ops(steps, lanes: int, f: Formulas):
    """Products and squarings a walk needs, per lane.  ``steps`` is the
    walk in order: ``DBL`` or a (B,) array of the kinds of point an
    addition adds.  Returns (products, squarings, kind of the final
    accumulator), each (B,)."""
    acc = np.full(lanes, IDENT)
    t_unpaid = np.zeros(lanes, np.int64)
    mul = np.zeros(lanes, np.int64)
    sqr = np.zeros(lanes, np.int64)
    for step in steps:
        if step is DBL:
            live = acc != IDENT
            aff = acc == AFFINE
            sqr += live * np.where(aff, f.dbl_affine[0], f.dbl[0])
            mul += live * np.where(aff, f.dbl_affine[1], f.dbl[1])
            t_unpaid = np.where(live, f.t, t_unpaid)
            acc = np.where(live, PROJ, acc)
        else:
            add = (step != IDENT) & (acc != IDENT)
            copy = (step != IDENT) & (acc == IDENT)
            n_affine = (step == AFFINE).astype(np.int64) + (acc == AFFINE)
            cost = np.choose(n_affine, f.add)
            mul += np.where(add, t_unpaid + cost, 0)
            t_unpaid = np.where(add, f.t, np.where(copy, 0, t_unpaid))
            acc = np.where(add, PROJ, np.where(copy, step, acc))
    return mul, sqr, acc


def lane_ints(a) -> list:
    """(B, 32) little-endian bytes (array or tensor) -> B Python ints."""
    rows = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
    return [int.from_bytes(row.tobytes(), "little") for row in rows]


def lane_bytes(values) -> np.ndarray:
    """B Python ints below 2^256 -> (B, 32) little-endian uint8."""
    raw = bytearray(b"".join(v.to_bytes(32, "little") for v in values))
    return np.frombuffer(raw, np.uint8).reshape(len(values), 32)


def lane_array(a) -> np.ndarray:
    """A (B,) per-lane array or tensor as numpy."""
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def joint_table(idx, lanes: int, first):
    """Which entries iP + jQ (i, j < 4) of a joint table a lane's digits
    ``idx`` (B, D) use: (used, added), each (B, 4, 4) bool, without the
    identity entry.  ``used``: every nonzero digit; ``added``: those that
    an addition reads (all but the first, ``first``, which is copied)."""
    lane = np.arange(lanes)
    added = np.zeros((lanes, 16), bool)
    for k in range(idx.shape[1]):
        added[lane, idx[:, k]] |= (idx[:, k] != 0) & (k > first)
    used = added.copy()
    used[lane, idx[lane, first]] = True
    used[:, 0] = added[:, 0] = False
    return used.reshape(lanes, 4, 4), added.reshape(lanes, 4, 4)


def comb_walk(d1, d2) -> list:
    """The steps of a comb walk over (B, 32) digits of two bases: per
    column a doubling, then each base's affine entry (the identity for a
    zero digit)."""
    steps = []
    for k in range(d1.shape[1]):
        steps += [DBL, np.where(d1[:, k] != 0, AFFINE, IDENT),
                  np.where(d2[:, k] != 0, AFFINE, IDENT)]
    return steps


def joint_walk(idx) -> list:
    """The steps of a 2-bit joint scan over (B, D) entries iP + jQ: per
    digit two doublings, then the entry.  P's multiples are affine
    constants and Q is affine, so entry 0 is the identity, iP and Q itself
    are affine, and every other entry is projective."""
    i, j = idx // 4, idx % 4
    kinds = np.where(idx == 0, IDENT, np.where(
        ((i > 0) & (j == 0)) | (idx == 1), AFFINE, PROJ))
    steps = []
    for k in range(idx.shape[1]):
        steps += [DBL, DBL, kinds[:, k]]
    return steps
