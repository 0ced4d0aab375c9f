"""The stage program of the BLS12-381 pairing kernel (``csrc/cuda_bls.cu``).

One lane's verify, e(sig, -g2) * e(H(m), pk) == 1, written out once as a
flat list of Fp jobs on numbered slots of the lane's shared memory and
cut into stages.  The kernel runs a lane on a group of G threads: in
each stage rank r runs jobs r, r + G, ... and the group then meets at
``__syncwarp(group mask)``.  No job of a stage reads a slot that another
job of the same stage writes, so running the ranks of a stage one after
another is a faithful serialisation, which is how the g++ host harness
and :func:`run_lane` run it.

The formulas, and so the count of products, are those of
``csrc/bls381_pairing.cuh`` (the one-thread lane, kept as the harness's
reference) over ``csrc/bls381_field.cuh``'s tower: Karatsuba Fp2
products (3 Fp products), Fp2 squares (2), the sparse line product (13
Fp2 products after the two Fp-by-Fp2 scalings), the Granger-Scott
cyclotomic square (6 Fp2 products), the Fermat inversion in Fp.  Every
stored value is exact and fully reduced, so the order of evaluation
changes no value and the count of Fp products and squarings equals
``cuda_bls.lane_ops``.

Tracing.  :class:`_Tower` runs those formulas on a tracer that records
each Fp operation (product, squaring, sum, difference, constant load)
with its product level: one more than the latest level among a
product's operands, the same as its operands' for a sum, and never less
than the floor that the tower raises at each Miller step and each Fp12
operation of the final exponentiation, so that work that depends only on
old values (the G2 doubling, the fixed side's line rows, a Frobenius of
a saved operand) runs in the stages of the step that needs it.  The G2
doubling of a Miller step thus shares the stages of the Fp12 square and
of the fixed side's line product.  An Fp12 product of the final
exponentiation runs its three Fp6 products one after another, so that 18
of its raw products are held at a time and not 54.

Lowering.  A sum of at most four slots with no difference in it that only
products read becomes part of those products' operands (each product
adds the slots unreduced, below 4p).  A sum or difference that only one
other sum reads becomes terms of it, up to :data:`SUM_TERMS` terms a
job.  What is left gets a slot: products, constant loads, sums.

Scheduling.  Product stage k holds the products of level k; the gap
after it holds the sums and loads of level k, cut into passes by their
depth within the gap.  Slots are then allocated over the stage order: a
slot is reused only by a value made in a later stage than the last
reader of its previous value.

The packed program (:attr:`Program.words`) is a header of :data:`HEADER`
words (stages, jobs, slots, Miller stages, the 12 slots of the result,
the 12 of the Miller loop's value, the offset of the jobs), the stages'
job offsets and the jobs, :data:`JOB_WORDS` words each.
"""

from __future__ import annotations

import functools
import heapq

import numpy as np

from . import bls12381 as bls

#: traced operations: an Fp product, an Fp squaring (counted apart for
#: the bound), a sum, a difference, a constant row load
OP_MUL, OP_SQR, OP_ADD, OP_SUB, OP_LDC = range(5)
_OP_IN = -1  # the fixed slots, loaded by the kernel's prologue
#: the kinds of jobs the kernel runs: products and squarings (OP_MUL,
#: OP_SQR), signed sums of slots, constant row loads
JOB_SUM, JOB_LDC = 2, 3
#: words a job: op << 29 | dst << 20 | a << 10, then three words of
#: three 10-bit fields each: for a product the 4 slots of each operand
#: (unused ones the zero slot), for a sum its a signed terms (slot | sign
#: << 9), for a load nothing (a: the row)
JOB_WORDS = 4
#: most terms of a sum job
SUM_TERMS = 9

#: fixed slots: the lane's 8 inputs (sig x, y; H(m) x, y; pk x0, x1, y0,
#: y1), then 0 and 1 (Montgomery)
IN_SX, IN_SY, IN_HX, IN_HY, IN_X0, IN_X1, IN_Y0, IN_Y1 = range(8)
ZERO, ONE = 8, 9
N_FIXED = 10
#: header words: stages, jobs, slots, stages of the Miller loop, the
#: result's 12 slots, the Miller loop's 12, the word offset of the jobs
#: (csrc/bls381_group.cuh)
HEADER = 29
MAX_SLOTS = 512
#: most slots a product operand sums (the Karatsuba pre-sums of an Fp6
#: coordinate: below 4p, which the product takes)
OPERAND_SLOTS = 4

#: constant table rows (12 words each): the 63 doubling rows of 3 Fp2
#: coefficients, the 5 addition rows, the 5 Frobenius gammas
_ROW_ADD = 63 * 6
_ROW_FROB = 68 * 6


class _Tracer:
    """Records Fp operations as values (ints, in order), each with its
    product level; sums are shared when the same one is asked again."""

    def __init__(self):
        self.kind, self.a, self.b, self.level = [], [], [], []
        self.floor = 0
        self._cse = {}
        for k in range(N_FIXED):
            self._push(_OP_IN, k, 0, 0)

    def _push(self, kind, a, b, level) -> int:
        self.kind.append(kind)
        self.a.append(a)
        self.b.append(b)
        self.level.append(level)
        return len(self.kind) - 1

    def _prod(self, kind, a, b) -> int:
        level = max(self.floor, self.level[a], self.level[b]) + 1
        return self._push(kind, a, b, level)

    def mul(self, a, b):
        return self._prod(OP_MUL, a, b)

    def sqr(self, a):
        return self._prod(OP_SQR, a, a)

    def _lin(self, kind, a, b) -> int:
        key = (kind, a, b) if kind == OP_SUB else (kind, min(a, b), max(a, b))
        hit = self._cse.get(key)
        if hit is not None:
            return hit
        v = self._push(kind, a, b,
                       max(self.floor, self.level[a], self.level[b]))
        self._cse[key] = v
        return v

    def add(self, a, b):
        return self._lin(OP_ADD, a, b)

    def sub(self, a, b):
        return self._lin(OP_SUB, a, b)

    def ldc(self, row: int) -> int:
        return self._push(OP_LDC, row, 0, self.floor)

    def at(self, *values) -> None:
        """Raise the floor to the level at which ``values`` (nested tuples
        of values) are all ready; it never falls, so an operation on an
        old value (the Frobenius of an operand saved before an
        exponentiation) runs where the program reaches it and does not
        hold slots meanwhile."""
        flat = list(_leaves(values))
        self.floor = max([self.floor] + [self.level[v] for v in flat])


def _leaves(x):
    if isinstance(x, (tuple, list)):
        for y in x:
            yield from _leaves(y)
    else:
        yield x


# ---------------------------------------------------------------------------
# the tower over the tracer (bls381_field.cuh's formulas)
# ---------------------------------------------------------------------------


class _Tower:
    def __init__(self, t: _Tracer):
        self.t = t

    # Fp2
    def f2_add(self, a, b):
        return (self.t.add(a[0], b[0]), self.t.add(a[1], b[1]))

    def f2_sub(self, a, b):
        return (self.t.sub(a[0], b[0]), self.t.sub(a[1], b[1]))

    def f2_neg(self, a):
        return (self.t.sub(ZERO, a[0]), self.t.sub(ZERO, a[1]))

    def f2_conj(self, a):
        return (a[0], self.t.sub(ZERO, a[1]))

    def f2_dbl(self, a):
        return self.f2_add(a, a)

    def f2_mul(self, a, b):
        t = self.t
        t0 = t.mul(a[0], b[0])
        t1 = t.mul(a[1], b[1])
        t2 = t.mul(t.add(a[0], a[1]), t.add(b[0], b[1]))
        return (t.sub(t0, t1), t.sub(t2, t.add(t0, t1)))

    def f2_sqr(self, a):
        t = self.t
        t0 = t.mul(t.add(a[0], a[1]), t.sub(a[0], a[1]))
        t1 = t.mul(a[0], a[1])
        return (t0, t.add(t1, t1))

    def f2_mul_fp(self, a, s):
        return (self.t.mul(a[0], s), self.t.mul(a[1], s))

    def f2_xi(self, a):
        return (self.t.sub(a[0], a[1]), self.t.add(a[0], a[1]))

    def fp_inv(self, a):
        t = self.t
        e = bls.P - 2
        acc = a
        for bit in range(e.bit_length() - 2, -1, -1):
            acc = t.sqr(acc)
            if (e >> bit) & 1:
                acc = t.mul(acc, a)
        return acc

    def f2_inv(self, a):
        t = self.t
        d = self.fp_inv(t.add(t.sqr(a[0]), t.sqr(a[1])))
        return (t.mul(a[0], d), t.sub(ZERO, t.mul(a[1], d)))

    # Fp6
    def f6_add(self, a, b):
        return tuple(self.f2_add(x, y) for x, y in zip(a, b))

    def f6_sub(self, a, b):
        return tuple(self.f2_sub(x, y) for x, y in zip(a, b))

    def f6_neg(self, a):
        return tuple(self.f2_neg(x) for x in a)

    def f6_mul_v(self, a):
        return (self.f2_xi(a[2]), a[0], a[1])

    def f6_mul(self, a, b):
        add, sub, mul, xi = self.f2_add, self.f2_sub, self.f2_mul, self.f2_xi
        t0 = mul(a[0], b[0])
        t1 = mul(a[1], b[1])
        t2 = mul(a[2], b[2])
        s = mul(add(a[1], a[2]), add(b[1], b[2]))
        c0 = add(t0, xi(sub(sub(s, t1), t2)))
        s = mul(add(a[0], a[1]), add(b[0], b[1]))
        c1 = add(sub(sub(s, t0), t1), xi(t2))
        s = mul(add(a[0], a[2]), add(b[0], b[2]))
        c2 = add(sub(sub(s, t0), t2), t1)
        return (c0, c1, c2)

    def f6_mul_by_01(self, a, b0, b1):
        add, sub, mul, xi = self.f2_add, self.f2_sub, self.f2_mul, self.f2_xi
        t0 = mul(a[0], b0)
        t1 = mul(a[1], b1)
        c0 = add(t0, xi(mul(a[2], b1)))
        c1 = sub(sub(mul(add(a[0], a[1]), add(b0, b1)), t0), t1)
        c2 = add(t1, mul(a[2], b0))
        return (c0, c1, c2)

    def f6_mul_by_1(self, a, b1):
        mul = self.f2_mul
        return (self.f2_xi(mul(a[2], b1)), mul(a[0], b1), mul(a[1], b1))

    def f6_inv(self, a):
        add, sub, mul, xi = self.f2_add, self.f2_sub, self.f2_mul, self.f2_xi
        sqr = self.f2_sqr
        c0 = sub(sqr(a[0]), xi(mul(a[1], a[2])))
        c1 = sub(xi(sqr(a[2])), mul(a[0], a[1]))
        c2 = sub(sqr(a[1]), mul(a[0], a[2]))
        t = add(xi(add(mul(a[2], c1), mul(a[1], c2))), mul(a[0], c0))
        ti = self.f2_inv(t)
        return (mul(c0, ti), mul(c1, ti), mul(c2, ti))

    # Fp12
    def one12(self):
        z = (ZERO, ZERO)
        return (((ONE, ZERO), z, z), (z, z, z))

    def f12_mul(self, a, b):
        # the three Fp6 products one stage after another: 18 raw products
        # held at a time, not 54 (the final exponentiation's peak of live
        # slots), for about one more product round a product
        t0 = self.f6_mul(a[0], b[0])
        self.t.at(t0)
        t1 = self.f6_mul(a[1], b[1])
        self.t.at(t1)
        t2 = self.f6_mul(self.f6_add(a[0], a[1]), self.f6_add(b[0], b[1]))
        return (self.f6_add(t0, self.f6_mul_v(t1)),
                self.f6_sub(self.f6_sub(t2, t0), t1))

    def f12_sqr(self, a):
        t = self.f6_mul(a[0], a[1])
        s = self.f6_mul(self.f6_add(a[0], a[1]),
                        self.f6_add(a[0], self.f6_mul_v(a[1])))
        return (self.f6_sub(self.f6_sub(s, t), self.f6_mul_v(t)),
                self.f6_add(t, t))

    def _fp4_sqr(self, a, b):
        add, sub, mul, xi = self.f2_add, self.f2_sub, self.f2_mul, self.f2_xi
        ab = mul(a, b)
        t0 = sub(mul(add(a, b), add(a, xi(b))), add(ab, xi(ab)))
        return t0, self.f2_dbl(ab)

    def _gs_minus(self, t, z):
        return self.f2_add(self.f2_dbl(self.f2_sub(t, z)), t)

    def _gs_plus(self, t, z):
        return self.f2_add(self.f2_dbl(self.f2_add(t, z)), t)

    def cyclo_sqr(self, a):
        t0, t1 = self._fp4_sqr(a[0][0], a[1][1])
        t2, t3 = self._fp4_sqr(a[1][0], a[0][2])
        t4, t5 = self._fp4_sqr(a[0][1], a[1][2])
        return ((self._gs_minus(t0, a[0][0]), self._gs_minus(t2, a[0][1]),
                 self._gs_minus(t4, a[0][2])),
                (self._gs_plus(self.f2_xi(t5), a[1][0]),
                 self._gs_plus(t1, a[1][1]), self._gs_plus(t3, a[1][2])))

    def conj12(self, a):
        return (a[0], self.f6_neg(a[1]))

    def f12_inv(self, a):
        d = self.f6_sub(self.f6_mul(a[0], a[0]),
                        self.f6_mul_v(self.f6_mul(a[1], a[1])))
        t = self.f6_inv(d)
        return (self.f6_mul(a[0], t), self.f6_neg(self.f6_mul(a[1], t)))

    def frob12(self, a):
        self.t.at(a)
        g = [(self.t.ldc(_ROW_FROB + 2 * j), self.t.ldc(_ROW_FROB + 2 * j + 1))
             for j in range(5)]
        c, mul = self.f2_conj, self.f2_mul
        return ((c(a[0][0]), mul(c(a[0][1]), g[0]), mul(c(a[0][2]), g[1])),
                (mul(c(a[1][0]), g[2]), mul(c(a[1][1]), g[3]),
                 mul(c(a[1][2]), g[4])))

    # the Miller loop (bls381_pairing.cuh)
    def dbl_step(self, T):
        sqr, mul, add, sub = self.f2_sqr, self.f2_mul, self.f2_add, self.f2_sub
        dbl = self.f2_dbl
        x, y, z = T
        X2, Y2, Z2 = sqr(x), sqr(y), sqr(z)
        X2_3 = add(dbl(X2), X2)
        l0 = sub(mul(X2_3, x), dbl(Y2))
        l1 = self.f2_neg(mul(X2_3, Z2))
        YZ2 = dbl(mul(y, z))
        l2 = mul(YZ2, Z2)
        C = sqr(Y2)
        D = dbl(sub(sqr(add(x, Y2)), add(X2, C)))
        X3 = sub(sqr(X2_3), dbl(D))
        C8 = dbl(dbl(dbl(C)))
        Y3 = sub(mul(X2_3, sub(D, X3)), C8)
        return (X3, Y3, YZ2), (l0, l1, l2)

    def add_step(self, T, xq, yq):
        sqr, mul, add, sub = self.f2_sqr, self.f2_mul, self.f2_add, self.f2_sub
        x, y, z = T
        Z2 = sqr(z)
        Z3 = mul(Z2, z)
        H = sub(mul(xq, Z2), x)
        R = sub(mul(yq, Z3), y)
        HZ = mul(H, z)
        l0 = sub(mul(R, xq), mul(HZ, yq))
        l1 = self.f2_neg(R)
        H2 = sqr(H)
        H3 = mul(H2, H)
        UH2 = mul(x, H2)
        X3 = sub(sub(sqr(R), H3), self.f2_dbl(UH2))
        Y3 = sub(mul(R, sub(UH2, X3)), mul(y, H3))
        return (X3, Y3, HZ), (l0, l1, HZ)

    def mul_line(self, f, line, xp, yp):
        lx = self.f2_mul_fp(line[1], xp)
        ly = self.f2_mul_fp(line[2], yp)
        t0 = self.f6_mul_by_01(f[0], line[0], lx)
        t1 = self.f6_mul_by_1(f[1], ly)
        s = self.f6_mul_by_01(self.f6_add(f[0], f[1]), line[0],
                              self.f2_add(lx, ly))
        return (self.f6_add(t0, self.f6_mul_v(t1)),
                self.f6_sub(self.f6_sub(s, t0), t1))

    def fixed_line(self, row: int):
        t = self.t
        return tuple((t.ldc(row + 2 * c), t.ldc(row + 2 * c + 1))
                     for c in range(3))

    def miller(self):
        q = ((IN_X0, IN_X1), (IN_Y0, IN_Y1))
        f = self.one12()
        T = (q[0], q[1], (ONE, ZERO))
        k = 0
        for i, bit in enumerate(bls._X_BITS):
            self.t.at(f)
            f = self.f12_sqr(f)
            T, line = self.dbl_step(T)
            f = self.mul_line(f, self.fixed_line(6 * i), IN_SX, IN_SY)
            f = self.mul_line(f, line, IN_HX, IN_HY)
            if bit:
                self.t.at(f)
                T, line = self.add_step(T, *q)
                f = self.mul_line(f, self.fixed_line(_ROW_ADD + 6 * k),
                                  IN_SX, IN_SY)
                f = self.mul_line(f, line, IN_HX, IN_HY)
                k += 1
        return self.conj12(f)

    # the final exponentiation
    def pow_x(self, m, e: int):
        acc = m
        for bit in range(62, -1, -1):
            self.t.at(acc)
            acc = self.cyclo_sqr(acc)
            if (e >> bit) & 1:
                acc = self.f12_mul(acc, m)
        return acc

    def final_exp(self, f0):
        x = bls.X_ABS
        self.t.at(f0)
        f = self.f12_mul(self.conj12(f0), self.f12_inv(f0))
        f = self.f12_mul(self.frob12(self.frob12(f)), f)
        m = f
        a = self.conj12(self.pow_x(m, x + 1))
        a = self.conj12(self.pow_x(a, x + 1))
        b = self.conj12(self.pow_x(a, x))
        a = self.f12_mul(b, self.frob12(a))
        c = self.pow_x(self.pow_x(a, x), x)
        a = self.f12_mul(self.f12_mul(c, self.frob12(self.frob12(a))),
                         self.conj12(a))
        # m^3 at the end, so its products do not hold slots across the
        # hard part
        self.t.at(a)
        m3 = self.f12_mul(self.cyclo_sqr(m), m)
        return self.f12_mul(a, m3)


# ---------------------------------------------------------------------------
# lowering: products that form their own pre-sums, sums of several terms
# ---------------------------------------------------------------------------


class _Lowered:
    """The traced values as jobs: which values get a slot, the slots each
    product operand adds, the signed terms of each sum, and each sum's or
    load's depth within its gap."""

    def __init__(self, t: _Tracer, keep):
        n = len(t.kind)
        self.t = t
        users = [[] for _ in range(n)]
        for v in range(N_FIXED, n):
            if t.kind[v] != OP_LDC:
                users[t.a[v]].append(v)
                users[t.b[v]].append(v)
        lin = (OP_ADD, OP_SUB)
        prod = (OP_MUL, OP_SQR)
        # a sum of at most OPERAND_SLOTS slots, with no difference in it,
        # that only products (or such sums) read: each product forms it
        # unreduced (below 4p) in its operand
        fused = [t.kind[v] == OP_ADD and v not in keep
                 and all(t.kind[u] in prod or t.kind[u] == OP_ADD
                         for u in users[v]) for v in range(n)]
        leaves: dict = {}
        for v in range(N_FIXED, n):
            if fused[v]:
                leaves[v] = self._leaves(t.a[v], fused, leaves) + \
                    self._leaves(t.b[v], fused, leaves)
                fused[v] = len(leaves[v]) <= OPERAND_SLOTS
        for v in range(n - 1, N_FIXED - 1, -1):
            fused[v] = fused[v] and all(t.kind[u] in prod or fused[u]
                                        for u in users[v])
        for v in range(N_FIXED, n):
            if fused[v]:
                leaves[v] = self._leaves(t.a[v], fused, leaves) + \
                    self._leaves(t.b[v], fused, leaves)
        # a sum that only one other sum reads (once, or twice as in x + x),
        # and that sum a job, becomes terms of its reader
        inlined = [t.kind[v] in lin and not fused[v] and v not in keep
                   and len(set(users[v])) == 1 and t.kind[users[v][0]] in lin
                   and not fused[users[v][0]] for v in range(n)]
        # ... as long as a job keeps at most SUM_TERMS terms: past that, the
        # largest of its inlined operands stays a job of its own
        size = [1] * n
        for v in range(N_FIXED, n):
            if t.kind[v] not in lin or fused[v]:
                continue
            ops = (t.a[v], t.b[v])
            while sum(size[x] if inlined[x] else 1 for x in ops) > SUM_TERMS:
                inlined[max((x for x in ops if inlined[x]),
                            key=size.__getitem__)] = False
            size[v] = sum(size[x] if inlined[x] else 1 for x in ops)
        self.jobs = [v for v in range(N_FIXED, n)
                     if not inlined[v] and not fused[v]]
        self.operands = {}   # product -> (slots of a, slots of b)
        self.terms = {}      # sum -> [(value, sign)]
        for v in self.jobs:
            if t.kind[v] in prod:
                self.operands[v] = (self._leaves(t.a[v], fused, leaves),
                                    self._leaves(t.b[v], fused, leaves))
            elif t.kind[v] in lin:
                coeff: dict = {}
                self._expand(v, 1, inlined, coeff, root=True)
                pos = [(x, 1) for x, c in sorted(coeff.items()) if c > 0
                       for _ in range(c)]
                neg = [(x, -1) for x, c in sorted(coeff.items()) if c < 0
                       for _ in range(-c)]
                if not pos:
                    pos = [(ZERO, 1)]
                self.terms[v] = pos + neg
        # depth of a sum or load within the gap of its level
        self.depth = {}
        for v in self.jobs:
            if t.kind[v] in lin:
                self.depth[v] = 1 + max(
                    [self.depth.get(x, 0) for x, _ in self.terms[v]
                     if t.level[x] == t.level[v]], default=0)
            elif t.kind[v] == OP_LDC:
                self.depth[v] = 1

    @staticmethod
    def _leaves(x, fused, leaves):
        return leaves[x] if fused[x] else [x]

    def _expand(self, v, sign, inlined, coeff, root=False):
        t = self.t
        if not root and not inlined[v]:
            coeff[v] = coeff.get(v, 0) + sign
            return
        self._expand(t.a[v], sign, inlined, coeff)
        self._expand(t.b[v], sign if t.kind[v] == OP_ADD else -sign,
                     inlined, coeff)

    def reads(self, v):
        if v in self.operands:
            return self.operands[v][0] + self.operands[v][1]
        if v in self.terms:
            return [x for x, _ in self.terms[v]]
        return ()


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------


class Program:
    """The scheduled, slot-allocated program of one lane."""

    def __init__(self, low: _Lowered, stages, stage_of, slot_of, miller_out,
                 result):
        t = low.t
        self.nstages = len(stages)
        jobs, offsets = [], [0]
        self.counts = {"mul": 0, "sqr": 0, "sum": 0, "ldc": 0, "terms": 0}
        #: per stage: (products, sum and load jobs)
        self.stage_sizes = []
        for vals in stages:
            nprod = 0
            for v in vals:
                kind, d = t.kind[v], slot_of[v] << 20
                if kind in (OP_MUL, OP_SQR):
                    xs, ys = low.operands[v]
                    ops = [slot_of[x] for x in xs] + [ZERO] * (4 - len(xs))
                    ops += [slot_of[y] for y in ys] + [ZERO] * (4 - len(ys))
                    jobs += [(kind << 29) | d,
                             ops[0] | ops[1] << 10 | ops[2] << 20,
                             ops[3] | ops[4] << 10 | ops[5] << 20,
                             ops[6] | ops[7] << 10]
                    self.counts["mul" if kind == OP_MUL else "sqr"] += 1
                    nprod += 1
                elif kind == OP_LDC:
                    jobs += [(JOB_LDC << 29) | d | (t.a[v] << 10), 0, 0, 0]
                    self.counts["ldc"] += 1
                else:
                    tv = low.terms[v]
                    packed = [slot_of[x] | (512 if sg < 0 else 0)
                              for x, sg in tv] + [0] * (SUM_TERMS - len(tv))
                    jobs += [(JOB_SUM << 29) | d | (len(tv) << 10)] + [
                        packed[k] | packed[k + 1] << 10 | packed[k + 2] << 20
                        for k in (0, 3, 6)]
                    self.counts["sum"] += 1
                    self.counts["terms"] += len(tv)
            offsets.append(len(jobs) // JOB_WORDS)
            self.stage_sizes.append((nprod, len(vals) - nprod))
        self.nslots = max(slot_of.values()) + 1
        self.result = [slot_of[v] for v in _leaves(result)]
        self.miller_result = [slot_of[v] for v in _leaves(miller_out)]
        self.miller_stages = 1 + max(stage_of[v] for v in _leaves(miller_out))
        jobs_at = -(-(HEADER + len(offsets)) // JOB_WORDS) * JOB_WORDS
        head = [self.nstages, len(jobs) // JOB_WORDS, self.nslots,
                self.miller_stages, *self.result, *self.miller_result,
                jobs_at]
        assert len(head) == HEADER
        words = np.zeros(jobs_at + len(jobs), dtype=np.uint32)
        words[:HEADER] = head
        words[HEADER:HEADER + len(offsets)] = offsets
        words[jobs_at:] = jobs
        self.words = words

    def rounds(self, group: int) -> dict:
        """Product rounds (a rank's products one after another) and job
        rounds of sums and loads, summed over the stages, at ``group``
        ranks a lane."""
        prod = sum(-(-p // group) for p, _ in self.stage_sizes)
        lin = sum(-(-n // group) for _, n in self.stage_sizes)
        return {"product_rounds": prod, "sum_rounds": lin,
                "stages": self.nstages}


def _schedule(low: _Lowered):
    """Group the jobs into stages, in order: product stage k, then the
    passes of the gap after it by depth.  Returns (stages, stage index of
    each job)."""
    t = low.t
    keys: dict = {}
    for v in low.jobs:
        if t.kind[v] in (OP_MUL, OP_SQR):
            key = (t.level[v], 0, 0)
        else:
            key = (t.level[v], 1, low.depth[v])
        keys.setdefault(key, []).append(v)
    stages, stage_of = [], {}
    for s, key in enumerate(sorted(keys)):
        vals = sorted(keys[key], key=lambda v: (t.kind[v], v))
        stages.append(vals)
        for v in vals:
            stage_of[v] = s
    return stages, stage_of


def _allocate(low: _Lowered, stages, stage_of, keep: dict):
    """Slots for every job's value: the fixed slots first, then greedy
    reuse over the stage order (a slot is taken again only in a stage
    after the last one that reads its old value).  ``keep``: value -> the
    stage up to which it stays."""
    last = {v: stage_of[v] for v in low.jobs}
    for v in low.jobs:
        for x in low.reads(v):
            if x >= N_FIXED:
                last[x] = max(last[x], stage_of[v])
    for v, s in keep.items():
        last[v] = max(last[v], s)
    ends: dict = {}
    for v, s in last.items():
        ends.setdefault(s, []).append(v)
    slot_of = {k: k for k in range(N_FIXED)}
    free: list = []
    top = N_FIXED
    for s, vals in enumerate(stages):
        for v in ends.get(s - 1, ()):
            heapq.heappush(free, slot_of[v])
        for v in vals:
            if free:
                slot_of[v] = heapq.heappop(free)
            else:
                slot_of[v] = top
                top += 1
    assert top <= MAX_SLOTS, f"{top} slots"
    return slot_of


@functools.lru_cache(maxsize=None)
def program() -> Program:
    """The lane's program (built once a process)."""
    t = _Tracer()
    tw = _Tower(t)
    f = tw.miller()
    out = tw.final_exp(f)
    low = _Lowered(t, set(_leaves(f)) | set(_leaves(out)))
    stages, stage_of = _schedule(low)
    miller_end = max(stage_of[v] for v in _leaves(f))
    keep = {v: len(stages) for v in _leaves(out)}
    for v in _leaves(f):
        keep[v] = max(keep.get(v, 0), miller_end)
    slot_of = _allocate(low, stages, stage_of, keep)
    return Program(low, stages, stage_of, slot_of, f, out)


# ---------------------------------------------------------------------------
# a reference run with Python integers
# ---------------------------------------------------------------------------


def run_lane(prog: Program, inputs, table, stages: int | None = None,
             group: int = 1) -> list:
    """Run ``stages`` stages (all by default) of ``prog`` on one lane with
    Python integers, the ranks of a group one after another as the host
    harness does: ``inputs`` the 8 Montgomery values, ``table`` the
    constant rows as ints.  Returns the slot file."""
    p = bls.P
    rinv = pow(1 << 384, -1, p)
    w = [int(x) for x in prog.words]
    nst = w[0] if stages is None else stages
    jobs_at = w[HEADER - 1]
    slot = [0] * w[2]
    slot[:8] = list(inputs)
    slot[ONE] = (1 << 384) % p
    for s in range(nst):
        for rank in range(group):
            for j in range(w[HEADER + s] + rank, w[HEADER + s + 1], group):
                w0, w1, w2, w3 = w[jobs_at + JOB_WORDS * j:
                                   jobs_at + JOB_WORDS * (j + 1)]
                op, d, a = w0 >> 29, (w0 >> 20) & 511, (w0 >> 10) & 1023
                if op in (OP_MUL, OP_SQR):
                    ops = [(x >> k) & 1023 for x in (w1, w2, w3)
                           for k in (0, 10, 20)]
                    x = sum(slot[k] for k in ops[0:4])
                    y = sum(slot[k] for k in ops[4:8])
                    assert x < 4 * p and y < 4 * p
                    slot[d] = x * y * rinv % p
                elif op == JOB_LDC:
                    slot[d] = table[a]
                else:
                    acc = 0
                    for k in range(a):
                        term = ((w1, w2, w3)[k // 3] >> (10 * (k % 3))) & 1023
                        x = slot[term & 511]
                        acc += -x if term >> 9 else x
                    slot[d] = acc % p
    return slot
