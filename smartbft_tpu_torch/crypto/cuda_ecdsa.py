"""Generic P-256 ECDSA verify: the CUDA kernel and its plain-torch version.

Port of the TPU kernel ``smartbft_tpu/crypto/pallas_ecdsa.py`` (``_kernel``
-> ``_verify_block``, driven by ``ecdsa_verify``).  It verifies signatures
by keys that are not in the comb registry: range checks on r and s, u1 =
e/s and u2 = r/s by a Fermat inversion, an on-curve check of Q, the joint
table {iG + jQ : i, j < 4} and a 128-digit 2-bit Strauss–Shamir scan over
RCB15 complete formulas (a = -3), then x(R) mod n == r compared
projectively.

* :func:`ecdsa_verify` is the wrapper: on CUDA tensors it launches
  ``csrc/cuda_ecdsa.cu`` (a group of threads per signature, over the
  stage program of ``csrc/p256_group.cuh``) and counts the launch
  in :data:`LAUNCHES`; on CPU tensors it runs :func:`ecdsa_verify_plain`.
  It never falls back from one to the other.
* :func:`ecdsa_verify_plain` repeats the kernel's arithmetic with the
  plain-torch Montgomery field of :mod:`.bignum`; its point formulas and
  level grouping follow the JAX package's ``_point_add``/``_point_double``
  line for line.  The comb kernel's plain version (:mod:`.cuda_comb`)
  shares its prologue and epilogue.

Inputs are (B, 32) uint8 little-endian values (:func:`p256.verify_bytes`),
which the kernel reads as eight 32-bit words.  The mask is (B,) int32 0/1.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import csrc
from .bignum import (
    TorchMont,
    add_raw,
    bytes_to_limbs,
    eq,
    geq,
    grp,
    grp1,
    int_to_limbs,
    is_zero,
)
from .opcount import (
    PROJ,
    WEIERSTRASS,
    joint_table,
    joint_walk,
    lane_bytes,
    lane_ints,
    walk_ops,
)
from .p256 import B as CURVE_B, GX, GY, N, P

#: launches and lanes of the CUDA kernel
LAUNCHES = csrc.LaunchCounter("ecdsa_verify")

#: the Fermat exponent n - 2 as MSB-first 4-bit digits (the kernel reads
#: the same digits out of constant words)
_INV_E = N - 2
INV_DIGITS = tuple((_INV_E >> (4 * i)) & 15 for i in range(63, -1, -1))

#: joint-scan window: 128 digits of 2 bits
WINDOW = 2
NDIGITS = 256 // WINDOW


class Curve:
    """Fields and constants of one device, built once per device."""

    def __init__(self, device):
        dev = torch.device(device)
        self.fp = TorchMont(P, dev)
        self.fn = TorchMont(N, dev)
        self.b_m = self.fp.encode(CURVE_B)
        self.n = int_to_limbs(N, dev)
        self.p = int_to_limbs(P, dev)
        zero = int_to_limbs(0, dev)
        self.inf = (zero, self.fp.one, zero)
        self.g = (self.fp.encode(GX), self.fp.encode(GY), self.fp.one)


@functools.lru_cache(maxsize=None)
def curve(device) -> Curve:
    return Curve(device)


# ---------------------------------------------------------------------------
# curve ops: a point is a tuple (X, Y, Z) of (..., 16) Montgomery tensors
# ---------------------------------------------------------------------------


def point_add(f: TorchMont, b_m, p, q):
    """RCB15 Algorithm 4 complete addition (a = -3)."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    a1, a2, a4, a5, a7, a8 = grp(
        f.add, [(x1, y1), (x2, y2), (y1, z1), (y2, z2), (x1, z1), (x2, z2)]
    )
    t0, t1, t2, m1, m2, m3 = grp(
        f.mul, [(x1, x2), (y1, y2), (z1, z2), (a1, a2), (a4, a5), (a7, a8)]
    )
    a3, a6, a9, u1, w1 = grp(
        f.add, [(t0, t1), (t1, t2), (t0, t2), (t2, t2), (t0, t0)]
    )
    t3, t4, y3a = grp(f.sub, [(m1, a3), (m2, a6), (m3, a9)])
    u2, w2 = grp(f.add, [(u1, t2), (w1, t0)])  # 3*t2, 3*t0
    zb, yb = grp(f.mul, [(b_m, t2), (b_m, y3a)])
    x3a, t0b, y3b = grp(f.sub, [(y3a, zb), (w2, u2), (yb, u2)])
    z3a = f.add(x3a, x3a)
    y3c = f.sub(y3b, t0)
    x3b, v1 = grp(f.add, [(x3a, z3a), (y3c, y3c)])
    x3c, y3d = grp(f.add, [(t1, x3b), (v1, y3c)])
    z3b = f.sub(t1, x3b)
    p1, p2, p3, p4, p5, p6 = grp(
        f.mul,
        [(t4, y3d), (t0b, y3d), (x3c, z3b), (t3, x3c), (t4, z3b), (t3, t0b)],
    )
    y3, z3 = grp(f.add, [(p3, p2), (p5, p6)])
    x3 = f.sub(p4, p1)
    return x3, y3, z3


def point_double(f: TorchMont, b_m, p):
    """RCB15 Algorithm 6 complete doubling (a = -3)."""
    x, y, z = p
    t0, t1, t2 = grp1(f.sqr, [x, y, z])
    xy, xz, yz = grp(f.mul, [(x, y), (x, z), (y, z)])
    t3, z3a, yz2, t2a, t0a = grp(
        f.add, [(xy, xy), (xz, xz), (yz, yz), (t2, t2), (t0, t0)]
    )
    t2_3, t0_3 = grp(f.add, [(t2a, t2), (t0a, t0)])
    bt2, bz3 = grp(f.mul, [(b_m, t2), (b_m, z3a)])
    y3a, z3b, t0d = grp(f.sub, [(bt2, z3a), (bz3, t2_3), (t0_3, t2_3)])
    y3a2 = f.add(y3a, y3a)
    z3c = f.sub(z3b, t0)
    y3b, z3c2 = grp(f.add, [(y3a2, y3a), (z3c, z3c)])
    z3d, y3c = grp(f.add, [(z3c2, z3c), (t1, y3b)])
    x3a = f.sub(t1, y3b)
    y3d, x3b, t0b, zz, zt = grp(
        f.mul,
        [(x3a, y3c), (x3a, t3), (t0d, z3d), (yz2, z3d), (yz2, t1)],
    )
    y3, zt2 = grp(f.add, [(y3d, t0b), (zt, zt)])
    x3 = f.sub(x3b, zz)
    z3 = f.add(zt2, zt2)
    return x3, y3, z3


def _inv_n(fn: TorchMont, s):
    """1/s mod n (Montgomery in and out), Fermat with a 4-bit window."""
    pows = [fn.one.expand_as(s), s]
    for _ in range(14):
        pows.append(fn.mul(pows[-1], s))
    acc = pows[INV_DIGITS[0]]
    for d in INV_DIGITS[1:]:
        for _ in range(4):
            acc = fn.sqr(acc)
        acc = fn.mul(acc, pows[d])
    return acc


def verify_scalars(c: Curve, e, r, s):
    """(u1, u2, ok): e/s and r/s mod n in the standard domain, and the
    range check 1 <= r, s < n.  e < 2**256 < 2n reduces by one
    subtraction, which the modular subtract e - n performs."""
    fn = c.fn
    ok = (~is_zero(r)) & (~geq(r, c.n)) & (~is_zero(s)) & (~geq(s, c.n))
    e_red = fn.sub(e, c.n)
    s_m, r_m, e_m = grp(fn.mul, [(s, fn.R2), (r, fn.R2), (e_red, fn.R2)])
    w = _inv_n(fn, s_m)
    u1m, u2m = grp(fn.mul, [(e_m, w), (r_m, w)])
    u1, u2 = grp(fn.mul, [(u1m, fn.raw_one), (u2m, fn.raw_one)])
    return u1, u2, ok


def verify_final(c: Curve, acc, r):
    """x(R) mod n == r, projectively: x_aff in {r, r + n} with x_aff < p,
    each candidate tested as cand * Z == X; and Z != 0."""
    fp = c.fp
    xr, _, zr = acc
    c17 = add_raw(r, c.n)
    c16 = c17[..., :16]
    c_ok = (c17[..., 16] == 0) & (~geq(c16, c.p))
    r_mp, c_mp = grp(fp.mul, [(r, fp.R2), (c16, fp.R2)])
    mr, mc = grp(fp.mul, [(r_mp, zr), (c_mp, zr)])
    match = eq(mr, xr) | (c_ok & eq(mc, xr))
    return match & (~is_zero(zr))


def _bits(u):
    """(B, 16) limbs -> (B, 256) bits, bit position = 16 * limb + offset."""
    sh = torch.arange(16, device=u.device)
    return ((u[..., :, None] >> sh) & 1).flatten(-2)


def _two_bit_digits(u):
    """(B, 16) scalar -> (B, 128) MSB-first 2-bit digits."""
    pairs = _bits(u).unflatten(-1, (NDIGITS, 2))
    return (pairs[..., 0] | (pairs[..., 1] << 1)).flip(-1)


def ecdsa_verify_plain(e, r, s, qx, qy) -> torch.Tensor:
    """The generic verify in plain torch on (B, 32) uint8 inputs; (B,)
    int32 mask.  Runs on whatever device the inputs are on."""
    c = curve(e.device)
    fp, b_m = c.fp, c.b_m
    e, r, s, qx, qy = (bytes_to_limbs(a) for a in (e, r, s, qx, qy))
    u1, u2, ok = verify_scalars(c, e, r, s)

    xm, ym = grp(fp.mul, [(qx, fp.R2), (qy, fp.R2)])
    yy, xx = grp1(fp.sqr, [ym, xm])
    x3v = fp.mul(xx, xm)
    threex = fp.add(fp.add(xm, xm), xm)
    oncurve = eq(yy, fp.add(fp.sub(x3v, threex), b_m))

    bsz = e.shape[0]
    one = fp.one.expand_as(xm)
    g = tuple(v.expand_as(xm) for v in c.g)
    inf = tuple(v.expand_as(xm) for v in c.inf)
    q = (xm, ym, one)
    two = point_double(fp, b_m, tuple(torch.stack([a, b]) for a, b in zip(g, q)))
    three = point_add(fp, b_m, two, tuple(torch.stack([a, b])
                                          for a, b in zip(g, q)))
    gs = [inf, g, tuple(v[0] for v in two), tuple(v[0] for v in three)]
    qs = [inf, q, tuple(v[1] for v in two), tuple(v[1] for v in three)]
    qstack = tuple(torch.stack([pt[k] for pt in qs]) for k in range(3))
    rows = []
    for gi in gs:  # one grouped 4-way addition per row of the table
        lhs = tuple(torch.stack([v] * 4) for v in gi)
        rows.append(point_add(fp, b_m, lhs, qstack))
    table = tuple(torch.cat([row[k] for row in rows]) for k in range(3))

    idx = _two_bit_digits(u1) * 4 + _two_bit_digits(u2)  # (B, 128)
    lane = torch.arange(bsz, device=e.device)
    acc = inf
    for k in range(NDIGITS):
        acc = point_double(fp, b_m, point_double(fp, b_m, acc))
        ik = idx[:, k]
        acc = point_add(fp, b_m, acc, tuple(t[ik, lane] for t in table))
    mask = verify_final(c, acc, r) & ok & oncurve
    return mask.to(torch.int32)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib(name: str = "cuda_ecdsa"):
    """The kernel library the wrapper loads, or a build of the same source
    with another group size (a name in :data:`csrc.VARIANTS`)."""
    lib = csrc.load(name)
    vp = ctypes.c_void_p
    lib.smartbft_ecdsa_verify.restype = ctypes.c_int
    lib.smartbft_ecdsa_verify.argtypes = [vp, vp, vp, vp, vp, vp,
                                          ctypes.c_int, vp]
    lib.smartbft_ecdsa_group.restype = ctypes.c_int
    lib.smartbft_ecdsa_group.argtypes = []
    return lib


def group_size(name: str = "cuda_ecdsa") -> int:
    """Threads per signature of the kernel library ``name``."""
    return _lib(name).smartbft_ecdsa_group()


def _check_bytes(a, name: str, bsz: int, device) -> None:
    if a.dtype != torch.uint8 or tuple(a.shape) != (bsz, 32):
        raise ValueError(f"{name}: expected ({bsz}, 32) uint8, got "
                         f"{tuple(a.shape)} {a.dtype}")
    if a.device != device or not a.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor on {device}")


def launch(lib: str, e, r, s, qx, qy) -> torch.Tensor:
    """Check the (B, 32) uint8 CUDA tensors, then launch the kernel of the
    library ``lib`` (see :func:`_lib`) on them; counts nothing."""
    bsz, dev = e.shape[0], e.device
    for a, name in zip((e, r, s, qx, qy), ("e", "r", "s", "qx", "qy")):
        _check_bytes(a, name, bsz, dev)
    out = torch.empty(bsz, dtype=torch.int32, device=dev)
    if bsz == 0:
        return out
    # the launch goes to the current device: make it the tensors'
    # (a worker thread starts on device 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib(lib).smartbft_ecdsa_verify(
            e.data_ptr(), r.data_ptr(), s.data_ptr(), qx.data_ptr(),
            qy.data_ptr(), out.data_ptr(), bsz, stream)
    csrc.check(rc, "ecdsa_verify")
    return out


def ecdsa_verify_cuda(e, r, s, qx, qy) -> torch.Tensor:
    """Launch the generic kernel on (B, 32) uint8 CUDA tensors."""
    out = launch("cuda_ecdsa", e, r, s, qx, qy)
    if out.numel():
        LAUNCHES.add(out.numel())
    return out


def as_tensor(a) -> torch.Tensor:
    """numpy arrays become CPU tensors; tensors pass through."""
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


def ecdsa_verify(e, r, s, qx, qy) -> torch.Tensor:
    """Batched generic P-256 verify; (B,) int32 0/1 mask on the inputs'
    device.  CUDA inputs run the kernel, CPU inputs the plain version."""
    args = [as_tensor(a) for a in (e, r, s, qx, qy)]
    if args[0].is_cuda:
        return ecdsa_verify_cuda(*args)
    return ecdsa_verify_plain(*args)


# ---------------------------------------------------------------------------
# the work a verify needs (:mod:`.opcount`)
# ---------------------------------------------------------------------------

#: the scalar work mod n of a lane past its range checks, shared by both
#: kernels: s into Montgomery form, the inversion's powers s^2..s^15 and
#: its 63 window steps (4 squarings, and a product unless the digit is 0),
#: then u1 = e·w and u2 = r·w, which leave the Montgomery domain as the
#: plain e and r meet the Montgomery w
N_OPS = {"n_mul": 1 + 14 + sum(d != 0 for d in INV_DIGITS[1:]) + 2,
         "n_sqr": 4 * (len(INV_DIGITS) - 1)}


def scalars_needed(e8, r8, s8):
    """(range ok, u1, u2) of each lane from the raw inputs: (B,) bool and
    two lists of Python ints (0 where the range check fails)."""
    es, rs, ss = (lane_ints(a) for a in (e8, r8, s8))
    ok = np.array([0 < r < N and 0 < s < N for r, s in zip(rs, ss)], bool)
    u1, u2 = [], []
    for e, r, s, good in zip(es, rs, ss, ok):
        w = pow(s, -1, N) if good else 0
        u1.append(e * w % N)
        u2.append(r * w % N)
    return ok, u1, u2


def final_ops(acc, r8) -> np.ndarray:
    """Products of the comparison x(R) mod n == r: r·Z, and (r + n)·Z
    where r + n < p; none where Z = 1."""
    cand = np.array([r + N < P for r in lane_ints(r8)], bool)
    return (acc == PROJ) * (1 + cand)


def mont_ops(e, r, s, qx, qy) -> dict:
    """Products and squarings by modulus the batch needs.  A lane failing
    its range checks needs none.  Any other needs Q's curve check (2
    squarings + 1 product mod p); on the curve, the scalar work
    (:data:`N_OPS`), the table points its digits use, the scan and the
    comparison.  Table points: 2Q (a doubling at Z = 1), 3Q = 2Q + Q, and
    iG + jQ for i, j >= 1 (10 products for j = 1, else 13); G's multiples
    are constants.  No conversion into Montgomery form mod p is counted:
    the reduction mod p needs none."""
    ok, u1, u2 = scalars_needed(e, r, s)
    xs, ys = lane_ints(qx), lane_ints(qy)
    on = np.array([x < P and y < P and (y * y - x * x * x + 3 * x - CURVE_B)
                   % P == 0 for x, y in zip(xs, ys)], bool)
    bsz = len(xs)
    d1, d2 = (_two_bit_digits(bytes_to_limbs(torch.from_numpy(
        lane_bytes(u)))).numpy() for u in (u1, u2))
    idx = d1 * 4 + d2  # (B, 128)
    mul, sqr, acc = walk_ops(joint_walk(idx), bsz, WEIERSTRASS)
    mul += final_ops(acc, r)

    used, _ = joint_table(idx, bsz, np.argmax(idx != 0, axis=1))
    need3 = used[:, :, 3].any(1)
    need2 = used[:, :, 2].any(1) | need3
    mul += (need2 * 7 + need3 * 13 + 10 * used[:, 1:, 1].sum(1)
            + 13 * used[:, 1:, 2:].sum((1, 2)))
    sqr += need2 * 2

    walk = ok & on
    return {"n_mul": int(walk.sum()) * N_OPS["n_mul"],
            "n_sqr": int(walk.sum()) * N_OPS["n_sqr"],
            "p_mul": int((ok + walk * mul).sum()),
            "p_sqr": int((2 * ok + walk * sqr).sum())}
