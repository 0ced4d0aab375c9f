"""Generic Ed25519 verify: the plain-torch Edwards arithmetic, the CUDA
kernel and its plain-torch version.

Port of the JAX package's XLA kernel ``smartbft_tpu/crypto/ed25519.py``
(``eddsa_verify_kernel`` with ``shamir_double_scalar``), the route for a
chunk that holds a key outside the comb registry.  Cofactorless, as the
reference: [S]B + [h](-A) == R, with S < L checked here, R and A checked
on the curve, a 16-entry joint table {iB + j(-A) : i, j < 4} and a
127-digit 2-bit Strauss–Shamir scan (2 doublings + 1 unified addition a
digit), then a projective comparison with R.

* The field is :class:`~.bignum.TorchMont` mod p = 2^255 - 19 with R =
  2^256, so every Montgomery value is the same number as in the JAX
  package and the CUDA kernels.  :func:`point_add` (add-2008-hwcd-3,
  a = -1) and :func:`point_double` (dbl-2008-hwcd, both halves negated)
  follow the JAX package's ``point_add``/``point_double`` line for line;
  :mod:`.cuda_ed25519` (the comb kernel's plain version) imports them.
* :func:`eddsa_verify` is the wrapper: on CUDA tensors it launches
  ``csrc/cuda_eddsa.cu`` (a group of 4 threads per signature, over the
  stage program of ``csrc/ed25519_group.cuh``) and counts the launch in
  :data:`LAUNCHES`; on CPU tensors it runs :func:`eddsa_verify_plain`.
  It never falls back from one to the other.

Inputs are (B, 32) uint8 little-endian values (:func:`ed25519.verify_inputs`),
which the kernel reads as eight 32-bit words, and a (B,) int32 host flag
``ok`` (0 where R or A does not decode).  The mask is (B,) int32 0/1.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import csrc
from .bignum import TorchMont, bytes_to_limbs, eq, geq, grp, grp1, int_to_limbs
from .cuda_ecdsa import _bits, _check_bytes, as_tensor
from .ed25519 import BX, BY, D, L, P, _aff_add
from .opcount import (
    EDWARDS,
    PROJ,
    joint_table,
    joint_walk,
    lane_array,
    lane_bytes,
    lane_ints,
    walk_ops,
)

#: launches and lanes of the CUDA kernel
LAUNCHES = csrc.LaunchCounter("eddsa_verify")

#: joint-scan window: 127 digits of 2 bits cover scalars below 2^254
NDIGITS = 127


class Curve:
    """Field and constants of one device, built once per device."""

    def __init__(self, device):
        dev = torch.device(device)
        self.fp = f = TorchMont(P, dev)
        self.d_m = f.encode(D)
        self.d2_m = f.encode(2 * D % P)
        self.l = int_to_limbs(L, dev)
        zero = int_to_limbs(0, dev)
        self.zero = zero
        #: the identity (0 : 1 : 1 : 0)
        self.ident = (zero, f.one, f.one, zero)
        b2 = _aff_add((BX, BY), (BX, BY))
        #: B, 2B, 3B as extended (X : Y : 1 : XY)
        self.b_mults = [self.ident] + [
            (f.encode(x), f.encode(y), f.one, f.encode(x * y % P))
            for x, y in ((BX, BY), b2, _aff_add(b2, (BX, BY)))]


@functools.lru_cache(maxsize=None)
def curve(device) -> Curve:
    return Curve(device)


# ---------------------------------------------------------------------------
# curve ops: a point is a tuple (X, Y, Z, T) of (..., 16) Montgomery tensors
# ---------------------------------------------------------------------------


def point_add(f: TorchMont, d2, p, q):
    """Unified addition add-2008-hwcd-3 (a = -1), complete on this curve:
    8 products and one by the 2d constant."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    s1, s2 = grp(f.sub, [(y1, x1), (y2, x2)])
    a1, a2, z1d = grp(f.add, [(y1, x1), (y2, x2), (z1, z1)])
    a, b, c1, d = grp(f.mul, [(s1, s2), (a1, a2), (t1, d2), (z1d, z2)])
    c = f.mul(c1, t2)
    e, ff = grp(f.sub, [(b, a), (d, c)])
    g, h = grp(f.add, [(d, c), (b, a)])
    x3, y3, t3, z3 = grp(f.mul, [(e, ff), (g, h), (e, h), (ff, g)])
    return x3, y3, z3, t3


def point_double(f: TorchMont, p):
    """Doubling dbl-2008-hwcd with both output halves negated (a = -1):
    4 squarings + 4 products, the same projective point.  T is not read."""
    x, y, z, _ = p
    xy = f.add(x, y)
    a, b, zz, s = grp1(f.sqr, [x, y, z, xy])
    c, h = grp(f.add, [(zz, zz), (a, b)])
    g, e1 = grp(f.sub, [(b, a), (s, a)])
    e = f.sub(e1, b)
    ff = f.sub(c, g)
    x3, y3, z3, t3 = grp(f.mul, [(e, ff), (g, h), (ff, g), (e, h)])
    return x3, y3, z3, t3


def is_on_curve(c: Curve, xm, ym):
    """-x² + y² == 1 + d x² y² for Montgomery affine coordinates."""
    f = c.fp
    xx, yy = grp1(f.sqr, [xm, ym])
    lhs = f.sub(yy, xx)
    rhs = f.add(f.one, f.mul(c.d_m, f.mul(xx, yy)))
    return eq(lhs, rhs)


def two_bit_digits(u):
    """(B, 16) scalar limbs -> (B, 127) MSB-first 2-bit digits of bits
    253..0 (the JAX package's ``digits_msb(u, 127, 2)``)."""
    pairs = _bits(u)[..., :2 * NDIGITS].unflatten(-1, (NDIGITS, 2))
    return (pairs[..., 0] | (pairs[..., 1] << 1)).flip(-1)


def eddsa_verify_plain(s, h, rx, ry, ax, ay, ok) -> torch.Tensor:
    """The generic verify in plain torch on (B, 32) uint8 inputs and a (B,)
    int32 ``ok``; (B,) int32 mask.  Runs on whatever device the inputs are
    on."""
    c = curve(s.device)
    f = c.fp
    s, h, rx, ry, ax, ay = (bytes_to_limbs(a) for a in (s, h, rx, ry, ax, ay))
    s_ok = ~geq(s, c.l)
    rxm, rym, axm, aym = grp(f.mul, [(v, f.R2) for v in (rx, ry, ax, ay)])
    oncurve = is_on_curve(c, rxm, rym) & is_on_curve(c, axm, aym)

    one = f.one.expand_as(axm)
    nega = (f.sub(c.zero, axm), aym, one, f.sub(c.zero, f.mul(axm, aym)))
    na2 = point_add(f, c.d2_m, nega, nega)
    na3 = point_add(f, c.d2_m, na2, nega)
    ident = tuple(v.expand_as(axm) for v in c.ident)
    nas = [ident, nega, na2, na3]
    bs = [tuple(v.expand_as(axm) for v in pt) for pt in c.b_mults]
    # entry 4i + j = iB + j(-A): the 16 additions in one grouped call
    lhs = tuple(torch.stack([bs[i][k] for i in range(4) for _ in range(4)])
                for k in range(4))
    rhs = tuple(torch.stack([nas[j][k] for _ in range(4) for j in range(4)])
                for k in range(4))
    table = point_add(f, c.d2_m, lhs, rhs)  # 4 x (16, B, 16)

    idx = two_bit_digits(s) * 4 + two_bit_digits(h)  # (B, 127)
    lane = torch.arange(s.shape[0], device=s.device)
    acc = ident
    for k in range(NDIGITS):
        acc = point_double(f, point_double(f, acc))
        ik = idx[:, k]
        acc = point_add(f, c.d2_m, acc, tuple(t[ik, lane] for t in table))
    x, y, z, _ = acc
    mx, my = grp(f.mul, [(rxm, z), (rym, z)])
    match = eq(mx, x) & eq(my, y)
    mask = match & s_ok & oncurve & (ok != 0)
    return mask.to(torch.int32)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib(name: str = "cuda_eddsa"):
    """The kernel library the wrapper loads, or a build of the same source
    with another group size (a name in :data:`csrc.VARIANTS`)."""
    lib = csrc.load(name)
    vp = ctypes.c_void_p
    lib.smartbft_eddsa_verify.restype = ctypes.c_int
    lib.smartbft_eddsa_verify.argtypes = [vp] * 8 + [ctypes.c_int, vp]
    lib.smartbft_eddsa_group.restype = ctypes.c_int
    lib.smartbft_eddsa_group.argtypes = []
    return lib


def group_size(name: str = "cuda_eddsa") -> int:
    """Threads per signature of the kernel library ``name``."""
    return _lib(name).smartbft_eddsa_group()


def check_lanes(a, name: str, bsz: int, device) -> None:
    """A (B,) int32 per-lane tensor (``ok``, ``kidx``) on ``device``."""
    if a.dtype != torch.int32 or tuple(a.shape) != (bsz,) \
            or a.device != device or not a.is_contiguous():
        raise ValueError(f"{name}: expected contiguous ({bsz},) int32 on "
                         f"{device}, got {tuple(a.shape)} {a.dtype}")


def launch(lib: str, s, h, rx, ry, ax, ay, ok) -> torch.Tensor:
    """Check the CUDA tensors (shapes as the plain version's), then launch
    the kernel of the library ``lib`` (see :func:`_lib`); counts nothing."""
    bsz, dev = s.shape[0], s.device
    names = ("s", "h", "rx", "ry", "ax", "ay")
    for a, name in zip((s, h, rx, ry, ax, ay), names):
        _check_bytes(a, name, bsz, dev)
    check_lanes(ok, "ok", bsz, dev)
    out = torch.empty(bsz, dtype=torch.int32, device=dev)
    if bsz == 0:
        return out
    # the launch goes to the current device: make it the tensors'
    # (a worker thread starts on device 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib(lib).smartbft_eddsa_verify(
            s.data_ptr(), h.data_ptr(), rx.data_ptr(), ry.data_ptr(),
            ax.data_ptr(), ay.data_ptr(), ok.data_ptr(), out.data_ptr(), bsz,
            stream)
    csrc.check(rc, "eddsa_verify")
    return out


def eddsa_verify_cuda(s, h, rx, ry, ax, ay, ok) -> torch.Tensor:
    """Launch the generic kernel on CUDA tensors (shapes as the plain
    one)."""
    out = launch("cuda_eddsa", s, h, rx, ry, ax, ay, ok)
    if out.numel():
        LAUNCHES.add(out.numel())
    return out


def eddsa_verify(s, h, rx, ry, ax, ay, ok) -> torch.Tensor:
    """Batched generic Ed25519 verify; (B,) int32 0/1 mask on the inputs'
    device.  CUDA inputs run the kernel, CPU inputs the plain version."""
    args = [as_tensor(a) for a in (s, h, rx, ry, ax, ay, ok)]
    if args[0].is_cuda:
        return eddsa_verify_cuda(*args)
    return eddsa_verify_plain(*args)


def on_curve_lanes(x8, y8) -> np.ndarray:
    """(B,) bool: (x, y) mod p lies on -x² + y² = 1 + d x² y²."""
    return np.array([(y * y - x * x - 1 - D * x * x % P * (y * y % P)) % P == 0
                     for x, y in zip(lane_ints(x8), lane_ints(y8))], bool)


def mont_ops(s, h, rx, ry, ax, ay, ok) -> dict:
    """Products and squarings mod p the batch needs (:mod:`.opcount`).  A
    lane with ``ok = 0`` or S >= L needs none.  Any other needs a curve
    check (2 squarings + 2 products) of R and of A, or only of the one that
    fails; on the curve, the table points its digits use, the scan and the
    comparison (2 products where Z is not 1).  Table points: -A's T (1
    product), -2A = -A + -A, -3A = -2A + -A and iB + j(-A) for i, j >= 1,
    each 7 products + 1 for its T where something reads it.  No Montgomery
    conversion is counted: a reduction for 2^255 - 19 needs none."""
    s_ints = lane_ints(s)
    bsz = len(s_ints)
    live = (lane_array(ok) != 0) & np.array([v < L for v in s_ints], bool)
    on = on_curve_lanes(rx, ry) & on_curve_lanes(ax, ay)
    sl, hl = (bytes_to_limbs(torch.from_numpy(lane_bytes(v)))
              for v in (s_ints, lane_ints(h)))
    idx = (two_bit_digits(sl) * 4 + two_bit_digits(hl)).numpy()  # (B, 127)
    mul, sqr, acc = walk_ops(joint_walk(idx), bsz, EDWARDS)
    mul += 2 * (acc == PROJ)

    used, added = joint_table(idx, bsz, np.argmax(idx != 0, axis=1))
    pairs = used[:, 1:, 1:]                  # iB + j(-A), i, j >= 1
    need_j = used[:, :, 1:].any(1)           # j(-A), j = 1..3
    read_j = added[:, 0, 1:] | pairs.any(1)  # j(-A)'s T is read
    need3 = need_j[:, 2]
    need2 = need_j[:, 1] | need3
    table = ((read_j[:, 0] | need2)
             + need2 * (7 + (read_j[:, 1] | need3))
             + need3 * (7 + read_j[:, 2])
             + (7 * pairs + added[:, 1:, 1:]).sum((1, 2)))

    checks = live * np.where(on, 2, 1)
    walk = live & on
    return {"ed_mul": int((2 * checks + walk * (table + mul)).sum()),
            "ed_sqr": int((2 * checks + walk * sqr).sum())}
