"""BLS12-381 aggregate verify: the CUDA kernel and its plain-torch version.

Port of the JAX package's ``smartbft_tpu/crypto/bls12381.py``
``bls_verify_kernel``: per lane, a fused dual Miller loop for
e(sig, -g2) * e(H(m), pk) in one Fp12 accumulator (the -g2 side reads
precomputed lines), the final exponentiation and an is-one check, masked
by the host's ``ok``.  A lane holds one signature or a whole aggregated
quorum; the cost is the same.

* The plain version runs the JAX package's device formulas on
  :class:`~.bignum.TorchMont` mod p with 24 16-bit limbs (R = 2^384), so
  every Montgomery value is the same number as in the JAX package and the
  CUDA kernel (12 32-bit words).  An Fp12 element is a (..., 12, 24)
  tensor of its coordinates (``a0re, a0im, a1re, a1im, a2re, a2im`` and
  the same for the w half), and a product of two of them is ONE stacked
  column product over its coordinate products with lazy reduction
  (:func:`mul12`), built from the host tower, as ``_mul12_tensor`` is:
  about a thousand stacked calls a verify, whatever the batch.
* :func:`bls_verify` is the wrapper: on CUDA tensors it launches
  ``csrc/cuda_bls.cu`` (a group of 12 threads a lane running the stage
  program of :mod:`.bls_stages` over ``csrc/bls381_group.cuh`` and
  ``csrc/bls381_field.cuh``) and counts the launch in :data:`LAUNCHES`;
  on CPU tensors it runs :func:`bls_verify_plain`.  It never falls back
  from one to the other.

Inputs are eight (B, 12) int32 tensors of little-endian 32-bit words of
Montgomery values (sig x, y; H(m) x, y; pk x0, x1, y0, y1), packed from
:func:`.bls12381.verify_inputs` by :func:`pack_inputs`, and a (B,) int32
``ok``.  The mask is (B,) int32 0/1.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import csrc
from . import bls12381 as bls
from . import bls_stages
from .bignum import TorchMont, words_to_limbs
from .cuda_ecdsa import as_tensor
from .cuda_eddsa import check_lanes
from .opcount import lane_array

#: launches and lanes of the CUDA kernel
LAUNCHES = csrc.LaunchCounter("bls_verify")

NLIMBS = bls.NLIMBS  # 16-bit limbs of a field element
WORDS = NLIMBS // 2  # 32-bit words of a field element


# ---------------------------------------------------------------------------
# the Fp12 product tensor, generated once from the host tower
# ---------------------------------------------------------------------------

#: products a reduction may sum: R/p is ~9.84 for BLS12-381, so 9 * p^2 <
#: R p and one conditional subtraction brings (T + mN)/R below p
_BUCKET_CAP = 9
_FULL_SUPPORT = tuple(range(12))
#: line rows: l00 at fp2 coordinate 0 (rows 0-1), lx at 1 (rows 2-3), ly
#: at 4 (rows 8-9)
_LINE_SUPPORT = (0, 1, 2, 3, 8, 9)
#: an Fp6 value in rows 0..5, the w half zero
_HALF_SUPPORT = (0, 1, 2, 3, 4, 5)


def _coord_basis(i: int):
    """Host Fp12 with a 1 in flat coordinate i."""
    flat = [0] * 12
    flat[i] = 1
    it = iter(flat)
    return tuple(tuple((next(it), next(it)) for _ in range(3))
                 for _ in range(2))


def _flatten_host_fp12(f):
    return [c for half in f for pair in half for c in pair]


@functools.lru_cache(maxsize=4)
def mul_tensor(y_support: tuple):
    """Product slots of z = x * y for y zero outside ``y_support``:
    (lhs row, rhs row, negate, output slot) numpy arrays and the number of
    reduction buckets.  A coefficient c of the tower becomes c slots (or
    p - c negated ones); output k's slots fill buckets of 9, slot
    ``bucket * 12 + k``."""
    slots_per_out: list = [[] for _ in range(12)]
    for i in range(12):
        for j in y_support:
            prod = _flatten_host_fp12(bls.fp12_mul(
                bls.HOST, _coord_basis(i), _coord_basis(j)))
            for k, c in enumerate(prod):
                if c == 0:
                    continue
                repeat, neg = (c, False) if c <= 4 else (bls.P - c, True)
                assert repeat <= 4, f"unexpected tensor coefficient {c}"
                slots_per_out[k].extend([(i, j, neg)] * repeat)
    n_buckets = max((len(s) + _BUCKET_CAP - 1) // _BUCKET_CAP
                    for s in slots_per_out)
    lhs, rhs, neg, out = [], [], [], []
    for k, slots in enumerate(slots_per_out):
        for pos, (i, j, n) in enumerate(slots):
            lhs.append(i)
            rhs.append(j)
            neg.append(n)
            out.append((pos // _BUCKET_CAP) * 12 + k)
    return (np.asarray(lhs, np.int64), np.asarray(rhs, np.int64),
            np.asarray(neg, bool), np.asarray(out, np.int64), n_buckets)


def frob_gammas() -> np.ndarray:
    """The Frobenius constants of a1, a2, b0, b1, b2 (xi^(k (p-1)/6) for k
    = 2, 4, 1, 3, 5), (5, 2, L) Montgomery limbs."""
    g1g2 = bls.fp2_mul(bls.HOST, bls._G1F, bls._G2F)
    g1g4 = bls.fp2_mul(bls.HOST, bls._G1F, bls._G4F)
    return np.stack([bls._fp2_const_mont(c)
                     for c in (bls._G2F, bls._G4F, bls._G1F, g1g2, g1g4)])


class Ctx:
    """The field, the product tensors and the constant tables of one
    device, built once per device."""

    def __init__(self, device):
        dev = torch.device(device)
        self.fp = TorchMont(bls.P, dev, NLIMBS)
        self.tensors = {}
        for sup in (_FULL_SUPPORT, _LINE_SUPPORT, _HALF_SUPPORT):
            lhs, rhs, neg, out, nb = mul_tensor(sup)
            self.tensors[sup] = (
                torch.from_numpy(lhs).to(dev), torch.from_numpy(rhs).to(dev),
                torch.from_numpy(neg).to(dev), torch.from_numpy(out).to(dev),
                nb)
        self.frob = self._limbs(frob_gammas())
        self.fixed_dbl = self._limbs(bls._FIXED_DBL)  # (63, 3, 2, L)
        self.fixed_add = self._limbs(bls._FIXED_ADD)

    def _limbs(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.astype(np.int64)).to(self.fp.device)


@functools.lru_cache(maxsize=None)
def ctx(device) -> Ctx:
    return Ctx(device)


# ---------------------------------------------------------------------------
# stacked Fp12 arithmetic: (..., 12, L) coordinates
# ---------------------------------------------------------------------------


def _slot_cols(a, b):
    """:func:`~.bignum._cols` for the hundreds of slot rows of an Fp12
    product: the columns summed shift by shift into one buffer, which
    never materialises the (..., L, 2L) skewed outer product."""
    n = a.shape[-1]
    out = a.new_zeros(a.shape[:-1] + (2 * n - 1,))
    for i in range(n):
        out[..., i:i + n] += a[..., i:i + 1] * b
    return out


def _mul12_tensor(c: Ctx, x, y, support):
    """z = x * y over stacked (..., 12, L) coordinates: one column product
    for every slot, column sums per output bucket, one stacked
    reduction."""
    f = c.fp
    lhs_idx, rhs_idx, neg, out, nb = c.tensors[support]
    x, y = torch.broadcast_tensors(x, y)
    lhs = x.index_select(-2, lhs_idx)
    rhs = torch.where(neg[:, None], f.neg(y).index_select(-2, rhs_idx),
                      y.index_select(-2, rhs_idx))
    cols = _slot_cols(lhs, rhs)  # (..., K, 2L - 1)
    slots = cols.new_zeros(cols.shape[:-2] + (12 * nb, cols.shape[-1]))
    slots.index_add_(-2, out, cols)
    red = f.redc(slots, terms=_BUCKET_CAP)  # (..., 12 nb, L)
    result = red[..., 0:12, :]
    for b in range(1, nb):
        result = f.add(result, red[..., 12 * b:12 * (b + 1), :])
    return result


def mul12(c: Ctx, x, y):
    return _mul12_tensor(c, x, y, _FULL_SUPPORT)


def sqr12(c: Ctx, x):
    return _mul12_tensor(c, x, x, _FULL_SUPPORT)


def mul12_line(c: Ctx, f, line_rows):
    """f times a sparse line element (rows 0-3 and 8-9 only)."""
    return _mul12_tensor(c, f, line_rows, _LINE_SUPPORT)


def conj12(c: Ctx, x):
    """a - b w: negate rows 6..11."""
    return torch.cat([x[..., 0:6, :], c.fp.neg(x[..., 6:12, :])], dim=-2)


def _rows_mul(c: Ctx, A, B):
    """Stacked Karatsuba Fp2 products (..., K, 2, L) x (..., K, 2, L): 3K
    Fp products in one call."""
    f = c.fp
    A, B = torch.broadcast_tensors(A, B)
    a0, a1 = A[..., 0, :], A[..., 1, :]
    b0, b1 = B[..., 0, :], B[..., 1, :]
    t = f.mul(torch.stack([a0, a1, f.add(a0, a1)], dim=-2),
              torch.stack([b0, b1, f.add(b0, b1)], dim=-2))
    t0, t1, t2 = t[..., 0, :], t[..., 1, :], t[..., 2, :]
    return torch.stack([f.sub(t0, t1), f.sub(t2, f.add(t0, t1))], dim=-2)


def _rows_xi(c: Ctx, a):
    """xi * a for stacked Fp2 rows (..., 2, L): (re - im, re + im)."""
    re, im = a[..., 0, :], a[..., 1, :]
    return torch.stack([c.fp.sub(re, im), c.fp.add(re, im)], dim=-2)


def frob12(c: Ctx, x):
    """The p-power Frobenius: conjugate every Fp2 coordinate, then scale
    five of the six by the gamma constants (one 5-way product)."""
    re = x[..., 0::2, :]
    im = c.fp.neg(x[..., 1::2, :])
    conj = torch.stack([re, im], dim=-2)  # (..., 6, 2, L)
    scaled = _rows_mul(c, conj[..., 1:6, :, :], c.frob)
    out = torch.cat([conj[..., 0:1, :, :], scaled], dim=-3)
    return out.flatten(-3, -2)


def _stk_pad6(a):
    """(..., 6, L) Fp6 rows -> (..., 12, L) Fp12 with a zero w half."""
    return torch.cat([a, torch.zeros_like(a)], dim=-2)


def _stk_mul_v(c: Ctx, a):
    """v * (c0 + c1 v + c2 v^2) = xi c2 + c0 v + c1 v^2 on (..., 6, L)."""
    return torch.cat([_rows_xi(c, a[..., 4:6, :]), a[..., 0:4, :]], dim=-2)


def _fp2_stk_mul(c: Ctx, pairs):
    """[(a, b), ...] independent stacked-Fp2 products in one call."""
    t = _rows_mul(c, torch.stack(torch.broadcast_tensors(
        *[a for a, _ in pairs]), dim=-3), torch.stack(torch.broadcast_tensors(
            *[b for _, b in pairs]), dim=-3))
    return tuple(t[..., i, :, :] for i in range(len(pairs)))


def _fp2_stk_sqr3(c: Ctx, a, b, d):
    """Three independent stacked Fp2 squares in one call."""
    return _fp2_stk_mul(c, [(a, a), (b, b), (d, d)])


def inv12(c: Ctx, x):
    """Fp12 inversion by the host tower's norm chain (Fp12 -> Fp6 -> Fp2
    -> one Fermat inversion in Fp), each level's independent products
    stacked."""
    f = c.fp
    a, b = x[..., 0:6, :], x[..., 6:12, :]
    pa, pb = _stk_pad6(a), _stk_pad6(b)
    a2 = _mul12_tensor(c, pa, pa, _HALF_SUPPORT)[..., 0:6, :]
    b2 = _mul12_tensor(c, pb, pb, _HALF_SUPPORT)[..., 0:6, :]
    den = f.sub(a2, _stk_mul_v(c, b2))  # a^2 - v b^2
    d0, d1, d2 = den[..., 0:2, :], den[..., 2:4, :], den[..., 4:6, :]
    s0, s1, s2 = _fp2_stk_sqr3(c, d0, d1, d2)
    p12, p01, p02 = _fp2_stk_mul(c, [(d1, d2), (d0, d1), (d0, d2)])
    c0 = f.sub(s0, _rows_xi(c, p12))
    c1 = f.sub(_rows_xi(c, s2), p01)
    c2 = f.sub(s1, p02)
    q21, q12, q00 = _fp2_stk_mul(c, [(d2, c1), (d1, c2), (d0, c0)])
    t = f.add(_rows_xi(c, f.add(q21, q12)), q00)  # (..., 2, L)
    sq = f.sqr(t)
    ninv = f.inv(f.add(sq[..., 0, :], sq[..., 1, :]))
    ri = f.mul(t, ninv[..., None, :])
    tinv = torch.stack([ri[..., 0, :], f.neg(ri[..., 1, :])], dim=-2)
    e0, e1, e2 = _fp2_stk_mul(c, [(c0, tinv), (c1, tinv), (c2, tinv)])
    e = torch.cat([e0, e1, e2], dim=-2)  # 1 / (a^2 - v b^2)
    return _mul12_tensor(c, conj12(c, x), _stk_pad6(e), _HALF_SUPPORT)


# ---------------------------------------------------------------------------
# the Miller loop
# ---------------------------------------------------------------------------


def dbl_step(c: Ctx, T):
    """Stacked Miller doubling T <- 2T on the twist, with the raw line
    coefficients (l00, lxc, lyc) (``bls12381._dbl_step``'s formulas)."""
    f = c.fp
    X, Y, Z = T  # each (..., 2, L)
    X2, Y2, Z2 = _fp2_stk_sqr3(c, X, Y, Z)
    X2_3 = f.add(f.add(X2, X2), X2)
    P1, P2, YZ = _fp2_stk_mul(c, [(X2_3, X), (X2_3, Z2), (Y, Z)])
    l00 = f.sub(P1, f.add(Y2, Y2))
    lxc = f.neg(P2)
    C, D2s, Fv = _fp2_stk_sqr3(c, Y2, f.add(X, Y2), X2_3)
    D = f.sub(D2s, f.add(X2, C))
    D = f.add(D, D)
    X3 = f.sub(Fv, f.add(D, D))
    YZ2 = f.add(YZ, YZ)
    M1, lyc = _fp2_stk_mul(c, [(X2_3, f.sub(D, X3)), (YZ2, Z2)])
    C2 = f.add(C, C)
    C4 = f.add(C2, C2)
    Y3 = f.sub(M1, f.add(C4, C4))
    return (X3, Y3, YZ2), (l00, lxc, lyc)


def add_step(c: Ctx, T, Q):
    """Stacked Miller mixed addition T <- T + Q, Q affine
    (``bls12381._add_step``'s formulas)."""
    f = c.fp
    X, Y, Z = T
    xq, yq = Q
    (Z2,) = _fp2_stk_mul(c, [(Z, Z)])
    Z3c, U2 = _fp2_stk_mul(c, [(Z2, Z), (xq, Z2)])
    (S2,) = _fp2_stk_mul(c, [(yq, Z3c)])
    H = f.sub(U2, X)
    Rr = f.sub(S2, Y)
    HZ, H2, R2 = _fp2_stk_mul(c, [(H, Z), (H, H), (Rr, Rr)])
    Rxq, HZyq, H3, UH2 = _fp2_stk_mul(
        c, [(Rr, xq), (HZ, yq), (H2, H), (X, H2)])
    X3 = f.sub(f.sub(R2, H3), f.add(UH2, UH2))
    M1, M2 = _fp2_stk_mul(c, [(Rr, f.sub(UH2, X3)), (Y, H3)])
    Y3 = f.sub(M1, M2)
    return (X3, Y3, HZ), (f.sub(Rxq, HZyq), f.neg(Rr), HZ)


def line_rows(c: Ctx, coeffs, xp, yp):
    """Scale lxc by xp and lyc by yp (one 2-way product) and assemble the
    sparse rows [l00, lx, 0 | 0, ly, 0] as (..., 12, L)."""
    l00, lxc, lyc = coeffs  # each (..., 2, L)
    ab = torch.stack(torch.broadcast_tensors(lxc, lyc), dim=-3)
    sc = torch.stack([xp, yp], dim=-2)[..., :, None, :]  # (..., 2, 1, L)
    scaled = c.fp.mul(ab, sc)
    lx, ly = scaled[..., 0, :, :], scaled[..., 1, :, :]
    z = torch.zeros_like(lx)
    rows = torch.stack([l00.expand_as(lx), lx, z, z, ly, z], dim=-3)
    return rows.flatten(-3, -2)


def _one12(c: Ctx, like):
    """1 in stacked form, (..., 12, L) for ``like`` of shape (..., L)."""
    f = torch.zeros(like.shape[:-1] + (12, NLIMBS), dtype=torch.int64,
                    device=like.device)
    f[..., 0, :] = c.fp.one
    return f


def miller(c: Ctx, sig_x, sig_y, hm_x, hm_y, qx, qy):
    """The fused dual Miller loop: e(sig, -g2) from the fixed line tables
    and e(H(m), pk) with pk = (qx, qy) stacked Fp2 (..., 2, L), in one
    accumulator; conjugated (x < 0).  An addition step runs where the
    loop's constant bit is 1."""
    f = _one12(c, sig_x)
    one2 = torch.zeros_like(qx)
    one2[..., 0, :] = c.fp.one
    T = (qx, qy, one2)
    for i, bit in enumerate(bls._X_BITS):
        f = sqr12(c, f)
        T, coeffs = dbl_step(c, T)
        f = mul12_line(c, f, line_rows(c, coeffs, hm_x, hm_y))
        row = c.fixed_dbl[i]
        f = mul12_line(c, f, line_rows(c, tuple(row), sig_x, sig_y))
        if bit:
            T, coeffs = add_step(c, T, (qx, qy))
            f = mul12_line(c, f, line_rows(c, coeffs, hm_x, hm_y))
            row = c.fixed_add[i]
            f = mul12_line(c, f, line_rows(c, tuple(row), sig_x, sig_y))
    return conj12(c, f)


def _cyclo_exp(c: Ctx, m, bits):
    """m^e for e given by its MSB-first bits."""
    acc = m
    for bit in bits[1:]:
        acc = sqr12(c, acc)
        if bit:
            acc = mul12(c, acc, m)
    return acc


def final_exp(c: Ctx, f):
    """f^(3 (p^12 - 1) / r), the JAX package's chain
    (``bls12381.host_final_exp``)."""
    f = mul12(c, conj12(c, f), inv12(c, f))
    f = mul12(c, frob12(c, frob12(c, f)), f)
    m = f

    def expx(z):
        return conj12(c, _cyclo_exp(c, z, bls._X_BITS_FULL))

    def expxm1(z):
        return conj12(c, _cyclo_exp(c, z, bls._XP1_BITS))

    a = expxm1(expxm1(m))
    b = expx(a)
    a = mul12(c, b, frob12(c, a))
    cc = _cyclo_exp(c, _cyclo_exp(c, a, bls._X_BITS_FULL), bls._X_BITS_FULL)
    a = mul12(c, mul12(c, cc, frob12(c, frob12(c, a))), conj12(c, a))
    m3 = mul12(c, sqr12(c, m), m)
    return mul12(c, a, m3)


def is_one(c: Ctx, f):
    """(...,) bool: row 0 is 1 (Montgomery) and rows 1..11 are 0."""
    rest_zero = (f[..., 1:, :] == 0).all(-1).all(-1)
    return (f[..., 0, :] == c.fp.one).all(-1) & rest_zero


def pairing_values(sig_x, sig_y, hm_x, hm_y, pk_x0, pk_x1, pk_y0, pk_y1):
    """Each lane's final-exponentiated Fp12 (B, 12, L) in Montgomery
    limbs, on the inputs' device (the plain version's, before the is-one
    check)."""
    c = ctx(sig_x.device)
    sx, sy, hx, hy, x0, x1, y0, y1 = (
        words_to_limbs(a) for a in (sig_x, sig_y, hm_x, hm_y, pk_x0, pk_x1,
                                    pk_y0, pk_y1))
    qx = torch.stack([x0, x1], dim=-2)
    qy = torch.stack([y0, y1], dim=-2)
    return final_exp(c, miller(c, sx, sy, hx, hy, qx, qy))


def bls_verify_plain(sig_x, sig_y, hm_x, hm_y, pk_x0, pk_x1, pk_y0, pk_y1,
                     ok) -> torch.Tensor:
    """The verify in plain torch on (B, 12) int32 words and a (B,) int32
    ``ok``; (B,) int32 mask.  Runs on whatever device the inputs are
    on."""
    f = pairing_values(sig_x, sig_y, hm_x, hm_y, pk_x0, pk_x1, pk_y0, pk_y1)
    return (is_one(ctx(sig_x.device), f) & (ok != 0)).to(torch.int32)


# ---------------------------------------------------------------------------
# host marshalling
# ---------------------------------------------------------------------------


def _limbs_to_words(a: np.ndarray) -> np.ndarray:
    """(..., 24) 16-bit limbs -> (..., 12) uint32 words."""
    a = a.astype(np.uint32)
    return a[..., 0::2] | (a[..., 1::2] << 16)


def pack_inputs(arrays) -> list:
    """:func:`.bls12381.verify_inputs`' nine arrays (24 16-bit limbs a
    value) -> eight (B, 12) int32 word arrays and the (B,) int32 ``ok``."""
    *vals, ok = arrays
    return [_limbs_to_words(a).view(np.int32) for a in vals] + \
        [np.asarray(ok).astype(np.int32)]


def verify_words(items) -> list:
    """Verify items -> the kernel's inputs (:func:`pack_inputs`)."""
    return pack_inputs(bls.verify_inputs(items))


def const_table() -> np.ndarray:
    """The kernel's constant table, (418, 12) uint32 words: the 63
    doubling rows of the fixed -g2 lines, then the 5 addition rows (3 Fp2
    coefficients each, l00, lxc, lyc), then the 5 Frobenius gammas of
    a1, a2, b0, b1, b2 (Fp2 each), all Montgomery values."""
    adds = bls._FIXED_ADD[bls._X_BITS_ARR == 1]
    rows = np.concatenate([bls._FIXED_DBL.reshape(-1, NLIMBS),
                           adds.reshape(-1, NLIMBS),
                           frob_gammas().reshape(-1, NLIMBS)])
    return _limbs_to_words(rows)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib(name: str = "cuda_bls"):
    """The kernel library the wrapper loads, or a build of the same source
    with another group size or stopping after the Miller loop (a name in
    :data:`csrc.VARIANTS`)."""
    lib = csrc.load(name)
    vp = ctypes.c_void_p
    lib.smartbft_bls_verify.restype = ctypes.c_int
    lib.smartbft_bls_verify.argtypes = [vp] * 10 + [ctypes.c_int, vp, vp,
                                                    ctypes.c_int, vp]
    lib.smartbft_bls_group.restype = ctypes.c_int
    lib.smartbft_bls_group.argtypes = []
    lib.smartbft_bls_shared_bytes.restype = ctypes.c_int
    lib.smartbft_bls_shared_bytes.argtypes = [ctypes.c_int]
    return lib


def group_size(name: str = "cuda_bls") -> int:
    """Threads a lane of the kernel library ``name``."""
    return _lib(name).smartbft_bls_group()


def shared_bytes(name: str = "cuda_bls") -> int:
    """Dynamic shared memory a block of the kernel library ``name`` takes
    for the stage program's slots."""
    return _lib(name).smartbft_bls_shared_bytes(bls_stages.program().nslots)


@functools.lru_cache(maxsize=None)
def device_table(device) -> torch.Tensor:
    """:func:`const_table` on ``device``, uploaded once per device."""
    return torch.from_numpy(const_table()).to(device)


@functools.lru_cache(maxsize=None)
def device_program(device) -> torch.Tensor:
    """The stage program's words (:func:`.bls_stages.program`) on
    ``device``, uploaded once per device."""
    words = bls_stages.program().words
    return torch.from_numpy(words.view(np.int32)).to(device)


def check_words(a, name: str, bsz: int, device) -> None:
    if a.dtype != torch.int32 or tuple(a.shape) != (bsz, WORDS) \
            or a.device != device or not a.is_contiguous():
        raise ValueError(f"{name}: expected contiguous ({bsz}, {WORDS}) int32 "
                         f"on {device}, got {tuple(a.shape)} {a.dtype}")


def launch(name: str, sig_x, sig_y, hm_x, hm_y, pk_x0, pk_x1, pk_y0, pk_y1,
           ok) -> torch.Tensor:
    """Check the CUDA tensors (shapes as the plain version's), then launch
    the kernel of the library ``name`` (see :func:`_lib`); counts
    nothing."""
    vals = (sig_x, sig_y, hm_x, hm_y, pk_x0, pk_x1, pk_y0, pk_y1)
    bsz, dev = sig_x.shape[0], sig_x.device
    names = ("sig_x", "sig_y", "hm_x", "hm_y", "pk_x0", "pk_x1", "pk_y0",
             "pk_y1")
    for a, label in zip(vals, names):
        check_words(a, label, bsz, dev)
    check_lanes(ok, "ok", bsz, dev)
    out = torch.empty(bsz, dtype=torch.int32, device=dev)
    if bsz == 0:
        return out
    # the launch goes to the current device: make it the tensors'
    # (a worker thread starts on device 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib(name).smartbft_bls_verify(
            *(a.data_ptr() for a in vals), ok.data_ptr(),
            device_program(dev).data_ptr(), bls_stages.program().nslots,
            device_table(dev).data_ptr(), out.data_ptr(), bsz, stream)
    csrc.check(rc, "bls_verify")
    return out


def bls_verify_cuda(sig_x, sig_y, hm_x, hm_y, pk_x0, pk_x1, pk_y0, pk_y1,
                    ok) -> torch.Tensor:
    """Launch the kernel on CUDA tensors (shapes as the plain version's)
    and count it."""
    out = launch("cuda_bls", sig_x, sig_y, hm_x, hm_y, pk_x0, pk_x1, pk_y0,
                 pk_y1, ok)
    if out.numel():
        LAUNCHES.add(out.numel())
    return out


def bls_verify(sig_x, sig_y, hm_x, hm_y, pk_x0, pk_x1, pk_y0, pk_y1,
               ok) -> torch.Tensor:
    """Batched BLS12-381 pairing-equation verify; (B,) int32 0/1 mask on
    the inputs' device.  CUDA inputs run the kernel, CPU inputs the plain
    version."""
    args = [as_tensor(a) for a in (sig_x, sig_y, hm_x, hm_y, pk_x0, pk_x1,
                                   pk_y0, pk_y1, ok)]
    if args[0].is_cuda:
        return bls_verify_cuda(*args)
    return bls_verify_plain(*args)


# ---------------------------------------------------------------------------
# the work behind the bound
# ---------------------------------------------------------------------------

#: Fp products of the kernel's formulas (Fp2 Karatsuba: 3; an Fp2 square
#: 2; an Fp2 by an Fp scalar 2; Fp6: 6 Fp2 products; the sparse line
#: product: 13 Fp2 products; an Fp12 square 2 Fp6 products; a square in the
#: cyclotomic subgroup, Granger-Scott, 3 Fp4 squares of 2 Fp2 products)
FP2_MUL, FP2_SQR, FP2_BY_FP = 3, 2, 2
FP6_MUL = 6 * FP2_MUL
FP12_MUL = 3 * FP6_MUL
FP12_SQR = 2 * FP6_MUL
CYCLO_SQR = 3 * 2 * FP2_MUL
LINE_MUL = 13 * FP2_MUL + 2 * FP2_BY_FP  # the line's scaling included
DBL_STEP = 6 * FP2_SQR + 5 * FP2_MUL
ADD_STEP = 3 * FP2_SQR + 10 * FP2_MUL
FROB = 5 * FP2_MUL
#: Fp12 inversion: 2 Fp6 squares, the Fp6 inverse (3 Fp2 squares, 9 Fp2
#: products, an Fp2 inverse: 2 products and 2 squares about one Fp
#: inversion) and 2 Fp6 products
INV12_MUL = 2 * FP6_MUL + 3 * FP2_SQR + 9 * FP2_MUL + 2 + 2 * FP6_MUL
INV12_SQR = 2
#: the Fermat inversion in Fp: p - 2 by square-and-multiply
FP_INV_SQR = (bls.P - 2).bit_length() - 1
FP_INV_MUL = bin(bls.P - 2).count("1") - 1


def lane_ops() -> dict:
    """Fp products and squarings of one live lane: the Miller loop (63
    doublings and their two lines, the 5 addition steps where the
    constant bit is 1 and theirs), then the final exponentiation."""
    nbits = len(bls._X_BITS)
    nadd = sum(bls._X_BITS)
    miller = (nbits * (FP12_SQR + DBL_STEP + 2 * LINE_MUL)
              + nadd * (ADD_STEP + 2 * LINE_MUL))
    exps = (bls._XP1_BITS,) * 2 + (bls._X_BITS_FULL,) * 3
    exp_sqr = sum(len(b) - 1 for b in exps)
    exp_mul = sum(sum(b[1:]) for b in exps)
    # easy part: 2 products, an inversion, 2 Frobenius; hard part: 4
    # products, 3 Frobenius, m^3 (a square and a product), the last one;
    # every square of the hard part is in the cyclotomic subgroup
    final = (exp_sqr + 1) * CYCLO_SQR + (exp_mul + 7) * FP12_MUL \
        + 5 * FROB + INV12_MUL + FP_INV_MUL
    return {"b381_mul": miller + final, "b381_sqr": INV12_SQR + FP_INV_SQR}


def mont_ops(sig_x, sig_y, hm_x, hm_y, pk_x0, pk_x1, pk_y0, pk_y1,
             ok) -> dict:
    """Products and squarings mod p the batch needs: :func:`lane_ops` for
    every lane with ``ok`` set, none for a dead lane (it fails without a
    pairing).  The loop's bits are constant, so every live lane needs the
    same."""
    live = int((lane_array(ok) != 0).sum())
    return {k: live * v for k, v in lane_ops().items()}
