"""The port's generic verify (crypto/cuda_ecdsa.py) against the JAX
package's (crypto/pallas_ecdsa.py): constants, curve formulas and the
plain-torch verify against ``p256.verify_item`` bit for bit.  The CUDA
kernel is held against the plain version on the card
(test_torch_cuda_kernels.py)."""

import hashlib
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smartbft_tpu.crypto import p256 as jp256
from smartbft_tpu.crypto import pallas_ecdsa as pe
from smartbft_tpu_torch.crypto import bignum as bn
from smartbft_tpu_torch.crypto import cuda_ecdsa as ce
from smartbft_tpu_torch.crypto import p256
from smartbft_tpu_torch.crypto.opcount import lane_bytes

# small plain-torch tensors gain nothing from intra-op threads, and the
# suite runs in parallel worker processes
torch.set_num_threads(1)


def test_inversion_digits_match_the_jax_package():
    assert list(ce.INV_DIGITS) == [int(d) for d in pe.INV_DIGITS]
    assert ce.NDIGITS == pe.NDIGITS and ce.WINDOW == pe.WINDOW


def _pt(point):
    """Affine int point -> Montgomery projective tuple of (1, 16) limbs."""
    c = ce.curve("cpu")
    if point is None:
        return tuple(v[None] for v in c.inf)
    return (c.fp.encode(point[0])[None], c.fp.encode(point[1])[None],
            c.fp.one[None])


def _affine(pt):
    x, y, z = (bn.from_limbs(v[0].numpy()) for v in pt)
    rinv = pow(1 << 256, -1, p256.P)
    x, y, z = (v * rinv % p256.P for v in (x, y, z))
    if z == 0:
        return None
    zi = pow(z, -1, p256.P)
    return (x * zi % p256.P, y * zi % p256.P)


@pytest.mark.parametrize("k1,k2", [(1, 2), (3, 3), (5, 7), (11, 0)])
def test_complete_formulas_match_integer_points(k1, k2):
    c = ce.curve("cpu")
    g = (p256.GX, p256.GY)
    p = p256.scalar_mult_int(k1, g) if k1 else None
    q = p256.scalar_mult_int(k2, g) if k2 else None
    got = _affine(ce.point_add(c.fp, c.b_m, _pt(p), _pt(q)))
    assert got == p256._point_add_int(p, q)
    assert _affine(ce.point_double(c.fp, c.b_m, _pt(p))) == \
        p256._point_add_int(p, p)


def test_scalars_and_digits():
    d, pub = p256.keygen(b"scal")
    msg = b"scalar-msg"
    r, s = p256.sign(d, msg)
    e8, r8, s8, _, _ = p256.verify_bytes([(msg, r, s, pub)])
    c = ce.curve("cpu")
    u1, u2, ok = ce.verify_scalars(
        c, *(bn.bytes_to_limbs(torch.from_numpy(a)) for a in (e8, r8, s8)))
    e = int.from_bytes(hashlib.sha256(msg).digest(), "big")
    w = pow(s, -1, p256.N)
    assert bn.from_limbs(u1[0].numpy()) == e * w % p256.N
    assert bn.from_limbs(u2[0].numpy()) == r * w % p256.N
    assert ok.tolist() == [True]
    digits = ce._two_bit_digits(u1)[0].tolist()
    theirs = [int(np.asarray(v)[0]) for v in
              pe._digits_w(jnp.asarray(u1.numpy().T.astype(np.uint32)),
                           pe.NDIGITS, 2)]
    assert digits == theirs


def _matrix():
    keys = [p256.keygen(b"gen-%d" % i) for i in range(3)]
    items = []
    for i in range(7):
        d, pub = keys[i % 3]
        msg = b"g-%d" % i
        r, s = p256.sign(d, msg)
        items.append((msg, r, s, pub))
    m, r, s, pub = items[1]
    items[1] = (m, (r + 1) % p256.N, s, pub)         # corrupted r
    m, r, s, pub = items[2]
    items[2] = (m, 0, s, pub)                         # r = 0
    m, r, s, pub = items[3]
    items[3] = (m, r, p256.N, pub)                    # s >= n
    m, r, s, pub = items[4]
    items[4] = (m, r, s, keys[0][1] if pub != keys[0][1] else keys[1][1])
    m, r, s, (x, y) = items[5]
    items[5] = (m, r, s, (x, (y + 1) % p256.P))       # off-curve key
    return items


def test_plain_generic_verify_matches_verify_item_bit_for_bit():
    items = _matrix()
    arrays = [np.concatenate([a, np.zeros((1, 32), np.uint8)])
              for a in p256.verify_bytes(items)]     # + one zero lane
    mask = ce.ecdsa_verify(*arrays)
    assert mask.dtype == torch.int32
    expect = [jp256.verify_item(it) for it in items] + [False]
    assert [bool(v) for v in mask.tolist()] == expect
    assert expect[:6] == [True, False, False, False, False, False]


def test_cpu_wrapper_launches_no_kernel():
    before = ce.LAUNCHES.launches
    ce.ecdsa_verify(*p256.verify_bytes(_matrix()[:1]))
    assert ce.LAUNCHES.launches == before


def _count_mont_ops(monkeypatch):
    """Count the Montgomery products and squarings the plain version runs,
    by modulus, as lanes x calls (the bound of chip_smoke.py rests on it)."""
    counts = dict.fromkeys(("n_mul", "n_sqr", "p_mul", "p_sqr"), 0)
    mul = bn.TorchMont.mul

    def counted(kind):
        def op(self, a, *b):
            shape = torch.broadcast_shapes(a.shape, *(x.shape for x in b))
            key = ("p_" if self.modulus == p256.P else "n_") + kind
            counts[key] += math.prod(shape[:-1])
            return mul(self, a, *(b or (a,)))
        return op

    monkeypatch.setattr(bn.TorchMont, "mul", counted("mul"))
    monkeypatch.setattr(bn.TorchMont, "sqr", counted("sqr"))
    return counts


def _lane(e: int, r: int, s: int, qy=None):
    """One lane's inputs with the given e, r and s, on a real key (or Q's
    y = ``qy``)."""
    _, pub = p256.keygen(b"lane")
    return [lane_bytes([v]) for v in (e, r, s, pub[0],
                                      pub[1] if qy is None else qy)]


def test_op_counts_of_the_bound_match_the_plain_version(monkeypatch):
    """The plain version runs the kernel's formulas on every lane; the
    bound counts that less what the verify does not need.  With s = 1, u1
    = e and u2 = r, here 2^252 - 1: digits (0, 0, 15, ..., 15)."""
    lane = _lane((1 << 252) - 1, (1 << 252) - 1, 1)
    counts = _count_mont_ops(monkeypatch)
    ce.ecdsa_verify(*lane)
    assert counts == {"n_mul": 84, "n_sqr": 252, "p_mul": 4631, "p_sqr": 776}
    # not needed mod n: r and e into and u1, u2 out of Montgomery form
    # (4), the inversion's 8 products by s^0 (8); mod p: Q into Montgomery
    # form (2); 2G and 3G, constants (10 + 14, and 3 squarings); three
    # products of 2Q (a doubling at Z = 1, and 1 squaring) and one of 3Q;
    # the 16 entries but 3G + 3Q (15 x 14 + 1); the first three digits'
    # six doublings and three additions on the identity (60 + 42, and 18
    # squarings); r and r + n into Montgomery form and (r + n)·Z, since
    # r + n > p (3)
    assert ce.mont_ops(*lane) == {
        "n_mul": 84 - 12, "n_sqr": 252,
        "p_mul": 4631 - (2 + 24 + 4 + 211 + 102 + 3), "p_sqr": 776 - 22}


@pytest.mark.parametrize("e,r,s,qy,want", [
    (5, 0, 3, None, (0, 0, 0)),                  # r = 0
    (5, 3, p256.N, None, (0, 0, 0)),             # s >= n
    (5, 3, 1, 2, (0, 1, 2)),                     # Q off the curve: its check
    # u1 = 0, u2 = 1: Q itself is copied, and Z = 1 at the end
    (0, 1, 1, None, (72, 1, 2)),
    # u1 = u2 = 1: G + Q (both affine) is built and copied; the
    # comparison tries r and r + n < p
    (1, 1, 1, None, (72, 1 + 10 + 2, 2)),
])
def test_bound_counts_only_the_work_the_verify_needs(e, r, s, qy, want):
    assert ce.mont_ops(*_lane(e, r, s, qy)) == {
        "n_mul": want[0], "n_sqr": 252 if want[0] else 0,
        "p_mul": want[1], "p_sqr": want[2]}


def test_cuda_launcher_checks_its_inputs():
    bad = torch.zeros((2, 31), dtype=torch.uint8)
    with pytest.raises(ValueError, match="expected"):
        ce.ecdsa_verify_cuda(bad, bad, bad, bad, bad)


@pytest.mark.slow
def test_plain_generic_matches_the_jax_verify_block():
    """The JAX package's ``_verify_block`` through ``_JaxOps`` (plain JAX;
    a compile of minutes on CPU) against the plain-torch version."""
    import jax

    items = _matrix()
    e, r, s, qx, qy = jp256.verify_inputs(items)

    @jax.jit
    def body(e, r, s, qx, qy):
        ops = pe._JaxOps(jnp.asarray(pe.INV_DIGITS))
        return pe._verify_block(ops, e.T, r.T, s.T, qx.T, qy.T)

    theirs = np.asarray(body(e, r, s, qx, qy))
    mine = ce.ecdsa_verify(*p256.verify_bytes(items))
    assert mine.tolist() == [int(v) for v in theirs]
