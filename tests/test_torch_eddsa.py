"""The port's generic Ed25519 verify (crypto/cuda_eddsa.py) against the JAX
package's XLA kernel (crypto/ed25519.py ``eddsa_verify_kernel``): the
Edwards formulas against integer points, the scalar digits, and the
plain-torch verify against ``ed25519.verify_item`` bit for bit.  The CUDA
kernel is held against the plain version on the card
(test_torch_cuda_kernels.py)."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smartbft_tpu.crypto import bignum as jbn
from smartbft_tpu.crypto import ed25519 as jed
from smartbft_tpu_torch.crypto import bignum as bn
from smartbft_tpu_torch.crypto import cuda_eddsa as cgd
from smartbft_tpu_torch.crypto import ed25519 as ed

# small plain-torch tensors gain nothing from intra-op threads, and the
# suite runs in parallel worker processes
torch.set_num_threads(1)


def _ext(point):
    """Affine int point -> extended Montgomery tuple of (1, 16) limbs."""
    f = cgd.curve("cpu").fp
    x, y = point
    return tuple(f.encode(v)[None] for v in (x, y, 1, x * y % ed.P))


def _affine(pt):
    x, y, z, t = (bn.from_limbs(v[0].numpy()) for v in pt)
    assert x * y % ed.P == t * z % ed.P  # T/Z = x y
    zi = pow(z, -1, ed.P)  # the Montgomery factors cancel
    return (x * zi % ed.P, y * zi % ed.P)


@pytest.mark.parametrize("k1,k2", [(1, 2), (3, 3), (5, 7), (11, 0)])
def test_edwards_formulas_match_integer_points(k1, k2):
    c = cgd.curve("cpu")
    b = (ed.BX, ed.BY)
    p, q = ed.scalar_mult_int(k1, b), ed.scalar_mult_int(k2, b)
    assert _affine(cgd.point_add(c.fp, c.d2_m, _ext(p), _ext(q))) == \
        ed._aff_add(p, q)
    assert _affine(cgd.point_double(c.fp, _ext(p))) == ed._aff_add(p, p)


def test_is_on_curve_and_base_multiples():
    c = cgd.curve("cpu")
    f = c.fp
    pt = ed.scalar_mult_int(99, (ed.BX, ed.BY))
    xm, ym = (f.encode(v)[None] for v in pt)
    assert cgd.is_on_curve(c, xm, ym).tolist() == [True]
    off = f.encode((pt[1] + 1) % ed.P)[None]
    assert cgd.is_on_curve(c, xm, off).tolist() == [False]
    for i, want in enumerate([(0, 1), (ed.BX, ed.BY),
                              ed.scalar_mult_int(2, (ed.BX, ed.BY)),
                              ed.scalar_mult_int(3, (ed.BX, ed.BY))]):
        assert _affine(tuple(v[None] for v in c.b_mults[i])) == want


@pytest.mark.parametrize("seed", [1, 2])
def test_digits_match_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    us = [int.from_bytes(rng.bytes(32), "little") for _ in range(4)]
    limbs = np.stack([bn.to_limbs(u, 16) for u in us])
    mine = cgd.two_bit_digits(torch.from_numpy(limbs.astype(np.int64)))
    theirs = np.asarray(jbn.digits_msb(jnp.asarray(limbs), 127, 2))
    assert mine.shape == (4, cgd.NDIGITS)
    assert (mine.numpy() == theirs).all()


def _matrix():
    """Ed25519 votes by keys outside any registry: valid, corrupted S,
    tampered message, S >= L, an undecodable R, an undecodable key, a
    signature under another key's name; plus one zero lane."""
    keys = [ed.keygen(b"gen-%d" % i) for i in range(3)]
    items = []
    for i in range(8):
        priv, pub = keys[i % 3]
        msg = b"g-%d" % i
        items.append(ed.make_item(msg, ed.sign_raw(priv, msg), pub))
    m, sig, pub = items[1]
    bad_s = (int.from_bytes(sig[32:], "little") + 1) % ed.L
    items[1] = (m, sig[:32] + bad_s.to_bytes(32, "little"), pub)
    m, sig, pub = items[2]
    items[2] = (b"tampered", sig, pub)
    m, sig, pub = items[3]
    items[3] = (m, sig[:32] + (ed.L + 2).to_bytes(32, "little"), pub)
    m, sig, pub = items[4]
    items[4] = (m, b"\xff" * 32 + sig[32:], pub)
    m, sig, _ = items[5]
    items[5] = (m, sig, b"\xff" * 32)
    m, sig, _ = items[6]
    items[6] = (m, sig, keys[1][1])  # keys[0]'s vote claimed by keys[1]
    return items


def _padded(items, extra=1):
    return [np.concatenate([a, np.zeros((extra,) + a.shape[1:], a.dtype)])
            for a in ed.verify_inputs(items)]


def test_plain_generic_verify_matches_verify_item_bit_for_bit():
    items = _matrix()
    mask = cgd.eddsa_verify(*_padded(items))     # + one zero lane
    assert mask.dtype == torch.int32 and mask.device.type == "cpu"
    expect = [jed.verify_item(it) for it in items] + [False]
    assert [bool(v) for v in mask.tolist()] == expect
    assert [ed.verify_item(it) for it in items] == expect[:-1]
    assert expect == [True, False, False, False, False, False, False, True,
                      False]


def test_in_kernel_range_check_rejects_s_at_or_above_l():
    """The generic route gets S as sent (the host folds only decode
    failures into ok), so S >= L must fail inside the verify even where
    S - L would verify."""
    priv, pub = ed.keygen(b"range")
    sig = ed.sign_raw(priv, b"r")
    s = int.from_bytes(sig[32:], "little")
    forged = sig[:32] + (s + ed.L).to_bytes(32, "little")
    # within the 254 bits the digits cover, so [S + L]B = [S]B
    assert s + ed.L < 1 << 254
    arrays = ed.verify_inputs([(b"r", sig, pub), (b"r", forged, pub)])
    assert arrays[6].tolist() == [1, 1]
    assert cgd.eddsa_verify(*arrays).tolist() == [1, 0]


def test_cpu_wrapper_launches_no_kernel():
    before = cgd.LAUNCHES.launches
    cgd.eddsa_verify(*ed.verify_inputs(_matrix()[:1]))
    assert cgd.LAUNCHES.launches == before


def _count_mont_ops(monkeypatch):
    """Count the Montgomery products and squarings the plain version runs
    mod p, as lanes x calls (the bound of chip_smoke.py rests on it)."""
    counts = dict.fromkeys(("ed_mul", "ed_sqr"), 0)
    mul = bn.TorchMont.mul

    def counted(kind):
        def op(self, a, *b):
            assert self.modulus == ed.P
            shape = torch.broadcast_shapes(a.shape, *(x.shape for x in b))
            counts["ed_" + kind] += math.prod(shape[:-1])
            return mul(self, a, *(b or (a,)))
        return op

    monkeypatch.setattr(bn.TorchMont, "mul", counted("mul"))
    monkeypatch.setattr(bn.TorchMont, "sqr", counted("sqr"))
    return counts


def _lane(s: int, h: int, ok: int = 1, ay=None):
    """One lane's verify inputs: a real R and key (or A's y = ``ay``), the
    given S and h."""
    arrays = ed.verify_inputs(_matrix()[:1])
    for a, v in ((0, s), (1, h), (5, ay)):
        if v is not None:
            arrays[a][0] = np.frombuffer(v.to_bytes(32, "little"), np.uint8)
    arrays[6][0] = ok
    return arrays


def test_op_counts_of_the_bound_match_the_plain_version(monkeypatch):
    """The plain version runs the kernel's formulas on every lane; the
    bound counts that less what the verify does not need.  On a lane whose
    digits are (0, 3·4 + 3, ..., 3·4 + 3):"""
    lane = _lane((1 << 252) - 1, (1 << 252) - 1)
    counts = _count_mont_ops(monkeypatch)
    cgd.eddsa_verify(*lane)
    assert counts == {"ed_mul": 2332, "ed_sqr": 1020}
    # products not needed: R and A into Montgomery form (4); the table's
    # 18 additions of 9 where -2A, -3A and 3B - 3A need 8 each (138); the
    # first two digits' four doublings and two additions on the identity
    # (16 + 18, and 16 squarings); the unread T of the first doubling and
    # of the addition in each of the other 125 digits (250)
    assert cgd.mont_ops(*lane) == {"ed_mul": 2332 - (4 + 138 + 34 + 250),
                                   "ed_sqr": 1020 - 16}


@pytest.mark.parametrize("s,h,ok,ay,want", [
    (5, 3, 0, None, (0, 0)),                       # host-rejected
    (ed.L, 3, 1, None, (0, 0)),                    # S >= L
    (5, 3, 1, 2, (2, 2)),                          # A off the curve
    (1, 0, 1, None, (4, 4)),          # one digit: B copied, Z = 1 at the end
    # digits 125, 126 = -A: copied, then an affine doubling (3S + 3M, T
    # unread), a doubling (4S + 3M, T read) and a mixed addition (7M);
    # -A's T (1M), the comparison (2M), both curve checks (4S + 4M)
    (0, 5, 1, None, (4 + 1 + 3 + 4 + 7 + 2, 4 + 3 + 4)),
])
def test_bound_counts_only_the_work_the_verify_needs(s, h, ok, ay, want):
    assert cgd.mont_ops(*_lane(s, h, ok, ay)) == \
        {"ed_mul": want[0], "ed_sqr": want[1]}


def test_cuda_launcher_checks_its_inputs():
    bad = torch.zeros((2, 31), dtype=torch.uint8)
    ok = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="expected"):
        cgd.eddsa_verify_cuda(bad, bad, bad, bad, bad, bad, ok)
    good = torch.zeros((2, 32), dtype=torch.uint8)
    with pytest.raises(ValueError, match="ok: expected"):
        cgd.eddsa_verify_cuda(good, good, good, good, good, good,
                              ok.to(torch.int64))


@pytest.mark.slow
def test_plain_generic_matches_the_jitted_xla_kernel():
    """The JAX package's ``eddsa_verify_kernel`` jitted at B = 8 (a compile
    of about 20 s on CPU) against the plain-torch version."""
    import jax

    items = _matrix()
    theirs = np.asarray(jax.jit(jed.eddsa_verify_kernel)(
        *[jnp.asarray(a) for a in jed.verify_inputs(items)]))
    mine = cgd.eddsa_verify(*ed.verify_inputs(items))
    assert mine.tolist() == [int(v) for v in theirs]
