"""The port's comb verify (crypto/cuda_comb.py) against the JAX package's
(crypto/pallas_comb.py): tables and digits value for value, the plain-torch
verify against ``p256.verify_item`` over the rejection matrix bit for bit,
the key registry and the engine adapter.  The CUDA kernel itself is held
against the plain version on the card (test_torch_cuda_kernels.py)."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smartbft_tpu.crypto import p256 as jp256
from smartbft_tpu.crypto import pallas_comb as pc
from smartbft_tpu_torch.crypto import bignum as bn
from smartbft_tpu_torch.crypto import cuda_comb as cc
from smartbft_tpu_torch.crypto import p256
from smartbft_tpu_torch.crypto.opcount import lane_bytes

# small plain-torch tensors gain nothing from intra-op threads, and the
# suite runs in parallel worker processes
torch.set_num_threads(1)


def _items(n, nkeys=2, corrupt=()):
    keys = [p256.keygen(b"ct-%d" % i) for i in range(nkeys)]
    items, expect = [], []
    for i in range(n):
        d, pub = keys[i % nkeys]
        msg = b"m-%d" % i
        r, s = p256.sign(d, msg)
        ok = True
        if i in corrupt:
            r = (r + 1) % p256.N
            ok = False
        items.append((msg, r, s, pub))
        expect.append(ok)
    return items, expect


@pytest.fixture(scope="module")
def two_keys():
    return [p256.keygen(b"ct-%d" % i)[1] for i in range(2)]


def test_tables_carry_over_from_the_jax_package(two_keys):
    reg_j = pc.CombKeyRegistry()
    reg_t = cc.CombKeyRegistry()
    for pub in two_keys:
        assert reg_j.register(pub) == reg_t.register(pub)
    gtab, qtab = cc.from_jax_tables(pc.g_table(), reg_j.stacked())
    assert gtab.dtype == np.uint32 and gtab.shape == (256, 3, 8)
    assert (gtab == cc.g_table()).all()
    assert qtab.shape == (2, 256, 3, 8)
    assert (qtab == reg_t.stacked()).all()


@pytest.mark.parametrize("idx", [0, 1, 3, 0x80, 0xA5, 0xFF])
def test_table_entries_are_comb_multiples(two_keys, idx):
    pub = two_keys[0]
    table = cc.build_table(pub)
    x, y, z = (p256.FP.decode(bn.to_limbs(bn.from_words(table[idx, c]), 16))
               for c in range(3))
    k = sum(1 << (cc.STRIDE * t) for t in range(cc.TEETH) if idx >> t & 1)
    want = p256.scalar_mult_int(k, pub)
    if want is None:
        assert (x, y, z) == (0, 1, 0)
    else:
        assert z == 1 and (x, y) == want


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_comb_digits_match_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    us = [int.from_bytes(rng.bytes(32), "little") % p256.N for _ in range(5)]
    limbs = np.stack([bn.to_limbs(u, 16) for u in us])
    mine = cc.comb_digits(torch.from_numpy(limbs.astype(np.int64)))
    theirs = pc._comb_digits(jnp.asarray(limbs.T), len(us))
    assert mine.shape == (5, cc.STRIDE)
    assert (mine.numpy().T == np.stack([np.asarray(d) for d in theirs])).all()


def test_pack_items_matches_the_jax_package():
    items, _ = _items(5, nkeys=2)
    mine = cc.pack_items(items, cc.CombKeyRegistry())
    theirs = pc.pack_items(items, pc.CombKeyRegistry())
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype and (a == b).all()


def _matrix():
    """The JAX comb test's rejection matrix: valid votes, corrupted r,
    r = 0, s >= n, a wrong-key claim, zero-padded lanes."""
    items, expect = _items(8, nkeys=2, corrupt=(3, 5))
    items[1] = (items[1][0], 0, items[1][2], items[1][3])          # r = 0
    items[2] = (items[2][0], items[2][1], p256.N, items[2][3])     # s >= n
    expect[1] = expect[2] = False
    reg = cc.CombKeyRegistry()
    e8, r8, s8, kidx = cc.pack_items(items, reg)
    kidx[6] = 1 - kidx[6]  # signature of key A presented as key B's vote
    expect[6] = False
    z = np.zeros((4, 32), np.uint8)
    e8, r8, s8 = (np.concatenate([a, z]) for a in (e8, r8, s8))
    kidx = np.concatenate([kidx, np.zeros(4, np.int32)])
    expect += [False] * 4
    return items, expect, (e8, r8, s8, kidx), reg


def test_plain_comb_verify_matches_verify_item_bit_for_bit():
    items, expect, (e8, r8, s8, kidx), reg = _matrix()
    mask = cc.ecdsa_verify_comb(e8, r8, s8, kidx, cc.g_table(), reg.stacked())
    assert mask.dtype == torch.int32 and mask.device.type == "cpu"
    assert [bool(v) for v in mask.tolist()] == expect
    # the JAX package's integer reference on the same items (lane 6's
    # wrong-key claim exists only at the kernel level)
    assert [jp256.verify_item(it) for it in items[:6]] == expect[:6]
    assert jp256.verify_item(items[7]) == expect[7]


def test_plain_comb_rejects_key_index_outside_the_stack():
    items, _ = _items(2, nkeys=1)
    reg = cc.CombKeyRegistry()
    e8, r8, s8, kidx = cc.pack_items(items, reg)
    kidx[1] = 5
    mask = cc.ecdsa_verify_comb(e8, r8, s8, kidx, cc.g_table(), reg.stacked())
    assert mask.tolist() == [1, 0]


def test_cpu_wrapper_launches_no_kernel():
    items, _ = _items(1, nkeys=1)
    reg = cc.CombKeyRegistry()
    before = cc.LAUNCHES.launches
    cc.ecdsa_verify_comb(*cc.pack_items(items, reg), cc.g_table(), reg.stacked())
    assert cc.LAUNCHES.launches == before


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


def _lane(e: int, r: int, s: int, kidx: int = 0):
    """One lane's comb inputs with the given e, r and s, on a real key."""
    items, _ = _items(1, nkeys=1)
    reg = cc.CombKeyRegistry()
    cc.pack_items(items, reg)
    return (*(lane_bytes([v]) for v in (e, r, s)),
            np.array([kidx], np.int32), cc.g_table(), reg.stacked())


#: r + n < p: the comparison tries both candidates
_BOTH = 1 << 31 < p256.P - p256.N


def test_op_counts_of_the_bound_match_the_plain_version(monkeypatch):
    """The plain version runs the kernel's formulas on every lane; the
    bound counts that less what the verify does not need.  With s = 1, u1
    = e and u2 = r, here 2^252 - 1, which has no zero comb digit:"""
    lane = _lane((1 << 252) - 1, (1 << 252) - 1, 1)
    counts = _count_mont_ops(monkeypatch)
    cc.ecdsa_verify_comb(*lane)
    assert counts == {"n_mul": 84, "n_sqr": 252, "p_mul": 1220, "p_sqr": 96}
    # not needed mod n: r and e into and u1, u2 out of Montgomery form
    # (4), the inversion's 8 products by s^0 (8); mod p: the first
    # iteration's doubling and G addition on the identity (10 + 14, and 3
    # squarings) and its Q addition with both Z = 1 (14 -> 10); in each of
    # the other 31, one product of the G and of the Q addition (Z2 = 1);
    # r and r + n into Montgomery form and (r + n)·Z, since r + n > p
    assert cc.mont_ops(*lane) == {
        "n_mul": 84 - 12, "n_sqr": 252,
        "p_mul": 1220 - (24 + 4 + 31 * 2 + 3), "p_sqr": 96 - 3}


@pytest.mark.parametrize("e,r,s,kidx,want", [
    (5, 0, 3, 0, (0, 0)),                        # r = 0
    (5, 3, p256.N, 0, (0, 0)),                   # s >= n
    (5, 3, 1, 7, (0, 0)),                        # key index outside the stack
    # the last iteration copies a G entry and adds a Q entry, both affine
    (1, 1, 1, 0, (10 + 1 + _BOTH, 0)),
    # the first iteration does the same, then 31 doublings
    (1 << 31, 1 << 31, 1, 0, (10 + 31 * 10 + 1 + _BOTH, 31 * 3)),
])
def test_bound_counts_only_the_work_the_verify_needs(e, r, s, kidx, want):
    n_ops = {"n_mul": 72, "n_sqr": 252} if want[0] else \
        {"n_mul": 0, "n_sqr": 0}
    assert cc.mont_ops(*_lane(e, r, s, kidx)) == \
        {**n_ops, "p_mul": want[0], "p_sqr": want[1]}


def test_registry_cap_validation_and_stacking(two_keys):
    reg = cc.CombKeyRegistry(cap=3)
    assert reg.register(two_keys[0]) == 0
    assert reg.register(two_keys[0]) == 0
    assert reg.stacked().shape == (1, 256, 3, 8)
    assert reg.register(two_keys[1]) == 1
    extra = p256.keygen(b"third")[1]
    assert reg.register(extra) == 2
    stack = reg.stacked()
    assert stack.shape == (4, 256, 3, 8) and not stack[3].any()
    with pytest.raises(cc.CombRegistryFull):
        reg.register(p256.keygen(b"fourth")[1])
    with pytest.raises(ValueError, match="not on the P-256 curve"):
        cc.CombKeyRegistry().register((1, 2))
    assert reg.index_of(extra) == 2 and reg.index_of((5, 5)) is None


def test_verifier_prewarm_overflow_and_unregistrable_chunks(two_keys, caplog):
    v = cc.CombVerifier("cpu", cap=1)
    with pytest.raises(cc.CombRegistryFull):
        v.prewarm_keys(two_keys)
    with pytest.raises(ValueError):
        v.prewarm_keys([(1, 2)])
    items, _ = _items(2, nkeys=2)
    with caplog.at_level("WARNING"):
        assert v.verify(items, 8) is None  # second key overflows the cap
    assert "registry full" in caplog.text
    assert v.verify(items[:1], 8).tolist() == [1]


def test_verifier_pads_and_caches_device_tables():
    items, _ = _items(3, nkeys=1, corrupt=(1,))
    v = cc.CombVerifier("cpu")
    assert v.verify(items, 8).tolist() == [1, 0, 1]
    g1, q1 = v.device_tables()
    assert v.device_tables()[1] is q1  # same registry version: cached
    v.verify(_items(2, nkeys=2)[0][1:], 8)
    assert v.device_tables()[1] is not q1


@pytest.mark.slow
def test_plain_comb_matches_the_interpret_mode_pallas_kernel():
    """One interpret-mode launch of the JAX comb kernel (minutes on CPU)
    against the plain-torch version on the same rejection matrix."""
    _, expect, (e8, r8, s8, kidx), reg = _matrix()
    reg_j = pc.CombKeyRegistry()
    for pub in reg._index:
        reg_j.register(pub)
    theirs = pc.ecdsa_verify_comb(e8, r8, s8, kidx, pc.g_table(),
                                  reg_j.stacked(), tile=16, interpret=True)
    mine = cc.ecdsa_verify_comb(e8, r8, s8, kidx, cc.g_table(), reg.stacked())
    assert mine.tolist() == [int(v) for v in np.asarray(theirs)]
    assert [bool(v) for v in mine.tolist()] == expect
