"""The port's Ed25519 comb verify (crypto/cuda_ed25519.py) against the JAX
package's (crypto/pallas_ed25519.py): tables and packing value for value,
the plain-torch verify against ``ed25519.verify_item`` over the rejection
matrix bit for bit, the registry with the Edwards hooks and the engine
adapter.  The CUDA kernel itself is held against the plain version on the
card (test_torch_cuda_kernels.py)."""

import numpy as np
import pytest
import torch

from smartbft_tpu.crypto import ed25519 as jed
from smartbft_tpu.crypto import pallas_ed25519 as ped
from smartbft_tpu_torch.crypto import bignum as bn
from smartbft_tpu_torch.crypto import cuda_comb as cc
from smartbft_tpu_torch.crypto import cuda_ed25519 as ced
from smartbft_tpu_torch.crypto import ed25519 as ed
from tests.test_torch_eddsa import _count_mont_ops

# small plain-torch tensors gain nothing from intra-op threads, and the
# suite runs in parallel worker processes
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def keys():
    return [ed.keygen(b"ck%d" % i) for i in range(3)]


def _registry(cap=128):
    return ced.Ed25519CombVerifier("cpu", cap=cap).registry


def test_tables_carry_over_from_the_jax_package(keys):
    reg_j = ped.Ed25519CombVerifier(tile=8).registry
    reg_t = _registry()
    for _, pub in keys:
        assert reg_j.register(pub) == reg_t.register(pub)
    btab, qtab = ced.from_jax_tables(ped.b_table(), reg_j.stacked())
    assert btab.dtype == np.uint32 and btab.shape == (256, 3, 8)
    assert (btab == ced.b_table()).all()
    assert qtab.shape == (4, 256, 3, 8) and not qtab[3].any()
    assert (qtab == reg_t.stacked()).all()


@pytest.mark.parametrize("idx", [0, 1, 3, 0x80, 0xA5, 0xFF])
def test_table_entries_are_negated_comb_multiples(keys, idx):
    pub = keys[0][1]
    table = ced._build_key_table(pub)
    x, y, t = (bn.from_words(table[idx, c]) * pow(1 << 256, -1, ed.P) % ed.P
               for c in range(3))
    k = sum(1 << (cc.STRIDE * i) for i in range(cc.TEETH) if idx >> i & 1)
    ax, ay = ed.decompress(pub)
    want = ed.scalar_mult_int(k, ((ed.P - ax) % ed.P, ay))
    assert (x, y) == want and t == x * y % ed.P


def _rejection_items(keys):
    """Valid votes, a corrupted S, a tampered message, S >= L, an
    undecodable R (y < p, no square root)."""
    items = []
    for i in range(9):
        priv, pub = keys[i % 3]
        msg = b"m%d" % i
        items.append(ed.make_item(msg, ed.sign_raw(priv, msg), pub))
    m, sig, pub = items[1]
    bad_s = (int.from_bytes(sig[32:], "little") + 1) % ed.L
    items[1] = (m, sig[:32] + bad_s.to_bytes(32, "little"), pub)
    m, sig, pub = items[2]
    items[2] = (b"tampered", sig, pub)
    m, sig, pub = items[3]
    items[3] = (m, sig[:32] + (ed.L + 9).to_bytes(32, "little"), pub)
    m, sig, pub = items[4]
    y = 2
    while ed.decompress(y.to_bytes(32, "little")) is not None:
        y += 1
    items[4] = (m, y.to_bytes(32, "little") + sig[32:], pub)
    return items


def test_pack_items_matches_the_jax_package(keys):
    items = _rejection_items(keys)
    mine = ced.pack_items(items, _registry())
    theirs = ped.pack_items(items, ped.Ed25519CombVerifier(tile=8).registry)
    for a, b in zip(mine, theirs):
        assert a.shape == b.shape and (a == b).all()
    assert mine[4].dtype == np.int32 and mine[5].dtype == np.int32
    assert mine[4].tolist() == [1, 1, 1, 0, 0, 1, 1, 1, 1]


def _matrix(keys):
    """The JAX comb test's rejection matrix, and more: valid votes, a
    corrupted S, a tampered message, S >= L, an undecodable R, a valid
    signature claimed under the wrong key, ok = 1 on a zero-padded stack
    slot, two zero-padded lanes."""
    items = _rejection_items(keys)
    expect = [ed.verify_item(it) for it in items]
    reg = _registry()
    s8, h8, rx8, ry8, ok, kidx = ced.pack_items(items, reg)
    kidx[5] = (kidx[5] + 1) % 3   # keys[2]'s vote claimed by keys[0]
    kidx[6], ok[6] = 3, 1          # slot 3 of the 4-slot stack is padding
    expect[5] = expect[6] = False
    z = np.zeros((2, 32), np.uint8)
    s8, h8, rx8, ry8 = (np.concatenate([a, z]) for a in (s8, h8, rx8, ry8))
    zl = np.zeros(2, np.int32)
    ok, kidx = np.concatenate([ok, zl]), np.concatenate([kidx, zl])
    expect += [False, False]
    return items, expect, (s8, h8, rx8, ry8, ok, kidx), reg


def test_plain_comb_verify_matches_verify_item_bit_for_bit(keys):
    items, expect, arrays, reg = _matrix(keys)
    assert reg.stacked().shape[0] == 4 and not reg.stacked()[3].any()
    mask = ced.eddsa_verify_comb(*arrays, ced.b_table(), reg.stacked())
    assert mask.dtype == torch.int32 and mask.device.type == "cpu"
    assert [bool(v) for v in mask.tolist()] == expect
    assert expect == [True, False, False, False, False, False, False, True,
                      True, False, False]
    # the JAX package's integer reference on the same items (the wrong-key
    # and padded-slot claims exist only at the kernel level)
    assert [jed.verify_item(it) for it in items[:5] + items[7:]] == \
        expect[:5] + expect[7:9]


def test_plain_comb_rejects_key_index_outside_the_stack(keys):
    items = _rejection_items(keys)[:2]
    reg = _registry()
    s8, h8, rx8, ry8, ok, kidx = ced.pack_items(items[:1] * 2, reg)
    kidx[1] = 5
    mask = ced.eddsa_verify_comb(s8, h8, rx8, ry8, ok, kidx, ced.b_table(),
                                 reg.stacked())
    assert mask.tolist() == [1, 0]


def test_cpu_wrapper_launches_no_kernel(keys):
    reg = _registry()
    before = ced.LAUNCHES.launches
    ced.eddsa_verify_comb(*ced.pack_items(_rejection_items(keys)[:1], reg),
                          ced.b_table(), reg.stacked())
    assert ced.LAUNCHES.launches == before


def _lane(keys, s: int, h: int, ok: int = 1, kidx: int = 0, r=None):
    """One lane's comb inputs: a real R (or ``r``) and key, S and h given."""
    reg = _registry()
    s8, h8, rx8, ry8, ok8, kidx8 = ced.pack_items(
        _rejection_items(keys)[:1], reg)
    s8[0] = np.frombuffer(s.to_bytes(32, "little"), np.uint8)
    h8[0] = np.frombuffer(h.to_bytes(32, "little"), np.uint8)
    if r is not None:
        rx8[0] = ry8[0] = np.frombuffer(r.to_bytes(32, "little"), np.uint8)
    ok8[0], kidx8[0] = ok, kidx
    return s8, h8, rx8, ry8, ok8, kidx8, ced.b_table(), reg.stacked()


def test_op_counts_of_the_bound_match_the_plain_version(keys, monkeypatch):
    """The plain version runs the kernel's formulas on every lane; the
    bound counts that less what the verify does not need.  On a lane with
    no zero digit:"""
    lane = _lane(keys, (1 << 252) - 1, (1 << 252) - 1)
    counts = _count_mont_ops(monkeypatch)
    ced.eddsa_verify_comb(*lane)
    assert counts == {"ed_mul": 710, "ed_sqr": 130}
    # products not needed: R into Montgomery form (2); the first
    # iteration's doubling and B addition on the identity (4 + 9, and 4
    # squarings) and its Q addition's Z1·Z2 and T (2); in each of the
    # other 31, Z1·Z2 of both additions (Z2 = 1) and the Q addition's T
    assert ced.mont_ops(*lane) == {"ed_mul": 710 - (2 + 13 + 2 + 31 * 3),
                                   "ed_sqr": 130 - 4}


@pytest.mark.parametrize("s,h,ok,kidx,r,want", [
    (5, 3, 0, 0, None, (0, 0)),             # host-rejected
    (5, 3, 1, 7, None, (0, 0)),             # key index outside the stack
    (5, 3, 1, 0, 2, (2, 2)),                # R off the curve
    (1, 1, 1, 0, None, (2 + 7 + 2, 2)),     # last iteration: copy, one add
    # iteration 0 copies one B entry; then 31 doublings, the first on an
    # affine point (3S), none of whose T is read (3M each)
    (1 << 31, 0, 1, 0, None, (2 + 31 * 3 + 2, 2 + 3 + 30 * 4)),
])
def test_bound_counts_only_the_work_the_verify_needs(keys, s, h, ok, kidx, r,
                                                     want):
    assert ced.mont_ops(*_lane(keys, s, h, ok, kidx, r)) == \
        {"ed_mul": want[0], "ed_sqr": want[1]}


def test_registry_with_the_edwards_hooks(keys):
    reg = _registry(cap=2)
    assert reg.register(keys[0][1]) == 0 and reg.register(keys[0][1]) == 0
    assert reg.stacked().shape == (1, 256, 3, 8)
    assert reg.register(keys[1][1]) == 1
    with pytest.raises(cc.CombRegistryFull):
        reg.register(keys[2][1])
    with pytest.raises(ValueError, match="not on the Ed25519 curve"):
        _registry().register(b"\xff" * 32)
    with pytest.raises(ValueError, match="not on the Ed25519 curve"):
        _registry().register((1, 2))  # a P-256-shaped key


def test_verifier_routes_unregistrable_chunks_away(keys, caplog):
    v = ced.Ed25519CombVerifier("cpu", cap=1)
    with pytest.raises(cc.CombRegistryFull):
        v.prewarm_keys([pub for _, pub in keys[:2]])
    with pytest.raises(ValueError):
        v.prewarm_keys([b"\xff" * 32])
    items = _rejection_items(keys)
    with caplog.at_level("WARNING"):
        assert v.verify(items[:2], 8) is None  # second key overflows
    assert "registry full" in caplog.text
    bad_key = [(b"m", items[0][1], b"\xff" * 32)]
    assert v.verify(bad_key, 8) is None        # undecodable key
    mask = v.verify(items[:1] + items[3:4], 8)
    assert mask.tolist() == [1, 0]
    g, q = v.device_tables()
    assert (g.numpy() == ced.b_table()).all() and q.shape[0] == 1


@pytest.mark.slow
def test_plain_comb_matches_the_interpret_mode_pallas_kernel(keys):
    """One interpret-mode launch of the JAX Ed25519 comb kernel (about 40 s
    on CPU) against the plain-torch version on the same rejection matrix."""
    _, expect, (s8, h8, rx8, ry8, ok, kidx), reg = _matrix(keys)
    cv = ped.Ed25519CombVerifier(tile=8)
    for pub in reg._index:
        cv.registry.register(pub)
    theirs = ped.eddsa_verify_comb(
        s8, h8, rx8, ry8, ok.astype(np.uint32), kidx, ped.b_table(),
        cv.registry.stacked(), tile=8, interpret=True)
    mine = ced.eddsa_verify_comb(s8, h8, rx8, ry8, ok, kidx, ced.b_table(),
                                 reg.stacked())
    assert mine.tolist() == [int(v) for v in np.asarray(theirs)]
    assert [bool(v) for v in mine.tolist()] == expect
