"""The pairing kernel's plain-torch version (crypto/cuda_bls.py) against
the JAX package's device half and host pairing.

* The stacked tower ops and Miller steps (``mul12``, ``sqr12``,
  ``conj12``, ``frob12``, ``_stk_dbl_step``, ``_stk_add_step``,
  ``_line_rows``) equal the JAX package's, value for value, on seeded
  inputs.  The JAX functions run compiled as one ``jax.jit`` program (the
  functions the JAX kernel runs; op by op they would compile for minutes on
  this CPU).
* ``inv12`` and the sparse line product equal the host tower.
* One module-scoped plain batch of 8 lanes (3 valid votes, a wrong key, an
  aggregated quorum, an undecodable signature, 2 padding lanes) through
  ``TorchVerifyEngine(device="cpu", scheme=bls12381)`` gives the mask of
  ``verify_item`` in both packages, and every lane's final-exponentiated
  value equals ``host_final_exp`` of the host Miller product.  Exact.
* The bound's operation count (``mont_ops``) and the constant table the
  kernel reads.
"""

import random

import numpy as np
import pytest
import torch

from smartbft_tpu.crypto import bls12381 as jbls
from smartbft_tpu_torch.crypto import bls12381 as tbls
from smartbft_tpu_torch.crypto import cuda_bls as cb
from smartbft_tpu_torch.crypto.provider import TorchVerifyEngine

# small plain-torch tensors gain nothing from intra-op threads, and the
# suite runs in parallel worker processes
torch.set_num_threads(1)

P = tbls.P
L = tbls.NLIMBS


@pytest.fixture(scope="module")
def c():
    return cb.ctx("cpu")


def _rand_fp12(rng):
    return tuple(tuple((rng.randrange(P), rng.randrange(P)) for _ in range(3))
                 for _ in range(2))


def _rows(values):
    """Ints -> (len, L) int64 Montgomery limbs."""
    return torch.from_numpy(np.stack([tbls.encode(v) for v in values])
                            .astype(np.int64))


def _enc12(x):
    return _rows(cb._flatten_host_fp12(x))


def _dec(t):
    """(..., L) Montgomery limbs -> ints (flat list)."""
    a = np.asarray(t).reshape(-1, L)
    return [tbls.decode(r) for r in a]


def _dec12(t):
    it = iter(_dec(t))
    return tuple(tuple((next(it), next(it)) for _ in range(3))
                 for _ in range(2))


# ---------------------------------------------------------------------------
# stacked ops against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_ref():
    """Seeded inputs and the JAX package's stacked functions' outputs on
    them (two lanes), as numpy."""
    import jax
    import jax.numpy as jnp

    rng = random.Random(99)
    xs = [_rand_fp12(rng) for _ in range(2)]
    ys = [_rand_fp12(rng) for _ in range(2)]
    X = np.stack([_enc12(x).numpy() for x in xs]).astype(np.uint32)
    Y = np.stack([_enc12(y).numpy() for y in ys]).astype(np.uint32)
    T = tuple(np.stack([np.stack([tbls.encode(rng.randrange(P)),
                                  tbls.encode(rng.randrange(P))])
                        for _ in range(2)]) for _ in range(3))
    Q = tuple(np.stack([np.stack([tbls.encode(rng.randrange(P)),
                                  tbls.encode(rng.randrange(P))])
                        for _ in range(2)]) for _ in range(2))
    xp = np.stack([tbls.encode(rng.randrange(P)) for _ in range(2)])
    yp = np.stack([tbls.encode(rng.randrange(P)) for _ in range(2)])

    def ref(X, Y, T, Q, xp, yp):
        dbl = jbls._stk_dbl_step(T)
        add = jbls._stk_add_step(T, Q)
        return {"mul12": jbls.mul12(X, Y), "sqr12": jbls.sqr12(X),
                "conj12": jbls.conj12(X), "frob12": jbls.frob12(X),
                "dbl": dbl, "add": add,
                "line": jbls._line_rows(dbl[1], xp, yp)}

    out = jax.jit(ref)(*(jax.tree.map(jnp.asarray, a)
                         for a in (X, Y, T, Q, xp, yp)))
    out = jax.tree.map(np.asarray, out)
    ins = dict(X=X, Y=Y, T=T, Q=Q, xp=xp, yp=yp, xs=xs, ys=ys)
    return ins, out


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_mul12_sqr12_conj12_frob12_match_jax(c, jax_ref):
    ins, out = jax_ref
    X, Y = _t(ins["X"]), _t(ins["Y"])
    assert torch.equal(cb.mul12(c, X, Y), _t(out["mul12"]))
    assert torch.equal(cb.sqr12(c, X), _t(out["sqr12"]))
    assert torch.equal(cb.conj12(c, X), _t(out["conj12"]))
    assert torch.equal(cb.frob12(c, X), _t(out["frob12"]))
    for i, (x, y) in enumerate(zip(ins["xs"], ins["ys"])):
        assert _dec12(out["mul12"][i]) == tbls.fp12_mul(tbls.HOST, x, y)


def _tree_equal(got, want):
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _tree_equal(g, w)
    else:
        assert torch.equal(got, _t(want))


def test_miller_steps_and_line_rows_match_jax(c, jax_ref):
    ins, out = jax_ref
    T = tuple(_t(a) for a in ins["T"])
    Q = tuple(_t(a) for a in ins["Q"])
    dbl = cb.dbl_step(c, T)
    _tree_equal(dbl, out["dbl"])
    _tree_equal(cb.add_step(c, T, Q), out["add"])
    line = cb.line_rows(c, dbl[1], _t(ins["xp"]), _t(ins["yp"]))
    assert torch.equal(line, _t(out["line"]))


def test_inv12_and_line_product_match_the_host_tower(c):
    rng = random.Random(7)
    xs = [_rand_fp12(rng) for _ in range(2)]
    X = torch.stack([_enc12(x) for x in xs])
    inv = cb.inv12(c, X)
    for i, x in enumerate(xs):
        assert _dec12(inv[i]) == tbls.fp12_inv(tbls.HOST, x)
    l00, lx, ly = ((rng.randrange(P), rng.randrange(P)) for _ in range(3))
    line = tbls._line_to_fp12(tbls.HOST, l00, lx, ly)
    got = cb.mul12_line(c, X, _enc12(line))
    for i, x in enumerate(xs):
        assert _dec12(got[i]) == tbls.fp12_mul(tbls.HOST, x, line)


def test_product_tensor_slots():
    """The lazy-reduction tensor of the JAX package: every slot of an
    output within 9 per bucket, a coefficient at most 4 or p - 4."""
    for sup, slots, buckets in ((cb._FULL_SUPPORT, 204, 3),
                                (cb._LINE_SUPPORT, 92, 2),
                                (cb._HALF_SUPPORT, 96, 2)):
        lhs, rhs, neg, out, nb = cb.mul_tensor(sup)
        assert (len(lhs), nb) == (slots, buckets)
        assert np.bincount(out).max() <= cb._BUCKET_CAP
        assert set(rhs.tolist()) <= set(sup)


# ---------------------------------------------------------------------------
# one plain batch, end to end
# ---------------------------------------------------------------------------


def _items():
    keys = [tbls.keygen(b"kernel-%d" % i) for i in range(3)]
    msg = b"kernel-digest"
    votes = [(msg, tbls.sign(sk, msg), pk) for sk, pk in keys]
    return votes + [
        (msg, votes[0][1], keys[1][1]),                   # wrong key
        tbls.aggregate_items(votes),                      # quorum lane
        (msg, b"\x01" * tbls.SIG_BYTES, keys[0][1]),      # does not decode
    ]


@pytest.fixture(scope="module")
def plain_batch():
    """The 6 lanes through the CPU engine (padded to 8): its verdicts, and
    the final-exponentiated values the plain version computed on the way
    (the same call)."""
    items = _items()
    engine = TorchVerifyEngine(device="cpu", scheme=tbls, pad_sizes=(8,))
    seen = []
    real = cb.pairing_values

    def spy(*args):
        seen.append((args, real(*args)))
        return seen[-1][1]

    mp = pytest.MonkeyPatch()
    mp.setattr(cb, "pairing_values", spy)
    try:
        mask = engine.verify(items)
    finally:
        mp.undo()
    (args, values), = seen
    return items, mask, args, values, engine


def test_plain_batch_matches_verify_item_of_both_packages(plain_batch):
    items, mask, _, _, engine = plain_batch
    assert mask == [True, True, True, False, True, False]
    assert mask == [tbls.verify_item(it) for it in items]
    assert mask == [jbls.verify_item(it) for it in items]
    assert engine.route_launches == {"comb": 0, "generic": 1}
    assert engine.rung_launches == {8: 1}
    assert engine.stats.sigs_verified == 6 and engine.stats.slots_used == 8


def _value(words):
    """A (12,) tensor of Montgomery words -> its int."""
    v = int.from_bytes(words.numpy().tobytes(), "little")
    return v * pow(tbls.R_MONT, -1, P) % P


def _g1(args, k, i):
    return (_value(args[k][i]), _value(args[k + 1][i]))


def test_plain_final_exp_values_equal_the_host(plain_batch):
    """Each lane's final-exponentiated value, padding lanes included, is
    the JAX package's ``host_final_exp`` of its host Miller product of the
    lane's inputs."""
    _, _, args, values, _ = plain_batch
    assert values.shape == (8, 12, L)
    for i in range(8):
        sig = _g1(args, 0, i)
        hm = _g1(args, 2, i)
        x0, x1, y0, y1 = (_value(args[k][i]) for k in range(4, 8))
        f = jbls.fp12_mul(
            jbls.HOST, jbls.host_miller_loop(sig, jbls.NEG_G2),
            jbls.host_miller_loop(hm, ((x0, x1), (y0, y1))))
        assert _dec12(values[i]) == jbls.host_final_exp(f), i


# ---------------------------------------------------------------------------
# inputs, table and bound
# ---------------------------------------------------------------------------


def test_pack_inputs_packs_limbs_into_words():
    arrays = tbls.verify_inputs(_items()[:2])
    words = cb.pack_inputs(arrays)
    assert [w.shape for w in words] == [(2, 12)] * 8 + [(2,)]
    assert all(w.dtype == np.int32 for w in words)
    for w, a in zip(words[:8], arrays[:8]):
        for i in range(2):
            assert int.from_bytes(w[i].tobytes(), "little") == \
                tbls.from_limbs(a[i])
    assert words[-1].tolist() == [1, 1]


def test_const_table_layout():
    table = cb.const_table()
    assert table.shape == (418, 12) and table.dtype == np.uint32

    def val(row):
        return int.from_bytes(table[row].tobytes(), "little")

    # doubling row 0's l00 (re), the first addition row's l00 (re), the
    # last Frobenius gamma (g1 g4, im)
    assert val(0) == tbls.from_limbs(tbls._FIXED_DBL[0, 0, 0])
    first_add = int(np.argmax(tbls._X_BITS_ARR))
    assert val(63 * 6) == tbls.from_limbs(tbls._FIXED_ADD[first_add, 0, 0])
    g1g4 = tbls.fp2_mul(tbls.HOST, tbls._G1F, tbls._G4F)
    assert tbls.decode(tbls.to_limbs(val(417), L)) == g1g4[1]


def test_bound_counts_only_the_work_the_verify_needs():
    """Hand-derived: a live lane needs the Miller loop's 63 steps (an Fp12
    square of 36 products, a doubling of 27, two sparse line products of
    43) and 5 additions (36 and two lines), then the final
    exponentiation: the hard part's 316 squares, all in the cyclotomic
    subgroup (18 products each, Granger-Scott), 34 Fp12 products of 54, 5
    Frobenius maps of 15, the Fp12 inversion's 107 products and the Fermat
    inversion's 228 products and 380 squares (and 2 more squares); a lane
    with ok = 0 needs nothing."""
    ops = cb.lane_ops()
    miller = 63 * (36 + 27 + 2 * 43) + 5 * (36 + 2 * 43)
    assert miller == 9997
    final = 316 * 18 + 34 * 54 + 5 * 15 + 107 + 228
    assert ops == {"b381_mul": miller + final, "b381_sqr": 382}
    assert miller + final == 17931
    words = cb.pack_inputs(tbls.verify_inputs(_items()))
    assert cb.mont_ops(*words) == {"b381_mul": 5 * 17931, "b381_sqr": 5 * 382}


def test_engine_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the engine would run the kernel")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchVerifyEngine(scheme=tbls)
