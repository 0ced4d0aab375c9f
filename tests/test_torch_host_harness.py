"""The CUDA kernels' arithmetic, built for the host: g++ compiles
``smartbft_tpu_torch/csrc/p256_field.cuh``, ``p256_group.cuh``,
``p256_comb_group.cuh``, ``ed25519_field.cuh``, ``ed25519_group.cuh``,
``ed25519_comb_group.cuh``, ``bls381_field.cuh``, ``bls381_group.cuh`` and
``bls381_pairing.cuh`` (through host_harness.cc)
and the field, curve and per-lane verify routines and the group kernels'
stage programs are held against Python integers — arithmetic faults show
here, before any time on the card."""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest

from smartbft_tpu.crypto import bls12381 as jbls
from smartbft_tpu_torch.crypto import bignum as bn
from smartbft_tpu_torch.crypto import bls12381 as tbls
from smartbft_tpu_torch.crypto import bls_stages as bs
from smartbft_tpu_torch.crypto import cuda_bls as cbl
from smartbft_tpu_torch.crypto import cuda_comb as cc
from smartbft_tpu_torch.crypto import cuda_ed25519 as ced
from smartbft_tpu_torch.crypto import ed25519 as ed
from smartbft_tpu_torch.crypto import p256

CSRC = pathlib.Path(__file__).resolve().parent.parent / "smartbft_tpu_torch" / "csrc"
R = 1 << 256
P_PTR = ctypes.c_void_p


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host harness cannot be built")
    out = tmp_path_factory.mktemp("p256_host") / "libp256_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o",
                    str(out), str(CSRC / "host_harness.cc")], check=True,
                   capture_output=True, timeout=300)
    return ctypes.CDLL(str(out))


def _w(x):
    return bn.to_words(x)


def _ptr(a):
    return a.ctypes.data_as(P_PTR)


def _i(a):
    return bn.from_words(a)


def _ints(seed, count, below):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % below
            for _ in range(count)] + [0, 1, below - 1]


MODS = [pytest.param(0, p256.P, id="p"), pytest.param(1, p256.N, id="n")]


@pytest.mark.parametrize("which,mod", MODS)
def test_field_mul_sqr_add_sub(lib, which, mod):
    rinv = pow(R, -1, mod)
    out = np.zeros(8, np.uint32)
    for x, y in zip(_ints(1, 30, mod), _ints(2, 30, mod)):
        a, b = _w(x), _w(y)
        lib.p256h_mont_mul(_ptr(a), _ptr(b), which, _ptr(out))
        assert _i(out) == x * y * rinv % mod
        lib.p256h_mont_sqr(_ptr(a), which, _ptr(out))
        assert _i(out) == x * x * rinv % mod
        lib.p256h_mod_add(_ptr(a), _ptr(b), which, _ptr(out))
        assert _i(out) == (x + y) % mod
        lib.p256h_mod_sub(_ptr(a), _ptr(b), which, _ptr(out))
        assert _i(out) == (x - y) % mod


#: a < 2^256 for p_mul's first factor, the edges the reduction must meet
P_EDGES = [0, 1, p256.P - 1, R - 1, R % p256.P]


@pytest.mark.parametrize("case", ["seeded", "edges"])
def test_special_form_product_mod_p(lib, case):
    """p_mul / p_sqr (the shift-and-add reduction mod p) against Python
    integers: a * b * 2^-256 mod p, fully reduced, for any a < 2^256 and
    b < p (p_sqr: a < p)."""
    rinv = pow(R, -1, p256.P)
    if case == "seeded":
        rng = np.random.default_rng(11)
        xs = [int.from_bytes(rng.bytes(32), "little") for _ in range(200)]
        ys = [int.from_bytes(rng.bytes(32), "little") % p256.P
              for _ in range(200)]
        pairs = list(zip(xs, ys))
    else:
        pairs = [(x, y) for x in P_EDGES for y in P_EDGES if y < p256.P]
    out = np.zeros(8, np.uint32)
    for x, y in pairs:
        lib.p256h_p_mul(_ptr(_w(x)), _ptr(_w(y)), _ptr(out))
        assert _i(out) == x * y * rinv % p256.P, (x, y)
        if x < p256.P:
            lib.p256h_p_sqr(_ptr(_w(x)), _ptr(out))
            assert _i(out) == x * x * rinv % p256.P, x


def test_inversion_mod_n(lib):
    out = np.zeros(8, np.uint32)
    for x in _ints(3, 10, p256.N)[:-3] + [1, p256.N - 1]:
        xm = x * R % p256.N
        lib.p256h_inv_n(_ptr(_w(xm)), _ptr(out))
        assert _i(out) == pow(x, -1, p256.N) * R % p256.N


def _proj(point):
    if point is None:
        return np.concatenate([_w(0), _w(R % p256.P), _w(0)])
    return np.concatenate([_w(point[0] * R % p256.P),
                           _w(point[1] * R % p256.P), _w(R % p256.P)])


def _affine(words):
    rinv = pow(R, -1, p256.P)
    x, y, z = (_i(words[8 * k:8 * k + 8]) * rinv % p256.P for k in range(3))
    if z == 0:
        return None
    zi = pow(z, -1, p256.P)
    return (x * zi % p256.P, y * zi % p256.P)


@pytest.mark.parametrize("k1,k2", [(1, 2), (3, 3), (7, 0), (0, 0), (5, 9)])
def test_point_double_and_add(lib, k1, k2):
    g = (p256.GX, p256.GY)
    p = p256.scalar_mult_int(k1, g) if k1 else None
    q = p256.scalar_mult_int(k2, g) if k2 else None
    out = np.zeros(24, np.uint32)
    lib.p256h_pt_add(_ptr(_proj(p)), _ptr(_proj(q)), _ptr(out))
    assert _affine(out) == p256._point_add_int(p, q)
    lib.p256h_pt_dbl(_ptr(_proj(p)), _ptr(out))
    assert _affine(out) == p256._point_add_int(p, p)


def _lanes():
    keys = [p256.keygen(b"hh-%d" % i) for i in range(2)]
    items = []
    for i in range(8):
        d, pub = keys[i % 2]
        msg = b"h-%d" % i
        items.append((msg, *p256.sign(d, msg), pub))
    m, r, s, pub = items[3]
    items[3] = (m, (r + 1) % p256.N, s, pub)
    m, r, s, pub = items[5]
    items[5] = (m, 0, s, pub)
    m, r, s, pub = items[6]
    items[6] = (m, r, p256.N, pub)
    return items


def test_comb_verify_of_eight_lanes(lib):
    items = _lanes()
    reg = cc.CombKeyRegistry()
    e8, r8, s8, kidx = cc.pack_items(items, reg)
    kidx[7] = 1 - kidx[7]  # wrong key claimed
    expect = [int(p256.verify_item(it)) for it in items]
    expect[7] = 0
    gtab, qtab = cc.g_table(), reg.stacked()
    out = np.zeros(8, np.uint32)
    lib.p256h_comb_verify(8, _ptr(e8), _ptr(r8), _ptr(s8), _ptr(kidx),
                          _ptr(gtab), _ptr(qtab), qtab.shape[0], _ptr(out))
    assert out.tolist() == expect
    assert expect == [1, 1, 1, 0, 1, 0, 0, 0]


def _run_generic(lib, entry, arrays, n):
    """The one-thread lane loop (entry 0) or the group kernel's program
    serialised for a group of ``entry`` ranks; (n,) verdicts."""
    out = np.zeros(n, np.uint32)
    ptrs = [_ptr(a) for a in arrays]
    if entry == 0:
        lib.p256h_ecdsa_verify(n, *ptrs, _ptr(out))
    else:
        lib.p256h_ecdsa_verify_group(entry, n, *ptrs, _ptr(out))
    return out.tolist()


GENERIC_ENTRIES = [pytest.param(0, id="lane"), pytest.param(1, id="group1"),
                   pytest.param(4, id="group4"), pytest.param(8, id="group8")]


@pytest.mark.parametrize("entry", GENERIC_ENTRIES)
def test_generic_verify_lanes(lib, entry):
    """Nine lanes (not a multiple of the group size): valid, corrupted r,
    r = 0, s >= n and an off-curve key.  The group program agrees with
    the one-thread lane and with ``verify_item``."""
    items = _lanes()
    m, r, s, (x, y) = items[0]
    items.append((m, r, s, (x, (y + 1) % p256.P)))  # off-curve key
    arrays = p256.verify_bytes(items)
    expect = [int(p256.verify_item(it)) for it in items]
    assert expect == [1, 1, 1, 0, 1, 0, 0, 1, 0]
    assert _run_generic(lib, entry, arrays, len(items)) == expect
    if entry:
        assert _run_generic(lib, 0, arrays, len(items)) == expect


@pytest.mark.parametrize("group", [4, 8])
def test_group_program_over_a_ragged_second_block(lib, group):
    """21 signatures: one full block of 16 and a ragged one of 5, whose
    11 idle slots re-run the last signature and must store nothing."""
    keys = [p256.keygen(b"hg-%d" % i) for i in range(3)]
    items = []
    for i in range(21):
        d, pub = keys[i % 3]
        msg = b"g-%d" % i
        items.append((msg, *p256.sign(d, msg), pub))
    m, r, s, pub = items[17]
    items[17] = (m, r, (s + 1) % p256.N, pub)
    arrays = p256.verify_bytes(items)
    expect = [int(p256.verify_item(it)) for it in items]
    assert expect.count(0) == 1
    out = np.full(24, 7, np.uint32)
    lib.p256h_ecdsa_verify_group(group, 21, *[_ptr(a) for a in arrays],
                                 _ptr(out))
    assert out[:21].tolist() == expect
    assert out[21:].tolist() == [7, 7, 7]


# ---------------------------------------------------------------------------
# the comb group program (p256_comb_group.cuh): products mod n on the
# prologue's chains, the block-level prologue and the stages serialised
# ---------------------------------------------------------------------------

#: first operands of the products mod n: any value below 2^256
N_EDGES = [0, 1, p256.N - 1, R - 1, R % p256.N]


@pytest.mark.parametrize("case", ["seeded", "edges"])
def test_mod_n_product_and_square(lib, case):
    """n_mul / n_sqr (the wide products and a CIOS reduction mod n) against
    Python integers: a * b * 2^-256 mod n, fully reduced, for any a < 2^256
    and b < n (n_sqr: a < n)."""
    n = p256.N
    rinv = pow(R, -1, n)
    if case == "seeded":
        rng = np.random.default_rng(17)
        pairs = [(int.from_bytes(rng.bytes(32), "little"),
                  int.from_bytes(rng.bytes(32), "little") % n)
                 for _ in range(200)]
    else:
        pairs = [(x, y) for x in N_EDGES for y in N_EDGES if y < n]
    out = np.zeros(8, np.uint32)
    for x, y in pairs:
        lib.p256h_n_mul(_ptr(_w(x)), _ptr(_w(y)), _ptr(out))
        assert _i(out) == x * y * rinv % n, (x, y)
        if x < n:
            lib.p256h_n_sqr(_ptr(_w(x)), _ptr(out))
            assert _i(out) == x * x * rinv % n, x


def test_inversion_mod_n_on_the_comb_product(lib):
    out = np.zeros(8, np.uint32)
    for x in _ints(19, 10, p256.N)[:-3] + [1, 2, p256.N - 1]:
        lib.p256h_n_inv(_ptr(_w(x * R % p256.N)), _ptr(out))
        assert _i(out) == pow(x, -1, p256.N) * R % p256.N


def _comb_truth(e, r, s, pub, in_stack):
    """The comb verify on Python integers: 1 <= r, s < n, a key in the
    stack, x(e/s G + r/s Q) = r mod n."""
    n = p256.N
    if not (in_stack and 0 < r < n and 0 < s < n):
        return 0
    w = pow(s, -1, n)
    pt = p256._point_add_int(p256.scalar_mult_int(e * w % n, (p256.GX, p256.GY)),
                             p256.scalar_mult_int(r * w % n, pub))
    return int(pt is not None and pt[0] % n == r)


def _comb_group_batch():
    """37 lanes by three keys: a full block of 32 and a ragged one of 5.
    Lane 3 has r = 0, 8 s = n, 12 a wrong e, 20 and 21 a key index outside
    the stack (4, -1), 22 the stack's zero-padded slot; lane 33 is a valid
    signature on e = 0 (every G digit the identity entry) and 34 has s = r
    (u2 = 1: Q digits the identity but one)."""
    keys = [p256.keygen(b"hc-%d" % i) for i in range(3)]
    items = []
    for i in range(37):
        d, pub = keys[i % 3]
        msg = b"c-%d" % i
        items.append((msg, *p256.sign(d, msg), pub))
    reg = cc.CombKeyRegistry()
    e8, r8, s8, kidx = cc.pack_items(items, reg)
    rows = [[_i(a[i].view(np.uint32)) for a in (e8, r8, s8)]
            for i in range(37)]
    rows[3][1] = 0
    rows[8][2] = p256.N
    rows[12][0] += 1
    kidx[20], kidx[21], kidx[22] = 4, -1, 3
    # r, s over e = 0 with nonce k: s = r d / k, so r/s Q = k G
    d, _ = keys[33 % 3]
    k = 0x1234567
    r = p256.scalar_mult_int(k, (p256.GX, p256.GY))[0] % p256.N
    rows[33] = [0, r, r * d * pow(k, -1, p256.N) % p256.N]
    rows[34][2] = rows[34][1]
    arrays = [np.stack([_w(row[j]).view(np.uint8) for row in rows])
              for j in range(3)]
    stack = reg.stacked()
    assert stack.shape[0] == 4 and not stack[3].any()
    truth = [_comb_truth(*rows[i], items[i][3], kidx[i] in (0, 1, 2))
             for i in range(37)]
    assert [i for i, t in enumerate(truth) if not t] == [3, 8, 12, 20, 21, 22, 34]
    assert truth[33] == 1
    return arrays, kidx, stack, truth


def _comb_group(lib, g, arrays, kidx, stack, slots=None):
    n = len(kidx)
    out = np.full(slots or n, 7, np.uint32)
    lib.p256h_comb_verify_group(g, n, *[_ptr(a) for a in arrays], _ptr(kidx),
                                _ptr(cc.g_table()), _ptr(stack),
                                stack.shape[0], _ptr(out))
    return out


@pytest.mark.parametrize("group", [1, 4, 8])
def test_comb_group_program_over_a_ragged_second_block(lib, group):
    """The prologue and the stage program agree with the integer verify on
    every lane (valid, r = 0, s = n, wrong e, key index outside the stack,
    zero-padded slot, identity entries) and with the one-thread lane; the
    ragged block's idle slots re-run the last signature and store
    nothing."""
    arrays, kidx, stack, truth = _comb_group_batch()
    out = _comb_group(lib, group, arrays, kidx, stack, slots=40)
    assert out[:37].tolist() == truth
    assert out[37:].tolist() == [7, 7, 7]
    lane = np.zeros(37, np.uint32)
    lib.p256h_comb_verify(37, *[_ptr(a) for a in arrays], _ptr(kidx),
                          _ptr(cc.g_table()), _ptr(stack), stack.shape[0],
                          _ptr(lane))
    assert lane.tolist() == truth


@pytest.fixture(scope="module")
def comb_plain_batch():
    """The ragged batch plus 8 seeded random rows (e, r, s any 256-bit
    values, kidx any of -1 .. 4), and the plain-torch version's mask."""
    import torch

    arrays, kidx, stack, _ = _comb_group_batch()
    rng = np.random.default_rng(37)
    arrays = [np.concatenate([a, rng.integers(0, 256, (8, 32), np.uint8)])
              for a in arrays]
    kidx = np.concatenate([kidx, rng.integers(-1, 5, 8).astype(np.int32)])
    want = cc.ecdsa_verify_comb_plain(
        *[torch.from_numpy(a) for a in (*arrays, kidx, cc.g_table(), stack)])
    return arrays, kidx, stack, want.tolist()


@pytest.mark.parametrize("group", [1, 4, 8])
def test_comb_group_program_matches_the_plain_version(lib, group,
                                                      comb_plain_batch):
    """The stage program's verdicts equal the plain-torch version's and the
    one-thread lane's, bit for bit, and so does a batch of one."""
    arrays, kidx, stack, want = comb_plain_batch
    assert _comb_group(lib, group, arrays, kidx, stack).tolist() == want
    lane = np.zeros(len(kidx), np.uint32)
    lib.p256h_comb_verify(len(kidx), *[_ptr(a) for a in arrays], _ptr(kidx),
                          _ptr(cc.g_table()), _ptr(stack), stack.shape[0],
                          _ptr(lane))
    assert lane.tolist() == want
    one = [a[:1].copy() for a in arrays]
    assert _comb_group(lib, group, one, kidx[:1].copy(), stack).tolist() == \
        want[:1] == [1]


# ---------------------------------------------------------------------------
# Ed25519 (ed25519_field.cuh)
# ---------------------------------------------------------------------------


def test_ed_field_mul_sqr_add_sub_inv(lib):
    mod = ed.P
    rinv = pow(R, -1, mod)
    out = np.zeros(8, np.uint32)
    for x, y in zip(_ints(4, 30, mod), _ints(5, 30, mod)):
        a, b = _w(x), _w(y)
        lib.edh_mont_mul(_ptr(a), _ptr(b), _ptr(out))
        assert _i(out) == x * y * rinv % mod
        lib.edh_mont_sqr(_ptr(a), _ptr(out))
        assert _i(out) == x * x * rinv % mod
        lib.edh_mod_add(_ptr(a), _ptr(b), _ptr(out))
        assert _i(out) == (x + y) % mod
        lib.edh_mod_sub(_ptr(a), _ptr(b), _ptr(out))
        assert _i(out) == (x - y) % mod
    for x in _ints(6, 5, mod)[:-3] + [1, mod - 1]:
        lib.edh_inv(_ptr(_w(x * R % mod)), _ptr(out))
        assert _i(out) == pow(x, -1, mod) * R % mod


def _ext(point):
    """Affine Edwards point -> extended (X : Y : 1 : XY) Montgomery words."""
    x, y = point
    return np.concatenate([_w(v * R % ed.P) for v in (x, y, 1, x * y % ed.P)])


def _ed_affine(words):
    x, y, z, t = (_i(words[8 * k:8 * k + 8]) for k in range(4))
    zi = pow(z, -1, ed.P)  # the Montgomery factors cancel in X/Z, Y/Z
    assert x * y % ed.P == t * z % ed.P  # T/Z = x y
    return (x * zi % ed.P, y * zi % ed.P)


@pytest.mark.parametrize("k1,k2", [(1, 2), (3, 3), (7, 0), (0, 0), (5, 9)])
def test_ed_point_double_and_add(lib, k1, k2):
    b = (ed.BX, ed.BY)
    p, q = ed.scalar_mult_int(k1, b), ed.scalar_mult_int(k2, b)
    out = np.zeros(32, np.uint32)
    lib.edh_pt_add(_ptr(_ext(p)), _ptr(_ext(q)), _ptr(out))
    assert _ed_affine(out) == ed._aff_add(p, q)
    lib.edh_pt_dbl(_ptr(_ext(p)), _ptr(out))
    assert _ed_affine(out) == ed._aff_add(p, p)


def test_ed_on_curve(lib):
    lib.edh_on_curve.restype = ctypes.c_uint32
    pt = ed.scalar_mult_int(12345, (ed.BX, ed.BY))
    xm, ym = (_w(v * R % ed.P) for v in pt)
    assert lib.edh_on_curve(_ptr(xm), _ptr(ym)) == 1
    ym_off = _w((pt[1] + 1) * R % ed.P)
    assert lib.edh_on_curve(_ptr(xm), _ptr(ym_off)) == 0


def _ed_lanes():
    """Eight Ed25519 votes by three keys: valid, corrupted S, tampered
    message, S >= L, an undecodable R."""
    keys = [ed.keygen(b"edh-%d" % i) for i in range(3)]
    items = []
    for i in range(8):
        priv, pub = keys[i % 3]
        msg = b"e-%d" % i
        items.append(ed.make_item(msg, ed.sign_raw(priv, msg), pub))
    m, sig, pub = items[2]
    bad_s = (int.from_bytes(sig[32:], "little") + 1) % ed.L
    items[2] = (m, sig[:32] + bad_s.to_bytes(32, "little"), pub)
    m, sig, pub = items[3]
    items[3] = (b"tampered", sig, pub)
    m, sig, pub = items[4]
    items[4] = (m, sig[:32] + (ed.L + 3).to_bytes(32, "little"), pub)
    m, sig, pub = items[5]
    items[5] = (m, b"\xff" * 32 + sig[32:], pub)
    return items


def test_ed_comb_verify_of_eight_lanes(lib):
    items = _ed_lanes()
    reg = ced.Ed25519CombVerifier("cpu").registry
    s8, h8, rx8, ry8, ok, kidx = ced.pack_items(items, reg)
    kidx[6] = (kidx[6] + 1) % 3   # valid signature under the wrong key
    kidx[7], ok[7] = 3, 1          # ok = 1 on the zero-padded stack slot
    expect = [int(ed.verify_item(it)) for it in items]
    expect[6] = expect[7] = 0
    btab, qtab = ced.b_table(), reg.stacked()
    assert qtab.shape[0] == 4 and not qtab[3].any()
    out = np.zeros(8, np.uint32)
    lib.edh_comb_verify(8, *[_ptr(a) for a in (s8, h8, rx8, ry8, ok, kidx)],
                        _ptr(btab), _ptr(qtab), qtab.shape[0], _ptr(out))
    assert out.tolist() == expect
    assert expect == [1, 1, 0, 0, 0, 0, 0, 0]


def test_ed_generic_verify_lanes(lib):
    items = _ed_lanes()[:6]
    m, sig, _ = items[0]
    items.append((m, sig, b"\xff" * 32))  # undecodable public key
    arrays = ed.verify_inputs(items)
    out = np.zeros(len(items), np.uint32)
    lib.edh_eddsa_verify(len(items), *[_ptr(a) for a in arrays], _ptr(out))
    assert out.tolist() == [int(ed.verify_item(it)) for it in items]
    assert out.tolist() == [1, 1, 0, 0, 0, 0, 0]


# ---------------------------------------------------------------------------
# Ed25519 group program (ed25519_group.cuh): the fold field mod 2^255 - 19
# in plain form, and the stage program serialised for g = 1, 2, 4
# ---------------------------------------------------------------------------

#: edges of the fold field: results may be only partly reduced, so any
#: value below 2^256 is an input
ED_EDGES = [0, 1, 19, 37, 38, ed.P - 1, ed.P, ed.P + 1, ed.P + 37,
            2 * ed.P - 1, 2**255, R - 39, R - 38, R - 1]


def _ed_pairs(case):
    if case == "edges":
        return [(x, y) for x in ED_EDGES for y in ED_EDGES]
    rng = np.random.default_rng(13)
    return [(int.from_bytes(rng.bytes(32), "little"),
             int.from_bytes(rng.bytes(32), "little")) for _ in range(200)]


@pytest.mark.parametrize("case", ["seeded", "edges"])
def test_ed_fold_field_against_integers(lib, case):
    """e_mul / e_sqr / e_add / e_sub (folds by 38) and the comb program's
    e_mul76 give a value below 2^256 equal to the exact result mod p;
    e_canon gives the representative below p."""
    out = np.zeros(8, np.uint32)
    p = ed.P
    for x, y in _ed_pairs(case):
        a, b = _w(x), _w(y)
        for fn, want in (("edh_e_mul", x * y), ("edh_e_add", x + y),
                         ("edh_e_sub", x - y)):
            getattr(lib, fn)(_ptr(a), _ptr(b), _ptr(out))
            assert _i(out) % p == want % p, (fn, x, y)
        lib.edh_e_sqr(_ptr(a), _ptr(out))
        assert _i(out) % p == x * x % p, x
        lib.edh_e_mul76(_ptr(a), _ptr(out))
        assert _i(out) % p == 76 * x % p, x
        lib.edh_e_canon(_ptr(a), _ptr(out))
        assert _i(out) == x % p, x


def _ed_group(lib, g, arrays, n, slots=None):
    out = np.full(slots or n, 7, np.uint32)
    lib.edh_eddsa_verify_group(g, n, *[_ptr(a) for a in arrays], _ptr(out))
    return out


def _off_curve(arrays, lane, which):
    """``which`` (2: R, 4: A) of ``lane`` moved off the curve (y + 1),
    with ok left at 1."""
    arrays = [a.copy() for a in arrays]
    y = int.from_bytes(arrays[which + 1][lane].tobytes(), "little")
    arrays[which + 1][lane] = np.frombuffer(
        ((y + 1) % ed.P).to_bytes(32, "little"), np.uint8)
    return arrays


def _ed_group_batch():
    """21 votes by three keys: a full block of 16 and a ragged one of 5.
    Lane 2 has a wrong h (tampered message), 4 has S >= L, 7 an
    undecodable A (ok = 0), 11 R and 19 A moved off the curve (ok = 1)."""
    keys = [ed.keygen(b"edg-%d" % i) for i in range(3)]
    items = []
    for i in range(21):
        priv, pub = keys[i % 3]
        msg = b"eg-%d" % i
        items.append(ed.make_item(msg, ed.sign_raw(priv, msg), pub))
    m, sig, pub = items[2]
    items[2] = (m + b"-tampered", sig, pub)
    m, sig, pub = items[4]
    s_int = int.from_bytes(sig[32:], "little")
    items[4] = (m, sig[:32] + (s_int + ed.L).to_bytes(32, "little"), pub)
    m, sig, _ = items[7]
    items[7] = (m, sig, b"\xff" * 32)
    arrays = _off_curve(_off_curve(ed.verify_inputs(items), 11, 2), 19, 4)
    expect = [int(ed.verify_item(it)) for it in items]
    assert expect[:8] == [1, 1, 0, 1, 0, 1, 1, 0]
    assert expect[11] == expect[19] == 1
    expect[11] = expect[19] = 0
    return arrays, expect


@pytest.mark.parametrize("group", [1, 2, 4])
def test_ed_group_program_over_a_ragged_second_block(lib, group):
    """The stage program agrees with ``verify_item`` on every lane (valid,
    wrong h, S >= L, R or A off the curve, undecodable A) and with the
    one-thread lane; the ragged block's idle slots re-run the last
    signature and store nothing."""
    arrays, expect = _ed_group_batch()
    out = _ed_group(lib, group, arrays, 21, slots=24)
    assert out[:21].tolist() == expect
    assert out[21:].tolist() == [7, 7, 7]
    lane = np.zeros(21, np.uint32)
    lib.edh_eddsa_verify(21, *[_ptr(a) for a in arrays], _ptr(lane))
    assert lane.tolist() == expect


@pytest.mark.parametrize("group", [1, 2, 4])
def test_ed_group_program_matches_the_plain_version(lib, group):
    """Seeded random 32-byte rows (R and A mostly off the curve, S mostly
    >= L) with ok = 1: the stage program's verdicts equal the plain-torch
    version's, and so does a batch of one."""
    from smartbft_tpu_torch.crypto import cuda_eddsa as cgd
    import torch

    arrays, _ = _ed_group_batch()
    rng = np.random.default_rng(29)
    noise = [rng.integers(0, 256, (6, 32), dtype=np.uint8) for _ in range(6)]
    arrays = [np.concatenate([a, z]) for a, z in zip(arrays[:6], noise)] + \
        [np.concatenate([arrays[6], np.ones(6, np.int32)])]
    want = cgd.eddsa_verify_plain(*[torch.from_numpy(a) for a in arrays])
    assert _ed_group(lib, group, arrays, 27).tolist() == want.tolist()
    one = [a[:1].copy() for a in arrays]
    assert _ed_group(lib, group, one, 1).tolist() == [1]


# ---------------------------------------------------------------------------
# Ed25519 comb group program (ed25519_comb_group.cuh): the tables read as
# they are stored, and the stage program serialised for g = 1, 2, 4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["base", "key"])
def test_ed_comb_tables_read_as_extended_points(which):
    """An entry's Montgomery words (x R, y R, x y R mod p), read as plain
    numbers with Z = R mod p = 38, are an extended point: T Z = X Y, and
    (X / Z, Y / Z) is the comb multiple (sum of 2^(32 t) P over the index's
    bits t) of B or of the negated key."""
    p = ed.P
    if which == "base":
        point, tab = (ed.BX, ed.BY), ced.b_table()
    else:
        _, pub = ed.keygen(b"edt-0")
        x, y = ed.decompress(pub)
        point, tab = ((p - x) % p, y), ced._build_key_table(pub)
    z = R % p
    assert z == 38
    ints = [[_i(tab[idx, c]) for c in range(3)] for idx in range(256)]
    assert all(t * z % p == x * y % p for x, y, t in ints)
    rng = np.random.default_rng(43)
    sample = [0, 255] + [1 << t for t in range(8)] + \
        rng.integers(2, 255, 6).tolist()
    zi = pow(z, -1, p)
    for idx in sample:
        k = sum(1 << (32 * t) for t in range(8) if idx >> t & 1)
        x, y, _ = ints[idx]
        assert (x * zi % p, y * zi % p) == ed.scalar_mult_int(k, point), idx


def _ed_comb_items():
    """40 votes by three keys (two blocks of 16 and a ragged one of 8) with
    _ed_lanes()'s faults: corrupted S (lane 2), tampered message (3, and 37
    in the ragged block), S >= L (4), an undecodable R (5)."""
    items = _ed_lanes()
    keys = [ed.keygen(b"edh-%d" % i) for i in range(3)]
    for i in range(8, 40):
        priv, pub = keys[i % 3]
        msg = b"e-%d" % i
        items.append(ed.make_item(msg, ed.sign_raw(priv, msg), pub))
    m, sig, pub = items[37]
    items[37] = (m + b"-tampered", sig, pub)
    return items


def _signed_by_minus_b(msg):
    """A valid signature under the key A = -B (secret scalar L - 1): its
    negated-key table is B's own, the table a lane outside the stack
    reads, so only the stack check rejects it there."""
    a_enc = ed.compress(((ed.P - ed.BX) % ed.P, ed.BY))
    r = 0x1234567
    r_enc = ed.compress(ed.scalar_mult_int(r, (ed.BX, ed.BY)))
    s = (r + ed.binding_hash(r_enc, a_enc, msg) * (ed.L - 1)) % ed.L
    return ed.make_item(msg, r_enc + s.to_bytes(32, "little"), a_enc)


@pytest.fixture(scope="module")
def ed_comb_batch():
    """The 40 lanes packed, with the key-index faults: a valid signature
    under the wrong kidx (lane 6), ok = 1 on the zero-padded stack slot
    (7), kidx outside the stack (8: -1, 9: the stack's size, 10: 1000 on
    a signature by -B), ok = 0 on a valid signature (11); the expected
    verdicts (``verify_item``, 0 on those lanes) and the plain-torch
    version's mask."""
    import torch

    items = _ed_comb_items()
    reg = ced.Ed25519CombVerifier("cpu").registry
    s8, h8, rx8, ry8, ok, kidx = ced.pack_items(items, reg)
    qtab = reg.stacked()
    assert qtab.shape[0] == 4 and not qtab[3].any()
    items[10] = _signed_by_minus_b(b"e-10")
    other = ced.Ed25519CombVerifier("cpu").registry
    for a, row in zip((s8, h8, rx8, ry8, ok),
                      ced.pack_items(items[10:11], other)):
        a[10] = row[0]
    assert ok[10] == 1
    kidx[6] = (kidx[6] + 1) % 3
    kidx[7], ok[7] = 3, 1
    kidx[8], kidx[9], kidx[10] = -1, 4, 1000
    ok[11] = 0
    truth = [int(ed.verify_item(it)) for it in items]
    assert [i for i, t in enumerate(truth) if not t] == [2, 3, 4, 5, 37]
    truth[6:12] = [0] * 6
    arrays = [s8, h8, rx8, ry8, ok, kidx]
    plain = ced.eddsa_verify_comb_plain(
        *[torch.from_numpy(a) for a in (*arrays, ced.b_table(), qtab)])
    return arrays, qtab, truth, plain.tolist()


def _ed_comb(lib, g, arrays, qtab, slots=None):
    """The one-thread lane loop (g = 0) or the comb group program
    serialised for a group of g ranks; ``slots`` output words, those past
    the batch left at 7."""
    n = len(arrays[4])
    out = np.full(slots or n, 7, np.uint32)
    ptrs = [_ptr(a) for a in (*arrays, ced.b_table(), qtab)]
    if g == 0:
        lib.edh_comb_verify(n, *ptrs, qtab.shape[0], _ptr(out))
    else:
        lib.edh_comb_verify_group(g, n, *ptrs, qtab.shape[0], _ptr(out))
    return out


@pytest.mark.parametrize("group", [1, 2, 4])
def test_ed_comb_group_program_over_a_ragged_second_block(lib, group,
                                                          ed_comb_batch):
    """The stage program agrees with ``verify_item`` on every lane (valid,
    corrupted S, tampered message, S >= L, undecodable R, wrong kidx,
    a zero-padded stack slot with ok = 1, kidx outside the stack, ok = 0
    on a valid signature), with
    the one-thread lane and with the plain-torch version, bit for bit; the
    ragged block's idle slots re-run the last signature and store
    nothing."""
    arrays, qtab, truth, plain = ed_comb_batch
    out = _ed_comb(lib, group, arrays, qtab, slots=48)
    assert out[:40].tolist() == truth == plain
    assert out[40:].tolist() == [7] * 8
    assert _ed_comb(lib, 0, arrays, qtab).tolist() == truth


@pytest.fixture(scope="module")
def ed_comb_plain_batch(ed_comb_batch):
    """The 40 lanes plus 8 seeded rows with ok = 1 and kidx any of -1 .. 4:
    four with random S, h, rx, ry (R almost surely off the curve), four
    with lane 0's R (on the curve) and random S and h; the plain-torch
    version's mask."""
    import torch

    arrays, qtab, _, _ = ed_comb_batch
    rng = np.random.default_rng(47)
    extra = [rng.integers(0, 256, (8, 32), np.uint8) for _ in range(4)]
    for a in (2, 3):
        extra[a][4:] = arrays[a][0]
    arrays = [np.concatenate([a, z]) for a, z in zip(arrays[:4], extra)] + [
        np.concatenate([arrays[4], np.ones(8, np.int32)]),
        np.concatenate([arrays[5], rng.integers(-1, 5, 8).astype(np.int32)])]
    want = ced.eddsa_verify_comb_plain(
        *[torch.from_numpy(a) for a in (*arrays, ced.b_table(), qtab)])
    return arrays, qtab, want.tolist()


@pytest.mark.parametrize("group", [1, 2, 4])
def test_ed_comb_group_program_matches_the_plain_version(lib, group,
                                                         ed_comb_plain_batch):
    """On the seeded rows too (values at or above p, S at or above L: the
    host checks those), the stage program's verdicts equal the plain-torch
    version's and the one-thread lane's, and so does a batch of one."""
    arrays, qtab, want = ed_comb_plain_batch
    assert _ed_comb(lib, group, arrays, qtab).tolist() == want
    assert _ed_comb(lib, 0, arrays, qtab).tolist() == want
    one = [a[:1].copy() for a in arrays]
    assert _ed_comb(lib, group, one, qtab).tolist() == want[:1] == [1]


# ---------------------------------------------------------------------------
# BLS12-381: bls381_field.cuh and bls381_pairing.cuh
# ---------------------------------------------------------------------------

BP = tbls.P
BR = 1 << 384


def _bw(x):
    return np.frombuffer(x.to_bytes(48, "little"), np.uint32).copy()


def _bi(a):
    return int.from_bytes(np.asarray(a, np.uint32).tobytes(), "little")


#: the edges of a reduction: 0, 1, p - 1 and R mod p (1 in Montgomery form)
BLS_EDGES = [0, 1, BP - 1, BR % BP]


@pytest.mark.parametrize("case", ["seeded", "edges"])
def test_bls_fp_against_integers(lib, case):
    """Montgomery product and square, addition, subtraction and the Fermat
    inversion mod p, fully reduced, against Python integers."""
    if case == "seeded":
        rng = np.random.default_rng(381)
        xs = [int.from_bytes(rng.bytes(48), "little") % BP for _ in range(40)]
        pairs = list(zip(xs[:20], xs[20:]))
    else:
        pairs = [(x, y) for x in BLS_EDGES for y in BLS_EDGES]
    rinv = pow(BR, -1, BP)
    out = np.zeros(12, np.uint32)
    for x, y in pairs:
        a, b = _bw(x), _bw(y)
        lib.blsh_fp_mul(_ptr(a), _ptr(b), _ptr(out))
        assert _bi(out) == x * y * rinv % BP, (x, y)
        lib.blsh_fp_sqr(_ptr(a), _ptr(out))
        assert _bi(out) == x * x * rinv % BP, x
        lib.blsh_fp_add(_ptr(a), _ptr(b), _ptr(out))
        assert _bi(out) == (x + y) % BP
        lib.blsh_fp_sub(_ptr(a), _ptr(b), _ptr(out))
        assert _bi(out) == (x - y) % BP
    for x, _ in pairs[:4]:
        lib.blsh_fp_inv(_ptr(_bw(x * BR % BP)), _ptr(out))
        want = pow(x, -1, BP) * BR % BP if x else 0
        assert _bi(out) == want, x


def _b12(x):
    """Host Fp12 -> (12, 12) Montgomery words in the stacked order."""
    return np.stack([_bw(v * BR % BP) for v in cbl._flatten_host_fp12(x)])


def _h12(words):
    rinv = pow(BR, -1, BP)
    it = iter(_bi(r) * rinv % BP for r in words.reshape(12, 12))
    return tuple(tuple((next(it), next(it)) for _ in range(3))
                 for _ in range(2))


@pytest.fixture(scope="module")
def bls_table():
    return np.ascontiguousarray(cbl.const_table())


def test_bls_fp12_ops_match_the_host_tower(lib, bls_table):
    """Fp12 product, square (the Karatsuba form), inverse and Frobenius
    against the JAX package's HostFp tower; the cyclotomic square
    (Granger-Scott) equals the square on the cyclotomic subgroup (the easy
    part's image f^((p^6 - 1)(p^2 + 1)) of a random f), and differs from
    it off the subgroup."""
    import random

    rng = random.Random(12)
    H = jbls.HOST
    g = (jbls._G1F, jbls._G2F, jbls._G4F)
    out = np.zeros((12, 12), np.uint32)
    for _ in range(3):
        x, y = (tuple(tuple((rng.randrange(BP), rng.randrange(BP))
                            for _ in range(3)) for _ in range(2))
                for _ in range(2))
        lib.blsh_fp12_mul(_ptr(_b12(x)), _ptr(_b12(y)), _ptr(out))
        assert _h12(out) == jbls.fp12_mul(H, x, y)
        lib.blsh_fp12_sqr(_ptr(_b12(x)), _ptr(out))
        assert _h12(out) == jbls.fp12_mul(H, x, x)
        lib.blsh_fp12_inv(_ptr(_b12(x)), _ptr(out))
        assert _h12(out) == jbls.fp12_inv(H, x)
        lib.blsh_fp12_frob(_ptr(_b12(x)), _ptr(bls_table), _ptr(out))
        assert _h12(out) == jbls.fp12_frob(H, x, *g)
        m = jbls.fp12_mul(H, jbls.fp12_conj(H, x), jbls.fp12_inv(H, x))
        m = jbls.fp12_mul(H, jbls.fp12_frob(H, jbls.fp12_frob(H, m, *g), *g),
                          m)
        lib.blsh_fp12_cyclo_sqr(_ptr(_b12(m)), _ptr(out))
        assert _h12(out) == jbls.fp12_mul(H, m, m)
        lib.blsh_fp12_cyclo_sqr(_ptr(_b12(x)), _ptr(out))
        assert _h12(out) != jbls.fp12_mul(H, x, x)
        line = tuple((rng.randrange(BP), rng.randrange(BP)) for _ in range(3))
        xp, yp = rng.randrange(BP), rng.randrange(BP)
        lw = np.stack([_bw(v * BR % BP) for pair in line for v in pair])
        lib.blsh_mul_line(_ptr(_b12(x)), _ptr(lw), _ptr(_bw(xp * BR % BP)),
                          _ptr(_bw(yp * BR % BP)), _ptr(out))
        scaled = jbls._scale_line(H, line, xp, yp)
        assert _h12(out) == jbls.fp12_mul(
            H, x, jbls._line_to_fp12(H, *scaled))


def _bls_items():
    keys = [tbls.keygen(b"harness-%d" % i) for i in range(3)]
    msg = b"harness-digest"
    votes = [(msg, tbls.sign(sk, msg), pk) for sk, pk in keys]
    return votes + [
        (msg, votes[0][1], keys[1][1]),                    # wrong key
        (b"harness-other", votes[2][1], keys[2][1]),       # wrong message
        tbls.aggregate_items(votes),                       # quorum lane
        (msg, tbls.aggregate_sigs([v[1] for v in votes[:2]]),
         tbls.aggregate_pubs([v[2] for v in votes])),      # one signer short
        (msg, b"\x01" * tbls.SIG_BYTES, keys[0][1]),       # does not decode
    ]


def _bls_verify(lib, table, words):
    n = len(words[-1])
    out = np.zeros(n, np.uint32)
    lib.blsh_verify(n, _ptr(table), *[_ptr(np.ascontiguousarray(w))
                                      for w in words], _ptr(out))
    return out.tolist()


def test_bls_lanes_match_verify_item(lib, bls_table):
    """The kernel's lane loop over the headers: valid votes, a wrong key, a
    wrong message, an aggregated quorum, an aggregate one signer short and
    an undecodable signature, against ``verify_item`` of both packages."""
    items = _bls_items()
    got = _bls_verify(lib, bls_table, cbl.verify_words(items))
    assert got == [1, 1, 1, 0, 0, 1, 0, 0]
    assert got == [int(tbls.verify_item(it)) for it in items]
    assert got == [int(jbls.verify_item(it)) for it in items]


def test_bls_miller_and_final_exp_match_the_host(lib, bls_table):
    """One lane's fused Miller loop and final exponentiation, value for
    value: the host Miller product of e(sig, -g2) e(H(m), pk), and its
    ``host_final_exp``."""
    msg, sig, pub = _bls_items()[0]
    words = cbl.verify_words([(msg, sig, pub)])
    lane = np.concatenate([w[0].view(np.uint32) for w in words[:8]])
    f = np.zeros((12, 12), np.uint32)
    lib.blsh_miller(_ptr(bls_table), _ptr(lane), _ptr(f))
    s = tbls.deserialize_g1(sig)
    pk = tbls.deserialize_g2(pub)
    want = jbls.fp12_mul(jbls.HOST, jbls.host_miller_loop(s, jbls.NEG_G2),
                         jbls.host_miller_loop(jbls.hash_to_g1(msg), pk))
    assert _h12(f) == want
    e = np.zeros((12, 12), np.uint32)
    lib.blsh_final_exp(_ptr(bls_table), _ptr(f), _ptr(e))
    assert _h12(e) == jbls.host_final_exp(want) == jbls.fp12_one(jbls.HOST)


def test_bls_op_counts_of_the_bound_match_the_kernel(lib, bls_table):
    """The bound's count (``cuda_bls.lane_ops``) is the headers' own: the
    g++ build counts every Fp product and squaring the lane loop runs, for
    each live lane, and none for a lane with ok = 0."""
    items = _bls_items()
    words = cbl.verify_words(items)
    counts = np.zeros(2, np.uint64)
    lib.blsh_reset_op_counts()
    _bls_verify(lib, bls_table, words)
    lib.blsh_op_counts(_ptr(counts))
    ops = cbl.mont_ops(*words)
    assert ops == {k: 7 * v for k, v in cbl.lane_ops().items()}
    assert counts.tolist() == [ops["b381_mul"], ops["b381_sqr"]]



# ---------------------------------------------------------------------------
# the pairing kernel's stage program (bls381_group.cuh over
# crypto/bls_stages.py), serialised as the kernel's grid at 1, 3, 6 and 12
# threads a lane
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bls_program():
    return np.ascontiguousarray(bs.program().words)


def _bls_group_batch():
    """The eight lanes of :func:`_bls_items` and four more (a valid vote,
    a wrong key, a quorum, random bytes with ok = 0), 12 lanes: the tail
    ends inside a block at every group size (32, 10, 5 and 2 lanes a
    block)."""
    items = _bls_items()
    rng = np.random.default_rng(5)
    extra = [items[1], (items[0][0], items[0][1], items[2][2]), items[5],
             (b"harness-x", rng.bytes(tbls.SIG_BYTES),
              rng.bytes(tbls.PUB_BYTES))]
    return items + extra


def _bls_group(lib, g, program, table, words):
    n = len(words[-1])
    out = np.full(n, 7, np.uint32)
    lib.blsh_verify_group(g, n, _ptr(program), _ptr(table),
                          *[_ptr(np.ascontiguousarray(w)) for w in words],
                          _ptr(out))
    return out.tolist()


@pytest.fixture(scope="module")
def bls_group_truth():
    items = _bls_group_batch()
    words = cbl.verify_words(items)
    truth = [int(tbls.verify_item(it)) for it in items]
    assert truth == [int(jbls.verify_item(it)) for it in items]
    assert truth == [1, 1, 1, 0, 0, 1, 0, 0, 1, 0, 1, 0]
    return words, truth


@pytest.mark.parametrize("group", [1, 3, 6, 12])
def test_bls_group_program_over_a_ragged_tail(lib, bls_table, bls_program,
                                              bls_group_truth, group):
    """The stage program run serialised as the kernel's blocks and groups
    run it gives ``verify_item``'s verdict of both packages on every lane
    (valid votes, a wrong key, a wrong message, aggregated quorums, an
    aggregate one signer short, an undecodable signature and random bytes,
    whose ok = 0 lanes store 0 untouched by the program), and counts
    ``lane_ops`` for each live lane and nothing for a dead one."""
    words, truth = bls_group_truth
    counts = np.zeros(2, np.uint64)
    lib.blsh_reset_op_counts()
    got = _bls_group(lib, group, bls_program, bls_table, words)
    lib.blsh_op_counts(_ptr(counts))
    assert got == truth
    ops = cbl.mont_ops(*words)
    assert ops == {k: 10 * v for k, v in cbl.lane_ops().items()}
    assert counts.tolist() == [ops["b381_mul"], ops["b381_sqr"]]
    one = [w[1:2].copy() for w in words]
    assert _bls_group(lib, group, bls_program, bls_table, one) == truth[1:2]


def test_bls_group_program_matches_the_plain_version(lib, bls_table,
                                                     bls_program,
                                                     bls_group_truth):
    """The library's group size (``cuda_bls``'s) against
    ``bls_verify_plain`` on the same words, mask for mask."""
    import torch

    words, truth = bls_group_truth
    plain = cbl.bls_verify_plain(*[torch.from_numpy(w) for w in words])
    assert plain.tolist() == truth
    assert _bls_group(lib, 12, bls_program, bls_table, words) == truth


@pytest.mark.parametrize("group", [1, 6, 12])
def test_bls_group_program_values_match_the_one_thread_lane(
        lib, bls_table, bls_program, group):
    """Value for value: after the Miller loop's stages the program's
    Miller slots hold the one-thread lane's ``miller`` (the first kernel's,
    ``bls381_pairing.cuh``), and after the last stage its result slots
    hold that lane's ``final_exp`` of it, on a valid vote and on a wrong
    key."""
    prog = bs.program()
    items = _bls_items()
    for k in (0, 3):
        words = cbl.verify_words([items[k]])
        lane = np.concatenate([w[0].view(np.uint32) for w in words[:8]])
        f = np.zeros((12, 12), np.uint32)
        lib.blsh_miller(_ptr(bls_table), _ptr(lane), _ptr(f))
        e = np.zeros((12, 12), np.uint32)
        lib.blsh_final_exp(_ptr(bls_table), _ptr(f), _ptr(e))
        for stages, at, want in ((prog.miller_stages, prog.miller_result, f),
                                 (prog.nstages, prog.result, e)):
            slots = np.zeros((prog.nslots, 12), np.uint32)
            lib.blsh_lane_slots(group, _ptr(bls_program), _ptr(bls_table),
                                _ptr(lane), stages, _ptr(slots))
            assert (slots[at] == want).all(), (k, stages)


def test_bls_fp_sum_without_reduction(lib):
    """``fp_add_nr``, a product operand's pre-sum: the exact sum of two
    values below 2^383."""
    rng = np.random.default_rng(83)
    out = np.zeros(12, np.uint32)
    for _ in range(20):
        x, y = (int.from_bytes(rng.bytes(48), "little") % (2 * BP)
                for _ in range(2))
        lib.blsh_fp_add_nr(_ptr(_bw(x)), _ptr(_bw(y)), _ptr(out))
        assert _bi(out) == x + y
