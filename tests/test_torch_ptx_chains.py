"""The PTX carry chains of ``csrc/p256_field.cuh``,
``csrc/ed25519_group.cuh``, ``csrc/p256_comb_group.cuh`` and
``csrc/bls381_field.cuh`` on a CPU.

The device half of ``p_mul`` / ``p_sqr`` / ``p_add`` / ``p_sub``, of
``e_mul`` / ``e_sqr`` / ``e_add`` / ``e_sub``, of ``n_mul`` / ``n_sqr``
and of the 12-word ``fp_mont`` / ``fp_add`` / ``fp_sub`` / ``fp_add_nr``
mod the BLS12-381 p is inline PTX that only nvcc builds, so the host harness (which compiles the portable twin) never runs
it.  Here the ``asm`` statements are read out
of the header as they are, each run on a small emulator of the PTX
integer instructions they use (``mad``/``madc`` with ``.lo``/``.hi`` and
the carry flag, ``add``/``addc``, ``sub``/``subc``, ``and``), with the C++
around them mirrored in Python, and the results held to Python integers.
"""

import pathlib
import re

import numpy as np
import pytest

from smartbft_tpu_torch.crypto import bls12381, ed25519, p256

CSRC = pathlib.Path(__file__).resolve().parent.parent / "smartbft_tpu_torch" \
    / "csrc"
M32 = (1 << 32) - 1
R = 1 << 256
P = p256.P


# ---------------------------------------------------------------------------
# the asm statements of the header's device section, by function
# ---------------------------------------------------------------------------


def _device_asm(header):
    text = (CSRC / header).read_text()
    dev = text[text.index("#ifdef __CUDA_ARCH__"):]
    blocks = {}
    for m in re.finditer(r"__device__ __forceinline__ \w+ (\w+)\(", dev):
        body_start = m.end()
        nxt = re.search(r"__device__ __forceinline__ \w+ \w+\(|#else",
                        dev[body_start:])
        body = dev[body_start:body_start + nxt.start()] if nxt else \
            dev[body_start:]
        blocks[m.group(1)] = [_parse_asm(a) for a in
                              re.findall(r"asm\((.*?)\);", body, re.S)]
    return blocks


def _parse_asm(src):
    template, out_part, in_part = src.split(":")
    code = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', template))
    code = code.replace("\\n", "\n").replace("\\t", " ")
    outs = re.findall(r'"([+=])r"\(([^)]*)\)', out_part)
    ins = re.findall(r'"r"\(([^)]*)\)', in_part)
    return code, outs, ins


#: the asm statements by function, per header
HEADERS = {h: _device_asm(h) for h in ("p256_field.cuh", "ed25519_group.cuh",
                                        "p256_comb_group.cuh",
                                        "bls381_field.cuh")}
ASM = HEADERS["p256_field.cuh"]
ED_ASM = HEADERS["ed25519_group.cuh"]
N_ASM = HEADERS["p256_comb_group.cuh"]


def test_the_header_has_the_chains_this_file_runs():
    assert {name: len(v) for name, v in ASM.items() if v} == {
        "p_row": 1, "p_redc_round": 1, "p_add_carries": 1,
        "p_final_sub": 1, "p_sqr_wide": 8, "p_add": 1, "p_sub": 1}


# ---------------------------------------------------------------------------
# the emulator
# ---------------------------------------------------------------------------


def _run(block, env):
    """Run one asm statement: ``env`` maps its operand expressions to
    values; returns the values of the output operands by expression."""
    code, outs, ins = block
    ops = [e for _, e in outs] + ins
    regs = {f"%{k}": env[e] for k, e in enumerate(ops)
            if k >= len(outs) or outs[k][0] == "+"}
    cf = None

    def val(x):
        x = x.strip()
        if x in regs:
            return regs[x]
        return int(x, 0)

    for line in code.replace("{", "\n").replace("}", "\n").split(";"):
        line = line.strip()
        if not line or line.startswith(".reg"):
            continue
        op, args = line.split(None, 1)
        d, *src = [a.strip() for a in args.split(",")]
        parts = op.split(".")
        base, has_cc = parts[0], "cc" in parts
        cin = 0
        if base in ("madc", "addc", "subc"):
            assert cf is not None, f"{line}: no carry flag was set"
            cin = cf
        if base in ("mad", "madc"):
            x, y, z = map(val, src)
            prod = x * y
            res = (prod & M32 if "lo" in parts else prod >> 32) + z + cin
            regs[d], carry = res & M32, res >> 32
        elif base in ("add", "addc"):
            res = val(src[0]) + val(src[1]) + cin
            regs[d], carry = res & M32, res >> 32
        elif base in ("sub", "subc"):
            res = val(src[0]) - val(src[1]) - cin
            regs[d], carry = res & M32, int(res < 0)
        elif base == "and":
            regs[d], carry = val(src[0]) & val(src[1]), None
        else:
            raise AssertionError(f"unknown PTX op {op}")
        cf = carry if has_cc else None
    return {e: regs[f"%{k}"] for k, (_, e) in enumerate(outs)}


def _words(x, n=8):
    return [(x >> (32 * j)) & M32 for j in range(n)]


def _num(ws):
    return sum(w << (32 * j) for j, w in enumerate(ws))


def _env_arrays(**arrays):
    """Operand expressions (``t[3]``, ``a.v[0]``, ``bi``) -> values, with
    ``t`` seen from an offset as the C++ passes ``t + i``."""
    env = {}
    for name, (vals, off) in arrays.items():
        if isinstance(vals, int):
            env[name] = vals
            continue
        for j in range(len(vals) - off):
            env[f"{name}[{j}]"] = env[f"{name}.v[{j}]"] = vals[off + j]
    return env


def _store(res, name, arr, off=0):
    for expr, v in res.items():
        m = re.fullmatch(rf"{name}(?:\.v)?\[(\d+)\]", expr)
        if m:
            arr[off + int(m.group(1))] = v


# ---------------------------------------------------------------------------
# the C++ around the chains, mirrored
# ---------------------------------------------------------------------------


def mul_wide(a, b):
    t = [0] * 17
    for i in range(8):
        res = _run(ASM["p_row"][0], _env_arrays(t=(t, i), a=(a, 0),
                                                bi=(b[i], 0)))
        _store(res, "t", t, i)
    return t


def sqr_wide(a):
    t = [0] * 17
    for block in ASM["p_sqr_wide"][:7]:
        _store(_run(block, _env_arrays(t=(t, 0), a=(a, 0))), "t", t)
    for j in range(15, 0, -1):  # __funnelshift_l(t[j-1], t[j], 1)
        t[j] = ((t[j] << 1) | (t[j - 1] >> 31)) & M32
    t[0] = (t[0] << 1) & M32
    _store(_run(ASM["p_sqr_wide"][7], _env_arrays(t=(t, 0), a=(a, 0))),
           "t", t)
    return t


def redc(t):
    t = list(t)
    c = []
    for i in range(8):
        env = _env_arrays(t=(t, i))
        res = _run(ASM["p_redc_round"][0], env)
        c.append(res.pop("c"))
        _store(res, "t", t, i)
    _store(_run(ASM["p_add_carries"][0], _env_arrays(t=(t, 0), c=(c, 0))),
           "t", t)
    res = _run(ASM["p_final_sub"][0], _env_arrays(t=(t, 0)))
    keep, d = res.pop("keep"), [0] * 8
    _store(res, "d", d)
    assert keep in (0, M32)
    return [(t[8 + j] & keep) | (d[j] & ~keep & M32) for j in range(8)]


def add(a, b):
    res = _run(ASM["p_add"][0], _env_arrays(a=(a, 0), b=(b, 0)))
    keep, s, d = res.pop("keep"), [0] * 8, [0] * 8
    _store(res, "s", s)
    _store(res, "d", d)
    assert keep in (0, M32)
    return [(s[j] & keep) | (d[j] & ~keep & M32) for j in range(8)]


def sub(a, b):
    out = [0] * 8
    _store(_run(ASM["p_sub"][0], _env_arrays(a=(a, 0), b=(b, 0))), "out",
           out)
    return out


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------


def _cases(kind):
    if kind == "edges":
        xs = [0, 1, P - 1, R - 1, R % P, 2**255]
        return [(x, y) for x in xs for y in xs if y < P]
    rng = np.random.default_rng(23)
    return [(int.from_bytes(rng.bytes(32), "little"),
             int.from_bytes(rng.bytes(32), "little") % P)
            for _ in range(60)]


@pytest.mark.parametrize("kind", ["seeded", "edges"])
def test_ptx_product_and_square_mod_p(kind):
    rinv = pow(R, -1, P)
    for x, y in _cases(kind):
        t = mul_wide(_words(x), _words(y))
        assert _num(t) == x * y
        assert _num(redc(t)) == x * y * rinv % P, (x, y)
        if x < P:
            t = sqr_wide(_words(x))
            assert _num(t) == x * x
            assert _num(redc(t)) == x * x * rinv % P, x


@pytest.mark.parametrize("kind", ["seeded", "edges"])
def test_ptx_add_and_sub_mod_p(kind):
    for x, y in _cases(kind):
        x %= P
        assert _num(add(_words(x), _words(y))) == (x + y) % P, (x, y)
        assert _num(sub(_words(x), _words(y))) == (x - y) % P, (x, y)
        assert _num(sub(_words(y), _words(x))) == (y - x) % P, (x, y)


# ---------------------------------------------------------------------------
# the fold field mod 2^255 - 19 (ed25519_group.cuh): e_mul / e_sqr are the
# wide products above and the fold chain; the results are below 2^256 and
# equal to the exact ones mod p
# ---------------------------------------------------------------------------

EP = ed25519.P


#: the chains each header holds, every one of them run below
CHAINS = {
    "p256_field.cuh": {"p_row": 1, "p_redc_round": 1, "p_add_carries": 1,
                       "p_final_sub": 1, "p_sqr_wide": 8, "p_add": 1,
                       "p_sub": 1},
    "ed25519_group.cuh": {"e_fold": 1, "e_add": 1, "e_sub": 1},
    "p256_comb_group.cuh": {"n_redc_round": 1, "n_final_sub": 1},
    "bls381_field.cuh": {"b_row": 1, "b_redc_row": 1, "b_final_sub": 1,
                         "fp_add_nr": 1, "b_sub": 1},
}


@pytest.mark.parametrize("header", sorted(CHAINS))
def test_each_header_has_the_chains_this_file_runs(header):
    assert {name: len(v) for name, v in HEADERS[header].items() if v} == \
        CHAINS[header]


def e_fold(t):
    out = [0] * 8
    _store(_run(ED_ASM["e_fold"][0], _env_arrays(t=(t, 0), k=(38, 0))),
           "r", out)
    return out


def e_addsub(name, a, b):
    out = [0] * 8
    _store(_run(ED_ASM[name][0], _env_arrays(a=(a, 0), b=(b, 0))), "r", out)
    return out


def _ed_cases(kind):
    if kind == "edges":
        xs = [0, 1, 19, 38, EP - 1, EP, EP + 1, 2 * EP - 1, 2**255, R - 39,
              R - 38, R - 1]
        return [(x, y) for x in xs for y in xs]
    rng = np.random.default_rng(31)
    return [(int.from_bytes(rng.bytes(32), "little"),
             int.from_bytes(rng.bytes(32), "little")) for _ in range(60)]


@pytest.mark.parametrize("kind", ["seeded", "edges"])
def test_ptx_fold_product_and_square_mod_2p255_19(kind):
    for x, y in _ed_cases(kind):
        got = _num(e_fold(mul_wide(_words(x), _words(y))))
        assert got < R and got % EP == x * y % EP, (x, y)
        got = _num(e_fold(sqr_wide(_words(x))))
        assert got < R and got % EP == x * x % EP, x


@pytest.mark.parametrize("kind", ["seeded", "edges"])
def test_ptx_fold_by_76_mod_2p255_19(kind):
    """The comb program's D = 76 z (``e_mul76`` of ed25519_comb_group.cuh,
    C++ over the chains above with no asm of its own): e_add(z, z), then
    e_fold of the 512-bit value with 2 z as its high half."""
    assert "asm(" not in (CSRC / "ed25519_comb_group.cuh").read_text()
    for x in sorted({x for x, _ in _ed_cases(kind)}):
        z2 = e_addsub("e_add", _words(x), _words(x))
        got = _num(e_fold([0] * 8 + z2))
        assert got < R and got % EP == 76 * x % EP, x


@pytest.mark.parametrize("kind", ["seeded", "edges"])
def test_ptx_fold_add_and_sub_mod_2p255_19(kind):
    for x, y in _ed_cases(kind):
        for name, want in (("e_add", x + y), ("e_sub", x - y)):
            got = _num(e_addsub(name, _words(x), _words(y)))
            assert got < R and got % EP == want % EP, (name, x, y)


# ---------------------------------------------------------------------------
# products mod n (p256_comb_group.cuh): the wide products above, 8 CIOS
# rounds of q = t[i] n' and a row of n, the deferred carries and a final
# subtraction of n
# ---------------------------------------------------------------------------

N = p256.N
N0INV = 0xEE00BC4F  # -n^-1 mod 2^32


def n_redc(t):
    t = list(t)
    c = []
    for i in range(8):
        q = t[i] * N0INV & M32
        res = _run(N_ASM["n_redc_round"][0],
                   _env_arrays(t=(t, i), nw=(_words(N), 0), q=(q, 0)))
        c.append(res.pop("c"))
        _store(res, "t", t, i)
        assert t[i] == 0
    _store(_run(ASM["p_add_carries"][0], _env_arrays(t=(t, 0), c=(c, 0))),
           "t", t)
    res = _run(N_ASM["n_final_sub"][0], _env_arrays(t=(t, 0)))
    keep, d = res.pop("keep"), [0] * 8
    _store(res, "d", d)
    assert keep in (0, M32)
    return [(t[8 + j] & keep) | (d[j] & ~keep & M32) for j in range(8)]


def _n_cases(kind):
    if kind == "edges":
        xs = [0, 1, N - 1, R - 1, R % N, 2**255]
        return [(x, y) for x in xs for y in xs if y < N]
    rng = np.random.default_rng(41)
    return [(int.from_bytes(rng.bytes(32), "little"),
             int.from_bytes(rng.bytes(32), "little") % N)
            for _ in range(60)]


@pytest.mark.parametrize("kind", ["seeded", "edges"])
def test_ptx_product_and_square_mod_n(kind):
    rinv = pow(R, -1, N)
    for x, y in _n_cases(kind):
        got = _num(n_redc(mul_wide(_words(x), _words(y))))
        assert got == x * y * rinv % N, (x, y)
        if x < N:
            assert _num(n_redc(sqr_wide(_words(x)))) == x * x * rinv % N, x


# ---------------------------------------------------------------------------
# the 12-word field mod the 381-bit BLS12-381 p (bls381_field.cuh): CIOS
# rounds of a row a * b[i] and a reduction row m * p with m = t[0] (-p^-1)
# mod 2^32, a shift, two final subtractions; the products take operands
# below 4p (a sum of up to four reduced values) and return values below p
# ---------------------------------------------------------------------------

BP = bls12381.P
BR = 1 << 384
BN0INV = 0xFFFCFFFD  # -p^-1 mod 2^32
B_ASM = HEADERS["bls381_field.cuh"]
BPW = _words(BP, 12)


def b_final_sub(t):
    res = _run(B_ASM["b_final_sub"][0], _env_arrays(t=(t, 0)))
    keep, d = res.pop("keep"), [0] * 12
    _store(res, "d", d)
    assert keep in (0, M32)
    return [(t[j] & keep) | (d[j] & ~keep & M32) for j in range(12)]


def b_mont(a, b):
    t = [0] * 13
    for i in range(12):
        _store(_run(B_ASM["b_row"][0],
                    _env_arrays(t=(t, 0), a=(a, 0), bi=(b[i], 0))), "t", t)
        m = t[0] * BN0INV & M32
        _store(_run(B_ASM["b_redc_row"][0],
                    _env_arrays(t=(t, 0), p=(BPW, 0), m=(m, 0))), "t", t)
        assert t[0] == 0
        t = t[1:] + [0]
    return b_final_sub(b_final_sub(t) + [0])


def b_add_nr(a, b):
    s = list(a)
    _store(_run(B_ASM["fp_add_nr"][0], _env_arrays(s=(s, 0), b=(b, 0))),
           "s", s)
    return s


def b_add(a, b):
    return b_final_sub(b_add_nr(a, b) + [0])


def b_sub(a, b):
    d = list(a)
    res = _run(B_ASM["b_sub"][0], _env_arrays(d=(d, 0), b=(b, 0)))
    mask = res.pop("mask")
    _store(res, "d", d)
    assert mask in (0, M32)
    return b_add_nr(d, [w & mask for w in BPW])


#: reduced edges: 0, 1, p - 1, R mod p (1 in Montgomery form) and values
#: near 2^384 mod p
B_EDGES = [0, 1, 2, BP - 1, BP - 2, (BP + 1) // 2, BR % BP, (BR - 1) % BP,
           (BR - 2**32) % BP, (BR + 2**383) % BP]


def _b_cases(kind, below):
    if kind == "edges":
        xs = [x for x in B_EDGES + [BP, BP + 1, 2 * BP - 1, 3 * BP + 7,
                                    4 * BP - 1] if x < below]
        return [(x, y) for x in xs for y in xs]
    rng = np.random.default_rng(381)
    return [(int.from_bytes(rng.bytes(48), "little") % below,
             int.from_bytes(rng.bytes(48), "little") % below)
            for _ in range(60)]


@pytest.mark.parametrize("kind", ["seeded", "edges"])
def test_ptx_bls_product_and_square_mod_p(kind):
    """Operands below 4p, as the stage program's pre-summed operands are;
    results fully reduced."""
    rinv = pow(BR, -1, BP)
    for x, y in _b_cases(kind, 4 * BP):
        got = _num(b_mont(_words(x, 12), _words(y, 12)))
        assert got == x * y * rinv % BP, (x, y)
        got = _num(b_mont(_words(x, 12), _words(x, 12)))
        assert got == x * x * rinv % BP, x


@pytest.mark.parametrize("kind", ["seeded", "edges"])
def test_ptx_bls_add_and_sub_mod_p(kind):
    for x, y in _b_cases(kind, BP):
        a, b = _words(x, 12), _words(y, 12)
        assert _num(b_add_nr(a, b)) == x + y, (x, y)
        assert _num(b_add(a, b)) == (x + y) % BP, (x, y)
        assert _num(b_sub(a, b)) == (x - y) % BP, (x, y)
        assert _num(b_sub(b, a)) == (y - x) % BP, (x, y)
