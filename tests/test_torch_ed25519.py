"""The port's Ed25519 host half (crypto/ed25519.py) against the JAX
package's (crypto/ed25519.py): the RFC 8032 vectors, keys and signatures
byte for byte, decompression (native and Python) on seeded encodings, the
generic kernel's marshalling value for value, and the integer reference
verify over a rejection matrix."""

import binascii
import hashlib

import numpy as np
import pytest

from tests.conftest import require_native

from smartbft_tpu import native as jnative
from smartbft_tpu.crypto import bignum as jbn
from smartbft_tpu.crypto import ed25519 as jed
from smartbft_tpu_torch import native
from smartbft_tpu_torch.crypto import ed25519 as ed

# RFC 8032 §7.1 (secret, public, message, signature), as the JAX test has them
RFC_VECTORS = [
    (
        "9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
        "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
        "",
        "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
        "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b",
    ),
    (
        "4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
        "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
        "72",
        "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
        "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00",
    ),
    (
        "c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
        "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
        "af82",
        "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
        "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a",
    ),
]


@pytest.mark.parametrize("sk,pk,msg,sig", RFC_VECTORS,
                         ids=["msg-empty", "msg-72", "msg-af82"])
def test_rfc8032_vectors(sk, pk, msg, sig):
    sk, pk, msg, sig = (binascii.unhexlify(x) for x in (sk, pk, msg, sig))
    a = ed._clamp(hashlib.sha512(sk).digest()[:32])
    assert ed.compress(ed.scalar_mult_int(a, (ed.BX, ed.BY))) == pk
    assert ed.sign(sk, msg) == sig
    assert ed.sign_raw(sk, msg) == sig
    assert ed.verify_int(pk, msg, sig)


def test_constants_match_the_jax_package():
    for name in ("P", "L", "D", "BX", "BY", "SQRT_M1"):
        assert getattr(ed, name) == getattr(jed, name), name


@pytest.mark.parametrize("seed", [b"a", b"seed-1", b"\x00" * 5])
def test_keygen_and_sign_byte_for_byte(seed):
    priv, pub = ed.keygen(seed)
    assert (priv, pub) == jed.keygen(seed)
    msg = b"payload-" + seed
    assert ed.sign(priv, msg) == jed.sign(priv, msg)
    assert ed.sign_raw(priv, msg) == jed.sign_raw(priv, msg)


def _encodings(seed, count=40):
    """Half valid encodings of multiples of B, half random bytes."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        if i < count // 2:
            k = int.from_bytes(rng.bytes(32), "little") >> 4
            out.append(ed.compress(ed.scalar_mult_int(k, (ed.BX, ed.BY))))
        else:
            out.append(rng.bytes(32))
    return out


@pytest.fixture
def jax_python_decompress(monkeypatch):
    """The JAX package's decompress on its Python path (native bypassed)."""
    monkeypatch.setattr(jnative, "ed_available", lambda: False)
    return jed.decompress


@pytest.mark.parametrize("path", ["python", "native"])
def test_decompress_matches_the_jax_package(jax_python_decompress, path):
    encs = _encodings(5) + [b"\xff" * 32, (1 << 255 | 1).to_bytes(32, "little")]
    want = [jax_python_decompress(e) for e in encs]
    if path == "native":
        require_native(native.ed_available(), "the port's native ed25519 helper")
        assert [native.ed_decompress(e) for e in encs] == want
        assert [ed.decompress(e) for e in encs] == want
    else:
        assert [ed._decompress_py(e) for e in encs] == want
    assert want[-2] is None                      # y >= p
    assert sum(w is None for w in want[20:40]) > 0  # random bytes fail often
    assert all(ed.compress(w) == e for e, w in zip(encs[:20], want[:20]))


def test_decompress_rejects_invalid():
    assert ed.decompress(b"\xff" * 32) is None          # y >= p
    assert ed.decompress(b"\x01" * 31) is None          # wrong length
    # y = 1 gives x = 0, which with the sign bit set is invalid
    assert ed._decompress_py((1 << 255 | 1).to_bytes(32, "little")) is None
    assert ed.decompress((1 << 255 | 1).to_bytes(32, "little")) is None


def _matrix():
    """Ed25519 votes: valid, corrupted S, tampered message, S >= L, an
    undecodable R, an undecodable key, a short signature."""
    keys = [ed.keygen(b"ted-%d" % i) for i in range(3)]
    items = []
    for i in range(9):
        priv, pub = keys[i % 3]
        msg = b"t-%d" % i
        items.append(ed.make_item(msg, ed.sign_raw(priv, msg), pub))
    m, sig, pub = items[1]
    bad_s = (int.from_bytes(sig[32:], "little") + 1) % ed.L
    items[1] = (m, sig[:32] + bad_s.to_bytes(32, "little"), pub)
    m, sig, pub = items[2]
    items[2] = (b"tampered", sig, pub)
    m, sig, pub = items[3]
    items[3] = (m, sig[:32] + (ed.L + 7).to_bytes(32, "little"), pub)
    m, sig, pub = items[4]
    items[4] = (m, b"\xff" * 32 + sig[32:], pub)
    m, sig, _ = items[5]
    items[5] = (m, sig, b"\xff" * 32)
    m, sig, pub = items[6]
    items[6] = (m, sig[:63], pub)
    return items


def test_verify_item_matches_the_jax_package():
    items = _matrix()
    want = [jed.verify_item(it) for it in items]
    assert [ed.verify_item(it) for it in items] == want
    assert want == [True, False, False, False, False, False, False, True,
                    True]


def test_verify_inputs_match_the_jax_package():
    items = _matrix()
    mine = ed.verify_inputs(items)
    theirs = jed.verify_inputs(items)
    for a, b in zip(mine[:6], theirs[:6]):
        assert a.shape == (len(items), 32) and a.dtype == np.uint8
        assert [int.from_bytes(r.tobytes(), "little") for r in a] == \
            [jbn.from_limbs(r) for r in b]
    assert mine[6].dtype == np.int32
    assert mine[6].tolist() == theirs[6].tolist() == \
        [1, 1, 1, 1, 0, 0, 0, 1, 1]
