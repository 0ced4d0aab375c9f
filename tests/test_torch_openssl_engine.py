"""The port's OpenSSL verify engine held against the JAX package's.

``smartbft_tpu_torch.crypto.openssl_engine.OpenSSLVerifyEngine`` is the
port's CPU baseline and the oracle every signature kernel's verdicts are
held to on the card.  On numpy-seeded waves of P-256 and Ed25519 votes
(valid ones, a flipped s, a wrong message, an off-curve or undecodable
key, a bad signature) its verdicts must equal the JAX package's engine,
the port's pure-Python ``HostVerifyEngine`` and, on one P-256 tile, the
comb kernel's plain version behind ``TorchVerifyEngine(device="cpu")``.
BLS12-381 has no OpenSSL path in either package."""

import numpy as np
import pytest

from smartbft_tpu.crypto import ed25519 as j_ed
from smartbft_tpu.crypto import p256 as j_p256
from smartbft_tpu.crypto.openssl_engine import OpenSSLVerifyEngine as JEngine
from smartbft_tpu_torch.crypto import bls12381, ed25519, p256
from smartbft_tpu_torch.crypto.openssl_engine import OpenSSLVerifyEngine
from smartbft_tpu_torch.crypto.provider import (
    HostVerifyEngine,
    TorchVerifyEngine,
)


def _p256_wave(seed, count=16):
    """(items, kinds): valid votes and, on seeded lanes, a flipped s, a
    wrong message, an off-curve key, r = 0 and s = n."""
    rng = np.random.default_rng(seed)
    keys = [p256.keygen(b"ossl-%d-%d" % (seed, i)) for i in range(4)]
    items, kinds = [], []
    for k in range(count):
        d, pub = keys[k % 4]
        msg = b"vote-%d-%d" % (seed, rng.integers(1 << 30))
        msg, r, s, pub = p256.make_item(msg, p256.sign_raw(d, msg), pub)
        kind = ["valid", "flip_s", "wrong_msg", "off_curve", "r_zero",
                "s_n"][int(rng.integers(6))] if k >= 4 else "valid"
        if kind == "flip_s":
            s ^= 1 << int(rng.integers(256))
        elif kind == "wrong_msg":
            msg = msg + b"!"
        elif kind == "off_curve":
            pub = (pub[0], (pub[1] + 1) % p256.P)
        elif kind == "r_zero":
            r = 0
        elif kind == "s_n":
            s = p256.N
        items.append((msg, r, s, pub))
        kinds.append(kind)
    return items, kinds


def _ed_wave(seed, count=8):
    """(items, kinds): valid votes and, on seeded lanes, a flipped bit of
    S, a wrong message, an undecodable key and a 63-byte signature."""
    rng = np.random.default_rng(seed)
    keys = [ed25519.keygen(b"ossl-ed-%d-%d" % (seed, i)) for i in range(3)]
    items, kinds = [], []
    for k in range(count):
        priv, pub = keys[k % 3]
        msg = b"ed-vote-%d-%d" % (seed, rng.integers(1 << 30))
        sig = ed25519.sign_raw(priv, msg)
        kind = ["valid", "flip_s", "wrong_msg", "bad_key",
                "short_sig"][int(rng.integers(5))] if k >= 3 else "valid"
        if kind == "flip_s":
            bit = 256 + int(rng.integers(250))
            sig = (int.from_bytes(sig, "little") ^ (1 << bit)).to_bytes(
                64, "little")
        elif kind == "wrong_msg":
            msg = msg + b"!"
        elif kind == "bad_key":
            pub = b"\xff" * 32
        elif kind == "short_sig":
            sig = sig[:63]
        items.append(ed25519.make_item(msg, sig, pub))
        kinds.append(kind)
    return items, kinds


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_p256_verdicts_match_the_jax_engine_and_the_host(seed):
    items, kinds = _p256_wave(seed)
    got = OpenSSLVerifyEngine(scheme=p256).verify(items)
    assert got == JEngine(scheme=j_p256).verify(items)
    assert got == HostVerifyEngine(scheme=p256).verify(items)
    assert got == [k == "valid" for k in kinds]
    assert sum(got) >= 4 and not all(got)


@pytest.mark.parametrize("seed", [3, 4])
def test_ed25519_verdicts_match_the_jax_engine_and_the_host(seed):
    items, kinds = _ed_wave(seed)
    got = OpenSSLVerifyEngine(scheme=ed25519).verify(items)
    assert got == JEngine(scheme=j_ed).verify(items)
    assert got == HostVerifyEngine(scheme=ed25519).verify(items)
    assert got == [k == "valid" for k in kinds]
    assert sum(got) >= 3 and not all(got)


def test_a_p256_tile_matches_the_comb_kernels_plain_version():
    """One four-lane tile on the comb route: OpenSSL's verdicts are the
    plain comb version's, lane for lane."""
    items, kinds = _p256_wave(5)
    tile = [items[0]] + [it for it, k in zip(items, kinds)
                         if k in ("flip_s", "wrong_msg", "r_zero")][:3]
    assert len(tile) == 4
    engine = TorchVerifyEngine(device="cpu", pad_sizes=(4,))
    got = engine.verify(tile)
    assert engine.route_launches == {"comb": 1, "generic": 0}
    assert got == OpenSSLVerifyEngine(scheme=p256).verify(tile)
    assert got == [True, False, False, False]


def test_bad_signature_lengths_never_reach_the_engine():
    """A P-256 signature value that is not 64 bytes fails the scheme's
    ``make_item`` in both packages; an Ed25519 one reaches the engine and
    fails there."""
    d, pub = p256.keygen(b"ossl-len")
    sig = p256.sign_raw(d, b"m")
    for mod in (p256, j_p256):
        with pytest.raises(ValueError, match="bad signature length"):
            mod.make_item(b"m", sig[:63], pub)
    priv, epub = ed25519.keygen(b"ossl-len")
    short = ed25519.make_item(b"m", ed25519.sign_raw(priv, b"m")[:63], epub)
    for engine in (OpenSSLVerifyEngine(scheme=ed25519), JEngine(scheme=j_ed)):
        assert engine.verify([short]) == [False]


def test_keys_are_cached_per_engine():
    """Every key that decodes is built once and kept; an off-curve one is
    rejected without entering the cache."""
    items, kinds = _p256_wave(6)
    engine = OpenSSLVerifyEngine(scheme=p256)
    engine.verify(items)
    assert set(engine._key_cache) == {
        pub for (_, _, _, pub), k in zip(items, kinds) if k != "off_curve"}
    assert engine.stats.sigs_verified == len(items)


def test_bls12381_has_no_openssl_engine():
    from smartbft_tpu.crypto import bls12381 as j_bls

    with pytest.raises(ValueError, match="p256 and ed25519"):
        OpenSSLVerifyEngine(scheme=bls12381)
    with pytest.raises(ValueError, match="p256 and ed25519"):
        JEngine(scheme=j_bls)
