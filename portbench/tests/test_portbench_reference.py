"""The reference verifiers on known and forged vectors, the signer's
output, and the ledger checker on tampered ledgers."""

import hashlib

import pytest

from portbench import reference, signer
from portbench.traffic import backlog

# RFC 6979 A.2.5: P-256, SHA-256, message "sample"
RFC6979_D = 0xC9AFA9D845BA75166B5C215767B1D6934E50C3DB36E89B127B8A622B120F6721
RFC6979_Q = (0x60FED4BA255A9D31C961EB74C6356D68C049B8923B61FA6CE669622E60F29FB6,
             0x7903FE1008B8BC99A41AE9E95628BC64F2F1B20C2D7E9F5177A3C294D4462299)
RFC6979_SIG = bytes.fromhex(
    "EFD48B2AACB6A8FD1140DD9CD45E81D69D2C877B56AAF991C34D0EA84EAF3716"
    "F7CB1C942D657C41D436C7A1B6E29F65F3E900DBB9AFF4064DC4AB2F843ACDA8")
# RFC 8032 7.1, test 1
RFC8032_PUB = bytes.fromhex(
    "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a")
RFC8032_SIG = bytes.fromhex(
    "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e065224901555fb882"
    "1590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b")


def test_p256_known_answer_and_the_signer_reproduces_it():
    assert reference.p256_verify(RFC6979_Q, b"sample", RFC6979_SIG)
    assert signer.sign_many("p256", RFC6979_D, [b"sample"]) == [RFC6979_SIG]
    assert not reference.p256_verify(RFC6979_Q, b"samplf", RFC6979_SIG)


def test_ed25519_known_answer():
    assert reference.ed25519_verify(RFC8032_PUB, b"", RFC8032_SIG)
    assert not reference.ed25519_verify(RFC8032_PUB, b"x", RFC8032_SIG)


@pytest.mark.parametrize("scheme", ["p256", "ed25519"])
def test_valid_forged_wrong_key_and_malformed(scheme):
    keys = signer.keys(scheme, 2**40 + 3, 2)
    msgs = [b"m-%d" % i for i in range(6)]
    sigs = signer.sign_many(scheme, keys[0][0], msgs)
    verify = reference.VERIFY[scheme]
    assert all(verify(keys[0][1], m, s) for m, s in zip(msgs, sigs))
    assert not any(verify(keys[0][1], m, signer.forge(scheme, s))
                   for m, s in zip(msgs, sigs))
    assert not any(verify(keys[1][1], m, s) for m, s in zip(msgs, sigs))
    assert not verify(keys[0][1], msgs[0], sigs[0][:63])
    assert not verify(keys[0][1], msgs[0], b"\x00" * 64)


def test_keys_and_signatures_follow_the_seed():
    a = signer.keys("p256", 5, 3)
    assert a == signer.keys("p256", 5, 3) and a != signer.keys("p256", 6, 3)
    jobs = [("ed25519", k, [b"a", b"b"]) for k, _ in
            signer.keys("ed25519", 5, 3)]
    assert signer.sign_jobs(jobs, 1) == signer.sign_jobs(jobs, 2)


def test_encodings():
    assert reference.enc_ids([1, 2]) == (b"\x00\x00\x00\x02" + (1).to_bytes(
        8, "big") + (2).to_bytes(8, "big"))
    msg = reference.consenter_sig_msg("ab" * 32, b"aux")
    assert reference.split_consenter_sig_msg(msg) == ("ab" * 32, b"aux")
    with pytest.raises(ValueError):
        reference.split_consenter_sig_msg(msg + b"x")
    reqs = [("c1", "7", b"p" * 64), ("c2", "8", b"")]
    payload = reference.enc_ids([]).replace(b"\x00\x00\x00\x00",
                                            b"\x00\x00\x00\x02") + b"".join(
        reference.enc_bytes(reference.request_bytes(*r)) for r in reqs)
    assert reference.decode_batch(payload) == reqs
    h = hashlib.sha256(reference.CHAIN_SEED + b"p" + b"m").digest()
    assert reference.chain_digest([(b"p", b"m")]) == h
    assert reference.quorum(64) == (43, 21)
    assert reference.quorum(16) == (11, 5)
    assert reference.quorum(4) == (3, 1)


def _ledgers(scheme="p256", n=4, decisions=3, per=3):
    """n identical replica ledgers of ``decisions`` decisions, requests
    numbered from 0, each decision with a quorum of valid votes."""
    keys = signer.keys(scheme, 11, n)
    q, _ = reference.quorum(n)
    led, k = [], 0
    for d in range(decisions):
        reqs = [reference.enc_bytes(reference.request_bytes(
            f"c{i}", str(k + i), b"x")) for i in range(per)]
        k += per
        payload = len(reqs).to_bytes(4, "big") + b"".join(reqs)
        metadata = reference.enc_ids([0, d + 1])
        digest = reference.proposal_digest(b"", payload, metadata, 0)
        sigs = []
        for s in range(1, q + 1):
            msg = reference.consenter_sig_msg(digest, reference.enc_ids([s]))
            sigs.append((s, signer.sign_many(scheme, keys[s - 1][0],
                                             [msg])[0], msg))
        led.append((payload, metadata, sigs, b"", 0))
    return {"nodes": n, "scheme": scheme}, [list(led) for _ in range(n)], \
        keys, k


def _failing(checks):
    return {name for name, value, limit in checks if value > limit}


def test_the_ledger_checker_passes_sound_ledgers():
    cfg, ledgers, keys, acked = _ledgers()
    assert _failing(backlog.check_ledgers(cfg, ledgers, keys, acked, 9, 1)) \
        == set()


def _tamper(kind):
    cfg, ledgers, keys, acked = _ledgers()
    led = ledgers[-1]
    p, m, sigs, h, v = led[1]
    if kind == "altered":
        led[1] = (p[:-1] + b"y", m, sigs, h, v)
    elif kind == "unchanged":
        del led[1]
    elif kind == "duplicate":
        led.insert(1, led[1])
    elif kind == "half_sigs":
        led[1] = (p, m, sigs[: len(sigs) // 2], h, v)
    elif kind == "forged_vote":
        s, val, msg = sigs[0]
        led[1] = (p, m, [(s, signer.forge("p256", val), msg)] + sigs[1:], h, v)
        ledgers = [led] * len(ledgers)
    elif kind == "lost_request":
        acked += 1
    return backlog.check_ledgers(cfg, ledgers, keys, acked, 99, 1)


@pytest.mark.parametrize("kind,fires", [
    ("altered", {"replicas_diverged", "votes_not_bound"}),
    ("unchanged", {"replicas_diverged"}),
    ("duplicate", {"replicas_diverged"}),
    ("half_sigs", {"decisions_without_quorum"}),
    ("forged_vote", {"sampled_votes_invalid"}),
    ("lost_request", {"acked_not_once"}),
])
def test_the_ledger_checker_catches_a_tampered_ledger(kind, fires):
    assert _failing(_tamper(kind)) == fires
