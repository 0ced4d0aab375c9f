"""The reference's Byzantine-actor cases against the port:
``tests/test_byzantine_actors.py`` (an equivocating leader, a vote
forger, a censoring leader under open-loop load, stale-view replay, a
flood of unique forged messages, and the misbehavior table's units),
compiled against ``smartbft_tpu_torch`` by :mod:`torch_reference` and
collected here as items of their own (``<file stem>__<case>``), under an
exact count guard.  The sync-poisoning round runs its rejoining replica
as a socket replica of the port's ``net.launch``; every case runs under a
time limit of its own.

The censor round has a limit of its own, far below the others': it
drains in seconds since the port drops a lower-view message of the leader
(``tests/test_torch_stale_view.py``), so a stall shows as a failure, not
as a slow pass.

Left out: the latency probe the reference marks slow."""

from torch_reference import case_time_limit, check_matrices, reference_tests

CASES = {"test_byzantine_actors.py": 14}
LEFT_OUT = {"test_byzantine_actors.py": [
    "test_byzantine_latency_probe_pair_and_row"]}
#: the censor round's own limit, in seconds
CENSOR = "test_byzantine_actors__test_censoring_leader_detected_under_" \
    "open_loop_load"
CENSOR_LIMIT = 20

time_limit = case_time_limit(60, {CENSOR: CENSOR_LIMIT})

for _file in CASES:
    globals().update(reference_tests(_file))


def test_reference_matrices_are_whole_and_ported():
    check_matrices(CASES, LEFT_OUT)
    got = reference_tests("test_byzantine_actors.py")
    assert got["test_byzantine_actors__test_vote_forger_is_attributed_"
               "shunned_and_shed"].__globals__["ByzantineActor"].__module__ \
        == "smartbft_tpu_torch.testing.byzantine"


# ----------------------------------------- a fault of both packages, repaired


def _malformed_votes(pkg):
    """A member's vote whose value P-256 cannot read (16 bytes, the
    Byzantine actor's forgery) and an outsider's, through the batch path
    and the single-vote paths of ``pkg``'s P-256 provider (host engine)."""
    import importlib

    provider = importlib.import_module(f"{pkg}.crypto.provider")
    messages = importlib.import_module(f"{pkg}.messages")
    rings = provider.Keyring.generate([1, 2, 3], seed=b"malformed-votes")
    provs = {i: provider.P256CryptoProvider(rings[i]) for i in rings}
    prop = messages.Proposal(header=b"h", payload=b"p", metadata=b"m")
    good = provs[2].sign_proposal(prop, b"a2")
    short = messages.Signature(signer=3, value=b"\x00" * 16,
                               msg=provs[3].sign_proposal(prop, b"a3").msg)
    outsider = messages.Signature(signer=9, value=b"\x00" * 16, msg=good.msg)
    auxes = provs[1].verify_consenter_sigs_batch([good, short, outsider],
                                                 prop)
    for check in (lambda: provs[1].verify_consenter_sig(short, prop),
                  lambda: provs[1].verify_signature(short)):
        try:
            check()
        except ValueError:
            pass
        else:
            raise AssertionError("a malformed vote verified")
    return auxes, provs[1].invalid_by_signer


def test_a_members_malformed_vote_is_an_invalid_signature():
    """The port attributes a member's unreadable signature value as an
    invalid signature of that member on every path, and only a signer
    outside the membership as an unknown signer.  The JAX package calls
    the member an unknown signer on the batch and consenter paths (its
    ``CryptoProvider._collect`` and ``verify_consenter_sig``), so on real
    P-256 its forgery oracle (``Invariants.forger_shunned_and_shed``)
    never sees the forger's invalid signatures."""
    auxes, by = _malformed_votes("smartbft_tpu_torch")
    assert auxes == [b"a2", None, None]
    assert by == {3: {"invalid_sig": 3}, 9: {"unknown_signer": 1}}
    auxes, by = _malformed_votes("smartbft_tpu")
    assert auxes == [b"a2", None, None]
    assert by == {3: {"unknown_signer": 2, "invalid_sig": 1},
                  9: {"unknown_signer": 1}}


def test_the_censor_limit_names_a_collected_case():
    """The own limit reaches the censor round only while the name is the
    round's item name."""
    assert callable(globals()[CENSOR])
