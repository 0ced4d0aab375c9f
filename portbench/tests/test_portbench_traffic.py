"""The traffic arithmetic: waves of Q - 1, pool sizes, forged shares and
in-flight counts, on the cells' own parameters."""

import pytest

from portbench import reference, run
from portbench.traffic import sidecar

SIDECARS = {"n64-p256.sidecar": (64, 42, 256 * 42),
            "n16-ed25519.sidecar": (16, 10, 256 * 10)}


@pytest.mark.parametrize("name", sorted(SIDECARS))
def test_sidecar_pool_and_flight_sizes(bench, name):
    _, cell, cfg = run.find_cell(bench, name)
    n, wave, pool = SIDECARS[name]
    p = cell["params"]
    assert cfg["nodes"] == n and reference.quorum(n)[0] - 1 == wave
    assert p["channels"] * p["decisions_per_channel"] * wave == pool
    assert p["forged_one_in"] == 64
    # one group, as many decisions in flight as a replica's pipeline holds,
    # never more than the pool
    assert p["channels"] == 1
    assert p["outstanding"] == cfg["settings"]["pipeline_depth"]
    assert p["outstanding"] <= p["decisions_per_channel"]
    # the rungs warmed are those of a full and a smaller flight
    flight = p["outstanding"] * wave
    rungs = cfg["verify_plane"]["pad_sizes"]
    assert min(r for r in rungs if r >= flight) in p["warm_rungs"]


@pytest.mark.parametrize("name", sorted(SIDECARS))
def test_built_pool_waves_forgeries_and_expected_verdicts(bench, name):
    _, cell, cfg = run.find_cell(bench, name)
    n, wave, _ = SIDECARS[name]
    params = dict(cell["params"], channels=2, decisions_per_channel=6,
                  forged_one_in=8)
    pool = sidecar.build_pool(cfg, params, 2**35 + 1, workers=1)
    q, f = reference.quorum(n)
    total = 2 * 6 * wave
    assert pool["total"] == total
    assert len(pool["forged"]) == total // 8
    forgers = {pool["decisions"][c][j]["sigs"][k][0]
               for c, j, k in pool["forged"]}
    assert len(forgers) <= f and pool["me"] not in forgers
    for row in pool["decisions"]:
        for dec in row:
            signers = [s[0] for s in dec["sigs"]]
            assert len(signers) == wave == len(set(signers))
            assert pool["me"] not in signers
            for (s, msg, aux, value), want in zip(dec["sigs"],
                                                  dec["expected"]):
                digest, got = reference.split_consenter_sig_msg(msg)
                assert digest == dec["digest"] and got == aux
                assert want in (aux, None)
    again = sidecar.build_pool(cfg, params, 2**35 + 1, workers=2)
    assert again["forged"] == pool["forged"]
    assert [[d["sigs"] for d in r] for r in again["decisions"]] == \
        [[d["sigs"] for d in r] for r in pool["decisions"]]


def test_the_reference_agrees_with_the_pool(bench):
    _, cell, cfg = run.find_cell(bench, "n64-p256.sidecar")
    params = dict(cell["params"], channels=1, decisions_per_channel=4,
                  forged_one_in=8, reference_sample={"valid": 8, "forged": 4})
    pool = sidecar.build_pool(cfg, params, 77, workers=1)
    assert sidecar.reference_check(cfg, pool, params, 77) == 0
    for c, j, k in pool["forged"]:  # a pool that expects forgeries to pass
        dec = pool["decisions"][c][j]
        dec["expected"][k] = dec["sigs"][k][2]
    assert sidecar.reference_check(cfg, pool, params, 77) == 4


@pytest.mark.parametrize("name", ["n16-ed25519.backlog"])
def test_backlog_keeps_two_pipelines_of_batches_pooled(cells, name):
    _, cell, cfg = run.find_cell(cells, name)
    s, p = cfg["settings"], cell["params"]
    assert p["pooled"] >= 2 * s["pipeline_depth"] * s["request_batch_max_count"]
    assert p["pooled"] < s["request_pool_size"]
    assert p["warm_decisions"] >= s["pipeline_depth"]
    assert cfg["request_payload_bytes"] == 64
