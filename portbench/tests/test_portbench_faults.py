"""``correct`` comes out false when the timed path is broken underneath.

Each case drives the rest of a run (the harness's look for a card is
skipped) with one fault planted under the timed path; ``accept`` and
``duplicate`` are the controls of the sidecar and the backlog cells.  On
the CPU the cells run at n = 4 with small pools on the kernels' plain
versions; the ``gpu`` cases run each cell's control at the cell's own size
on three seeds."""

import pytest

from portbench import run

SMALL = {
    "sidecar": {"channels": 2, "outstanding": 2, "decisions_per_channel": 3,
                "forged_one_in": 8, "warmup_s": 1.0, "warm_rungs": [8, 32],
                "reference_sample": {"valid": 6, "forged": 2}},
    "backlog": {"pooled": 40, "feed_chunk": 20, "warm_decisions": 2,
                "warm_rungs": [8, 32], "quorum_sample": 2,
                "drain_timeout_s": 10.0},
}
CONTROL = {"sidecar": "accept", "backlog": "duplicate"}


def _cpu_run(cells, cell, fault, seed=2**33 + 5):
    kind = cell.split(".")[1]
    return run.run_cell(cells, cell, seed, 3.0, False, device="cpu",
                        workers=1, fault=fault, params=SMALL[kind], nodes=4)


@pytest.mark.parametrize("cell", ["n64-p256.sidecar", "n16-ed25519.backlog"])
def test_a_sound_run_is_correct(cells, cell):
    res = _cpu_run(cells, cell, None)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", [
    ("n64-p256.sidecar", "accept"), ("n64-p256.sidecar", "flip"),
    ("n16-ed25519.sidecar", "half"),
    ("n16-ed25519.backlog", "duplicate"), ("n16-ed25519.backlog", "altered"),
    ("n16-ed25519.backlog", "unchanged"),
    ("n16-ed25519.backlog", "half_sigs"),
])
def test_a_broken_timed_path_is_not_correct(cells, cell, fault):
    res = _cpu_run(cells, cell, fault)
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"])


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2**33 + 101, 2**33 + 102, 2**33 + 103])
@pytest.mark.parametrize("cell", ["n64-p256.sidecar",
                                  "n16-ed25519.sidecar",
                                  "n16-ed25519.backlog"])
def test_the_control_fails_at_the_cells_size(cells, card, cell, seed):
    res = run.run_cell(cells, cell, seed, 5.0, False, device=card,
                       fault=CONTROL[cell.split(".")[1]])
    failing = {c["name"]: c["value"] for c in res["checks"]
               if c["value"] > c["limit"]}
    print(f"CONTROL {cell} {seed} {failing}")
    assert not res["correct"] and failing


def _plane(**change):
    """verify_plane_checks on the counters of a sound P-256 run, with
    ``change`` applied; the names of the checks that fail."""
    from portbench import deploy

    counters = {"route_launches": {"generic": 0}, "slots_used": 96,
                "sigs_verified": 90,
                "kernels": {"comb": (3, 96), "generic": (0, 0),
                            "ed_comb": (0, 0), "ed_generic": (0, 0)}}
    breaker = {"opens": 0, "host_fallback_batches": 0, "launch_failures": 0}
    counters["kernels"].update(change.pop("kernels", {}))
    breaker.update(change)
    return {k for k, v, lim in deploy.verify_plane_checks(
        {"scheme": "p256"}, counters, breaker, 90, kernels=True) if v > lim}


@pytest.mark.parametrize("change,fires", [
    ({}, set()),
    ({"kernels": {"ed_comb": (1, 8)}}, {"other_kernel_launches"}),
    ({"kernels": {"comb": (3, 64)}},
     {"lanes_not_slots", "sigs_outside_lanes"}),
    ({"host_fallback_batches": 1}, {"host_fallback_waves"}),
    ({"opens": 1}, {"breaker_opens"}),
])
def test_the_verify_plane_checks_on_the_cards_counters(change, fires):
    assert _plane(**change) == fires
