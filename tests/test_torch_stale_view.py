"""A lower-view message of the current leader is dropped by the port.

The facade routes ViewChange / ViewData / NewView to the view changer's
queue and PrePrepare / Prepare / Commit to the view's, so a message the
new leader sent in view 0 can reach a replica after that leader's NewView
for view 1.  The reference's ``View._process_msg`` then complains alone
and stops the view, and the replica's pool timers stay stopped: in the
chaos censor round the deposed leader never forwarded the requests it had
acked (ROADMAP Queue 3).  The port drops such a message instead: it is
stale, harmless to safety, and no sign of a faulty leader.  A message of
a higher view from the leader still complains and syncs, as in the
reference (``test_view_units.py::test_higher_view_from_leader_triggers_
sync`` runs unchanged in ``tests/test_torch_ref_units.py``).

The cluster case gives the deposed leader a fixed delivery order, from a
seeded network with a hold on one link: the new leader's NewView for
view 1, then that leader's view-0 Prepare and Commit.  Against the
reference's rule it shows the lone complaint, the stopped view and the
stopped pool timers."""

import asyncio
import dataclasses

import pytest

from smartbft_tpu_torch.core.pipeline import WindowedView
from smartbft_tpu_torch.messages import Commit, HeartBeatResponse, Prepare
from smartbft_tpu_torch.testing.app import (
    App,
    SharedLedgers,
    fast_config,
    wait_for,
)
from smartbft_tpu_torch.testing.network import Network
from smartbft_tpu_torch.utils.clock import Scheduler
from torch_reference import case_time_limit, reference_tests

time_limit = case_time_limit(30)

#: the reference's own View fixture, compiled against the port
make_view = reference_tests("test_view_units.py")[
    "test_view_units__test_wrong_view_from_non_leader_is_not_fatal"
].__globals__["make_view"]


class _Complaints:
    def __init__(self):
        self.complaints = []

    def complain(self, view, stop_view):
        self.complaints.append((view, stop_view))


class _Syncs:
    def __init__(self):
        self.syncs = 0

    def sync(self):
        self.syncs += 1


def _windowed_view(number=1, leader_id=1):
    """A port WindowedView over recording fakes (no network, no
    controller), in view ``number`` led by ``leader_id``."""
    wview = reference_tests("test_pipeline.py")
    make_wview = next(iter(wview.values())).__globals__["make_wview"]
    v = make_wview(self_id=2, leader_id=leader_id, proposal_sequence=5)
    assert isinstance(v, WindowedView)
    v.number = number
    v.failure_detector = _Complaints()
    v.synchronizer = _Syncs()
    return v


# ------------------------------------------------------------ the views

@pytest.mark.parametrize("kind", [Prepare, Commit])
def test_a_lower_view_message_of_the_leader_is_dropped(kind):
    """``test_view_units.py::test_wrong_view_from_leader_complains_and_
    stops`` on the port: the leader's view-0 message reaches its view-1
    View and is dropped, with no complaint, no stop and no sync."""
    v = make_view()
    msg = Prepare(view=0, seq=5, digest="d") if kind is Prepare else \
        Commit(view=0, seq=5, digest="d")
    v._process_msg(1, msg)
    assert v.failure_detector.complaints == []
    assert not v.stopped()
    assert v.synchronizer.syncs == 0
    assert len(v.prepares) == 0 and len(v.commits) == 0


@pytest.mark.parametrize("msg_view, complaints, syncs, stopped", [
    (0, [], 0, False),
    (2, [(1, False)], 1, True),
])
def test_the_windowed_view_applies_the_same_rule(msg_view, complaints,
                                                 syncs, stopped):
    v = _windowed_view()
    v._process_msg(1, Prepare(view=msg_view, seq=5, digest="d"))
    assert v.failure_detector.complaints == complaints
    assert v.synchronizer.syncs == syncs
    assert v.stopped() is stopped


# ------------------------------------------------------- the cluster

def _config(i):
    return dataclasses.replace(fast_config(i), leader_rotation=False,
                               decisions_per_leader=0)


async def _stale_after_new_view(root, seed):
    """Leader 1 commits one request in view 0 while the link 2 -> 1 holds
    every view-0 vote of replica 2.  Leader 1 is then muted until every
    replica installs view 1 (leader 2), so replica 1 processes replica
    2's NewView first; then the held view-0 votes of its new leader are
    released to it.  Returns what replica 1 did with them and whether
    the cluster commits a request submitted at replica 1 afterwards."""
    scheduler = Scheduler()
    network = Network(seed=seed)
    shared = SharedLedgers()
    apps = [App(i, network, shared, scheduler, wal_dir=f"{root}/wal-{i}",
                config=_config(i))
            for i in range(1, 5)]
    for a in apps:
        await a.start()
    held = []

    def hold(msg, source):
        if source == 2 and isinstance(msg, (Prepare, Commit)) \
                and msg.view == 0:
            held.append(msg)
            return False
        return True

    replica = network.nodes[1]
    replica.add_filter(hold)
    try:
        await apps[1].submit("c", "before")
        await wait_for(lambda: all(len(a.ledger()) >= 1 for a in apps),
                       scheduler, 30.0)
        network.mute(1)
        await wait_for(
            lambda: all(a.consensus.controller.curr_view_number == 1
                        and a.consensus.controller.curr_view is not None
                        for a in apps),
            scheduler, 120.0)
        network.unmute(1)
        consensus = apps[0].consensus
        complaints = []
        complain = consensus.complain
        consensus.complain = lambda view, stop: (
            complaints.append((view, stop)), complain(view, stop))[-1]
        answers = []
        send = network.send_consensus
        network.send_consensus = lambda src, dst, m, *a, **k: (
            answers.append((src, dst)) if isinstance(m, HeartBeatResponse)
            else None, send(src, dst, m, *a, **k))[-1]
        view = consensus.controller.curr_view
        replica.clear_filters()
        for msg in held:
            send(2, 1, msg)
        for _ in range(8):
            await asyncio.sleep(0)
            scheduler.advance_by(0.05)
            await asyncio.sleep(0.001)
        out = {
            "held": [(type(m).__name__, m.view) for m in held],
            "complaints": complaints,
            "view_stopped": view.stopped(),
            "pool_timers_stopped": consensus.pool._stopped,
            "view": consensus.controller.curr_view_number,
            "heartbeat_answers_by_1": [a for a in answers if a[0] == 1],
        }
        await apps[0].submit("c", "after")
        try:
            await wait_for(lambda: all(len(a.ledger()) >= 2 for a in apps),
                           scheduler, 60.0)
        except TimeoutError:
            out["views_after"] = "no commit within 60 logical s"
        else:
            out["views_after"] = [a.consensus.controller.curr_view_number
                                  for a in apps]
        return out
    finally:
        for a in apps:
            await a.stop()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_a_stale_vote_of_the_new_leader_after_its_new_view_is_dropped(
        tmp_path, seed):
    """The deposed leader's replica gets its new leader's NewView, then
    that leader's view-0 Prepare and Commit.  It neither complains nor
    stops its view, its pool timers keep running, its leader monitor does
    not answer the stale votes, and a request it takes afterwards commits
    everywhere in view 1."""
    out = asyncio.run(_stale_after_new_view(str(tmp_path), seed))
    assert out["held"] == [("Prepare", 0), ("Commit", 0)], out
    assert out["complaints"] == [], out
    assert out["view_stopped"] is False, out
    assert out["pool_timers_stopped"] is False, out
    assert out["view"] == 1, out
    assert out["heartbeat_answers_by_1"] == [], out
    assert out["views_after"] == [1, 1, 1, 1], out
