"""An abort frees a View parked in its decide rendezvous.

``View._decide`` hands the decision to the controller and waits for its
delivery.  The controller resolves that wait from the same loop that
processes abort events, so when a view change queues an abort ahead of
the decision, ``Controller._abort_view`` awaits the view's task while the
view waits for the controller: a deadlock.  The deposed leader of the
chaos censor round hung so, in view 0, after its commit quorum for the
last decision it proposed.  ``WindowedView._decide`` already races the
rendezvous against abort; the port's ``View._decide`` now does the same.
The decision stays queued at the controller, which delivers it once the
abort has finished."""

import asyncio

from smartbft_tpu_torch.core.view import ViewAborted
from smartbft_tpu_torch.messages import Signature
from torch_reference import case_time_limit, reference_tests

time_limit = case_time_limit(30)

_units = reference_tests("test_view_units.py")[
    "test_view_units__test_wrong_view_from_non_leader_is_not_fatal"
].__globals__
make_view, proposal_for = _units["make_view"], _units["proposal_for"]


class _ParkedDecider:
    """A controller whose delivery never comes."""

    def __init__(self):
        self.calls = 0
        self.fut = None

    async def decide(self, proposal, signatures, requests):
        self.calls += 1
        self.fut = asyncio.get_running_loop().create_future()
        await self.fut


class _Decider:
    def __init__(self):
        self.decided = []

    async def decide(self, proposal, signatures, requests):
        self.decided.append([s.signer for s in signatures])


async def _deciding(v):
    """``View._run``'s handling of the decide step."""
    try:
        await v._decide(proposal_for(v), [], [])
    except ViewAborted:
        return "aborted"
    return "decided"


def test_an_abort_frees_a_view_parked_in_its_decide():
    async def run():
        v = make_view()
        v.decider = _ParkedDecider()
        v.my_proposal_sig = Signature(signer=2, value=b"v", msg=b"m")
        v._task = asyncio.ensure_future(_deciding(v))
        for _ in range(5):
            await asyncio.sleep(0)
        assert v.decider.calls == 1 and not v._task.done()
        await asyncio.wait_for(v.abort(), timeout=5.0)
        assert v._task.result() == "aborted"
        assert v.stopped()
        assert v.proposal_sequence == 6  # the next sequence was prepared
        # the controller completes the parked rendezvous later: harmless
        v.decider.fut.set_result(None)
        await asyncio.sleep(0)

    asyncio.run(run())


def test_a_decide_that_is_delivered_returns_as_before():
    async def run():
        v = make_view()
        v.decider = _Decider()
        v.my_proposal_sig = Signature(signer=2, value=b"v", msg=b"m")
        assert await _deciding(v) == "decided"
        assert v.decider.decided == [[2]]
        assert not v.stopped()
        # a later abort ends a view that is not deciding
        v._task = None
        await v.abort()
        assert v.stopped()

    asyncio.run(run())
