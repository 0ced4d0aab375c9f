"""The snapshot rejoin's crash height, in both packages.

``net/cluster.py::run_snapshot_rejoin`` kills a victim replica, grows
the chain until every donor's snapshot horizon has passed the victim's
crash height, respawns it and requires that it rejoined by installing a
donor's snapshot (``snap_chunks_received > 0``).  In its
crash-during-capture round it kills the victim just after the victim's
own snapshot capture lands.  The JAX package takes the crash height from
the victim's last answer over the control channel, which can trail the
decision (and with it the capture) that landed before the kill; donors
whose horizon passed only that answer may sit at the victim's own
snapshot, so the victim replays a short tail instead of fetching a
snapshot, and the oracle fails although nothing went wrong
(``python -m smartbft_tpu.testing.chaos --soak --snapshots``).  The
port reads the crash height off the dead victim's ledger file.

The mechanism is pinned here on a scripted cluster (no processes): each
submitted request commits at the next observation of the cluster, one
decision for everything pending, at every live replica; every 8
decisions a replica captures a snapshot and compacts its ledger to it;
a replica respawns at what it persisted and catches up by snapshot only
if the donors compacted past its height.  The same run goes through both
packages' ``run_snapshot_rejoin``."""

import json
import os
import types

import pytest

from smartbft_tpu.net import cluster as j_cluster
from smartbft_tpu_torch.messages import Proposal
from smartbft_tpu_torch.net import cluster as t_cluster
from smartbft_tpu_torch.net.launch import LedgerFile
from smartbft_tpu_torch.types import Decision

INTERVAL = 8


class ScriptedCluster:
    """The subset of ``SocketCluster`` that ``run_snapshot_rejoin`` uses,
    over replicas whose state is three numbers: height, compaction base
    and snapshot height."""

    def __init__(self, root, n=4):
        self.live = set(range(1, n + 1))
        self.height = dict.fromkeys(self.live, 0)
        self.base = dict.fromkeys(self.live, 0)
        self.snap = dict.fromkeys(self.live, 0)
        self.chunks_received = dict.fromkeys(self.live, 0)
        self.chunks_sent = dict.fromkeys(self.live, 0)
        self.pending = self.committed = 0
        self.control_reads: list = []
        self.replicas = {}
        for i in self.live:
            spec = os.path.join(root, f"spec-{i}.json")
            with open(spec, "w") as fh:
                json.dump({"ledger_path":
                           os.path.join(root, f"ledger-{i}.bin")}, fh)
            self.replicas[i] = types.SimpleNamespace(spec_path=spec)

    def _commit_pending(self):
        if not self.pending:
            return
        for i in self.live:
            self.height[i] += 1
            if self.height[i] - self.snap[i] >= INTERVAL:
                self.snap[i] = self.base[i] = self.height[i]
        self.committed += self.pending
        self.pending = 0

    # -- what run_snapshot_rejoin calls ------------------------------------

    def wait_leader(self):
        return 1

    def live_ids(self):
        return sorted(self.live)

    def submit(self, via, client, rid):
        self.pending += 1

    def wait_committed(self, total, timeout=None, nodes=None):
        self._commit_pending()
        assert self.committed >= total

    def wait_quiescent(self, timeout=None):
        self._commit_pending()

    def heights(self):
        self._commit_pending()
        return {i: self.height[i] for i in self.live}

    def snapshot_stats(self, i):
        self._commit_pending()
        return {"snapshot_height": self.snap[i], "base_height": self.base[i],
                "height": self.height[i]}

    def control(self, i):
        def call(cmd):
            assert cmd == "height"
            self.control_reads.append(self.height[i])
            return {"height": self.height[i]}
        return types.SimpleNamespace(call=call)

    def kill(self, i):
        """SIGKILL: what the replica persisted stays on disk."""
        self.live.discard(i)
        with open(self.replicas[i].spec_path) as fh:
            ledger = LedgerFile(json.load(fh)["ledger_path"])
        ledger.compact(self.base[i], b"\0" * 32,
                       [Decision(proposal=Proposal())]
                       * (self.height[i] - self.base[i]))

    def restart(self, i):
        donors = sorted(self.live)
        self.live.add(i)
        if min(self.base[d] for d in donors) > self.height[i]:
            donor = max(donors, key=lambda d: self.snap[d])
            self.base[i] = self.snap[i] = self.snap[donor]
            self.chunks_received[i] += 2
            self.chunks_sent[donor] += 2
        self.height[i] = self.height[donors[0]]

    def transport_stats(self):
        return {i: {"snap_chunks_received": self.chunks_received[i],
                    "snap_bytes_received": 1024 * self.chunks_received[i],
                    "snap_chunks_sent": self.chunks_sent[i],
                    "sync_poisoned": 0} for i in self.height}

    def check_fork_free(self):
        pass


@pytest.mark.parametrize("crash_during_snapshot", [True, False])
def test_the_crash_height_is_what_the_victim_persisted(tmp_path,
                                                       crash_during_snapshot):
    """Crash during capture: the victim's last control answer is 7 while
    it persisted its own snapshot at 8.  The JAX package takes 7, stops
    growing the chain once the donors' horizon is 8, and its victim then
    replays the tail: its oracle raises.  The port takes 8, grows the
    chain until the donors compact at 16, and its victim installs their
    snapshot.  A plain crash (no capture race) passes in both."""
    outcomes = {}
    for name, mod in (("jax", j_cluster), ("port", t_cluster)):
        root = tmp_path / name
        root.mkdir()
        cluster = ScriptedCluster(str(root))
        try:
            report = mod.run_snapshot_rejoin(
                cluster, warmup=8, history=48,
                crash_during_snapshot=crash_during_snapshot)
            outcomes[name] = ("ok", report.victim_height_at_kill,
                              report.victim_base_after,
                              report.snap_chunks_received)
        except AssertionError as exc:
            outcomes[name] = ("AssertionError", str(exc).splitlines()[0])
        if crash_during_snapshot:
            assert cluster.control_reads[-1] == 7
    if crash_during_snapshot:
        assert outcomes == {
            "jax": ("AssertionError",
                    "victim caught up without receiving a single snapshot "
                    "chunk"),
            "port": ("ok", 8, 16, 2)}
    else:
        assert outcomes["jax"] == outcomes["port"]
        assert outcomes["port"][0] == "ok" and outcomes["port"][3] > 0
