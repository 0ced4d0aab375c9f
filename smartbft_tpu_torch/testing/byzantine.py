"""Byzantine actor harness: misbehave ON THE WIRE, assert the
honest majority stays safe AND live.

Every fault the chaos harness injected before this module was *omissive*
(crash, mute, partition) or *accidental* (bit corruption, device faults).
A Byzantine replica is neither: it runs the real stack and uses the
protocol's own seams against it.  :class:`ByzantineActor` wraps ONE
replica of an in-process cluster (``testing.network`` + ``testing.app``)
and arms attack modes at the replica's transport boundary, so everything
past the wire — intake, vote registration, the verify plane, blacklist
recomputation — is the production code path under attack:

- **equivocation** (``equivocate()``): as leader, send a DIFFERENT
  proposal to every follower at the same (view, seq), with matching
  per-target Prepare digests and genuinely re-signed per-target Commits
  (the actor owns its signing key — the signatures verify; the lie is the
  content).  With per-target-unique variants no digest can reach a
  prepare quorum, so honest replicas stall, complain, and view-change the
  liar out; the send log feeds the equivocation oracle
  (``chaos.Invariants.no_equivocation_commit``).
- **vote forgery** (``forge_votes()``): flood honest replicas with
  well-formed Commits whose ConsenterSigMsg binds the REAL in-flight
  proposal digest (spied off the leader's PrePrepare) but whose signature
  value is garbage.  Each forged vote passes the binding check and costs
  a verify-plane verdict — the resource the attack aims at — until the
  per-sender invalid-vote accounting (``core.misbehavior``) shuns the
  forger and intake sheds its votes for free.  Unique aux bytes per
  forgery make every message wire-unique, churning the bounded intern /
  sig-msg memos (the ``LruMemo``s) instead of growing them.
- **stale-view replay** (``stale_replay()`` + ``replay_stale()``):
  re-broadcast recorded votes from superseded views.  Honest intake
  counts them observationally per sender (``stale_view`` is an OBSERVED
  cause — honest replicas racing a view change emit the same shape, so
  it never shuns) and the view's own gating drops them pre-verification.
- **leader censorship** (``censor()``): as leader, silently drop
  forwarded client requests from selected clients.  The followers'
  forward/complain machinery must detect the suppression and vote the
  censor out; the new leader orders the victims' requests from the
  followers' pools.

The fifth attack class — **sync poisoning under load** — happens at the
socket replica's state-transfer plane, not the in-process wire, so it
ships as a self-contained scenario (:func:`sync_poison_round`) over
``net.launch.ReplicaApp`` with scripted donors: one liar serving
forged tails and a garbage snapshot offer while honest donors keep
extending their ledgers mid-sync.  Asserts the certificate checks reject
every lie, ``sync_poisoned`` counts the liar (and ONLY the liar), and
the donor-shun threshold stops even asking it.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from dataclasses import dataclass
from typing import Iterable, Optional

from ..codec import decode, encode
from ..crypto.provider import ConsenterSigMsg
from ..messages import Commit, Message, PrePrepare, Prepare, Signature
from ..types import proposal_digest
from .app import App, BatchPayload, TestRequest

__all__ = [
    "ByzantineActor",
    "SendRecord",
    "sync_poison_round",
]


@dataclass
class SendRecord:
    """One equivocation-relevant outbound consensus send — the oracle's
    evidence: which digest this actor told which follower at (view, seq)."""

    target: int
    view: int
    seq: int
    kind: str  # "preprepare" | "prepare" | "commit"
    digest: str
    mutated: bool = False


class ByzantineActor:
    """Arms attack modes on one replica's wire seams.

    Construct over a started (or about-to-start) :class:`testing.app.App`
    and arm any combination of modes.  The actor never touches consensus
    internals — only ``Node.mutate_send`` (outbound), ``Node.filters``
    (inbound spy; always returns True, never vetoes), the network's
    broadcast injection point, and the facade's ``handle_request`` (the
    censorship seam the transport routes forwarded requests through).
    """

    #: bound on retained send-log / spy-history entries — a soak must not
    #: grow oracle evidence without bound
    LOG_CAP = 4096

    def __init__(self, app: App, network) -> None:
        self.app = app
        self.id = app.id
        self.network = network
        self.node = network.nodes[app.id]
        #: oracle evidence: every (mutated or not) PrePrepare/Prepare/
        #: Commit this actor sent while equivocation was armed
        self.send_log: deque[SendRecord] = deque(maxlen=self.LOG_CAP)
        #: (view, seq) -> {target -> variant digest} for armed equivocation
        self._variants: dict[tuple[int, int], dict[int, str]] = {}
        #: (view, seq, digest) of inbound PrePrepares, newest last — the
        #: forgery flood binds REAL digests so forged votes reach the
        #: verify plane instead of dying at the digest-match gate
        self.spied: deque[tuple[int, int, str]] = deque(maxlen=self.LOG_CAP)
        #: recorded inbound votes for stale replay
        self._history: deque[Message] = deque(maxlen=256)
        # armed-mode flags / counters
        self._equivocating = False
        self._flood_per_preprepare = 0
        self._max_forged: Optional[int] = None
        self._record_history = False
        self._censored_clients: frozenset[str] = frozenset()
        self._spy_installed = False
        self.forged = 0
        self.forged_prepares = 0
        self.replayed = 0
        self.censored = 0

    # -- mode arming -------------------------------------------------------

    def equivocate(self) -> "ByzantineActor":
        """As leader, tell every follower a different story per (view,
        seq): per-target proposal variants, matching Prepare digests, and
        re-signed per-target Commits."""
        self._equivocating = True
        self._install_mutator()
        return self

    def forge_votes(self, per_preprepare: int = 3,
                    max_forged: Optional[int] = None) -> "ByzantineActor":
        """Flood ``per_preprepare`` forged Commits at every spied
        PrePrepare (bounded by ``max_forged`` total when given)."""
        self._flood_per_preprepare = per_preprepare
        self._max_forged = max_forged
        self._install_spy()
        return self

    def stale_replay(self, keep: int = 256) -> "ByzantineActor":
        """Start recording inbound votes so :meth:`replay_stale` can
        re-broadcast them after the cluster moves past their view."""
        self._history = deque(maxlen=keep)
        self._record_history = True
        self._install_spy()
        return self

    def censor(self, clients: Iterable[str]) -> "ByzantineActor":
        """As leader, silently drop forwarded requests from ``clients``.
        Direct submissions at honest replicas still pool there — the
        complain machinery must detect the suppression and rotate this
        actor out, at which point the new leader orders them."""
        self._censored_clients = frozenset(clients)
        consensus = self.app.consensus
        orig = consensus.handle_request

        async def censored(sender: int, raw: bytes):
            try:
                cid = self.app.request_id(raw).client_id
            except Exception:  # noqa: BLE001 — undecodable: not a victim
                cid = None
            if cid in self._censored_clients:
                self.censored += 1
                return None
            return await orig(sender, raw)

        consensus.handle_request = censored
        return self

    # -- live injection ----------------------------------------------------

    async def flood_unique_prepares(self, count: int, *,
                                    burst: int = 500) -> None:
        """Broadcast ``count`` wire-unique (unsigned) forged Prepares —
        pure decode-plane pressure: every one churns the bounded intern
        memo; none carries a signature, so none reaches the verify plane.
        The LruMemo flood-bound satellite pins memory stays flat.

        Paced in ``burst``-sized waves with a drain wait between them:
        the in-process inboxes are themselves bounded (INCOMING_BUFFER),
        so a synchronous mega-burst would mostly be dropped at the door —
        that is the OTHER flood defense, not the decode-plane one this
        attack targets."""
        import asyncio

        view, seq = 0, 1
        if self.spied:
            view, seq, _ = self.spied[-1]
        peers = [n for n in self.network._gmap(self.node.group).values()
                 if n.id != self.id]
        sent = 0
        while sent < count:
            for _ in range(min(burst, count - sent)):
                sent += 1
                self.forged_prepares += 1
                p = Prepare(
                    view=view, seq=seq,
                    digest=f"byz-forged-{self.id}-{self.forged_prepares}",
                )
                self.network.broadcast_consensus(self.id, p,
                                                 group=self.node.group)
            while any(n._inbox.qsize() > 0 for n in peers):
                await asyncio.sleep(0)

    def replay_stale(self, current_view: Optional[int] = None) -> int:
        """Re-broadcast every recorded vote from a view strictly below
        ``current_view`` (default: the highest view ever recorded —
        replays everything the cluster has moved past).  Returns how many
        went out."""
        if current_view is None:
            current_view = max(
                (m.view for m in self._history), default=0
            )
        n = 0
        for m in list(self._history):
            if m.view < current_view:
                self.network.broadcast_consensus(self.id, m,
                                                 group=self.node.group)
                n += 1
        self.replayed += n
        return n

    # -- oracle surface ----------------------------------------------------

    def equivocated_slots(self) -> list[tuple[int, int]]:
        """(view, seq) pairs where per-target variants went out."""
        return sorted(self._variants)

    def variant_digests(self, view: int, seq: int) -> dict[int, str]:
        return dict(self._variants.get((view, seq), {}))

    def snapshot(self) -> dict:
        return {
            "id": self.id,
            "equivocated_slots": self.equivocated_slots(),
            "sends_logged": len(self.send_log),
            "forged": self.forged,
            "forged_prepares": self.forged_prepares,
            "replayed": self.replayed,
            "censored": self.censored,
            "spied": len(self.spied),
        }

    # -- seams -------------------------------------------------------------

    def _install_mutator(self) -> None:
        if self.node.mutate_send is not None \
                and self.node.mutate_send is not self._mutate:
            raise RuntimeError(
                f"node {self.id} already has a mutate_send hook installed"
            )
        self.node.mutate_send = self._mutate

    def _install_spy(self) -> None:
        if not self._spy_installed:
            self.node.add_filter(self._spy)
            self._spy_installed = True

    def _log(self, target: int, view: int, seq: int, kind: str,
             digest: str, mutated: bool) -> None:
        self.send_log.append(SendRecord(
            target=target, view=view, seq=seq, kind=kind, digest=digest,
            mutated=mutated,
        ))

    def _mutate(self, target: int, msg: Message) -> Optional[Message]:
        """Outbound hook (the network hands a deep copy — mutating here
        can never leak into another recipient's ingest)."""
        if not self._equivocating:
            return msg
        if isinstance(msg, PrePrepare):
            msg = self._variant_preprepare(target, msg)
            self._log(target, msg.view, msg.seq, "preprepare",
                      proposal_digest(msg.proposal), True)
            return msg
        if isinstance(msg, Prepare):
            d = self._variants.get((msg.view, msg.seq), {}).get(target)
            if d is not None:
                msg = dataclasses.replace(msg, digest=d)
            self._log(target, msg.view, msg.seq, "prepare", msg.digest,
                      d is not None)
            return msg
        if isinstance(msg, Commit):
            d = self._variants.get((msg.view, msg.seq), {}).get(target)
            if d is not None:
                msg = self._resign_commit(msg, d)
            self._log(target, msg.view, msg.seq, "commit", msg.digest,
                      d is not None)
            return msg
        return msg

    def _variant_preprepare(self, target: int, msg: PrePrepare) -> PrePrepare:
        """A per-target proposal variant: the original batch plus one
        forged request unique to this target, so every follower computes
        a different digest for the same (view, seq)."""
        proposal = msg.proposal
        try:
            batch = decode(BatchPayload, proposal.payload)
            requests = list(batch.requests)
        except Exception:  # noqa: BLE001 — unexpected payload: leave it
            return msg
        requests.append(encode(TestRequest(
            client_id=f"byz-{self.id}",
            request_id=f"equiv-{msg.view}-{msg.seq}-{target}",
        )))
        variant = dataclasses.replace(
            proposal, payload=encode(BatchPayload(requests=requests))
        )
        self._variants.setdefault((msg.view, msg.seq), {})[target] = \
            proposal_digest(variant)
        return dataclasses.replace(msg, proposal=variant)

    def _resign_commit(self, commit: Commit, digest: str) -> Commit:
        """Re-sign the per-target digest with the actor's REAL key: the
        signature verifies — equivocation is a content lie, not a crypto
        forgery — so safety must come from quorum intersection, not from
        signature rejection."""
        try:
            aux = decode(ConsenterSigMsg, commit.signature.msg).aux
        except Exception:  # noqa: BLE001 — trivial-crypto cluster
            aux = b""
        msg_bytes = encode(ConsenterSigMsg(proposal_digest=digest, aux=aux))
        sig = Signature(signer=self.id, value=self.app.sign(msg_bytes),
                        msg=msg_bytes)
        return dataclasses.replace(commit, digest=digest, signature=sig)

    def _spy(self, msg: Message, sender: int) -> bool:
        """Inbound filter: record, optionally flood; NEVER vetoes."""
        if isinstance(msg, PrePrepare):
            digest = proposal_digest(msg.proposal)
            self.spied.append((msg.view, msg.seq, digest))
            if self._flood_per_preprepare > 0:
                self._flood(msg.view, msg.seq, digest)
        elif self._record_history and isinstance(msg, (Prepare, Commit)):
            self._history.append(msg)
        return True

    def _flood(self, view: int, seq: int, digest: str) -> None:
        """Broadcast forged Commits binding the real in-flight digest:
        each passes the binding check (the spied digest is genuine) and
        costs the verify plane a verdict; the garbage signature value
        then fails, attributed per-signer to THIS actor.  Unique aux per
        forgery keeps every message wire-unique (memo-churn pressure)."""
        for _ in range(self._flood_per_preprepare):
            if self._max_forged is not None \
                    and self.forged >= self._max_forged:
                return
            self.forged += 1
            aux = b"byz-forged-%d-%d" % (self.id, self.forged)
            msg_bytes = encode(ConsenterSigMsg(
                proposal_digest=digest, aux=aux
            ))
            sig = Signature(signer=self.id, value=b"\x00" * 16,
                            msg=msg_bytes)
            commit = Commit(view=view, seq=seq, digest=digest,
                            signature=sig)
            self.network.broadcast_consensus(self.id, commit,
                                             group=self.node.group)


# ---------------------------------------------------------------- sync poison


def _thin_decision(seq: int, signers=(1, 2)):
    """A decision whose certificate is BELOW quorum — the forged-tail
    material a lying donor serves (continuity is correct, so only the
    certificate check can catch it)."""
    from ..messages import Proposal, ViewMetadata

    raw = encode(TestRequest(client_id="byz", request_id=f"forged-{seq}",
                             payload=b"x"))
    md = ViewMetadata(view_id=1, latest_sequence=seq)
    prop = Proposal(header=b"", payload=encode(BatchPayload(requests=[raw])),
                    metadata=encode(md), verification_sequence=0)
    sigs = [Signature(signer=i, value=b"sig-%d" % i, msg=b"")
            for i in signers]
    return prop, sigs


def _committed_history(depth: int, members=(1, 2, 3, 4)):
    """Full-quorum committed decisions 1..depth (the honest donors'
    ledger) — same wire shapes a live cluster commits."""
    from ..messages import Proposal, ViewMetadata
    from ..types import Decision

    out = []
    for seq in range(1, depth + 1):
        raw = encode(TestRequest(client_id="cli", request_id=f"r-{seq}",
                                 payload=b"p"))
        md = ViewMetadata(view_id=1, latest_sequence=seq)
        prop = Proposal(header=b"",
                        payload=encode(BatchPayload(requests=[raw])),
                        metadata=encode(md), verification_sequence=0)
        sigs = tuple(Signature(signer=i, value=b"sig-%d" % i, msg=b"")
                     for i in members)
        out.append(Decision(proposal=prop, signatures=sigs))
    return out


async def sync_poison_round(root: str, *, depth: int = 8, extra: int = 4,
                            liar: int = 2) -> dict:
    """One sync-poisoning-under-load scenario against a real
    ``net.launch.ReplicaApp`` rejoiner (height 0):

    - donor ``liar`` serves forged tails (thin certificates) on its first
      two answers, then an empty tail with a garbage snapshot offer —
      three distinct poisoning shapes;
    - the honest donors keep APPENDING while the rejoiner syncs (each
      answer serves a longer tail than the last — the open-load race);
    - a second sync pass (after the cluster commits ``extra`` more
      decisions) must not even ask the liar: its poisoning streak crossed
      ``SYNC_DONOR_SHUN_THRESHOLD``.

    Returns the observation dict the tier-1 test and the ``--byzantine``
    matrix both assert on.  Wall clock, bounded by the scripted donors —
    cheap to await from a soak round or a test body.
    """
    import os
    from types import SimpleNamespace

    from ..net.framing import WireDecision
    from ..net.launch import SYNC_DONOR_SHUN_THRESHOLD, ReplicaApp

    members = (1, 2, 3, 4)
    base = str(root)
    spec = {
        "node_id": 1,
        "peers": {i: f"uds:{base}/n{i}.sock" for i in members if i != 1},
        "listen": f"uds:{base}/n1.sock",
        "ledger_path": os.path.join(base, "ledger-1.bin"),
        "wal_dir": os.path.join(base, "wal-1"),
    }
    history = _committed_history(depth + extra, members)
    calls = {p: 0 for p in members if p != 1}
    liar_calls = {"sync": 0}
    # the donors' visible height: honest answers keep extending it — the
    # rejoiner races live commits exactly like a real rejoin under load
    served = {"h": depth}

    def _wire(ds):
        return [WireDecision(proposal=d.proposal,
                             signatures=list(d.signatures)) for d in ds]

    async def fake_sync(peer, from_height, timeout=1.0):
        calls[peer] += 1
        if peer == liar:
            liar_calls["sync"] += 1
            if liar_calls["sync"] <= 2:
                # forged tail: correct continuity, thin certificates
                tail = []
                for seq in range(from_height + 1, from_height + 4):
                    prop, sigs = _thin_decision(seq)
                    tail.append(WireDecision(proposal=prop,
                                             signatures=sigs))
                return SimpleNamespace(decisions=tail, snapshot_height=0,
                                       snapshot_bytes=0)
            # then: nothing to serve but a (garbage) snapshot offer
            return SimpleNamespace(decisions=[],
                                   snapshot_height=from_height + 5,
                                   snapshot_bytes=1000)
        h = served["h"]
        tail = _wire(history[from_height:h])
        served["h"] = min(len(history), h + 2)
        return SimpleNamespace(decisions=tail, snapshot_height=0,
                               snapshot_bytes=0)

    async def fake_fetch(peer, height, chunk_bytes=0):
        return b"not a snapshot"  # fails blob integrity -> poisoned

    r = ReplicaApp(spec)
    r._recover_local_state()
    r.transport.request_sync = fake_sync
    r.transport.fetch_snapshot = fake_fetch
    try:
        await r._sync_over_wire()
        height_pass1 = r.height()
        liar_asks_pass1 = calls[liar]
        # the cluster keeps committing; the rejoiner syncs again — the
        # liar's streak crossed the threshold, so it is not even asked
        served["h"] = len(history)
        await r._sync_over_wire()
        return {
            "height_pass1": height_pass1,
            "height": r.height(),
            "target_height": len(history),
            "sync_poisoned": dict(r.sync_poisoned),
            "metrics_poisoned": r.transport.metrics.sync_poisoned,
            "liar": liar,
            "liar_asks_pass1": liar_asks_pass1,
            "liar_asks_total": calls[liar],
            "honest_asks": {p: c for p, c in calls.items() if p != liar},
            "shun_threshold": SYNC_DONOR_SHUN_THRESHOLD,
        }
    finally:
        r.ledger_file.close()
