"""naive_chain — a minimal hash-chained blockchain embedding smartbft_tpu_torch.

Four in-process nodes order client transactions into blocks chained by
the previous block's digest (the shape of SmartBFT's
``examples/naive_chain``).  Every node implements the WHOLE plugin SPI
itself — Application, Comm, Assembler, Signer, Verifier,
MembershipNotifier, RequestInspector, Synchronizer — over its own
asyncio channel mesh, with zero imports from the
``smartbft_tpu_torch.testing`` harness.  Commit votes carry REAL P-256
signatures through the library's ``P256CryptoProvider``, so this is
also a working template for a production embedding.

:func:`main` builds ONE ``TorchVerifyEngine(scheme=p256, device=...)``
and hands it to every node's provider: the four registered keys take
the comb kernel on the card.  ``device="cpu"`` runs the kernel's plain
torch version; with no card and no ``--device cpu`` it raises, as the
engine does.  ``ChainNode(..., engine=None)`` keeps the provider's own
host engine.

Run:  python -m smartbft_tpu_torch.examples.naive_chain [--device cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import hashlib
import os
import shutil
import tempfile

from smartbft_tpu_torch import wal as walmod
from smartbft_tpu_torch.api import (
    Application,
    Assembler,
    Comm,
    MembershipNotifier,
    RequestInspector,
    Signer,
    Synchronizer,
    Verifier,
)
from smartbft_tpu_torch.codec import decode, encode, wiremsg
from smartbft_tpu_torch.config import Configuration
from smartbft_tpu_torch.consensus import Consensus
from smartbft_tpu_torch.crypto import p256
from smartbft_tpu_torch.crypto.provider import (
    Keyring,
    P256CryptoProvider,
    TorchVerifyEngine,
)
from smartbft_tpu_torch.messages import Message, Proposal, Signature, ViewMetadata
from smartbft_tpu_torch.types import Decision, Reconfig, RequestInfo, SyncResponse
from smartbft_tpu_torch.utils.clock import Scheduler, WallClockDriver
from smartbft_tpu_torch.utils.logging import StdLogger
from smartbft_tpu_torch.utils.memo import BoundedMemo
from smartbft_tpu_torch.utils.tasks import create_logged_task


# --------------------------------------------------------------------------
# wire types owned by the application (the library never sees their schema)
# --------------------------------------------------------------------------

@wiremsg
class Transaction:
    """A client transaction (chain.go's Transaction equivalent)."""

    client_id: str = ""
    tx_id: str = ""
    payload: bytes = b""


@wiremsg
class BlockData:
    transactions: list[bytes] = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.transactions is None:
            object.__setattr__(self, "transactions", [])


@wiremsg
class BlockHeader:
    sequence: int = 0
    prev_hash: bytes = b""
    data_hash: bytes = b""


# --------------------------------------------------------------------------
# the embedder's own transport: an asyncio channel mesh (chain_test.go's
# channel network, re-built here because the library owns no transport)
# --------------------------------------------------------------------------

class ChannelMesh:
    """node-id -> inbox queue; each node drains its own inbox task."""

    def __init__(self) -> None:
        self.inboxes: dict[int, asyncio.Queue] = {}

    def register(self, node_id: int) -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue(maxsize=1000)
        self.inboxes[node_id] = q
        return q

    def node_ids(self) -> list[int]:
        return sorted(self.inboxes.keys())

    def post(self, target: int, item) -> None:
        q = self.inboxes.get(target)
        if q is None:
            return
        try:
            q.put_nowait(item)
        except asyncio.QueueFull:
            pass  # drop on overflow, like any real bounded transport


class NodeComm(Comm):
    """The Comm SPI for one node over the mesh."""

    def __init__(self, self_id: int, mesh: ChannelMesh):
        self.self_id = self_id
        self.mesh = mesh

    def send_consensus(self, target_id: int, msg: Message) -> None:
        self.mesh.post(target_id, ("consensus", self.self_id, msg))

    def send_transaction(self, target_id: int, request: bytes) -> None:
        self.mesh.post(target_id, ("request", self.self_id, request))

    def nodes(self) -> list[int]:
        return self.mesh.node_ids()


# --------------------------------------------------------------------------
# the chain node: implements every remaining SPI interface itself
# --------------------------------------------------------------------------

class ChainNode(Application, Assembler, Signer, Verifier, RequestInspector,
                Synchronizer, MembershipNotifier):
    """One replica of the blockchain (node.go:90-273 equivalent)."""

    def __init__(self, node_id: int, mesh: ChannelMesh, scheduler: Scheduler,
                 keyring: Keyring, wal_dir: str, pipeline: int = 1,
                 engine=None):
        self.id = node_id
        self.pipeline = pipeline
        self.mesh = mesh
        self.scheduler = scheduler
        self.comm = NodeComm(node_id, mesh)
        # engine=None: the provider's own host engine; main() passes one
        # TorchVerifyEngine shared by every node
        self.crypto = P256CryptoProvider(keyring, engine=engine)
        # the View's batched-verify seam goes through the provider too
        self.verify_consenter_sigs_batch = self.crypto.verify_consenter_sigs_batch
        self.verify_consenter_sigs_batch_async = (
            self.crypto.verify_consenter_sigs_batch_async
        )
        self.wal_dir = wal_dir
        self.logger = StdLogger(f"chain-{node_id}")
        self._request_id_cache: BoundedMemo = BoundedMemo()
        self.blocks: list[tuple[BlockHeader, list[bytes], tuple[Signature, ...]]] = []
        self.decisions: list[Decision] = []  # full committed decisions
        self.block_listeners: list[asyncio.Queue] = []
        self.consensus: Consensus | None = None
        # register in the mesh at construction: every node must see the full
        # membership via Comm.nodes() before any consensus instance starts
        self._inbox: asyncio.Queue = mesh.register(node_id)
        self._inbox_task: asyncio.Task | None = None
        self._wal = None
        # Pipelined-embedder pattern: with pipeline_depth > 1 the leader
        # assembles block s+1 BEFORE block s delivers, so a hash-chained
        # application must chain on its PENDING ladder (assembled/verified
        # headers above the delivered tip), not on the delivered tip alone.
        # seq -> BlockHeader; pruned at delivery, branches above a
        # re-verified sequence dropped (a view change may replace an
        # uncommitted block, invalidating everything chained on it).
        self._pending_headers: dict[int, BlockHeader] = {}

    # -- Application -------------------------------------------------------

    #: in-memory ledger append — lets the controller deliver inline
    blocking_deliver = False

    def deliver(self, proposal: Proposal, signatures) -> Reconfig:
        header = decode(BlockHeader, proposal.header)
        data = decode(BlockData, proposal.payload)
        self.blocks.append((header, list(data.transactions), tuple(signatures)))
        self.decisions.append(
            Decision(proposal=proposal, signatures=tuple(signatures))
        )
        for s in [s for s in self._pending_headers if s <= len(self.blocks)]:
            del self._pending_headers[s]
        for q in self.block_listeners:
            q.put_nowait((header, list(data.transactions)))
        return Reconfig(in_latest_decision=False)

    # -- Assembler ---------------------------------------------------------

    def _tip_hash_at(self, seq: int) -> bytes | None:
        """Hash of the chain header AT ``seq`` — delivered or pending —
        or None when this node doesn't know it (catch-up handles that)."""
        if seq == 0:
            return b"genesis"
        if seq <= len(self.blocks):
            return hashlib.sha256(encode(self.blocks[seq - 1][0])).digest()
        pending = self._pending_headers.get(seq)
        if pending is not None:
            return hashlib.sha256(encode(pending)).digest()
        return None

    def _remember_header(self, header: BlockHeader) -> None:
        """Record a pending (assembled/verified) header — bounded to the
        window above the delivered tip so a bogus far-future sequence can
        never poison the ladder or grow it without bound."""
        if not (len(self.blocks) < header.sequence
                <= len(self.blocks) + max(self.pipeline, 1)):
            return
        existing = self._pending_headers.get(header.sequence)
        if existing is not None and existing != header:
            # a superseded branch: everything chained above it is invalid
            for s in [s for s in self._pending_headers if s > header.sequence]:
                del self._pending_headers[s]
        self._pending_headers[header.sequence] = header

    def assemble_proposal(self, metadata: bytes, requests) -> Proposal:
        payload = encode(BlockData(transactions=list(requests)))
        # the consensus core tells us which sequence this proposal will
        # occupy (ViewMetadata.latest_sequence) — deriving it from the
        # pending ladder instead would let a stale entry from an abandoned
        # proposal (view change before commit) skip a height
        md = decode(ViewMetadata, metadata)
        next_seq = md.latest_sequence
        # re-proposing at a height supersedes anything remembered at or
        # above it (only possible after a view change abandoned it)
        for s in [s for s in self._pending_headers if s >= next_seq]:
            del self._pending_headers[s]
        prev_hash = self._tip_hash_at(next_seq - 1)
        if prev_hash is None:  # a leader always has its own frontier's context
            raise ValueError(f"assembling at {next_seq} without chain context")
        header = BlockHeader(
            sequence=next_seq,
            prev_hash=prev_hash,
            data_hash=hashlib.sha256(payload).digest(),
        )
        self._remember_header(header)
        return Proposal(
            header=encode(header),
            payload=payload,
            metadata=metadata,
            verification_sequence=self.verification_sequence(),
        )

    # -- Signer / Verifier: crypto via the library provider, semantics ours --

    def sign(self, data: bytes) -> bytes:
        return self.crypto.sign(data)

    def sign_proposal(self, proposal: Proposal, auxiliary_input: bytes) -> Signature:
        return self.crypto.sign_proposal(proposal, auxiliary_input)

    def verify_proposal(self, proposal: Proposal) -> list[RequestInfo]:
        header = decode(BlockHeader, proposal.header)
        data = decode(BlockData, proposal.payload)
        if header.data_hash != hashlib.sha256(proposal.payload).digest():
            raise ValueError("block data hash mismatch")
        if proposal.verification_sequence != self.verification_sequence():
            raise ValueError("wrong verification sequence")
        # chain linkage: the proposal must extend the chain at its height —
        # the delivered tip, or (pipelined mode) a pending verified header
        # above it.  Unknown heights pass here and are handled by catch-up.
        expected_prev = self._tip_hash_at(header.sequence - 1)
        if expected_prev is not None:
            if header.prev_hash != expected_prev:
                raise ValueError("block does not extend the chain tip")
            # remember only VERIFIED linkage: an unknown height must stay
            # transient (catch-up handles it), or a bogus far sequence
            # could sit in the ladder forever
            self._remember_header(header)
        return [self.request_id(r) for r in data.transactions]

    def verify_request(self, raw_request: bytes) -> RequestInfo:
        return self.request_id(raw_request)

    def verify_consenter_sig(self, signature: Signature, proposal: Proposal) -> bytes:
        return self.crypto.verify_consenter_sig(signature, proposal)

    def verify_signature(self, signature: Signature) -> None:
        self.crypto.verify_signature(signature)

    def verification_sequence(self) -> int:
        return 0  # static membership: the config epoch never advances

    def requests_from_proposal(self, proposal: Proposal) -> list[RequestInfo]:
        data = decode(BlockData, proposal.payload)
        return [self.request_id(r) for r in data.transactions]

    def auxiliary_data(self, msg: bytes) -> bytes:
        return self.crypto.auxiliary_data(msg)

    # -- RequestInspector --------------------------------------------------

    def request_id(self, raw_request: bytes) -> RequestInfo:
        # bounded memo: the inspector sees the same bytes at submit,
        # proposal verification, and removal
        def compute() -> RequestInfo:
            tx = decode(Transaction, raw_request)
            return RequestInfo(client_id=tx.client_id, request_id=tx.tx_id)

        return self._request_id_cache.get_or(raw_request, compute)

    # -- MembershipNotifier ------------------------------------------------

    def membership_change(self) -> bool:
        return False

    # -- Synchronizer ------------------------------------------------------

    def sync(self) -> SyncResponse:
        """Naive, like the reference example: report the local tip with its
        original metadata and signatures (a real embedder fetches missing
        blocks from peers here)."""
        if not self.decisions:
            return SyncResponse(latest=Decision(proposal=Proposal()),
                                reconfig=Reconfig(in_latest_decision=False))
        return SyncResponse(latest=self.decisions[-1],
                            reconfig=Reconfig(in_latest_decision=False))

    # -- lifecycle ---------------------------------------------------------

    async def _serve_inbox(self) -> None:
        while True:
            item = await self._inbox.get()
            if item is None:
                return
            kind, sender, payload = item
            if self.consensus is None:
                continue
            if kind == "consensus":
                self.consensus.handle_message(sender, payload)
            else:
                await self.consensus.handle_request(sender, payload)

    def _latest_metadata(self) -> tuple[ViewMetadata, Proposal, list[Signature]]:
        if not self.decisions:
            return ViewMetadata(), Proposal(), []
        latest = self.decisions[-1]
        md = (decode(ViewMetadata, latest.proposal.metadata)
              if latest.proposal.metadata else ViewMetadata())
        return md, latest.proposal, list(latest.signatures)

    async def start(self) -> None:
        # a logged task: the package's rule for every background task, so
        # an inbox loop that dies is never silent
        self._inbox_task = create_logged_task(
            self._serve_inbox(), name=f"chain-inbox-{self.id}",
            logger=self.logger,
        )
        self._wal, entries = walmod.initialize_and_read_all(self.wal_dir, self.logger)
        md, last_proposal, last_sigs = self._latest_metadata()
        self.consensus = Consensus(
            config=self._config(),
            application=self,
            assembler=self,
            wal=self._wal,
            wal_initial_content=entries,
            comm=self.comm,
            signer=self,
            verifier=self,
            membership_notifier=self,
            request_inspector=self,
            synchronizer=self,
            logger=self.logger,
            metadata=md,
            last_proposal=last_proposal,
            last_signatures=last_sigs,
            scheduler=self.scheduler,
            viewchanger_tick_interval=0.2,
            heartbeat_tick_interval=0.2,
        )
        await self.consensus.start()

    async def stop(self) -> None:
        if self.consensus is not None:
            await self.consensus.stop()
        if self._inbox_task is not None:
            # await (not put_nowait): a flooded bounded inbox would raise
            # QueueFull and leave the task unjoined / the WAL open
            await self._inbox.put(None)
            await self._inbox_task
            self._inbox_task = None
        if self._wal is not None:
            self._wal.close()

    def _config(self) -> Configuration:
        # pipeline >= 2 runs the pipelined in-flight window (rotation-off
        # mode): the leader keeps k blocks outstanding so consecutive
        # blocks' quorum waves coalesce into shared verify launches
        pipe = (
            dict(leader_rotation=False, decisions_per_leader=0,
                 pipeline_depth=self.pipeline)
            if self.pipeline > 1 else {}
        )
        return Configuration(
            self_id=self.id,
            request_batch_max_count=10,
            request_batch_max_interval=0.05,
            request_forward_timeout=2.0,
            request_complain_timeout=4.0,
            request_auto_remove_timeout=30.0,
            view_change_resend_interval=1.0,
            view_change_timeout=10.0,
            leader_heartbeat_timeout=15.0,
            leader_heartbeat_count=10,
            collect_timeout=1.0,
            sync_on_start=False,
            **pipe,
        )

    async def submit(self, client_id: str, tx_id: str, payload: bytes) -> None:
        tx = encode(Transaction(client_id=client_id, tx_id=tx_id, payload=payload))
        await self.consensus.submit_request(tx)


def verify_chain(node: "ChainNode") -> None:
    """Assert every block's prev_hash links to its predecessor's header —
    the chain-integrity check shared by the demo and the tests."""
    for i in range(1, len(node.blocks)):
        prev_hdr = node.blocks[i - 1][0]
        want = hashlib.sha256(encode(prev_hdr)).digest()
        assert node.blocks[i][0].prev_hash == want, f"chain broken at {i}!"


# --------------------------------------------------------------------------
# demo main: 4 nodes, 10 blocks, chain-link verification
# --------------------------------------------------------------------------

async def main(num_blocks: int = 10, device: str = "cuda",
               engine=None) -> list[ChainNode]:
    """Order ``num_blocks`` one-transaction blocks on 4 nodes whose commit
    votes verify through ONE ``TorchVerifyEngine`` on ``device`` (or the
    P-256 ``engine`` given instead), check every chain's links, re-verify
    every commit signature offline through the same provider surface,
    and return the (stopped) nodes."""
    scheduler = Scheduler()
    driver = WallClockDriver(scheduler, tick_interval=0.01)
    mesh = ChannelMesh()
    keyrings = Keyring.generate([1, 2, 3, 4], seed=b"naive-chain")
    if engine is None:
        engine = TorchVerifyEngine(scheme=p256, device=device)
    tmp = tempfile.mkdtemp(prefix="naive_chain_wal_")

    nodes = [
        ChainNode(i, mesh, scheduler, keyrings[i], os.path.join(tmp, f"wal-{i}"),
                  engine=engine)
        for i in range(1, 5)
    ]
    driver.start()
    for n in nodes:
        await n.start()

    listener: asyncio.Queue = asyncio.Queue()
    nodes[0].block_listeners.append(listener)

    print(f"chain started: 4 nodes, real P-256 votes on "
          f"{getattr(engine, 'device', type(engine).__name__)}, "
          f"leader={nodes[0].consensus.get_leader_id()}")
    for k in range(num_blocks):
        await nodes[0].submit("alice", f"txn-{k}", payload=f"transfer #{k}".encode())
        header, txns = await asyncio.wait_for(listener.get(), timeout=30)
        tx = decode(Transaction, txns[0])
        print(
            f"block {header.sequence}: prev={header.prev_hash.hex()[:12]} "
            f"txns={len(txns)} first={tx.client_id}:{tx.tx_id}"
        )

    # every node delivers the whole chain (followers may trail the
    # listener's node by a few loop turns), then verify chain links +
    # re-verify every commit signature offline
    for _ in range(3000):
        if all(len(n.blocks) >= num_blocks for n in nodes):
            break
        await asyncio.sleep(0.01)
    verifier = P256CryptoProvider(keyrings[2], engine=engine)
    for node in nodes:
        verify_chain(node)
    n_sigs = 0
    for decision in nodes[0].decisions:
        assert len(decision.signatures) >= 3  # quorum for n=4
        for sig in decision.signatures:
            verifier.verify_consenter_sig(sig, decision.proposal)
            n_sigs += 1
    heights = [len(n.blocks) for n in nodes]
    print(f"chain verified: heights={heights}, "
          f"{n_sigs} commit signatures re-verified offline")

    for n in nodes:
        await n.stop()
    await driver.stop()
    shutil.rmtree(tmp, ignore_errors=True)
    return nodes


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args()
    asyncio.run(main(args.blocks, args.device))
