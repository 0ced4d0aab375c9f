"""Mesh-sharded signature verification and the distributed quorum step.

Design notes (one process, several devices):

* A :class:`Mesh` is an array of ``torch.device`` with axis names.  A
  mesh launch puts each device's tile on that device and launches the
  scheme's kernel there, under ``torch.cuda.device(d)`` and on that
  device's current stream; every tile is launched before any verdict is
  read back, so the cards run together.
* Verification lanes are independent: a tile runs the route the
  single-device :class:`~smartbft_tpu_torch.crypto.provider.
  TorchVerifyEngine` takes (comb, or generic for an unregistrable key,
  or the pairing kernel), each device with its own comb registry and
  tables, so verdicts are bit-identical to the single-device engine's.
* The quorum step is the one place a cross-device reduction exists: the
  per-device weighted vote counts sum over the 'vote' mesh axis
  (``torch.cuda.comm.reduce_add`` for CUDA tensors, a plain sum on the
  CPU) — one integer per in-flight sequence.
* :func:`~smartbft_tpu_torch.utils.torchenv.force_cpu` gives the tests N
  virtual CPU devices; each tile then runs its kernel's plain version.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..crypto import p256
from ..crypto.provider import (
    _ROUTES,
    MeshVerifyStats,
    TorchVerifyEngine,
    on_device,
)
from ..utils.torchenv import visible_devices


class Mesh:
    """Devices laid out on named axes: ``devices`` is a numpy object array
    of ``torch.device`` whose shape gives one length an axis."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of rank {devices.ndim} needs as many "
                             f"axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat(self) -> list:
        """The devices in row-major order (device ``i`` of a launch)."""
        return list(self.devices.reshape(-1))


def shard_map_available() -> bool:
    """Capability probe kept under the JAX package's name: the port's
    quorum step is plain torch on each device and needs no optional API,
    so it is always available."""
    return True


def build_mesh(shape: Optional[tuple[int, ...]] = None,
               axis_names: tuple[str, ...] = ("lane",),
               devices=None) -> Mesh:
    """A :class:`Mesh` over the first prod(shape) devices.

    Default: all visible devices (:func:`~smartbft_tpu_torch.utils.
    torchenv.visible_devices`) on a 1D 'lane' axis.  For the quorum step
    pass ``shape=(seq_par, vote_par)`` and ``axis_names=('seq', 'vote')``.
    """
    devices = list(visible_devices() if devices is None else devices)
    if shape is None:
        shape = (len(devices),)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n} devices, "
                         f"have {len(devices)}")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devices[:n]):
        grid[i] = torch.device(d)
    return Mesh(grid.reshape(shape), axis_names)


def _route(scheme):
    """The scheme's kernels: its CUDA routes, else (the toy scheme of the
    tests) its own host marshalling and torch kernel, as the JAX package's
    mesh engines run ``scheme.verify_kernel``."""
    route = _ROUTES.get(scheme)
    if route is None and hasattr(scheme, "verify_inputs") \
            and hasattr(scheme, "verify_kernel"):
        route = (None, scheme.verify_inputs, scheme.verify_kernel)
    return route


def _sum_on(parts: list, device) -> torch.Tensor:
    """Sum equal-shape tensors that live on the mesh's devices into one on
    ``device`` (the cross-device sum over the 'vote' axis)."""
    if len(parts) == 1:
        return parts[0]
    if all(p.is_cuda for p in parts) \
            and len({p.device for p in parts}) == len(parts):
        return torch.cuda.comm.reduce_add(parts, destination=device.index)
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return total


class ShardedVerifyEngine(TorchVerifyEngine):
    """:class:`TorchVerifyEngine` with batch lanes sharded over a 1D mesh.

    Same engine surface, so it plugs into ``CryptoProvider`` and the async
    coalescer unchanged.  Pad sizes are rounded up to multiples of the mesh
    size so every device gets an equal tile; a chunk's padded rows split
    into contiguous tiles, one launch a device.
    """

    def __init__(self, mesh=None,
                 pad_sizes: tuple[int, ...] = (64, 256, 1024), scheme=p256,
                 metrics=None):
        self.mesh = mesh if mesh is not None else build_mesh()
        if len(self.mesh.axis_names) != 1:
            raise ValueError("ShardedVerifyEngine wants a 1D mesh; use "
                             "quorum_decide for 2D (seq x vote) meshes")
        self.lanes = self.mesh.size
        rounded = sorted({-(-s // self.lanes) * self.lanes for s in pad_sizes})
        self._init_plane(self.mesh.flat(), rounded, scheme, metrics,
                         _route(scheme))

    def _place(self, a) -> list:
        """Split the padded rows of ``a`` into one equal tile a device and
        put each tile on its device."""
        tiles = np.split(np.asarray(a), self.lanes)
        return [torch.from_numpy(np.ascontiguousarray(t)).to(d)
                for t, d in zip(tiles, self._devices)]

    def _tiles(self, n: int, size: int) -> list:
        """Item indices of each device's tile, in lane order: contiguous
        rows ``[d * per_dev, (d + 1) * per_dev)``."""
        per_dev = size // self.lanes
        return [list(range(d * per_dev, min((d + 1) * per_dev, n)))
                for d in range(self.lanes)]

    def _verify_chunk(self, items) -> list[bool]:
        n = len(items)
        size = self._pad_to(n)
        per_dev = size // self.lanes
        t0 = time.perf_counter()
        tiles = self._tiles(n, size)
        launched = []
        for d, idx in enumerate(tiles):
            with on_device(self._devices[d]):
                launched.append(self._launch(d, [items[i] for i in idx],
                                             per_dev))
        out = [False] * n
        for idx, (mask, _) in zip(tiles, launched):
            for i, v in zip(idx, mask.cpu().tolist()):
                out[i] = bool(v)
        self._record(n, size, time.perf_counter() - t0,
                     [route for _, route in launched],
                     self._per_device(tiles))
        return out

    def _per_device(self, tiles) -> Optional[list]:
        return None  # VerifyStats: no per-device accounting


class MeshUnavailable(RuntimeError):
    """The configured verify mesh cannot be built on this host (fewer
    visible devices than requested).  The wiring seam
    (``CryptoProvider.configure_verify_mesh``) catches this and keeps the
    single-device engine LOUDLY with a counted downgrade — a
    mis-provisioned host degrades to reduced width instead of dying."""


def mesh_device_count() -> int:
    """Visible device count (0 when none is visible)."""
    try:
        return len(visible_devices())
    except Exception:  # noqa: BLE001 — capability probe, never fatal
        return 0


#: default per-device lane ladder for the graduated mesh engine: each
#: device contributes a fixed lane budget, so aggregate per-launch
#: capacity scales linearly with the mesh width
MESH_PER_DEVICE_LANES = (8, 64, 512, 2048)


def _mesh_devices(devices: Optional[int], what: str) -> list:
    """The first ``devices`` visible devices (all when 0 or None); raises
    :class:`MeshUnavailable` when the host has fewer."""
    avail = visible_devices()
    want = len(avail) if not devices else int(devices)
    if want < 1 or want > len(avail):
        raise MeshUnavailable(f"{what} wants {want} device(s), host has "
                              f"{len(avail)}")
    return avail[:want]


class MeshVerifyEngine(ShardedVerifyEngine):
    """The graduated live-path mesh engine.

    Each coalesced wave is padded to a device-count multiple, split along
    the batch axis into one tile a device, and verified in ONE logical
    launch that spans the whole mesh (one kernel launch a device);
    per-item verdicts come back to the host in submission order and the
    coalescer slices them per submitter/tag exactly as on the
    single-device engine.  Construction raises :class:`MeshUnavailable`
    when the host has fewer visible devices than requested — the wiring
    seam turns that into a loud counted downgrade, never a crash.

    ``pad_sizes=None`` derives a ladder of ``MESH_PER_DEVICE_LANES`` lanes
    PER DEVICE, so per-launch capacity (``pad_sizes[-1]``) scales with the
    mesh width; an explicit ladder is rounded up to device multiples like
    any :class:`ShardedVerifyEngine`.  ``stats`` is a
    :class:`~smartbft_tpu_torch.crypto.provider.MeshVerifyStats`:
    per-launch per-device fill and pad waste ride every record, exported
    through ``AsyncBatchCoalescer.mesh_snapshot``.

    **Strided placement**: items round-robin over devices (item *j* lands
    in device ``j % D``'s tile) instead of filling devices front to back,
    so pad slots spread evenly; per-device item counts differ by at most
    one.  Verification lanes are independent, so the permutation cannot
    change any verdict; results un-permute before slicing.
    """

    #: which mesh shape this engine runs (the 2D seq×vote engine says
    #: "2d"); configure_verify_mesh keys idempotence on (devices, topology)
    topology = "1d"

    def __init__(self, devices: Optional[int] = None, mesh=None,
                 pad_sizes: Optional[tuple[int, ...]] = None, scheme=p256,
                 metrics=None):
        if mesh is None:
            avail = _mesh_devices(devices, "verify mesh")
            mesh = build_mesh((len(avail),), ("batch",), devices=avail)
        n_dev = mesh.size
        if pad_sizes is None:
            pad_sizes = tuple(lanes * n_dev for lanes in MESH_PER_DEVICE_LANES)
        super().__init__(mesh=mesh, pad_sizes=tuple(pad_sizes), scheme=scheme,
                         metrics=metrics)
        #: mesh width — the attribute the wiring seam keys idempotence on
        #: (FaultyEngine delegates it, so a fault-wrapped mesh still reads
        #: as "already graduated")
        self.devices = self.lanes
        self.stats = MeshVerifyStats(devices=self.devices, metrics=metrics)

    def mesh_snapshot(self) -> dict:
        """JSON-able block: devices, per-launch fill per device, pad
        waste — the engine half of the coalescer's ``mesh`` block."""
        out = self.stats.mesh_block(capacity=self.pad_sizes[-1])
        out["topology"] = self.topology
        return out

    def _tiles(self, n: int, size: int) -> list:
        """Strided tiles: item *j* goes to padded row ``(j % D) * per_dev
        + j // D``, so device *d*'s tile holds items ``d, d+D, d+2D, ...``
        and pad rows stay zero (they verify False and are never read)."""
        d_count = self.devices
        return [list(range(d, n, d_count)) for d in range(d_count)]

    def _per_device(self, tiles) -> list:
        return [len(idx) for idx in tiles]


class QuorumMeshVerifyEngine(TorchVerifyEngine):
    """2D (seq x vote) mesh engine: live cluster waves through the quorum
    step.

    A coalesced cluster flush holds commit votes for one or more in-flight
    sequences (each vote's message bytes identify its sequence).  This
    engine groups the flush into a (seq_tile x vote_tile) quorum block —
    one row per distinct message — and runs ONE mesh step per block: each
    device verifies its tile of the block in one launch, weighs its
    verdicts (1 for a distinct vote, 0 for a duplicate or a pad cell),
    sums them per row, and the rows' counts sum across the 'vote' mesh
    axis (the quorum-decision reduction of :func:`quorum_decide`).
    Per-item verdicts feed the protocol's certificate construction
    unchanged; the per-sequence counts are exposed via :attr:`last_counts`
    and checked against host-side tallies in the tests.

    Padding cells replicate a real item of the same block with weight 0,
    so they cannot inflate counts and every tile has a fixed shape.

    Selectable through ``Configuration.verify_mesh_topology = "2d"`` via
    the same ``CryptoProvider.configure_verify_mesh`` seam as the 1D
    engine — construction from a ``devices`` count builds the (seq × vote)
    mesh (vote axis 2-wide on even widths) and raises
    :class:`MeshUnavailable` on narrower hosts (a loud downgrade at the
    seam).
    """

    topology = "2d"

    def __init__(self, devices: Optional[int] = None, mesh=None,
                 quorum: int = 3, seq_tile: int = 8,
                 vote_tile: int = 16, scheme=p256, metrics=None):
        if mesh is None:
            avail = _mesh_devices(devices, "2d verify mesh")
            want = len(avail)
            vote_par = 2 if want % 2 == 0 else 1
            mesh = build_mesh((want // vote_par, vote_par), ("seq", "vote"),
                              devices=avail)
        if tuple(mesh.axis_names) != ("seq", "vote"):
            raise ValueError("QuorumMeshVerifyEngine wants a ('seq','vote') mesh")
        self.mesh = mesh
        seq_par, vote_par = (int(x) for x in mesh.devices.shape)
        self._seq_par, self._vote_par = seq_par, vote_par
        self.seq_tile = -(-seq_tile // seq_par) * seq_par
        self.vote_tile = -(-vote_tile // vote_par) * vote_par
        self.quorum = quorum
        self._init_plane(mesh.flat(), (self.seq_tile * self.vote_tile,),
                         scheme, metrics, _route(scheme))
        #: mesh width — the attribute configure_verify_mesh keys
        #: idempotence on (together with ``topology``)
        self.devices = seq_par * vote_par
        self.stats = MeshVerifyStats(devices=self.devices, metrics=metrics)
        #: mesh quorum steps executed (each = one sum over 'vote')
        self.psum_steps = 0
        #: message bytes -> summed valid-vote count, from the last flush
        self.last_counts: dict[bytes, int] = {}
        #: message bytes -> count >= quorum, the mesh-side quorum decision
        self.last_decided: dict[bytes, bool] = {}

    def mesh_snapshot(self) -> dict:
        """The engine half of the ``mesh`` block (same schema as the 1D
        engine, plus the quorum-step count)."""
        out = self.stats.mesh_block(capacity=self.pad_sizes[-1])
        out["topology"] = self.topology
        out["psum_steps"] = self.psum_steps
        return out

    def _probe_item(self):
        sk, pub = self.scheme.keygen(b"quorum-mesh-probe")
        return self.scheme.make_item(b"p", self.scheme.sign_raw(sk, b"p"), pub)

    def _step(self, flat: list, weights: np.ndarray):
        """One quorum step over a (seq_tile x vote_tile) block given as
        ``flat`` row-major items: device (i, j) launches the block's rows
        ``i * rows_per_dev ...`` by votes ``j * votes_per_dev ...``, weighs
        and sums its rows, then each row group's counts sum over the
        'vote' axis.  Every tile launches before anything is read back.
        Returns ((seq_tile, vote_tile) verdicts, (seq_tile,) counts) on
        the host and the device launches' routes."""
        rpd = self.seq_tile // self._seq_par
        vpd = self.vote_tile // self._vote_par
        grid = np.arange(self.seq_tile * self.vote_tile).reshape(
            self.seq_tile, self.vote_tile)
        masks, local, routes = {}, {}, []
        for i in range(self._seq_par):
            for j in range(self._vote_par):
                d = i * self._vote_par + j
                dev = self._devices[d]
                cells = grid[i * rpd:(i + 1) * rpd, j * vpd:(j + 1) * vpd]
                with on_device(dev):
                    mask, route = self._launch(
                        d, [flat[c] for c in cells.reshape(-1)], rpd * vpd)
                    mask = mask.reshape(rpd, vpd).to(torch.int32)
                    w = torch.from_numpy(np.ascontiguousarray(
                        weights[i * rpd:(i + 1) * rpd,
                                j * vpd:(j + 1) * vpd])).to(dev)
                    local[i, j] = (mask * w).sum(-1)
                masks[i, j] = mask
                routes.append(route)
        counts = [_sum_on([local[i, j] for j in range(self._vote_par)],
                          self._devices[i * self._vote_par])
                  for i in range(self._seq_par)]
        mask2d = np.concatenate([
            np.concatenate([masks[i, j].cpu().numpy()
                            for j in range(self._vote_par)], axis=1)
            for i in range(self._seq_par)])
        return mask2d, np.concatenate([c.cpu().numpy() for c in counts]), \
            routes

    def verify(self, items) -> list[bool]:
        if not items:
            return []
        # group the flush into rows by message; rows with more votes than
        # the tile split across rows (verdicts stay exact; the split rows'
        # counts are partial and merged host-side below)
        rows: list[tuple[bytes, list[int]]] = []
        by_msg: dict[bytes, int] = {}
        counted: set = set()  # distinct items whose lane weights count
        duplicate_lanes: set[int] = set()
        for idx, it in enumerate(items):
            msg = it[0]
            # duplicate votes (colocated replicas re-checking the same
            # signature in an un-deduped flush) get verified lanes but
            # weight 0, so the summed quorum count tallies DISTINCT valid
            # votes; unhashable scheme items degrade to counting all
            try:
                if it in counted:
                    duplicate_lanes.add(idx)
                else:
                    counted.add(it)
            except TypeError:
                pass
            at = by_msg.get(msg)
            if at is None or len(rows[at][1]) >= self.vote_tile:
                by_msg[msg] = len(rows)
                rows.append((msg, [idx]))
            else:
                rows[at][1].append(idx)

        out = [False] * len(items)
        self.last_counts = {}
        t0 = time.perf_counter()
        lanes = 0
        routes: list = []
        # exact per-device REAL-item counts under the (seq x vote) tile
        # mapping: device (r-tile, v-tile) owns rows_per_dev x
        # votes_per_dev cells of each block — the honest fill vector
        dev_counts = [0] * self.devices
        rows_per_dev = self.seq_tile // self._seq_par
        votes_per_dev = self.vote_tile // self._vote_par
        for off in range(0, len(rows), self.seq_tile):
            block = rows[off : off + self.seq_tile]
            flat: list = []
            weights = np.zeros((self.seq_tile, self.vote_tile), np.int32)
            for r in range(self.seq_tile):
                idxs = block[r][1] if r < len(block) else []
                fill = items[idxs[0]] if idxs else (
                    items[block[0][1][0]] if block else self._probe_item()
                )
                for v in range(self.vote_tile):
                    if v < len(idxs):
                        flat.append(items[idxs[v]])
                        if idxs[v] not in duplicate_lanes:
                            weights[r, v] = 1
                    else:
                        flat.append(fill)
            mask2d, counts, step_routes = self._step(flat, weights)
            routes += step_routes
            self.psum_steps += 1
            lanes += self.seq_tile * self.vote_tile
            with self._lock:
                size = self.seq_tile * self.vote_tile
                self.rung_launches[size] = self.rung_launches.get(size, 0) + 1
            for r, (msg, idxs) in enumerate(block):
                for v, idx in enumerate(idxs):
                    out[idx] = bool(mask2d[r, v])
                    dev_counts[(r // rows_per_dev) * self._vote_par
                               + (v // votes_per_dev)] += 1
                self.last_counts[msg] = (
                    self.last_counts.get(msg, 0) + int(counts[r])
                )
        self.last_decided = {
            m: c >= self.quorum for m, c in self.last_counts.items()
        }
        with self._lock:
            self.stats.record(len(items), lanes, time.perf_counter() - t0,
                              per_device=dev_counts)
            for route in routes:
                self.route_launches[route] += 1
        return out


def quorum_decide(mesh, quorum: int, scheme=p256):
    """The distributed quorum step: (S, V, ...) vote block -> (S,) decided.

    Shards sequences over 'seq' and votes over 'vote'; each device runs the
    scheme's generic verify kernel on its tile (one launch), then vote
    counts sum across the 'vote' axis.  Returns a function over the
    scheme's generic-route inputs (``p256.verify_bytes``,
    ``ed25519.verify_inputs``, ``cuda_bls.verify_words``, or the toy
    scheme's ``verify_inputs``) reshaped to (S, V, ...), numpy or torch;
    it returns a (S,) bool tensor on the CPU.

    Scheme-generic: inputs may be per-vote vectors (rank 3 as a quorum
    block) or per-vote scalars like the host-validity masks of ed25519 and
    bls12381 (rank 2).
    """
    if tuple(mesh.axis_names) != ("seq", "vote"):
        raise ValueError("quorum_decide wants a ('seq', 'vote') mesh")
    route = _route(scheme)
    if route is None:
        raise ValueError(f"quorum_decide: no kernels for scheme "
                         f"{getattr(scheme, '__name__', scheme)}")
    kernel = route[2]
    seq_par, vote_par = (int(x) for x in mesh.devices.shape)

    def decide(*arrays):
        ranks = tuple(np.ndim(a) for a in arrays)
        if any(r not in (2, 3) for r in ranks):
            raise ValueError(f"quorum-block inputs must be rank 2 or 3, got {ranks}")
        arrays = [torch.as_tensor(a) for a in arrays]
        s_len, v_len = arrays[0].shape[:2]
        if s_len % seq_par or v_len % vote_par:
            raise ValueError(f"a ({s_len}, {v_len}) block does not tile a "
                             f"({seq_par}, {vote_par}) mesh")
        rpd, vpd = s_len // seq_par, v_len // vote_par
        local = {}
        for i in range(seq_par):
            for j in range(vote_par):
                dev = mesh.devices[i, j]
                with on_device(dev):
                    tile = [a[i * rpd:(i + 1) * rpd, j * vpd:(j + 1) * vpd]
                            .reshape((rpd * vpd,) + tuple(a.shape[2:]))
                            .contiguous().to(dev) for a in arrays]
                    local[i, j] = kernel(*tile).reshape(rpd, vpd) \
                        .to(torch.int32).sum(-1)
        counts = [_sum_on([local[i, j] for j in range(vote_par)],
                          mesh.devices[i, 0]).cpu()
                  for i in range(seq_par)]
        return torch.cat(counts) >= quorum

    return decide
