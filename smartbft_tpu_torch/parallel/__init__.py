"""Device-mesh parallelism for the crypto plane.

The reference scales by adding replicas (one process each); its only
in-process parallelism is goroutine fan-out per signature
(internal/bft/view.go:537-541).  Here the same work is data parallel over
kernel lanes, so it spreads over the cards of one host from ONE process:
a mesh launch puts one tile on each device and launches it there, and
the one cross-device reduction, the quorum vote count, is a sum on a
device — no process group is needed.

Three products:

* :class:`ShardedVerifyEngine` — a drop-in verify engine (same surface as
  ``TorchVerifyEngine``) whose batch lanes split over a 1D device mesh,
  one launch a device; verification is embarrassingly parallel until the
  final host-side mask read.
* :func:`quorum_decide` — the 2D (seq x vote) quorum step: each device
  verifies its (sequences, votes) tile, vote counts sum over the 'vote'
  axis, and the decided mask splits over 'seq'.
* :class:`QuorumMeshVerifyEngine` — that quorum step as a LIVE verify
  engine: selectable through ``Configuration.verify_mesh_topology =
  "2d"`` on the same ``verify_mesh_devices`` knob path as
  :class:`MeshVerifyEngine`, with per-item verdicts bit-identical to the
  1D engine and per-sequence vote counts summed on the devices.
"""

from .engine import (
    MeshUnavailable,
    MeshVerifyEngine,
    QuorumMeshVerifyEngine,
    ShardedVerifyEngine,
    build_mesh,
    mesh_device_count,
    quorum_decide,
    shard_map_available,
)

__all__ = [
    "MeshUnavailable",
    "MeshVerifyEngine",
    "QuorumMeshVerifyEngine",
    "ShardedVerifyEngine",
    "build_mesh",
    "mesh_device_count",
    "quorum_decide",
    "shard_map_available",
]
