"""Real-socket transport + multi-process replica cluster.

The library's embedder supplies the transport (layer L4, ``Comm``); this
package is one: an asyncio TCP / Unix-domain-socket implementation of the
:class:`smartbft_tpu_torch.api.Comm` SPI, plus a process-per-replica
launcher, so the engine can leave the single-process box.

Layout:

* :mod:`framing`   — length-prefixed frame format over the canonical
  ``messages.wire_of`` encoding, incremental :class:`FrameDecoder`,
  handshake / sync / snapshot / reject / read wire messages;
* :mod:`transport` — :class:`SocketComm`: encode-once broadcast,
  per-wave write coalescing (one flush per outbox drain), wave-batched
  ingest (one ``handle_message_batch`` per read), reconnect with
  exponential backoff + jitter, bounded outboxes with counted drops;
* :mod:`cluster`   — :class:`SocketCluster`: spawns one OS process per
  replica (``python -m smartbft_tpu_torch.net.launch``) sharing only key
  material and a peer address map; control-channel client; socket-level
  chaos runner speaking the ``testing.chaos.ChaosEvent`` vocabulary
  (SIGKILL, link drop, slow link);
* :mod:`launch`    — the replica process entry point.

A graceful close shuts the connections a server accepted before it
awaits the server's ``wait_closed()``, which since Python 3.12 waits for
them (``SocketComm.close``, ``launch.ControlServer.close``).
"""

from .framing import (
    FrameDecoder,
    FrameError,
    encode_frame,
    parse_addr,
)
from .transport import SocketComm, TransportMetrics

__all__ = [
    "FrameDecoder",
    "FrameError",
    "encode_frame",
    "parse_addr",
    "SocketComm",
    "TransportMetrics",
]
