"""Wire frames of the socket transport.

Only :mod:`.framing` is part of the port so far: the length-prefixed
frame format, the incremental :class:`FrameDecoder` and the handshake,
sync, snapshot, reject and read wire messages.  The in-process test
application's read surface (``testing.app.App.serve_read``) answers with
its :class:`~.framing.ReadResponse`.  The transport, the multi-process
cluster and the replica launcher are not ported yet.
"""

from .framing import (
    FrameDecoder,
    FrameError,
    encode_frame,
    parse_addr,
)

__all__ = [
    "FrameDecoder",
    "FrameError",
    "encode_frame",
    "parse_addr",
]
