"""Online sDTW monitoring over the chunk-carry protocol.

``StreamSession`` consumes the reference as an unbounded chunk sequence,
advancing every query's DP carry through the row-scan tile loop or the
hand-written sDTW kernel — distances, spans and top-K matches are
bitwise-identical to ``engine.sdtw`` for any feed partition (int32).
``engine.stream()`` is the front door. ``StreamProfile`` is the
incremental matrix profile; ``ShardedStreamSession`` streams the
reference through the sharded pipeline of a mesh of ranks.
"""
from .profile import StreamProfile
from .session import (DEFAULT_STREAM_CHUNK, AlertEvent, StreamResult,
                      StreamSession)
from .sharded import ShardedStreamSession

__all__ = ["StreamSession", "ShardedStreamSession", "StreamResult",
           "AlertEvent", "StreamProfile", "DEFAULT_STREAM_CHUNK"]
