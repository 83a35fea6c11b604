"""Online sDTW monitoring over the chunk-carry protocol.

``StreamSession`` consumes the reference as an unbounded chunk sequence,
advancing every query's DP carry through the row-scan tile loop or the
hand-written sDTW kernel — distances, spans and top-K matches are
bitwise-identical to ``engine.sdtw`` for any feed partition (int32).
``engine.stream()`` is the front door. ``StreamProfile`` is the
incremental matrix profile. Not ported yet: ``ShardedStreamSession``
(ROADMAP queue 1 item 12).
"""
from .profile import StreamProfile
from .session import (DEFAULT_STREAM_CHUNK, AlertEvent, StreamResult,
                      StreamSession)

__all__ = ["StreamSession", "StreamResult", "AlertEvent", "StreamProfile",
           "DEFAULT_STREAM_CHUNK"]
