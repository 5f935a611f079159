"""Server side of the round: the sync, async and buffered round loops, the
staleness buffer, and the arrival-timeline adapter for the legacy failure
modes (ported from ``repro.fl.server``)."""
from repro_torch.fl.server.buffer import PendingUpdate, StalenessBuffer
from repro_torch.fl.server.loops import (SERVER_MODES, AsyncRoundLoop,
                                         RoundLoop, SyncRoundLoop, TimePoint,
                                         make_round_loop)
from repro_torch.fl.server.timeline import TimedFailureAdapter

__all__ = [
    "PendingUpdate", "StalenessBuffer",
    "SERVER_MODES", "AsyncRoundLoop", "RoundLoop", "SyncRoundLoop",
    "TimePoint", "make_round_loop",
    "TimedFailureAdapter",
]
