"""The parts of ``repro/obs/telemetry.py`` the ported round runs on: the
drop-cause outcome vocabulary, ``beta_row`` and the disabled hub
``NULL_TELEMETRY``.  The live ``Telemetry`` hub and its sinks are not ported
yet; ``FFTRunner`` refuses a config that turns telemetry on.

Every client has exactly one terminal outcome per round:

  ``not_selected``     the server never contacted the client this round
  ``link_down``        selected, but the failure model reported the link down
  ``missed_deadline``  selected and up, but the upload landed too late
  ``buffered``         async modes: the upload is parked for a later round
  ``evicted``          the upload aged past the staleness horizon
  ``aggregated``       the upload reached the strategy's aggregation step

The disabled hub is a no-op whose methods do nothing and which is *falsy*,
so instrumentation sites guard record-building work with ``if tel:``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

# ---------------------------------------------------------------------------
# drop-cause / outcome vocabulary
# ---------------------------------------------------------------------------
NOT_SELECTED = "not_selected"
SKIPPED_STRAGGLER = "skipped_straggler"
LINK_DOWN = "link_down"
MISSED_DEADLINE = "missed_deadline"
BUFFERED = "buffered"
EVICTED = "evicted"
AGGREGATED = "aggregated"

OUTCOMES = (NOT_SELECTED, SKIPPED_STRAGGLER, LINK_DOWN, MISSED_DEADLINE,
            BUFFERED, EVICTED, AGGREGATED)
# a buffered upload can only ever resolve to one of these
RESOLUTIONS = (AGGREGATED, EVICTED)


def beta_row(beta: float, *, role: str = "client",
             client: Optional[int] = None,
             origin_round: Optional[int] = None,
             staleness: Optional[int] = None,
             rung: Optional[str] = None,
             distortion: Optional[float] = None) -> Dict[str, Any]:
    """One participant's actually-applied aggregation weight.

    ``role`` is ``"server"``, ``"comp"`` (compensatory model), or
    ``"client"``; client rows carry the id and, when known, the origin
    round, staleness, codec rung, and distortion the weight was computed
    under — the renderer's β-mass-by-staleness/rung tables group on these.
    """
    row: Dict[str, Any] = {"role": role, "beta": float(beta)}
    if client is not None:
        row["client"] = int(client)
    if origin_round is not None:
        row["origin_round"] = int(origin_round)
    if staleness is not None:
        row["staleness"] = int(staleness)
    if rung is not None:
        row["rung"] = str(rung)
    if distortion is not None:
        row["distortion"] = float(distortion)
    return row


class _NullTimer:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_TIMER = _NullTimer()


class NullTelemetry:
    """Disabled telemetry: every method is a no-op and the object is falsy,
    so ``if tel:``-guarded record building never runs.  One shared instance
    (``NULL_TELEMETRY``) is the default everywhere."""

    enabled = False

    def __bool__(self) -> bool:
        return False

    def start_run(self, meta: Optional[Dict] = None) -> None:
        pass

    def begin_round(self, rnd: int) -> None:
        pass

    def client_outcome(self, rnd: int, client: int, outcome: str,
                       **fields) -> None:
        pass

    def resolve(self, origin_round: int, client: int, outcome: str,
                staleness: Optional[int] = None,
                applied_round: Optional[int] = None) -> None:
        pass

    def betas(self, rnd: int, rows) -> None:
        pass

    def gauge(self, rnd: int, name: str, value: float) -> None:
        pass

    def distribution(self, rnd: int, name: str, values) -> None:
        pass

    def counter(self, name: str, inc: float = 1) -> None:
        pass

    def timer(self, name: str):
        return _NULL_TIMER

    def end_round(self, rnd: int) -> None:
        pass

    def end_run(self) -> None:
        pass


NULL_TELEMETRY = NullTelemetry()
