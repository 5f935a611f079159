"""NDJSON network-trace schema with record/replay.

A trace freezes one *realization* of a failure process so it can be saved,
shared, and replayed bit-exactly — operationalizing the paper's
per-realization convergence claim: two runs that replay the same trace see
the identical sequence of ``connected`` masks.

Schema (one JSON object per line):

  {"record": "header", "version": 2, "scenario": "...", "n_clients": N,
   "deadline_s": ..., "model_bytes": ..., "codec": "fp32",
   "upload_bytes": ..., "seed": ...}
  {"record": "round", "round": r, "deadline_s": ..., "duration_s": ...,
   "clients": [{"id": i, "capacity_bps": ..., "up": true,
                "duration_s": ..., "t_download_s": ..., "t_compute_s": ...,
                "t_upload_s": ..., "payload_bytes": ...,
                "selected": true, "met_deadline": true,
                "connected": true, "cause": "ok"}, ...]}

``capacity_bps``/``duration_s``/``t_*_s`` are null for legacy failure models
that have no timing semantics; ``connected`` is always present, so any
model's realization is replayable.  Per-client ``duration_s`` is the landing
instant (``ClientRoundEvent.finish_s``) — recorded even for uploads that
missed the deadline, so an asynchronous run replays its staleness-buffered
arrivals bit-exactly.  Non-finite floats are serialized as the strings
"inf"/"-inf"/"nan" (JSON has no literals for them) and decoded back
losslessly by ``_unnum``.

Version 2 (communication codecs, ``repro.fl.comm``) adds the codec name to
the header and per-client ``payload_bytes`` (bytes-on-wire of that round's
upload) to each client row.  Version-1 traces still load — they predate
codecs, so they are implicitly ``fp32``; the runtime refuses to replay any
trace under a codec other than the one it was recorded with (the recorded
upload timings would be priced at the wrong byte count).

Version 3 (adaptive codec assignment + compressed downlink) adds
``downlink_codec`` / ``download_bytes`` to the header and, per client row,
``download_bytes`` plus — for adaptive runs — the per-round ``codec`` rung
that client was assigned.  An adaptive header carries the controller spec
(``"adaptive:<lo>-<hi>"``) and a null ``upload_bytes`` (there is no single
upload size; the per-round byte vectors are authoritative and the round
loop cross-checks the replaying controller against them).  Version-2 traces
still load as static-codec recordings with the fp32 broadcast.

Version 4 (fidelity-aware aggregation) adds per-client ``distortion`` — the
upload's measured normalized compression distortion (``‖carry −
decoded‖/‖carry‖`` from ``CommState.roundtrip``; null for clients that
uploaded nothing that round) — and restricts the per-round ``codec`` rung
to *selected* clients (a rung the server never handed out is policy state,
not an assignment; unselected rows carry no codec).  Distortion depends on
the model trajectory, not just the network realization, so replaying a
trace under a *different strategy* legitimately reproduces different
distortions — the replay machinery therefore exposes the recorded values
(``ReplayFailureModel.distortions``) for cross-checks instead of failing
loudly in the loop; same-configuration replays can (and the fidelity bench
does) assert they match bit-exactly.  Version-3 traces still load.

Version 5 (population scale) adds *sketch rounds*: above
``TRACE_SKETCH_THRESHOLD`` clients (or with ``FFTConfig.trace_mode =
"sketch"``), a round record stores O(1) state instead of N client rows —
exact participation counts, a per-cause drop histogram, Greenwald–Khanna
quantile sketches (``repro.obs.sketch``) of the finite arrival times and
link capacities, byte totals, and a SHA-1 digest of the round's up-mask.
The realization stays recoverable because scenario worlds are
deterministic in their seed: ``regenerate_model`` rebuilds the recorded
failure model from the header alone and the digest cross-checks that the
regenerated rounds are the recorded realization (the digest is
payload-independent, so the check holds for adaptive runs too, whose byte
repricing never perturbs the link draw).  Sketch rounds are *not*
row-replayable — ``draw_events`` on one raises, pointing at regeneration —
while v1–v4 traces and v5 full-mode rounds replay exactly as before.
"""
from __future__ import annotations

import hashlib
import json
import math
from collections import Counter
from typing import Dict, List, Optional

import numpy as np

from repro_torch.fl.failures import FailureModel
from repro_torch.fl.scenarios.engine import (CAUSE_OK, ClientRoundEvent,
                                             RoundEvents)

TRACE_VERSION = 5
SUPPORTED_TRACE_VERSIONS = (1, 2, 3, 4, 5)
# trace_mode="auto": per-client rows below this population, sketches at or
# above it (a 1M-client round would otherwise write ~1M JSON rows per round)
TRACE_SKETCH_THRESHOLD = 4096
TRACE_MODES = ("auto", "full", "sketch")


def up_mask_digest(up: np.ndarray) -> str:
    """SHA-1 of a round's packed up-mask (plus its length, so a prefix of a
    larger population never collides).  Payload-independent — repricing a
    round's bytes never changes which links were up — which is what lets a
    regenerated realization be cross-checked against a sketch trace even
    for adaptive runs."""
    up = np.asarray(up, dtype=bool)
    h = hashlib.sha1()
    h.update(str(len(up)).encode())
    h.update(np.packbits(up).tobytes())
    return h.hexdigest()


def _num(x) -> object:
    """JSON-safe float: inf/-inf/nan become strings, None passes through."""
    if x is None:
        return None
    x = float(x)
    if math.isinf(x):
        return "inf" if x > 0 else "-inf"
    if math.isnan(x):
        return "nan"
    return x


def _unnum(x) -> Optional[float]:
    if x is None:
        return None
    if x == "inf":
        return math.inf
    if x == "-inf":
        return -math.inf
    if x == "nan":
        return math.nan
    return float(x)


class TraceRecorder:
    """Append-per-round NDJSON writer.  Opens fresh (truncates) so one file
    always holds exactly one realization."""

    def __init__(self, path: str, header: Dict, mode: str = "auto"):
        if mode not in TRACE_MODES:
            raise ValueError(f"trace mode must be one of {TRACE_MODES}, "
                             f"got {mode!r}")
        self.path = path
        self._fh = open(path, "w")
        hdr = {"record": "header", "version": TRACE_VERSION}
        hdr.update(header)
        hdr.setdefault("codec", "fp32")
        hdr.setdefault("downlink_codec", "fp32")
        hdr["model_bytes"] = _num(hdr.get("model_bytes"))
        hdr["upload_bytes"] = _num(hdr.get("upload_bytes"))
        hdr["download_bytes"] = _num(hdr.get("download_bytes"))
        hdr["deadline_s"] = _num(hdr.get("deadline_s"))
        n = int(hdr.get("n_clients") or 0)
        self.sketch_mode = (mode == "sketch"
                            or (mode == "auto"
                                and n >= TRACE_SKETCH_THRESHOLD))
        if self.sketch_mode:
            hdr["mode"] = "sketch"
        self._fh.write(json.dumps(hdr) + "\n")

    def write_round(self, rnd: int, selected: np.ndarray,
                    connected: np.ndarray, events: Optional[RoundEvents],
                    up: Optional[np.ndarray] = None,
                    met_deadline: Optional[np.ndarray] = None,
                    payload_bytes=None, download_bytes=None,
                    codecs=None, distortions=None) -> None:
        """``up``/``met_deadline`` carry the failure draw for legacy models
        (no ``events``); without them replay would fabricate connectivity
        for clients that were down but unselected.  ``payload_bytes`` /
        ``download_bytes`` are scalars or (N,) arrays of this round's
        per-client wire sizes in each direction, recorded per client row;
        ``codecs`` is the per-client rung list of an adaptive round (None
        for static runs, whose codec lives in the header; per-entry None
        for clients the server did not select that round); ``distortions``
        maps client id → measured compression distortion of that round's
        upload (clients that uploaded nothing carry null).

        In sketch mode (v5) the per-client fields fold into O(1) summary
        state instead of rows — counts, cause histogram, GK sketches, byte
        totals, up-mask digest — and ``codecs``/``distortions`` are not
        stored (they are per-client by nature; a sketch round's realization
        is recovered by regeneration, not row replay)."""
        if self.sketch_mode:
            self._write_sketch_round(rnd, selected, connected, events,
                                     up=up, met_deadline=met_deadline,
                                     payload_bytes=payload_bytes,
                                     download_bytes=download_bytes)
            return
        clients = []
        n = len(selected)
        distortions = distortions or {}
        if payload_bytes is not None:
            payload_bytes = np.broadcast_to(
                np.asarray(payload_bytes, float), (n,))
        if download_bytes is not None:
            download_bytes = np.broadcast_to(
                np.asarray(download_bytes, float), (n,))
        for i in range(n):
            pb = _num(payload_bytes[i]) if payload_bytes is not None else None
            db = (_num(download_bytes[i]) if download_bytes is not None
                  else None)
            if events is not None:
                e = events.events[i]
                row = {"id": i, "capacity_bps": _num(e.capacity_bps),
                       "up": bool(e.up), "duration_s": _num(e.finish_s),
                       "t_download_s": _num(e.t_download_s),
                       "t_compute_s": _num(e.t_compute_s),
                       "t_upload_s": _num(e.t_upload_s),
                       "payload_bytes": pb,
                       "selected": bool(selected[i]),
                       "met_deadline": bool(e.met_deadline),
                       "connected": bool(connected[i]), "cause": e.cause}
            else:
                up_i = bool(up[i]) if up is not None else (
                    bool(connected[i]) or not bool(selected[i]))
                met_i = bool(met_deadline[i]) if met_deadline is not None \
                    else True
                row = {"id": i, "capacity_bps": None, "up": up_i,
                       "duration_s": None, "payload_bytes": pb,
                       "selected": bool(selected[i]),
                       "met_deadline": met_i,
                       "connected": bool(connected[i]),
                       "cause": CAUSE_OK if up_i and met_i else "outage"}
            if db is not None:
                row["download_bytes"] = db
            if codecs is not None and codecs[i] is not None:
                row["codec"] = str(codecs[i])
            if i in distortions:
                row["distortion"] = _num(distortions[i])
            clients.append(row)
        rec = {"record": "round", "round": int(rnd),
               "deadline_s": _num(events.deadline_s if events else None),
               # server wait over the round's actual cohort, not all clients
               "duration_s": _num(events.server_wait(selected)
                                  if events else None),
               "clients": clients}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def _write_sketch_round(self, rnd: int, selected, connected, events,
                            up=None, met_deadline=None, payload_bytes=None,
                            download_bytes=None) -> None:
        """One O(1)-state round record: exact counts + cause histogram +
        GK quantile sketches + byte totals + up-mask digest."""
        from repro_torch.obs.sketch import GKQuantiles
        selected = np.asarray(selected, dtype=bool)
        connected = np.asarray(connected, dtype=bool)
        n = len(selected)
        if events is not None:
            up_arr = np.asarray(events.up_mask(), dtype=bool)
            met_arr = np.asarray(events.deadline_mask(), dtype=bool)
        else:
            up_arr = (np.asarray(up, dtype=bool) if up is not None
                      else connected | ~selected)
            met_arr = (np.asarray(met_deadline, dtype=bool)
                       if met_deadline is not None
                       else np.ones(n, dtype=bool))
        # cause histogram: bincount over the dense codes when the events
        # are array-backed, else a Counter over the per-client strings
        codes = getattr(events, "cause_codes", None)
        if codes is not None:
            counts = np.bincount(np.asarray(codes),
                                 minlength=len(events.cause_table))
            causes = {name: int(c) for name, c
                      in zip(events.cause_table, counts) if c}
        elif events is not None:
            causes = dict(Counter(events.cause_list()))
        else:
            down = ~(up_arr & met_arr)
            causes = {CAUSE_OK: int(n - down.sum())}
            if int(down.sum()):
                causes["outage"] = int(down.sum())
        sketch = {
            "n_clients": n,
            "n_selected": int(selected.sum()),
            "n_up": int(up_arr.sum()),
            "n_connected": int(connected.sum()),
            "n_met_deadline": int(met_arr.sum()),
            "causes": causes,
            "up_digest": up_mask_digest(up_arr),
        }
        if events is not None:
            finish = np.asarray(events.finish_array(), dtype=float)
            caps = np.asarray(events.capacity_array(), dtype=float)
            for name, vals in (("finish_s", finish), ("capacity_bps", caps)):
                gk = GKQuantiles()
                for v in vals[np.isfinite(vals)]:
                    gk.add(float(v))
                sketch[name] = gk.to_json()
        if payload_bytes is not None:
            pb = np.broadcast_to(np.asarray(payload_bytes, float), (n,))
            sketch["payload_bytes_total"] = _num(float(pb[selected].sum()))
        if download_bytes is not None:
            db = np.broadcast_to(np.asarray(download_bytes, float), (n,))
            sketch["download_bytes_total"] = _num(float(db[selected].sum()))
        rec = {"record": "round", "round": int(rnd),
               "deadline_s": _num(events.deadline_s if events else None),
               "duration_s": _num(events.server_wait(selected)
                                  if events else None),
               "sketch": sketch}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_trace(path: str):
    """Parse a trace file -> (header dict, {round -> round dict})."""
    header: Optional[Dict] = None
    rounds: Dict[int, Dict] = {}
    with open(path) as fh:
        for line_no, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            kind = rec.get("record")
            if kind == "header":
                if rec.get("version") not in SUPPORTED_TRACE_VERSIONS:
                    raise ValueError(
                        f"{path}:{line_no}: unsupported trace version "
                        f"{rec.get('version')!r} "
                        f"(supported: {SUPPORTED_TRACE_VERSIONS})")
                header = rec
            elif kind == "round":
                rounds[int(rec["round"])] = rec
            else:
                raise ValueError(f"{path}:{line_no}: unknown record {kind!r}")
    if header is None:
        raise ValueError(f"{path}: missing header record")
    return header, rounds


class ReplayFailureModel(FailureModel):
    """Replays a recorded trace bit-exactly.

    ``draw(r)`` / ``draw_events(r)`` return exactly what was recorded for
    round ``r`` — no randomness at all, so every strategy sees the identical
    failure realization the original run saw.
    """

    def __init__(self, path: str, n_clients: Optional[int] = None):
        self.path = path
        self.header, self._rounds = load_trace(path)
        if self.header.get("n_clients"):
            self.n = int(self.header["n_clients"])
        elif self._rounds:
            self.n = len(next(iter(self._rounds.values()))["clients"])
        else:
            raise ValueError(f"trace {path}: header lacks n_clients and no "
                             f"rounds are recorded")
        if n_clients is not None and n_clients != self.n:
            raise ValueError(
                f"trace {path} has {self.n} clients, runner has {n_clients}")

    def rounds_available(self) -> List[int]:
        return sorted(self._rounds)

    @property
    def codec(self) -> str:
        """Codec the trace was recorded under (v1 traces predate codecs)."""
        return str(self.header.get("codec", "fp32"))

    def payload_bytes(self, r: int) -> Optional[np.ndarray]:
        """Recorded per-client upload sizes for round ``r`` (None for v1)."""
        return self._client_floats(r, "payload_bytes")

    def download_bytes(self, r: int) -> Optional[np.ndarray]:
        """Recorded per-client broadcast sizes for round ``r`` (None before
        v3)."""
        return self._client_floats(r, "download_bytes")

    def codecs(self, r: int) -> Optional[List[Optional[str]]]:
        """Recorded per-client codec rungs for round ``r`` (adaptive v3+
        traces only; None means the header codec applied to everyone).
        Per-entry None marks a client the server did not select that round
        (v4 records rungs for selected clients only) — consumers must skip
        those entries, not substitute the header spec."""
        if "sketch" in self._round(r):
            return None
        rows = sorted(self._round(r)["clients"], key=lambda c: c["id"])
        vals = [c.get("codec") for c in rows]
        if all(v is None for v in vals):
            return None
        return [str(v) if v is not None else None for v in vals]

    def distortions(self, r: int) -> Optional[np.ndarray]:
        """Recorded per-client upload distortions for round ``r`` (v4
        traces; NaN for clients that uploaded nothing; None before v4).
        Distortion depends on the model trajectory, so this is only
        comparable against a replay under the *same* strategy and config —
        the fidelity bench uses it as a bit-exactness cross-check."""
        return self._client_floats(r, "distortion")

    def sketch_of(self, r: int) -> Optional[Dict]:
        """The recorded sketch summary of round ``r`` (None for full-mode
        rounds)."""
        return self._round(r).get("sketch")

    def _client_floats(self, r: int, field: str) -> Optional[np.ndarray]:
        if "sketch" in self._round(r):
            return None
        rows = sorted(self._round(r)["clients"], key=lambda c: c["id"])
        vals = [_unnum(c.get(field)) for c in rows]
        if all(v is None for v in vals):
            return None
        return np.array([math.nan if v is None else v for v in vals])

    def _round(self, r: int) -> Dict:
        if r not in self._rounds:
            raise ValueError(
                f"trace {self.path} has no round {r} "
                f"(recorded rounds: {min(self._rounds)}..{max(self._rounds)})")
        return self._rounds[r]

    def draw_events(self, r: int) -> RoundEvents:
        rec = self._round(r)
        if "sketch" in rec:
            raise ValueError(
                f"trace {self.path} round {r} was recorded in sketch mode "
                f"(v5): per-client rows were not stored, so it cannot be "
                f"row-replayed.  Regenerate the realization from the header "
                f"(repro.fl.scenarios.trace.regenerate_model) — scenario "
                f"worlds are deterministic in their seed — or re-record "
                f"with trace_mode='full'")
        def val(x, default):
            return x if x is not None else default

        events = []
        for c in sorted(rec["clients"], key=lambda c: c["id"]):
            events.append(ClientRoundEvent(
                client=int(c["id"]),
                capacity_bps=val(_unnum(c.get("capacity_bps")), 0.0),
                up=bool(c["up"]),
                t_download_s=val(_unnum(c.get("t_download_s")), 0.0),
                t_compute_s=val(_unnum(c.get("t_compute_s")), 0.0),
                t_upload_s=val(_unnum(c.get("t_upload_s")), 0.0),
                finish_s=val(_unnum(c.get("duration_s")), math.inf),
                met_deadline=bool(c.get("met_deadline", c["connected"])),
                cause=str(c.get("cause", CAUSE_OK))))
        return RoundEvents(
            rnd=r, deadline_s=val(_unnum(rec.get("deadline_s")), math.inf),
            events=events,
            duration_s=val(_unnum(rec.get("duration_s")), 0.0))

    def draw(self, r: int) -> np.ndarray:
        ev = self.draw_events(r)
        return ev.up_mask() & ev.deadline_mask()


# --------------------------------------------------------------------------
# Sketch-trace regeneration (v5)
# --------------------------------------------------------------------------
def regenerate_model(header: Dict):
    """Rebuild the failure model a sketch trace was recorded under.

    Scenario worlds are deterministic in their seed, so the header —
    scenario name, population, sizes, seed — is sufficient to re-derive
    every round's realization; ``verify_sketch_round`` cross-checks a
    regenerated round against a recorded sketch via the up-mask digest.
    Only ``scenario:*`` recordings regenerate (legacy modes were wrapped in
    a channel-dependent adapter whose channels the trace does not carry);
    rounds must then be drawn in order from round 0, exactly like the
    recording run drew them."""
    scn = str(header.get("scenario") or "")
    if not scn.startswith("scenario:"):
        raise ValueError(
            f"only scenario:* recordings can be regenerated from the "
            f"header; this trace was recorded under {scn!r}")
    from repro_torch.fl import scenarios as scen
    return scen.make_scenario_model(
        scn.split(":", 1)[1], int(header["n_clients"]),
        model_bytes=float(_unnum(header["model_bytes"])),
        deadline_s=float(_unnum(header["deadline_s"])),
        compute_s=float(header.get("compute_s", 2.0)),
        seed=int(header.get("seed", 0)))


def verify_sketch_round(model, rec: Dict) -> bool:
    """True iff ``model``'s realization of ``rec``'s round matches the
    recorded sketch (up-mask digest + participation counts).  ``model``
    must have drawn all earlier rounds in order (stateful worlds)."""
    sketch = rec.get("sketch")
    if sketch is None:
        raise ValueError(f"round {rec.get('round')} is not a sketch round")
    ev = model.draw_events(int(rec["round"]))
    up = np.asarray(ev.up_mask(), dtype=bool)
    met = np.asarray(ev.deadline_mask(), dtype=bool)
    return (up_mask_digest(up) == sketch["up_digest"]
            and int(up.sum()) == int(sketch["n_up"])
            and int(met.sum()) == int(sketch["n_met_deadline"]))
