"""Unified event-timeline simulation core — TimelineIR.

Every cost producer in the repo appends typed events to ONE `Timeline`:

  * ``PicnicSimulator.run``            — analytic prefill/decode/C2C spans
    (or `MeasuredTraffic`-sourced C2C transfers),
  * ``ContinuousBatchingEngine``       — per-round prefill/decode spans,
    idle (`ClusterSleep`) gaps, per-token `TokenEmit`s,
  * ``CCPGModel`` (dynamic mode)       — real `ClusterWake` latency on
    cluster transitions instead of a folded-in residue constant.

Every consumer derives its numbers from the same event stream:
`InferenceResult` (cycle/byte sums), `ServingReport` (percentiles,
tok/s, tok/J via the span-integrated energy), and the Chrome-trace
exporter (`chrome://tracing` / Perfetto JSON).

Energy is INTEGRATED over spans — ``sum(duration * power)`` in append
order — instead of multiplying one average power by the wall clock.
The paper's CCPG and interconnect claims are time-resolved effects
(cluster wake-up, bursty C2C, idle retention) that average-power models
cannot show; see PAPERS.md on CIM power-gating surveys.

Cursor semantics: *advancing* appends (`compute` / `wake` / `sleep`)
move ``now`` and integrate energy; *concurrent* appends (`c2c` /
`token` / `sample`, or any append with ``advance=False``) annotate the
stream at a given instant without advancing time — C2C bursts overlap
compute, token emits are instantaneous.

Recording modes
---------------
``columnar=True`` (the default, the fast simulation core) stores each
event class as growable parallel columns of scalars — no per-event
Python object is built on the hot append path, and the existing
dataclass events are materialized **lazily** (and cached) only when a
consumer actually reads ``timeline.events`` (golden-file comparisons,
``TrafficTrace.from_timeline``).  ``columnar=False`` keeps the original
one-dataclass-per-append recorder; both modes run the same float
arithmetic in the same order, so they are byte-identical — locked by
tests/test_fastpath.py.

``aggregate_only=True`` goes one step further: NO event stream at all —
only the running per-(class, kind) sums and per-class counts that the
columnar recorder already maintains internally.  Same accumulator
arithmetic in the same append order (so every derived aggregate stays
bit-identical to the other modes), but reading ``events`` / ``column``
/ the trace exporters raises.  This is the sweep-engine recorder: a
grid of N cells keeps N aggregate-only timelines, mirrored into one
cell-major :class:`SweepAggregates` array block while the vectorized
round loop advances all cells at once.

Aggregate queries (`cycles()` / `span_seconds()` / `count()` /
`total_energy_J()`) read running per-(class, kind) sums maintained on
append — O(1) instead of an O(E) event scan — in ALL modes.
"""
from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass
from typing import (Dict, Iterator, List, Optional, Sequence, Tuple, Type,
                    Union)

import numpy as np

from .interconnect import LinkSpec, OPTICAL, c2c_average_power


# ---------------------------------------------------------------------------
# Event taxonomy
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ComputeSpan:
    """A busy span of the active cluster(s): one prefill, one (batched)
    decode iteration, or one sampled chunk of the analytic decode walk."""
    t0: float
    dur_s: float
    kind: str                # "prefill" | "decode"
    power_W: float = 0.0
    cycles: int = 0          # exact cycle count (ints sum losslessly)
    batch: int = 1           # co-scheduled requests riding this span
    name: str = ""


@dataclass(frozen=True)
class C2CTransfer:
    """Photonic/electrical chip-to-chip burst.  Concurrent with compute
    (the link runs under the compute wave unless `overlap` < 1 exposes
    part of it — the exposed part is inside the owning ComputeSpan)."""
    t0: float
    dur_s: float
    nbytes: int
    phase: str = ""          # "prefill" | "decode"
    source: str = "analytic"  # "analytic" | MeasuredTraffic.source


@dataclass(frozen=True)
class ClusterWake:
    """Exposed cluster power-up latency (CCPG).  Static mode folds the
    pre-wake residue into decode cycles; dynamic mode emits the full
    regulator-settle walk as real timeline latency."""
    t0: float
    dur_s: float
    cycles: int = 0
    cluster: int = -1        # -1: aggregate walk over all transitions


@dataclass(frozen=True)
class ClusterSleep:
    """Idle/retention span: scratchpads only (CCPG) or full active burn
    (no gating path).  ``advance=False`` appends mark background sleepers
    concurrent with compute (their power is already inside the span's
    aggregate) and carry no energy of their own."""
    t0: float
    dur_s: float
    power_W: float = 0.0


@dataclass(frozen=True)
class EnergySample:
    """Instantaneous power sample (W) — the Fig-8-style power trace.
    Emitted automatically at every advancing span start; contributes no
    energy (spans carry the integral)."""
    t0: float
    power_W: float


@dataclass(frozen=True)
class TokenEmit:
    """``n`` tokens produced at instant ``t0`` (request_id -1: aggregate
    analytic walk, otherwise the serving engine's per-request emits)."""
    t0: float
    n: int = 1
    request_id: int = -1


@dataclass(frozen=True)
class NodeFail:
    """A fleet node dies at instant ``t0`` holding its in-flight KV
    (fault injection, launch/config.FaultConfig).  Appended to the
    failing node's own timeline; the router's recovery actions
    (re-routes, recompute prefills, retransmits) land on the survivors'
    timelines as ordinary spans/transfers."""
    t0: float
    node: int = -1


@dataclass(frozen=True)
class NodeRecover:
    """The node rejoins the fleet at ``t0`` after ``downtime_s`` of
    being dead (its timeline is padded with a zero-power sleep over the
    gap — a dead node burns nothing)."""
    t0: float
    node: int = -1
    downtime_s: float = 0.0


Event = Union[ComputeSpan, C2CTransfer, ClusterWake, ClusterSleep,
              EnergySample, TokenEmit, NodeFail, NodeRecover]

# The core categories every full trace contains; the fault kinds only
# appear when fault injection is on, so they live in their own tuple
# (trace-completeness checks iterate EVENT_CATEGORIES).
EVENT_CATEGORIES: Tuple[Type, ...] = (
    ComputeSpan, C2CTransfer, ClusterWake, ClusterSleep, EnergySample,
    TokenEmit)
FAULT_EVENT_CATEGORIES: Tuple[Type, ...] = (NodeFail, NodeRecover)
ALL_EVENT_CATEGORIES: Tuple[Type, ...] = \
    EVENT_CATEGORIES + FAULT_EVENT_CATEGORIES

# columnar class ids, in ALL_EVENT_CATEGORIES order
_COMPUTE, _C2C, _WAKE, _SLEEP, _SAMPLE, _TOKEN, _FAIL, _RECOVER = range(8)


# ---------------------------------------------------------------------------
# Accumulator
# ---------------------------------------------------------------------------

class Timeline:
    """Append-only event stream with a time cursor and running integrals.

    The integrals (`energy_J`, `busy_s`, `idle_s`, `occupancy_s`) are
    accumulated in append order with one multiply-add per span, so a
    producer that previously charged ``energy += dt * power`` inline
    reproduces its floats bit-for-bit by appending the same spans in the
    same order.  The same holds for the per-(class, kind) cycle / span /
    count aggregates behind `cycles()` / `span_seconds()` / `count()`.
    """

    def __init__(self, link: LinkSpec = OPTICAL, *, columnar: bool = True,
                 aggregate_only: bool = False):
        self.link = link
        self.columnar = columnar
        self.aggregate_only = aggregate_only
        self.now = 0.0
        self.energy_J = 0.0        # span-integrated chip energy
        self.busy_s = 0.0
        self.idle_s = 0.0
        self.c2c_bytes = 0
        self.tokens = 0
        self.occupancy_s = 0.0     # integral of batch occupancy over busy
        # running aggregates behind the O(1) derived queries; float sums
        # run in append order, exactly as the old O(E) scans did
        self._cycles: Dict[Tuple[str, Optional[str]], int] = \
            defaultdict(int)
        self._span_s: Dict[Tuple[str, Optional[str]], float] = \
            defaultdict(float)
        if aggregate_only:
            self._counts = [0] * 8             # per-class append counts
        elif columnar:
            # per-class parallel columns + one global class-id sequence;
            # dataclass events are materialized lazily from these
            self._seq: List[int] = []
            self._cols: Tuple[Tuple[list, ...], ...] = tuple(
                tuple([] for _ in range(n))
                for n in (7, 5, 4, 3, 2, 3, 2, 3))
            self._mat: List[Event] = []        # lazy materialization cache
            self._cursors = [0] * 8            # per-class materialize pos
        else:
            self._events: List[Event] = []

    # -- advancing producers ------------------------------------------
    def compute(self, dur_s: float, *, kind: str, power_W: float = 0.0,
                cycles: int = 0, batch: int = 1, name: str = "") -> float:
        now = self.now
        if self.aggregate_only:
            cnt = self._counts
            cnt[_COMPUTE] += 1
            cnt[_SAMPLE] += 1
        elif self.columnar:
            seq = self._seq
            seq.append(_COMPUTE)
            c = self._cols[_COMPUTE]
            c[0].append(now)
            c[1].append(dur_s)
            c[2].append(kind)
            c[3].append(power_W)
            c[4].append(cycles)
            c[5].append(batch)
            c[6].append(name)
            seq.append(_SAMPLE)               # auto power sample (inline)
            c = self._cols[_SAMPLE]
            c[0].append(now)
            c[1].append(power_W)
        else:
            self._events.append(ComputeSpan(now, dur_s, kind, power_W,
                                            cycles, batch, name))
            self._events.append(EnergySample(now, power_W))
        span = self._span_s
        span["ComputeSpan", None] += dur_s
        span["ComputeSpan", kind] += dur_s
        if cycles:
            cyc = self._cycles
            cyc["ComputeSpan", None] += cycles
            cyc["ComputeSpan", kind] += cycles
        self.busy_s += dur_s
        self.energy_J += dur_s * power_W
        self.occupancy_s += dur_s * batch
        self.now = now + dur_s
        return self.now

    def wake(self, dur_s: float, *, power_W: float = 0.0, cycles: int = 0,
             cluster: int = -1) -> float:
        now = self.now
        if self.aggregate_only:
            cnt = self._counts
            cnt[_WAKE] += 1
            cnt[_SAMPLE] += 1
        elif self.columnar:
            seq = self._seq
            seq.append(_WAKE)
            c = self._cols[_WAKE]
            c[0].append(now)
            c[1].append(dur_s)
            c[2].append(cycles)
            c[3].append(cluster)
            seq.append(_SAMPLE)
            c = self._cols[_SAMPLE]
            c[0].append(now)
            c[1].append(power_W)
        else:
            self._events.append(ClusterWake(now, dur_s, cycles, cluster))
            self._events.append(EnergySample(now, power_W))
        self._span_s["ClusterWake", None] += dur_s
        if cycles:
            self._cycles["ClusterWake", None] += cycles
        self.busy_s += dur_s
        self.energy_J += dur_s * power_W
        self.now = now + dur_s
        return self.now

    def sleep(self, dur_s: float, *, power_W: float = 0.0,
              t0: Optional[float] = None, advance: bool = True) -> float:
        at = self.now if t0 is None else t0
        if self.aggregate_only:
            self._counts[_SLEEP] += 1
        elif self.columnar:
            self._seq.append(_SLEEP)
            c = self._cols[_SLEEP]
            c[0].append(at)
            c[1].append(dur_s)
            c[2].append(power_W)
        else:
            self._events.append(ClusterSleep(at, dur_s, power_W))
        self._span_s["ClusterSleep", None] += dur_s
        if advance:
            if self.aggregate_only:
                self._counts[_SAMPLE] += 1
            elif self.columnar:
                self._seq.append(_SAMPLE)
                c = self._cols[_SAMPLE]
                c[0].append(at)
                c[1].append(power_W)
            else:
                self._events.append(EnergySample(at, power_W))
            self.idle_s += dur_s
            self.energy_J += dur_s * power_W
            self.now += dur_s
        return self.now

    # -- concurrent annotations ---------------------------------------
    def c2c(self, nbytes: int, *, dur_s: float = 0.0, phase: str = "",
            t0: Optional[float] = None, source: str = "analytic",
            advance: bool = False, power_W: float = 0.0) -> None:
        """``advance=True`` serializes the burst (cursor moves past it) —
        the Fig-10 layer-boundary handoff view; the default treats it as
        concurrent with the surrounding compute (any exposed transfer
        time is already inside the owning ComputeSpan's cycles).
        ``power_W`` charges chip power over an *advancing* burst (the
        chiplets do not stop burning while stalled on a remote KV read);
        concurrent bursts carry no energy of their own."""
        nbytes = int(nbytes)
        at = self.now if t0 is None else t0
        if self.aggregate_only:
            self._counts[_C2C] += 1
        elif self.columnar:
            self._seq.append(_C2C)
            c = self._cols[_C2C]
            c[0].append(at)
            c[1].append(dur_s)
            c[2].append(nbytes)
            c[3].append(phase)
            c[4].append(source)
        else:
            self._events.append(C2CTransfer(at, dur_s, nbytes, phase,
                                            source))
        self._span_s["C2CTransfer", None] += dur_s
        self.c2c_bytes += nbytes
        if advance:
            if power_W:
                if self.aggregate_only:
                    self._counts[_SAMPLE] += 1
                elif self.columnar:
                    self._seq.append(_SAMPLE)
                    c = self._cols[_SAMPLE]
                    c[0].append(self.now)
                    c[1].append(power_W)
                else:
                    self._events.append(EnergySample(self.now, power_W))
                self.energy_J += dur_s * power_W
            self.busy_s += dur_s
            self.now += dur_s

    def token(self, n: int = 1, *, request_id: int = -1,
              t0: Optional[float] = None) -> None:
        n = int(n)
        at = self.now if t0 is None else t0
        if self.aggregate_only:
            self._counts[_TOKEN] += 1
        elif self.columnar:
            self._seq.append(_TOKEN)
            c = self._cols[_TOKEN]
            c[0].append(at)
            c[1].append(n)
            c[2].append(request_id)
        else:
            self._events.append(TokenEmit(at, n, request_id))
        self.tokens += n

    def token_each(self, request_ids: Sequence[int], *,
                   t0: Optional[float] = None) -> None:
        """Batched emit: ONE single-token `TokenEmit` per request id, all
        at the same instant — the serving engine's per-decode-round
        batch, appended with C-level column extends instead of one
        `token()` call per resident.  Event-stream equivalent to
        ``for rid in request_ids: token(1, request_id=rid)``."""
        b = len(request_ids)
        if not b:
            return
        at = self.now if t0 is None else t0
        if self.aggregate_only:
            self._counts[_TOKEN] += b
        elif self.columnar:
            self._seq.extend([_TOKEN] * b)
            c = self._cols[_TOKEN]
            c[0].extend([at] * b)
            c[1].extend([1] * b)
            c[2].extend(request_ids)
        else:
            self._events.extend(
                TokenEmit(at, 1, rid) for rid in request_ids)
        self.tokens += b

    def node_fail(self, node: int = -1, *,
                  t0: Optional[float] = None) -> None:
        """Concurrent instant: this node crashed (fault injection)."""
        at = self.now if t0 is None else t0
        if self.aggregate_only:
            self._counts[_FAIL] += 1
        elif self.columnar:
            self._seq.append(_FAIL)
            c = self._cols[_FAIL]
            c[0].append(at)
            c[1].append(node)
        else:
            self._events.append(NodeFail(at, node))

    def node_recover(self, node: int = -1, *, downtime_s: float = 0.0,
                     t0: Optional[float] = None) -> None:
        """Concurrent instant: this node rejoined after a crash."""
        at = self.now if t0 is None else t0
        if self.aggregate_only:
            self._counts[_RECOVER] += 1
        elif self.columnar:
            self._seq.append(_RECOVER)
            c = self._cols[_RECOVER]
            c[0].append(at)
            c[1].append(node)
            c[2].append(downtime_s)
        else:
            self._events.append(NodeRecover(at, node, downtime_s))

    def sample(self, power_W: float) -> None:
        if self.aggregate_only:
            self._counts[_SAMPLE] += 1
            return
        if self.columnar:
            self._seq.append(_SAMPLE)
            c = self._cols[_SAMPLE]
            c[0].append(self.now)
            c[1].append(power_W)
        else:
            self._events.append(EnergySample(self.now, power_W))

    # -- event materialization ----------------------------------------
    def _no_events(self) -> RuntimeError:
        return RuntimeError(
            "aggregate-only timeline stores no events; use the running "
            "aggregates (cycles/span_seconds/count) or record with "
            "aggregate_only=False")

    @property
    def n_events(self) -> int:
        """Event count without materializing anything — O(1)."""
        if self.aggregate_only:
            return sum(self._counts)
        return len(self._seq) if self.columnar else len(self._events)

    @property
    def events(self) -> List[Event]:
        """The dataclass event stream.  In columnar mode this is a lazy,
        incrementally extended materialization cache: appends after a
        read only materialize the new tail on the next read."""
        if self.aggregate_only:
            raise self._no_events()
        if not self.columnar:
            return self._events
        if len(self._mat) < len(self._seq):
            mat, cur, cols = self._mat, self._cursors, self._cols
            ctors = (ComputeSpan, C2CTransfer, ClusterWake, ClusterSleep,
                     EnergySample, TokenEmit, NodeFail, NodeRecover)
            for cid in self._seq[len(mat):]:
                i = cur[cid]
                mat.append(ctors[cid](*(col[i] for col in cols[cid])))
                cur[cid] = i + 1
        return self._mat

    def _iter_events(self) -> Iterator[Event]:
        """Yield events one at a time WITHOUT caching a materialized list
        (columnar mode) — the streaming export path for million-event
        traces."""
        if self.aggregate_only:
            raise self._no_events()
        if not self.columnar:
            yield from self._events
            return
        ctors = (ComputeSpan, C2CTransfer, ClusterWake, ClusterSleep,
                 EnergySample, TokenEmit, NodeFail, NodeRecover)
        cur = [0] * 8
        cols = self._cols
        for cid in self._seq:
            i = cur[cid]
            yield ctors[cid](*(col[i] for col in cols[cid]))
            cur[cid] = i + 1

    _FIELDS = {
        "ComputeSpan": ("t0", "dur_s", "kind", "power_W", "cycles",
                        "batch", "name"),
        "C2CTransfer": ("t0", "dur_s", "nbytes", "phase", "source"),
        "ClusterWake": ("t0", "dur_s", "cycles", "cluster"),
        "ClusterSleep": ("t0", "dur_s", "power_W"),
        "EnergySample": ("t0", "power_W"),
        "TokenEmit": ("t0", "n", "request_id"),
        "NodeFail": ("t0", "node"),
        "NodeRecover": ("t0", "node", "downtime_s"),
    }

    def column(self, cls: Type, field: str) -> list:
        """One raw column of ``cls`` (e.g. ``column(ComputeSpan, "dur_s")``)
        in append order — the zero-copy analysis path in columnar mode."""
        name = cls.__name__
        fields = self._FIELDS[name]
        if field not in fields:
            raise KeyError(f"{name} has no field {field!r}")
        if self.aggregate_only:
            raise self._no_events()
        if self.columnar:
            return list(self._cols[self._CIDS[name]][fields.index(field)])
        return [getattr(e, field) for e in self._events
                if isinstance(e, cls)]

    # -- derived queries (O(1): running aggregates) --------------------
    def cycles(self, cls: Type = ComputeSpan,
               kind: Optional[str] = None) -> int:
        """Exact integer cycle sum over events of ``cls`` (optionally a
        ComputeSpan ``kind``) — the lossless bridge back to the cycle
        model's arithmetic."""
        return self._cycles.get((cls.__name__, kind), 0)

    def span_seconds(self, cls: Type = ComputeSpan,
                     kind: Optional[str] = None) -> float:
        return self._span_s.get((cls.__name__, kind), 0.0)

    _CIDS = {"ComputeSpan": _COMPUTE, "C2CTransfer": _C2C,
             "ClusterWake": _WAKE, "ClusterSleep": _SLEEP,
             "EnergySample": _SAMPLE, "TokenEmit": _TOKEN,
             "NodeFail": _FAIL, "NodeRecover": _RECOVER}

    def count(self, cls: Type) -> int:
        if self.aggregate_only:
            return self._counts[self._CIDS[cls.__name__]]
        if self.columnar:
            return len(self._cols[self._CIDS[cls.__name__]][0])
        return sum(1 for e in self._events if isinstance(e, cls))

    def c2c_energy_J(self, wall_s: Optional[float] = None) -> float:
        """Link energy for the delivered bytes: average power at the
        delivered rate (bursty traffic, duty-cycled laser bias) over the
        wall clock."""
        wall = max(self.now if wall_s is None else wall_s, 1e-12)
        return c2c_average_power(self.c2c_bytes / wall, self.link) * wall

    def total_energy_J(self) -> float:
        return self.energy_J + self.c2c_energy_J()

    def power_trace(self) -> List[Tuple[float, float]]:
        """(t, W) steps from the EnergySample stream."""
        if self.aggregate_only:
            raise self._no_events()
        if self.columnar:
            t0s, ws = self._cols[_SAMPLE]
            return list(zip(t0s, ws))
        return [(e.t0, e.power_W) for e in self._events
                if isinstance(e, EnergySample)]

    # -- Chrome trace export ------------------------------------------
    _TIDS = {"ComputeSpan": 1, "C2CTransfer": 2, "ClusterWake": 3,
             "ClusterSleep": 4, "TokenEmit": 5}
    # fault lanes: their thread metadata is emitted ONLY when such
    # events exist, so zero-fault traces stay byte-identical
    _FAULT_TIDS = {"NodeFail": 6, "NodeRecover": 7}

    def iter_chrome_events(self, *, process_name: str = "picnic",
                           pid: int = 0) -> Iterator[Dict]:
        """Yield `chrome://tracing` event dicts one at a time (metadata
        first), without holding the whole trace in memory.  ``pid``
        attributes every event to one trace process — fleet runs export
        each NODE's timeline under its own pid (see
        :func:`merge_chrome_traces`); the default 0 keeps single-node
        output byte-identical to the pre-fleet exporter."""
        yield {"ph": "M", "pid": pid, "name": "process_name",
               "args": {"name": process_name}}
        for lane, tid in sorted(self._TIDS.items(), key=lambda kv: kv[1]):
            yield {"ph": "M", "pid": pid, "tid": tid,
                   "name": "thread_name", "args": {"name": lane}}
        for lane, tid in sorted(self._FAULT_TIDS.items(),
                                key=lambda kv: kv[1]):
            if self.count(ALL_EVENT_CATEGORIES[tid]) > 0:
                yield {"ph": "M", "pid": pid, "tid": tid,
                       "name": "thread_name", "args": {"name": lane}}

        def span(cat, name, e, args):
            return {"ph": "X", "pid": pid, "tid": self._TIDS[cat],
                    "cat": cat, "name": name, "ts": e.t0 * 1e6,
                    "dur": e.dur_s * 1e6, "args": args}

        for e in self._iter_events():
            ts = e.t0 * 1e6                     # chrome wants microseconds
            if isinstance(e, ComputeSpan):
                yield span("ComputeSpan", e.name or e.kind, e,
                           {"kind": e.kind, "cycles": e.cycles,
                            "batch": e.batch, "power_W": e.power_W})
            elif isinstance(e, C2CTransfer):
                yield span("C2CTransfer", f"c2c:{e.phase or 'burst'}",
                           e, {"bytes": e.nbytes, "phase": e.phase,
                               "source": e.source})
            elif isinstance(e, ClusterWake):
                yield span("ClusterWake", "wake", e,
                           {"cycles": e.cycles, "cluster": e.cluster})
            elif isinstance(e, ClusterSleep):
                yield span("ClusterSleep", "sleep", e,
                           {"power_W": e.power_W})
            elif isinstance(e, EnergySample):
                yield {"ph": "C", "pid": pid, "cat": "EnergySample",
                       "name": "power_W", "ts": ts,
                       "args": {"power_W": e.power_W}}
            elif isinstance(e, TokenEmit):
                yield {"ph": "i", "pid": pid,
                       "tid": self._TIDS["TokenEmit"],
                       "cat": "TokenEmit", "name": f"tok x{e.n}",
                       "ts": ts, "s": "t",
                       "args": {"n": e.n, "request_id": e.request_id}}
            elif isinstance(e, NodeFail):
                yield {"ph": "i", "pid": pid,
                       "tid": self._FAULT_TIDS["NodeFail"],
                       "cat": "NodeFail", "name": "node_fail",
                       "ts": ts, "s": "p", "args": {"node": e.node}}
            elif isinstance(e, NodeRecover):
                yield {"ph": "i", "pid": pid,
                       "tid": self._FAULT_TIDS["NodeRecover"],
                       "cat": "NodeRecover", "name": "node_recover",
                       "ts": ts, "s": "p",
                       "args": {"node": e.node,
                                "downtime_s": e.downtime_s}}

    def to_chrome_trace(self, *, process_name: str = "picnic",
                        pid: int = 0) -> Dict:
        """`chrome://tracing` / Perfetto JSON: one thread lane per event
        category, power as a counter track, tokens as instant events."""
        return {"traceEvents":
                list(self.iter_chrome_events(process_name=process_name,
                                             pid=pid)),
                "displayTimeUnit": "ms"}

    def dump_chrome_trace(self, path, *, process_name: str = "picnic",
                          pid: int = 0) -> None:
        """Stream the Chrome trace to ``path`` one event at a time —
        constant memory, so ``--trace-out`` stays usable on
        million-event traces."""
        with open(path, "w") as f:
            f.write('{"displayTimeUnit": "ms", "traceEvents": [\n')
            first = True
            for ev in self.iter_chrome_events(process_name=process_name,
                                              pid=pid):
                if not first:
                    f.write(",\n")
                json.dump(ev, f)
                first = False
            f.write("\n]}\n")

    def save_chrome_trace(self, path, *, process_name: str = "picnic",
                          pid: int = 0) -> None:
        self.dump_chrome_trace(path, process_name=process_name, pid=pid)


def merge_chrome_traces(named_timelines) -> Dict:
    """One `chrome://tracing` document from several timelines: each
    ``(name, timeline)`` pair becomes its own trace PROCESS (pid = list
    position, process_name = name) — per-node attribution for fleet
    runs, where every node's events keep their own lanes but share the
    global clock."""
    events: List[Dict] = []
    for pid, (name, tl) in enumerate(named_timelines):
        events.extend(tl.iter_chrome_events(process_name=name, pid=pid))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# Cell-major aggregate block (the sweep engine's 2D recorder)
# ---------------------------------------------------------------------------

class SweepAggregates:
    """The running aggregates of N timelines as cell-major numpy arrays.

    One row of scalars per cell — the exact accumulator set an
    aggregate-only :class:`Timeline` maintains for the serving decode
    loop — so a vectorized round update::

        agg.now[idx] += dt; agg.energy_J[idx] += dt * power; ...

    performs, per cell, the same IEEE-754 float64 multiply-adds in the
    same order as N scalar timelines appending the same spans.  The
    vector axis is *cells*: lanes never mix, so every cell's float
    accumulation stays bit-identical to its scalar run.

    ``sync_in(i, tl)`` snapshots one cell's timeline into row ``i`` when
    that cell enters the vectorized path; ``sync_out(i, tl)`` writes the
    row back before the cell's scalar engine resumes (or reports).  Only
    the accumulators the vectorized decode round can touch are mirrored;
    everything else (prefill spans, sleeps, wakes, cycle sums) mutates
    exclusively on the scalar side and needs no mirror.
    """

    _SPAN_KEYS = (("ComputeSpan", None), ("ComputeSpan", "decode"),
                  ("C2CTransfer", None), ("ComputeSpan", "prefill"),
                  ("ClusterWake", None))

    def __init__(self, n_cells: int):
        self.n_cells = n_cells
        self.now = np.zeros(n_cells)
        self.busy_s = np.zeros(n_cells)
        self.energy_J = np.zeros(n_cells)
        self.occupancy_s = np.zeros(n_cells)
        self.tokens = np.zeros(n_cells, dtype=np.int64)
        self.c2c_bytes = np.zeros(n_cells, dtype=np.int64)
        # per-(class, kind) running span sums, one lane per tracked key
        self.span_compute = np.zeros(n_cells)
        self.span_decode = np.zeros(n_cells)
        self.span_c2c = np.zeros(n_cells)
        self.span_prefill = np.zeros(n_cells)
        self.span_wake = np.zeros(n_cells)
        self.cyc_wake = np.zeros(n_cells, dtype=np.int64)
        # aggregate-only event counts kept exact during vector rounds
        self.n_compute = np.zeros(n_cells, dtype=np.int64)
        self.n_sample = np.zeros(n_cells, dtype=np.int64)
        self.n_c2c = np.zeros(n_cells, dtype=np.int64)
        self.n_token = np.zeros(n_cells, dtype=np.int64)
        self.n_wake = np.zeros(n_cells, dtype=np.int64)

    def sync_in(self, i: int, tl: Timeline) -> None:
        self.now[i] = tl.now
        self.busy_s[i] = tl.busy_s
        self.energy_J[i] = tl.energy_J
        self.occupancy_s[i] = tl.occupancy_s
        self.tokens[i] = tl.tokens
        self.c2c_bytes[i] = tl.c2c_bytes
        span = tl._span_s
        self.span_compute[i] = span.get(self._SPAN_KEYS[0], 0.0)
        self.span_decode[i] = span.get(self._SPAN_KEYS[1], 0.0)
        self.span_c2c[i] = span.get(self._SPAN_KEYS[2], 0.0)
        self.span_prefill[i] = span.get(self._SPAN_KEYS[3], 0.0)
        self.span_wake[i] = span.get(self._SPAN_KEYS[4], 0.0)
        self.cyc_wake[i] = tl._cycles.get(self._SPAN_KEYS[4], 0)
        if tl.aggregate_only:
            cnt = tl._counts
            self.n_compute[i] = cnt[_COMPUTE]
            self.n_sample[i] = cnt[_SAMPLE]
            self.n_c2c[i] = cnt[_C2C]
            self.n_token[i] = cnt[_TOKEN]
            self.n_wake[i] = cnt[_WAKE]

    def sync_out(self, i: int, tl: Timeline) -> None:
        tl.now = float(self.now[i])
        tl.busy_s = float(self.busy_s[i])
        tl.energy_J = float(self.energy_J[i])
        tl.occupancy_s = float(self.occupancy_s[i])
        tl.tokens = int(self.tokens[i])
        tl.c2c_bytes = int(self.c2c_bytes[i])
        span = tl._span_s
        span[self._SPAN_KEYS[0]] = float(self.span_compute[i])
        span[self._SPAN_KEYS[1]] = float(self.span_decode[i])
        span[self._SPAN_KEYS[2]] = float(self.span_c2c[i])
        # prefill/wake lanes: only written when they carry anything (or
        # the key already exists) so a decode-only sweep does not grow
        # the span dict's key set relative to its scalar run
        for key, col in ((self._SPAN_KEYS[3], self.span_prefill),
                         (self._SPAN_KEYS[4], self.span_wake)):
            v = float(col[i])
            if v or key in span:
                span[key] = v
        cw = int(self.cyc_wake[i])
        if cw or self._SPAN_KEYS[4] in tl._cycles:
            tl._cycles[self._SPAN_KEYS[4]] = cw
        if tl.aggregate_only:
            cnt = tl._counts
            cnt[_COMPUTE] = int(self.n_compute[i])
            cnt[_SAMPLE] = int(self.n_sample[i])
            cnt[_C2C] = int(self.n_c2c[i])
            cnt[_TOKEN] = int(self.n_token[i])
            cnt[_WAKE] = int(self.n_wake[i])

    def sync_in_many(self, idx: np.ndarray, tls: Sequence[Timeline]) -> None:
        """Batched :meth:`sync_in` — one fancy-indexed scatter per column
        instead of per-lane scalar writes.  All ``tls`` must be
        aggregate-only recorders (the sweep engine's only mode)."""
        K0, K1, K2, K3, K4 = self._SPAN_KEYS
        f = np.array([(tl.now, tl.busy_s, tl.energy_J, tl.occupancy_s,
                       tl._span_s.get(K0, 0.0), tl._span_s.get(K1, 0.0),
                       tl._span_s.get(K2, 0.0), tl._span_s.get(K3, 0.0),
                       tl._span_s.get(K4, 0.0)) for tl in tls])
        self.now[idx] = f[:, 0]
        self.busy_s[idx] = f[:, 1]
        self.energy_J[idx] = f[:, 2]
        self.occupancy_s[idx] = f[:, 3]
        self.span_compute[idx] = f[:, 4]
        self.span_decode[idx] = f[:, 5]
        self.span_c2c[idx] = f[:, 6]
        self.span_prefill[idx] = f[:, 7]
        self.span_wake[idx] = f[:, 8]
        g = np.array([(tl.tokens, tl.c2c_bytes, tl._cycles.get(K4, 0),
                       tl._counts[_COMPUTE], tl._counts[_SAMPLE],
                       tl._counts[_C2C], tl._counts[_TOKEN],
                       tl._counts[_WAKE]) for tl in tls], dtype=np.int64)
        self.tokens[idx] = g[:, 0]
        self.c2c_bytes[idx] = g[:, 1]
        self.cyc_wake[idx] = g[:, 2]
        self.n_compute[idx] = g[:, 3]
        self.n_sample[idx] = g[:, 4]
        self.n_c2c[idx] = g[:, 5]
        self.n_token[idx] = g[:, 6]
        self.n_wake[idx] = g[:, 7]

    def sync_out_many(self, idx: np.ndarray, tls: Sequence[Timeline]) -> None:
        """Batched :meth:`sync_out`: gather every column once, then per-
        timeline attribute stores (aggregate-only recorders required)."""
        K0, K1, K2, K3, K4 = self._SPAN_KEYS
        now, busy, en, occ = (self.now[idx], self.busy_s[idx],
                              self.energy_J[idx], self.occupancy_s[idx])
        tok, cbytes = self.tokens[idx], self.c2c_bytes[idx]
        sc, sd, s2 = (self.span_compute[idx], self.span_decode[idx],
                      self.span_c2c[idx])
        sp, sw, cw = (self.span_prefill[idx], self.span_wake[idx],
                      self.cyc_wake[idx])
        nc, ns, n2, nt, nw = (self.n_compute[idx], self.n_sample[idx],
                              self.n_c2c[idx], self.n_token[idx],
                              self.n_wake[idx])
        for k, tl in enumerate(tls):
            tl.now = float(now[k])
            tl.busy_s = float(busy[k])
            tl.energy_J = float(en[k])
            tl.occupancy_s = float(occ[k])
            tl.tokens = int(tok[k])
            tl.c2c_bytes = int(cbytes[k])
            span = tl._span_s
            span[K0] = float(sc[k])
            span[K1] = float(sd[k])
            span[K2] = float(s2[k])
            v = float(sp[k])
            if v or K3 in span:
                span[K3] = v
            v = float(sw[k])
            if v or K4 in span:
                span[K4] = v
            c = int(cw[k])
            if c or K4 in tl._cycles:
                tl._cycles[K4] = c
            cnt = tl._counts
            cnt[_COMPUTE] = int(nc[k])
            cnt[_SAMPLE] = int(ns[k])
            cnt[_C2C] = int(n2[k])
            cnt[_TOKEN] = int(nt[k])
            cnt[_WAKE] = int(nw[k])

    def decode_round(self, idx: np.ndarray, dt: np.ndarray,
                     power_W: np.ndarray, batch: np.ndarray,
                     burst_bytes: np.ndarray, burst_dur: np.ndarray,
                     fetch_bytes: np.ndarray, fetch_dur: np.ndarray) -> None:
        """One batched decode round for the cells in ``idx`` — the
        vectorized equivalent of the scalar engine's per-round timeline
        appends, in the scalar append order:

          1. ``compute(dt, kind="decode", power_W, batch)``
          2. concurrent decode C2C burst (``burst_bytes`` over
             ``burst_dur``)
          3. advancing kv-fetch C2C at chip power (``fetch_bytes`` over
             ``fetch_dur``; zero for non-paged cells — adding 0.0 /
             +0 is bit-neutral on every accumulator, matching the scalar
             engine *skipping* those appends)
          4. one `TokenEmit` per resident

        Each numbered update is a separate elementwise op, so within a
        lane the float adds hit each accumulator in the scalar order.
        """
        # 1. decode ComputeSpan (+ its auto power sample)
        self.span_compute[idx] += dt
        self.span_decode[idx] += dt
        self.busy_s[idx] += dt
        self.energy_J[idx] += dt * power_W
        self.occupancy_s[idx] += dt * batch
        self.now[idx] += dt
        self.n_compute[idx] += 1
        self.n_sample[idx] += 1
        # 2. concurrent decode burst
        self.span_c2c[idx] += burst_dur
        self.c2c_bytes[idx] += burst_bytes
        self.n_c2c[idx] += (burst_bytes > 0)
        # 3. advancing kv fetch at chip power
        self.span_c2c[idx] += fetch_dur
        self.c2c_bytes[idx] += fetch_bytes
        self.energy_J[idx] += fetch_dur * power_W
        self.busy_s[idx] += fetch_dur
        self.now[idx] += fetch_dur
        has_fetch = fetch_bytes > 0
        self.n_c2c[idx] += has_fetch
        self.n_sample[idx] += has_fetch & (power_W > 0)
        # 4. token emits
        self.tokens[idx] += batch
        self.n_token[idx] += batch

    def decode_burst(self, idx: np.ndarray, h: np.ndarray, dt: np.ndarray,
                     power_W: np.ndarray, batch: np.ndarray,
                     burst_bytes: np.ndarray, burst_dur: np.ndarray,
                     fetch_bytes: np.ndarray, fetch_dur: np.ndarray,
                     next_arrival: np.ndarray,
                     wake_dt: Optional[np.ndarray] = None,
                     wake_cyc: Optional[np.ndarray] = None,
                     risk_eta: Optional[np.ndarray] = None,
                     risk_bound: Optional[np.ndarray] = None) -> np.ndarray:
        """Apply up to ``h[k]`` consecutive decode rounds to each lane
        ``idx[k]`` in one shot — bit-identical to calling
        :meth:`decode_round` that many times per lane, because
        ``np.add.accumulate`` is a strict sequential left fold (no
        pairwise regrouping) and each accumulator's fold starts from its
        current value (row 0 of the increment matrix).

        ``dt`` is the per-round compute duration, shape ``(H, n)`` with
        ``H >= h.max()``; row ``j`` prices round ``j+1`` of the burst.
        Rows beyond a lane's ``h`` are ignored (each lane's result is
        gathered at its own prefix position, so garbage rows past the
        horizon never contribute).

        Rounds are additionally truncated at the lane's next request
        arrival: the scalar engine admits (and leaves pure decode) once
        its clock reaches ``next_arrival``, so a burst must not price
        rounds past that point.  Returns the per-lane round counts
        actually applied (``>= 1`` — callers guarantee no arrival is due
        at burst entry).

        ``wake_dt`` / ``wake_cyc`` (dynamic CCPG): a per-lane constant
        ``ClusterWake`` walk replayed *before* each round's compute —
        ``busy/energy/now`` see an extra add per round in the scalar
        order, ``("ClusterWake", None)`` span/cycles and the wake/sample
        counts advance for lanes with ``wake_dt > 0``.  Zero-``wake_dt``
        lanes are bit-neutral.

        ``risk_eta`` / ``risk_bound`` (TTFT deadlines): rounds are also
        truncated once the lane's clock would put its queue head at
        deadline risk — round ``j`` runs only while
        ``clock_before_j + risk_eta < risk_bound`` (the scalar engine's
        ``clock + prefill_eta >= arrival + deadline_ttft`` at-risk test,
        same float expression).  Pass ``risk_eta = 0.0`` /
        ``risk_bound = inf`` for unconstrained lanes.
        """
        n = int(idx.size)
        H = int(h.max())
        dt = dt[:H]
        lanes = np.arange(n)
        if wake_dt is not None and wake_dt.any():
            return self._decode_burst_wake(
                idx, h, dt, power_W, batch, burst_bytes, burst_dur,
                fetch_bytes, fetch_dur, next_arrival, wake_dt, wake_cyc,
                risk_eta, risk_bound)
        if not fetch_bytes.any():
            # Fetch-free fast path: every accumulator sees exactly one
            # add per round (the fetch adds would all be `x + 0.0`,
            # which is bit-neutral on the non-negative accumulators but
            # doubles the fold depth) — fold all seven in one matrix.
            inc = np.empty((H + 1, 7 * n))
            starts = (self.now, self.busy_s, self.energy_J,
                      self.span_c2c, self.span_compute, self.span_decode,
                      self.occupancy_s)
            for k, a in enumerate(starts):
                inc[0, k * n:(k + 1) * n] = a[idx]
            inc[1:, 0 * n:1 * n] = dt
            inc[1:, 1 * n:2 * n] = dt
            inc[1:, 2 * n:3 * n] = dt * power_W
            inc[1:, 3 * n:4 * n] = burst_dur
            inc[1:, 4 * n:5 * n] = dt
            inc[1:, 5 * n:6 * n] = dt
            inc[1:, 6 * n:7 * n] = dt * batch
            acc = np.add.accumulate(inc, axis=0)
            # Round j+1 (0-based j) runs only while the clock *before*
            # it — acc row j of the `now` block — is short of the
            # arrival; monotone, so the count is the prefix length.
            j = np.arange(H)[:, None]
            clock = acc[:H, :n]
            ok = clock < next_arrival
            if risk_eta is not None:
                ok &= (clock + risk_eta) < risk_bound
            h = (ok & (j < h)).sum(axis=0)
            for k, a in enumerate(starts):
                a[idx] = acc[h, k * n + lanes]
            self.tokens[idx] += batch * h
            self.c2c_bytes[idx] += burst_bytes * h
            self.n_compute[idx] += h
            self.n_token[idx] += batch * h
            self.n_c2c[idx] += (burst_bytes > 0) * h
            self.n_sample[idx] += h
            return h
        # Clock prefix first: interleave (dt, fetch_dur) per round — the
        # scalar order is now += dt then now += fetch_dur — with the
        # current clock in row 0 so the fold seeds correctly.
        incN = np.empty((2 * H + 1, n))
        incN[0] = self.now[idx]
        incN[1::2] = dt
        incN[2::2] = fetch_dur
        accN = np.add.accumulate(incN, axis=0)
        # Round j+1 (0-based j) runs only while the clock *before* it —
        # accN[2j] — is still short of the arrival; the predicate is
        # monotone (clock never decreases) so the count is the prefix
        # length.
        j = np.arange(H)[:, None]
        clock = accN[0:2 * H:2]
        ok = clock < next_arrival
        if risk_eta is not None:
            ok &= (clock + risk_eta) < risk_bound
        h = (ok & (j < h)).sum(axis=0)
        r2 = 2 * h
        self.now[idx] = accN[r2, lanes]
        # busy / energy / span_c2c also see two adds per round, with
        # per-accumulator increments; fold all three in one accumulate.
        incB = np.empty((2 * H + 1, 3 * n))
        incB[0, :n] = self.busy_s[idx]
        incB[0, n:2 * n] = self.energy_J[idx]
        incB[0, 2 * n:] = self.span_c2c[idx]
        incB[1::2, :n] = dt
        incB[2::2, :n] = fetch_dur
        incB[1::2, n:2 * n] = dt * power_W
        incB[2::2, n:2 * n] = fetch_dur * power_W
        incB[1::2, 2 * n:] = burst_dur
        incB[2::2, 2 * n:] = fetch_dur
        accB = np.add.accumulate(incB, axis=0)
        self.busy_s[idx] = accB[r2, lanes]
        self.energy_J[idx] = accB[r2, n + lanes]
        self.span_c2c[idx] = accB[r2, 2 * n + lanes]
        # One-add-per-round accumulators: span_compute / span_decode
        # (same increments, different starts) and occupancy.
        incS = np.empty((H + 1, 3 * n))
        incS[0, :n] = self.span_compute[idx]
        incS[0, n:2 * n] = self.span_decode[idx]
        incS[0, 2 * n:] = self.occupancy_s[idx]
        incS[1:, :n] = dt
        incS[1:, n:2 * n] = dt
        incS[1:, 2 * n:] = dt * batch
        accS = np.add.accumulate(incS, axis=0)
        self.span_compute[idx] = accS[h, lanes]
        self.span_decode[idx] = accS[h, lanes + n]
        self.occupancy_s[idx] = accS[h, lanes + 2 * n]
        # Integer counters are associative — closed form is exact.
        self.tokens[idx] += batch * h
        self.c2c_bytes[idx] += (burst_bytes + fetch_bytes) * h
        self.n_compute[idx] += h
        self.n_token[idx] += batch * h
        self.n_c2c[idx] += ((burst_bytes > 0).astype(np.int64)
                            + (fetch_bytes > 0)) * h
        self.n_sample[idx] += h + ((fetch_bytes > 0) & (power_W > 0)) * h
        return h

    def _decode_burst_wake(self, idx, h, dt, power_W, batch,
                           burst_bytes, burst_dur, fetch_bytes, fetch_dur,
                           next_arrival, wake_dt, wake_cyc,
                           risk_eta, risk_bound) -> np.ndarray:
        """Dynamic-CCPG decode burst: each round replays the scalar
        engine's ``ClusterWake`` walk, then compute, then the (possibly
        zero) kv fetch — ``now/busy/energy`` fold three adds per round
        in that order.  ``dt`` is already trimmed to ``(H, n)``.
        Zero-``wake_dt`` lanes add ``x + 0.0`` on non-negative
        accumulators (bit-neutral) and are excluded from the wake
        span/cycle/count columns.
        """
        n = int(idx.size)
        H = dt.shape[0]
        lanes = np.arange(n)
        # now / busy / energy: wake, compute, fetch adds per round.
        inc3 = np.empty((3 * H + 1, 3 * n))
        inc3[0, :n] = self.now[idx]
        inc3[0, n:2 * n] = self.busy_s[idx]
        inc3[0, 2 * n:] = self.energy_J[idx]
        inc3[1::3, :n] = wake_dt
        inc3[2::3, :n] = dt
        inc3[3::3, :n] = fetch_dur
        inc3[1::3, n:2 * n] = wake_dt
        inc3[2::3, n:2 * n] = dt
        inc3[3::3, n:2 * n] = fetch_dur
        inc3[1::3, 2 * n:] = wake_dt * power_W
        inc3[2::3, 2 * n:] = dt * power_W
        inc3[3::3, 2 * n:] = fetch_dur * power_W
        acc3 = np.add.accumulate(inc3, axis=0)
        j = np.arange(H)[:, None]
        clock = acc3[0:3 * H:3, :n]
        ok = clock < next_arrival
        if risk_eta is not None:
            ok &= (clock + risk_eta) < risk_bound
        h = (ok & (j < h)).sum(axis=0)
        r3 = 3 * h
        self.now[idx] = acc3[r3, lanes]
        self.busy_s[idx] = acc3[r3, n + lanes]
        self.energy_J[idx] = acc3[r3, 2 * n + lanes]
        # span_c2c: two adds per round (decode burst, then fetch).
        inc2 = np.empty((2 * H + 1, n))
        inc2[0] = self.span_c2c[idx]
        inc2[1::2] = burst_dur
        inc2[2::2] = fetch_dur
        self.span_c2c[idx] = np.add.accumulate(inc2, axis=0)[2 * h, lanes]
        # One add per round: compute/decode spans, occupancy, wake span.
        incS = np.empty((H + 1, 4 * n))
        incS[0, :n] = self.span_compute[idx]
        incS[0, n:2 * n] = self.span_decode[idx]
        incS[0, 2 * n:3 * n] = self.occupancy_s[idx]
        incS[0, 3 * n:] = self.span_wake[idx]
        incS[1:, :n] = dt
        incS[1:, n:2 * n] = dt
        incS[1:, 2 * n:3 * n] = dt * batch
        incS[1:, 3 * n:] = wake_dt
        accS = np.add.accumulate(incS, axis=0)
        self.span_compute[idx] = accS[h, lanes]
        self.span_decode[idx] = accS[h, lanes + n]
        self.occupancy_s[idx] = accS[h, lanes + 2 * n]
        self.span_wake[idx] = accS[h, lanes + 3 * n]
        # Integer counters are associative — closed form is exact.
        woke = wake_dt > 0
        self.tokens[idx] += batch * h
        self.c2c_bytes[idx] += (burst_bytes + fetch_bytes) * h
        self.cyc_wake[idx] += woke * wake_cyc * h
        self.n_wake[idx] += woke * h
        self.n_compute[idx] += h
        self.n_token[idx] += batch * h
        self.n_c2c[idx] += ((burst_bytes > 0).astype(np.int64)
                            + (fetch_bytes > 0)) * h
        self.n_sample[idx] += (h + woke * h
                               + ((fetch_bytes > 0) & (power_W > 0)) * h)
        return h

    def prefill_burst(self, idx: np.ndarray, h: np.ndarray, dt: np.ndarray,
                      power_W: np.ndarray, burst_bytes: np.ndarray,
                      burst_dur: np.ndarray, next_arrival: np.ndarray,
                      wake_dt: Optional[np.ndarray] = None,
                      wake_cyc: Optional[np.ndarray] = None) -> np.ndarray:
        """Apply up to ``h[k]`` consecutive *full-cap prefill chunk*
        steps to each lane ``idx[k]`` — the vectorized equivalent of the
        scalar engine's per-chunk appends while a partial prefill cruises
        alone (no residents, no due arrival):

          1. optional dynamic-CCPG ``ClusterWake`` walk (``wake_dt``)
          2. ``compute(dt_j, kind="prefill", power_W, batch=1)``
          3. concurrent prefill C2C (``burst_bytes`` over ``burst_dur``;
             non-advancing, zero bytes skip the scalar append —
             bit-neutral here)

        ``dt`` has shape ``(H, n)``: row ``j`` prices chunk ``j+1``
        (context grows by the chunk cap each step).  Chunks truncate at
        the lane's next arrival, exactly like :meth:`decode_burst`.
        Returns the per-lane chunk counts applied.
        """
        n = int(idx.size)
        H = int(h.max())
        dt = dt[:H]
        lanes = np.arange(n)
        j = np.arange(H)[:, None]
        if wake_dt is not None and wake_dt.any():
            # now / busy / energy: wake + compute adds per round.
            inc2 = np.empty((2 * H + 1, 3 * n))
            inc2[0, :n] = self.now[idx]
            inc2[0, n:2 * n] = self.busy_s[idx]
            inc2[0, 2 * n:] = self.energy_J[idx]
            inc2[1::2, :n] = wake_dt
            inc2[2::2, :n] = dt
            inc2[1::2, n:2 * n] = wake_dt
            inc2[2::2, n:2 * n] = dt
            inc2[1::2, 2 * n:] = wake_dt * power_W
            inc2[2::2, 2 * n:] = dt * power_W
            acc2 = np.add.accumulate(inc2, axis=0)
            h = ((acc2[0:2 * H:2, :n] < next_arrival)
                 & (j < h)).sum(axis=0)
            r2 = 2 * h
            self.now[idx] = acc2[r2, lanes]
            self.busy_s[idx] = acc2[r2, n + lanes]
            self.energy_J[idx] = acc2[r2, 2 * n + lanes]
            # One add per round: spans, occupancy (batch == 1), wake.
            incS = np.empty((H + 1, 5 * n))
            incS[0, :n] = self.span_compute[idx]
            incS[0, n:2 * n] = self.span_prefill[idx]
            incS[0, 2 * n:3 * n] = self.span_c2c[idx]
            incS[0, 3 * n:4 * n] = self.occupancy_s[idx]
            incS[0, 4 * n:] = self.span_wake[idx]
            incS[1:, :n] = dt
            incS[1:, n:2 * n] = dt
            incS[1:, 2 * n:3 * n] = burst_dur
            incS[1:, 3 * n:4 * n] = dt
            incS[1:, 4 * n:] = wake_dt
            accS = np.add.accumulate(incS, axis=0)
            self.span_compute[idx] = accS[h, lanes]
            self.span_prefill[idx] = accS[h, lanes + n]
            self.span_c2c[idx] = accS[h, lanes + 2 * n]
            self.occupancy_s[idx] = accS[h, lanes + 3 * n]
            self.span_wake[idx] = accS[h, lanes + 4 * n]
            woke = wake_dt > 0
            self.cyc_wake[idx] += woke * wake_cyc * h
            self.n_wake[idx] += woke * h
            self.c2c_bytes[idx] += burst_bytes * h
            self.n_compute[idx] += h
            self.n_sample[idx] += h + woke * h
            self.n_c2c[idx] += (burst_bytes > 0) * h
            return h
        # Wake-free: one add per round on every accumulator.
        inc = np.empty((H + 1, 7 * n))
        starts = (self.now, self.busy_s, self.energy_J, self.span_c2c,
                  self.span_compute, self.span_prefill, self.occupancy_s)
        for k, a in enumerate(starts):
            inc[0, k * n:(k + 1) * n] = a[idx]
        inc[1:, 0 * n:1 * n] = dt
        inc[1:, 1 * n:2 * n] = dt
        inc[1:, 2 * n:3 * n] = dt * power_W
        inc[1:, 3 * n:4 * n] = burst_dur
        inc[1:, 4 * n:5 * n] = dt
        inc[1:, 5 * n:6 * n] = dt
        inc[1:, 6 * n:7 * n] = dt  # occupancy: batch == 1 during cruise
        acc = np.add.accumulate(inc, axis=0)
        h = ((acc[:H, :n] < next_arrival) & (j < h)).sum(axis=0)
        for k, a in enumerate(starts):
            a[idx] = acc[h, k * n + lanes]
        self.c2c_bytes[idx] += burst_bytes * h
        self.n_compute[idx] += h
        self.n_sample[idx] += h
        self.n_c2c[idx] += (burst_bytes > 0) * h
        return h
