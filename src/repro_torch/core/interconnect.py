"""Chip-to-chip interconnect energy/latency: silicon photonics vs
electrical (paper §II-D, §IV-C, Fig 9/10).

The optical engine die carries a laser source, microring modulators,
switching elements and photodetectors; the model reduces this to an
energy-per-bit + static laser bias + serialization bandwidth, which is the
level the paper evaluates at (average C2C power for a traffic trace).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

from .energy import E_DRAM_ACCESS, E_ELECTRICAL_C2C, E_OPTICAL_C2C


@dataclass(frozen=True)
class LinkSpec:
    kind: str                 # "optical" | "electrical"
    energy_per_bit: float     # J/bit
    bandwidth_Bps: float      # bytes/s
    static_watts: float = 0.0


# laser bias is shared across the pod's links (comb source) -> small
# per-link static allocation [15]
OPTICAL = LinkSpec("optical", E_OPTICAL_C2C, 64e9, static_watts=0.002)
ELECTRICAL = LinkSpec("electrical", E_ELECTRICAL_C2C, 16e9)


def c2c_average_power(bytes_per_second: float, link: LinkSpec,
                      duty: float | None = None) -> float:
    """Average power at a given traffic rate.  ``duty`` is the fraction of
    time the link is active; C2C traffic is bursty (Fig 10: <1% link
    utilization) and the laser/modulator bias is gated between bursts, so
    the static term is duty-cycled.  duty=None derives it from the rate."""
    if duty is None:
        duty = min(1.0, bytes_per_second / link.bandwidth_Bps)
    return bytes_per_second * 8 * link.energy_per_bit \
        + link.static_watts * duty


def c2c_transfer_time(payload_bytes: int, link: LinkSpec) -> float:
    return payload_bytes / link.bandwidth_Bps


def dram_access_power(bytes_per_second: float) -> float:
    return bytes_per_second * 8 * E_DRAM_ACCESS


def retransmit_overhead_bytes(payload_bytes: int,
                              retransmit_frac: float) -> int:
    """Extra wire bytes a degraded link re-sends for one transfer.

    When ring-resonator thermal drift pushes the BER past the FEC
    budget, a ``retransmit_frac`` fraction of the payload fails FEC and
    is re-transmitted (launch/config.LinkFault window).  The overhead
    rides the same :class:`LinkSpec` as the payload — priced on the
    timeline as ``C2CTransfer(phase="retransmit")`` with duration
    ``c2c_transfer_time(overhead, link)`` — so a degraded window slows
    *and* burns energy exactly in proportion to the traffic it carries.
    """
    if retransmit_frac <= 0.0:
        return 0
    return int(int(payload_bytes) * retransmit_frac)


def fleet_handoff_bytes(context_tokens: int, bytes_per_token: int,
                        measured: "Optional[MeasuredTraffic]" = None
                        ) -> int:
    """Wire bytes for ONE prefill -> decode KV handoff across the
    inter-node fabric (launch/fleet_engine.py).

    Analytic Table-II-style default: the KV footprint of the resident
    context (``context_tokens * bytes_per_token``).  With ``measured``
    (HLO-captured traffic, see :class:`MeasuredTraffic`) the sharded
    re-establishment cost is charged on top — re-admitting the KV on the
    destination node's chiplets replays the prefill's measured
    collective wire bytes, traffic the analytic footprint ignores."""
    nbytes = int(context_tokens) * int(bytes_per_token)
    if measured is not None:
        nbytes += int(measured.prefill_bytes)
    return nbytes


@dataclass(frozen=True)
class MeasuredTraffic:
    """Photonic-link traffic measured from compiled (SPMD-partitioned) HLO.

    Produced by ``launch/collective_capture.py``: the TP×SP×PP cells are
    lowered, ``hlo_cost.analyze`` extracts per-collective ring-model wire
    bytes, and the totals land here — the measured replacement for the
    cycle model's analytic layer-boundary C2C estimate (the same
    measured-traffic methodology as Photonic Fabric, arXiv:2507.14000).

    ``prefill_bytes``: total link bytes for one prefill of the prompt.
    ``decode_bytes_per_token``: total link bytes per generated token
    (one sharded decode step, normalized per request).
    ``per_collective``: op -> {count, bytes, wire_bytes} per chip per step,
    as reported by ``hlo_cost.Cost.coll`` — kept for reporting.
    """
    prefill_bytes: float
    decode_bytes_per_token: float
    per_collective: Mapping[str, Mapping[str, float]] = \
        field(default_factory=dict)
    n_devices: int = 1
    source: str = "hlo"


@dataclass
class TrafficTrace:
    """(t_start_s, duration_s, bytes) C2C burst events — Fig 10."""
    events: List[Tuple[float, float, int]]

    @classmethod
    def from_timeline(cls, timeline) -> "TrafficTrace":
        """Build the Fig-10 burst trace from a TimelineIR event stream
        (core/timeline.Timeline): every C2CTransfer event becomes one
        burst.  Duck-typed on ``nbytes`` to keep interconnect free of a
        timeline import."""
        events = [(e.t0, e.dur_s, e.nbytes) for e in timeline.events
                  if hasattr(e, "nbytes")]
        return cls(events)

    def average_power(self, link: LinkSpec, horizon_s: float) -> float:
        total_bits = sum(b for _, _, b in self.events) * 8
        return total_bits * link.energy_per_bit / horizon_s + link.static_watts

    def utilization(self, horizon_s: float) -> float:
        busy = sum(d for _, d, _ in self.events)
        return busy / horizon_s

    def binned(self, horizon_s: float, n_bins: int = 100) -> List[float]:
        """Average C2C bandwidth per bin (GB/s) — the Fig 10 timeline."""
        bins = [0.0] * n_bins
        dt = horizon_s / n_bins
        for t, d, b in self.events:
            i = min(int(t / dt), n_bins - 1)
            bins[i] += b
        return [b / dt / 1e9 for b in bins]
