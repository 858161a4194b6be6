"""Chiplet Clustering and Power Gating — CCPG (paper §II-E, Fig 5).

Four adjacent compute-tile chiplets form a cluster.  During runtime only
ONE cluster is fully activated; every other cluster keeps only its
scratchpad modules powered (context-window / KV retention) while all other
macros sleep.  RRAM weights are unaffected (non-volatile).

The model exposes system power with/without CCPG and the wake-up overhead
that makes throughput "similar" rather than identical.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from .energy import TileSpec
from .scheduling import ChipletAllocation

CLUSTER_SIZE = 4


@dataclass
class CCPGModel:
    tile: TileSpec = field(default_factory=TileSpec)
    wake_cycles: int = 1000          # cluster power-up (regulator settle)
    dram_hub_watts: float = 0.25     # DRAM hub + IO (external comms, §II)
    optical_base_watts: float = 0.05  # laser bias per active link
    # Table II excludes the DRAM hub (weights live in RRAM, embeddings are
    # streamed once); opt in when modelling the full package
    include_dram_hub: bool = False

    def system_power(self, n_chiplets: int, *, ccpg: bool) -> float:
        if not ccpg:
            p = n_chiplets * self.tile.tile_power_active
        else:
            n_sleep = max(0, n_chiplets - CLUSTER_SIZE)
            n_active = min(n_chiplets, CLUSTER_SIZE)
            p = (n_active * self.tile.tile_power_active
                 + n_sleep * self.tile.tile_power_sleep)
        if self.include_dram_hub:
            p += self.dram_hub_watts
        return p

    def power_saving_frac(self, n_chiplets: int) -> float:
        p0 = self.system_power(n_chiplets, ccpg=False)
        if p0 <= 0.0:
            return 0.0               # nothing to gate on an empty system
        p1 = self.system_power(n_chiplets, ccpg=True)
        return 1.0 - p1 / p0

    def wake_overhead_cycles(self, alloc: ChipletAllocation) -> int:
        """Per decode token: each cluster transition wakes the next cluster.
        Wake-up is overlapped with the previous cluster's tail compute
        (pre-wake one cluster ahead), leaving a small exposed residue.
        (Cheap arithmetic on purpose — the serving engine snapshots the
        residue once per run rather than calling this per iteration.)"""
        n_transitions = max(0, alloc.n_clusters - 1)
        exposed = max(0, self.wake_cycles - 2000)   # pre-wake hides ~2us
        return n_transitions * exposed + n_transitions * 16  # ctrl overhead

    def wake_latency_cycles(self, alloc: ChipletAllocation) -> int:
        """Dynamic mode: the FULL regulator-settle latency (`wake_cycles`)
        is exposed on every cluster transition — no pre-wake overlap.
        This is what the timeline layer emits as real `ClusterWake`
        events; the static path above keeps only the folded-in residue,
        which leaves `wake_cycles` dead state at its default value."""
        n_transitions = max(0, alloc.n_clusters - 1)
        return n_transitions * (self.wake_cycles + 16)  # settle + ctrl

    def wake_overhead_cycles_batched(self, alloc: ChipletAllocation,
                                     batch_size: int) -> int:
        """Cluster residency is shared by a co-scheduled batch: one engine
        iteration walks the cluster sequence ONCE (all requests ride the
        same activation wave through the active cluster), so the wake
        residue is charged per iteration — not per request.  This is the
        reason batching improves tokens/J *more* with CCPG than without."""
        if batch_size <= 0:
            return 0
        return self.wake_overhead_cycles(alloc)

    def idle_power(self, n_chiplets: int, *, ccpg: bool) -> float:
        """Power while NO request is in flight.  With CCPG every cluster
        sleeps (scratchpads retain KV; RRAM weights are non-volatile);
        without it the chiplets have no gating path and burn active power.
        """
        if ccpg:
            p = n_chiplets * self.tile.tile_power_sleep
            if self.include_dram_hub:
                p += self.dram_hub_watts   # the hub has no gating path
            return p
        return self.system_power(n_chiplets, ccpg=False)

    def scaling_table(self, chiplet_counts: List[int]) -> List[dict]:
        rows = []
        for n in chiplet_counts:
            rows.append({
                "chiplets": n,
                "power_no_ccpg_W": self.system_power(n, ccpg=False),
                "power_ccpg_W": self.system_power(n, ccpg=True),
                "saving_%": 100 * self.power_saving_frac(n),
            })
        return rows
