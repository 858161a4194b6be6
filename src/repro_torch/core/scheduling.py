"""Temporal scheduling & layer-to-chiplet allocation (paper §III).

* Layer-wise chiplet allocation: each chiplet stores an attention layer or
  a feed-forward layer (a decoder's gate/up/down count as separate FF
  layers, as the paper does for Llama); layers that exceed one chiplet's
  67.1M-weight capacity span multiple chiplets.
* FlashAttention schedule: the two-level nested loop (outer over KV blocks,
  inner over Q rows) is mapped so the inner loop partially unrolls across
  the DMAC lanes of the routers holding the K/V scratchpads.
* KV cache: cyclically striped across the scratchpads pre-allocated to
  K/V (partition.ScratchpadPlan), so utilization stays balanced at any
  sequence length.

The cycle model below turns a schedule into per-token cycles; its two
calibration constants are fitted once on the Llama-1B/512 row (see
simulator.calibrate) and then validated against the other 8 rows of
Table II.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .energy import TileSpec
from .mapping import map_layer
from .noc import Mesh2D, MeshConfig
from .partition import PEArraySpec, attention_grids, ffn_grids, TileGrid


@dataclass(frozen=True)
class LayerDesc:
    kind: str                 # "attn" | "ffn" | "moe_ffn" | "ssm"
    name: str
    matrices: Tuple[Tuple[str, int, int], ...]   # (name, in_dim, out_dim)

    @property
    def n_weights(self) -> int:
        return sum(i * o for _, i, o in self.matrices)


def llm_layers(cfg) -> List[LayerDesc]:
    """Decompose a ModelConfig into PICNIC layers (paper granularity)."""
    layers: List[LayerDesc] = []
    d = cfg.d_model
    for li in range(cfg.n_layers):
        if cfg.family in ("ssm",) :
            di = cfg.ssm.expand * d
            h = di // cfg.ssm.head_dim
            layers.append(LayerDesc("ssm", f"L{li}.ssm", (
                ("in_proj", d, 2 * di + 2 * cfg.ssm.d_state + h),
                ("out_proj", di, d))))
            continue
        is_hybrid_attn = (cfg.family == "hybrid"
                          and (li + 1) % max(cfg.attn_every, 1) == 0)
        if cfg.family == "hybrid" and not is_hybrid_attn:
            di = cfg.ssm.expand * d
            h = di // cfg.ssm.head_dim
            layers.append(LayerDesc("ssm", f"L{li}.ssm", (
                ("in_proj", d, 2 * di + 2 * cfg.ssm.d_state + h),
                ("out_proj", di, d))))
            continue
        layers.append(LayerDesc("attn", f"L{li}.attn", (
            ("W_Q", d, cfg.q_dim), ("W_K", d, cfg.kv_dim),
            ("W_V", d, cfg.kv_dim), ("W_O", cfg.q_dim, d))))
        dff = cfg.moe.d_ff_expert if (cfg.moe and
                                      (li % cfg.moe_every == cfg.moe_every - 1)) \
            else cfg.d_ff
        n_ff = (cfg.moe.top_k + cfg.moe.n_shared_experts) if (
            cfg.moe and (li % cfg.moe_every == cfg.moe_every - 1)) else 1
        gated = cfg.mlp in ("swiglu", "geglu")
        names = ("W_gate", "W_up", "W_down") if gated else ("W_up", "W_down")
        for e in range(n_ff):
            for nm in names:
                if nm == "W_down":
                    layers.append(LayerDesc(
                        "ffn", f"L{li}.{nm}{e}", ((nm, dff, d),)))
                else:
                    layers.append(LayerDesc(
                        "ffn", f"L{li}.{nm}{e}", ((nm, d, dff),)))
    return layers


def total_weight_params(cfg) -> int:
    """Weights resident in RRAM (embeddings stay in DRAM)."""
    n = cfg.n_params(include_embeddings=False)
    if cfg.moe:
        # all experts are resident (non-volatile), even if only top-k active
        pass
    return n


@dataclass
class ChipletAllocation:
    """Layer -> chiplet ids (a layer may span several chiplets)."""
    assignments: List[Tuple[LayerDesc, List[int]]]
    n_chiplets: int
    tile: TileSpec

    @property
    def n_clusters(self) -> int:
        return -(-self.n_chiplets // 4)          # clusters of 4 (paper Fig 5)


def layer_tiles(ld: LayerDesc, pe: PEArraySpec = PEArraySpec()) -> int:
    """256x256 crossbar tiles needed by a layer (partition.py tiling)."""
    t = 0
    for _, i, o in ld.matrices:
        t += (-(-i // pe.rows)) * (-(-o // pe.cols))
    return t


def allocate_chiplets(cfg, tile: TileSpec = TileSpec()) -> ChipletAllocation:
    """Tile-granular greedy packing in layer order (paper §III-1/2: matrices
    are partitioned into 256x256 crossbar tiles and packed into the 1024
    router-PE pairs of consecutive chiplets).  Table II's measured power is
    reproduced only by tile-granular packing — pure layer-per-chiplet
    rounding overshoots 13B power by ~65%."""
    pairs_per_chip = tile.n_pairs
    layers = llm_layers(cfg)
    assignments: List[Tuple[LayerDesc, List[int]]] = []
    tiles_used = 0
    for ld in layers:
        t = layer_tiles(ld)
        first = tiles_used // pairs_per_chip
        last = (tiles_used + t - 1) // pairs_per_chip
        assignments.append((ld, list(range(first, last + 1))))
        tiles_used += t
    n = -(-tiles_used // pairs_per_chip)
    return ChipletAllocation(assignments, max(n, 1), tile)


# ---------------------------------------------------------------------------
# Cycle model
# ---------------------------------------------------------------------------

@dataclass
class CycleModel:
    """Per-token cycle counts from the mapped schedule.

    alpha: global pipeline-inefficiency factor (program fetch, FSM fill,
           bank swaps) — calibrated.
    dmac_eff: effective utilization of the 16-lane router DMACs during the
           FlashAttention inner loop — calibrated.
    """
    mesh: MeshConfig = field(default_factory=MeshConfig)
    pe: PEArraySpec = field(default_factory=PEArraySpec)
    alpha: float = 1.0
    # Memoize per-shape cycle costs (the serving fast path).  The decode
    # cost of one iteration depends only on (batch, sum(contexts)) given
    # an allocation, and is AFFINE in sum(contexts) — verified against
    # the direct layer walk at cache-fill time, so a subclass with a
    # non-affine override transparently falls back to the walk.  All
    # calibration constants participate in the cache key, so mutating
    # `alpha` & friends (tests do) can never serve a stale entry.
    memoize: bool = True
    # Memo capacities (entries, LRU-evicted).  Thousand-cell sweeps share
    # one CycleModel across every cell of a grid; if the working set of
    # (alloc, batch) / (chunk, ctx_before) shapes exceeds these, the LRU
    # thrashes silently — memo_stats() exposes hit/miss/eviction counters
    # so the thrash is visible and the knobs make it fixable.
    decode_memo_max: int = 256
    prefill_memo_max: int = 4096
    # --- calibrated constants (least-squares fit on the nine Table II rows;
    #     all rows reproduced within +-7%, see EXPERIMENTS.md) -------------
    # 1. Per-token SMAC cost: 'cycles_per_tile' per active 256x256 crossbar
    #    tile (bit-serial DAC in + shared-ADC column readout + in-network
    #    partial-sum accumulation, pipelined as a wave across the region).
    #    Table II decomposes as T = a*tiles + b*L*ctx + c*L with a~34.4
    #    consistently across 1B/8B/13B.
    cycles_per_tile: float = 34.394
    # 2. FlashAttention inner loop: transport-bound on KV-scratchpad reads +
    #    SCU round trip -> ~53.6 cycles per context position per decoder
    #    layer, independent of head count (heads run in parallel lanes).
    ctx_cycles_per_pos: float = 53.618
    # 3. Per-decoder-layer fixed overhead (NPM bank swap, layer-boundary
    #    sync, C2C handoff) ~9.1k cycles.
    layer_fixed_cycles: float = 9112.0
    softmax_overhead: int = 16
    c2c_bytes_per_cycle: float = 64.0      # optical engine burst BW
    c2c_latency: int = 100
    # 4. Batched decode: weights are stationary in the RRAM crossbars, so a
    #    co-scheduled batch re-uses the same crossbar read/settle wave; each
    #    extra batch element only pays the bit-serial DAC input streaming +
    #    shared-ADC column readout slot of the pipelined wave (~18% of the
    #    full per-tile cost — the DAC-in/ADC-out stages of the 34.4-cycle
    #    tile pipeline).  KV-scratchpad reads and C2C activation traffic do
    #    NOT amortize: every request owns its context.
    batch_issue_frac: float = 0.18

    # the decode affinity check probes the direct walk at these ctx sums;
    # a mismatch at any of them marks the (alloc, b) entry non-affine
    _AFFINE_PROBES = (1, 1009, 65537)
    # legacy class-level capacity aliases (pre-knob callers); the
    # instance fields above are authoritative
    _DECODE_MEMO_MAX = 256
    _PREFILL_MEMO_MAX = 4096
    # any assignment to these invalidates the memo (via the version
    # stamp baked into every cache key); mutating a nested MeshConfig /
    # PEArraySpec IN PLACE is not observable — replace the object instead
    _CALIBRATION_FIELDS = frozenset({
        "mesh", "pe", "alpha", "cycles_per_tile", "ctx_cycles_per_pos",
        "layer_fixed_cycles", "softmax_overhead", "c2c_bytes_per_cycle",
        "c2c_latency", "batch_issue_frac"})

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        if name in self._CALIBRATION_FIELDS:
            # bump the memo-key version; tests mutate alpha & friends
            # freely and must never see a stale cached cost
            object.__setattr__(self, "_cal_ver",
                               getattr(self, "_cal_ver", 0) + 1)
            object.__setattr__(self, "_decode_hot", None)

    def __post_init__(self):
        # (key) -> (base_cycles, n_attn | None, c2c_cyc, c2c_bytes, alloc)
        # and (key) -> ((cycles, c2c_bytes), alloc); the alloc strong ref
        # pins id(alloc) for the lifetime of its entries
        self._decode_memo: "OrderedDict" = OrderedDict()
        self._decode_hot: Optional[tuple] = None   # last (key, entry)
        self._prefill_memo: "OrderedDict" = OrderedDict()
        self._stats = {
            "decode_hot_hits": 0, "decode_hits": 0, "decode_misses": 0,
            "decode_evictions": 0, "prefill_hits": 0, "prefill_misses": 0,
            "prefill_evictions": 0,
        }
        object.__setattr__(self, "_cal_ver", getattr(self, "_cal_ver", 0))

    def memo_stats(self) -> Dict[str, int]:
        """Hit/miss/eviction counters plus current sizes & capacities of
        the decode and prefill memos.  Non-zero ``*_evictions`` on a sweep
        means the LRU working set exceeds the capacity knobs
        (``decode_memo_max`` / ``prefill_memo_max``) and the grid is
        silently re-walking layer costs — raise the knob."""
        out = dict(self._stats)
        out["decode_size"] = len(self._decode_memo)
        out["decode_max"] = self.decode_memo_max
        out["prefill_size"] = len(self._prefill_memo)
        out["prefill_max"] = self.prefill_memo_max
        return out

    def _decode_key(self, cfg, alloc: ChipletAllocation, b: int) -> tuple:
        return (id(alloc), cfg.d_model, b, self._cal_ver)

    def smac_cycles(self, ld: LayerDesc) -> int:
        return int(self.cycles_per_tile * layer_tiles(ld, self.pe))

    def layer_decode_cycles_batched(self, ld: LayerDesc, ctx_sum: int,
                                    b: int) -> int:
        """One engine iteration through one layer for a batch of ``b``
        requests whose contexts sum to ``ctx_sum``: the weight-stationary
        crossbar wave is paid once (+``batch_issue_frac`` DAC/ADC
        streaming per extra request), KV-scratchpad reads are charged per
        request (``ctx_sum``), the layer-fixed overhead once, and the SCU
        softmax pass per request.  ``b == 1`` is the single-stream cost."""
        cyc = int(self.smac_cycles(ld)
                  * (1.0 + self.batch_issue_frac * (b - 1)))
        if ld.kind == "attn":
            cyc += int(self.ctx_cycles_per_pos * ctx_sum)
            cyc += int(self.layer_fixed_cycles) + self.softmax_overhead * b
        elif ld.kind == "ssm":
            cyc += int(self.layer_fixed_cycles)   # per-decoder overhead
        return cyc

    def layer_decode_cycles(self, ld: LayerDesc, d_model: int,
                            context: int, n_heads: int, q_dim: int,
                            kv_dim: int) -> int:
        """One token through one layer."""
        return self.layer_decode_cycles_batched(ld, context, 1)

    def c2c_transfer_cycles(self, payload_bytes: int) -> int:
        return self.c2c_latency + int(payload_bytes / self.c2c_bytes_per_cycle)

    def token_decode_cycles(self, cfg, alloc: ChipletAllocation,
                            context: int, *,
                            overlap: float = 0.0) -> Tuple[int, int]:
        """(cycles, c2c_bytes) for one decode token end to end."""
        return self.batched_token_decode_cycles(cfg, alloc, [context],
                                                overlap=overlap)

    def batched_token_decode_cycles(
            self, cfg, alloc: ChipletAllocation,
            contexts: List[int], *, overlap: float = 0.0) -> Tuple[int, int]:
        """(cycles, c2c_bytes) for ONE engine iteration that advances a
        co-scheduled batch of requests by one token each.

        Cost decomposition per layer (``b = len(contexts)``):
          * SMAC: the crossbar wave is paid once; extra batch elements
            stream through its DAC/ADC pipeline stages (``batch_issue_frac``
            each) — this is the weight-stationary amortization that makes
            batched decode sublinear in b.
          * Attention context: per-request KV-scratchpad reads, so the
            term is linear in sum(contexts) — no sharing.
          * Layer-fixed (NPM bank swap, boundary sync): once per
            iteration — the whole batch crosses the boundary together.
          * Softmax: one SCU pass per request.
          * C2C: per-request activation vectors cross chiplet boundaries
            together in one burst of ``b * d_model`` bytes.

        ``overlap`` (0..1) hides that fraction of the C2C transfer
        cycles under the next layer's compute wave (double-buffered
        activation forwarding); the default 0.0 serializes them — the
        calibrated Table II interpretation.

        ``b == 1`` at ``overlap == 0`` reproduces
        :meth:`token_decode_cycles`'s single-stream cost exactly (the
        calibrated Table II path is unchanged).
        """
        if not 0.0 <= overlap <= 1.0:
            raise ValueError(f"overlap must be in [0, 1], got {overlap}")
        compute_cyc, c2c_cyc, c2c_bytes = \
            self.batched_token_decode_cycles_split(cfg, alloc, contexts)
        if overlap:
            cyc = compute_cyc + (1.0 - overlap) * c2c_cyc
        else:
            cyc = compute_cyc + c2c_cyc   # exact int sum: legacy path
        return int(cyc * self.alpha), c2c_bytes

    def batched_token_decode_cycles_split(
            self, cfg, alloc: ChipletAllocation,
            contexts: Sequence[int]) -> Tuple[int, int, int]:
        """(compute_cycles, c2c_cycles, c2c_bytes) — the pre-``alpha``
        decomposition of one batched decode iteration, separating the
        layer compute wave from the chiplet-boundary C2C transfers so
        the timeline layer can model compute/C2C overlap explicitly.

        ``contexts`` may be any sequence (list or numpy array — the SoA
        serving engine passes its context column directly).  With
        ``memoize`` on, the O(layers) walk runs once per distinct
        ``(alloc, batch)`` shape; every later call is an O(1) affine
        lookup in ``sum(contexts)`` — bit-identical to the walk, which
        adds one independently truncated ``int(ctx_cycles_per_pos *
        ctx_sum)`` term per attention layer."""
        b = len(contexts)
        if b == 0:
            return 0, 0, 0
        ctx_sum = int(contexts.sum()) if hasattr(contexts, "sum") \
            else sum(contexts)
        if not self.memoize:
            return self._decode_split_walk(cfg, alloc, ctx_sum, b)
        key = self._decode_key(cfg, alloc, b)
        hot = self._decode_hot            # last (key, entry): the serving
        if hot is not None and hot[0] == key:  # loop repeats one shape
            entry = hot[1]
            base, n_attn, c2c_cyc, c2c_bytes, _ = entry
            if n_attn is not None:
                self._stats["decode_hot_hits"] += 1
                return (base
                        + n_attn * int(self.ctx_cycles_per_pos * ctx_sum),
                        c2c_cyc, c2c_bytes)
        memo = self._decode_memo
        entry = memo.get(key)
        if entry is None:
            self._stats["decode_misses"] += 1
            base, c2c_cyc, c2c_bytes = \
                self._decode_split_walk(cfg, alloc, 0, b)
            n_attn = sum(1 for ld, _ in alloc.assignments
                         if ld.kind == "attn")
            affine = all(
                self._decode_split_walk(cfg, alloc, p, b)[0]
                == base + n_attn * int(self.ctx_cycles_per_pos * p)
                for p in self._AFFINE_PROBES)
            entry = (base, n_attn if affine else None, c2c_cyc,
                     c2c_bytes, alloc)
            memo[key] = entry
            while len(memo) > self.decode_memo_max:
                memo.popitem(last=False)
                self._stats["decode_evictions"] += 1
        else:
            self._stats["decode_hits"] += 1
            memo.move_to_end(key)
        self._decode_hot = (key, entry)
        base, n_attn, c2c_cyc, c2c_bytes, _ = entry
        if n_attn is None:      # non-affine subclass: direct walk
            return self._decode_split_walk(cfg, alloc, ctx_sum, b)
        return (base + n_attn * int(self.ctx_cycles_per_pos * ctx_sum),
                c2c_cyc, c2c_bytes)

    def decode_affine_split(self, cfg, alloc: ChipletAllocation, b: int
                            ) -> Optional[Tuple[int, int, int, int,
                                                float, float, int]]:
        """Like :meth:`decode_affine` but with the serialized C2C cycles
        kept SEPARATE from the compute base: ``(base_compute_cycles,
        n_attn, c2c_cycles, c2c_bytes, ctx_cycles_per_pos, alpha,
        cal_ver)`` such that one batch-``b`` iteration at C2C overlap
        fraction ``ov`` costs exactly

            int((base_compute + n_attn * int(cpp * ctx_sum)
                 + (1.0 - ov) * c2c_cycles) * alpha)

        — the :meth:`batched_token_decode_cycles` ``overlap`` branch as
        plain arithmetic (the sweep engine's vectorized split-cost lane).
        At ``ov == 0`` the scalar engine folds ``c2c_cycles`` into the
        base as an exact int sum instead; both reductions are reproduced
        bit-for-bit from this decomposition.  ``None`` when memoization
        is off or the cost is non-affine."""
        if not self.memoize or b <= 0:
            return None
        key = self._decode_key(cfg, alloc, b)
        hot = self._decode_hot
        entry = hot[1] if (hot is not None and hot[0] == key) \
            else self._decode_memo.get(key)
        if entry is None:
            self._decode_hot = None      # force split() to (re)build
            self.batched_token_decode_cycles_split(cfg, alloc, [0] * b)
            entry = self._decode_memo[key]
        base, n_attn, c2c_cyc, c2c_bytes, _ = entry
        if n_attn is None:
            return None
        return (base, n_attn, c2c_cyc, c2c_bytes,
                self.ctx_cycles_per_pos, self.alpha, self._cal_ver)

    def decode_affine(self, cfg, alloc: ChipletAllocation, b: int
                      ) -> Optional[Tuple[int, int, int, float, float, int]]:
        """Fast-path export of the memoized decode decomposition:
        ``(base_cycles, n_attn, c2c_bytes, ctx_cycles_per_pos, alpha,
        cal_ver)`` such that one batch-``b`` iteration costs exactly

            int((base_cycles + n_attn * int(ctx_cycles_per_pos
                                            * sum(contexts))) * alpha)

        pre-CCPG cycles (``base_cycles`` already folds the serialized C2C
        transfer cycles in).  The serving engine inlines this as plain
        arithmetic in its round loop; the snapshot is valid while the
        returned ``cal_ver`` equals the model's current one.  ``None``
        when memoization is off or a subclass made the cost non-affine —
        callers must fall back to :meth:`batched_token_decode_cycles`."""
        if not self.memoize or b <= 0:
            return None
        key = self._decode_key(cfg, alloc, b)
        hot = self._decode_hot
        entry = hot[1] if (hot is not None and hot[0] == key) \
            else self._decode_memo.get(key)
        if entry is None:
            self._decode_hot = None      # force split() to (re)build
            self.batched_token_decode_cycles_split(cfg, alloc, [0] * b)
            entry = self._decode_memo[key]
        base, n_attn, c2c_cyc, c2c_bytes, _ = entry
        if n_attn is None:
            return None
        return (base + c2c_cyc, n_attn, c2c_bytes,
                self.ctx_cycles_per_pos, self.alpha, self._cal_ver)

    def _decode_split_walk(self, cfg, alloc: ChipletAllocation,
                           ctx_sum: int, b: int) -> Tuple[int, int, int]:
        """The direct per-layer walk (the reference path memoization is
        verified against)."""
        compute_cyc = 0
        c2c_cyc = 0
        c2c_bytes = 0
        d = cfg.d_model
        prev_chips: Optional[List[int]] = None
        for ld, chips in alloc.assignments:
            compute_cyc += self.layer_decode_cycles_batched(ld, ctx_sum, b)
            if prev_chips is not None and chips != prev_chips:
                payload = d * b  # 8-bit activations, one per request
                c2c_cyc += self.c2c_transfer_cycles(payload)
                c2c_bytes += payload
            prev_chips = chips
        return compute_cyc, c2c_cyc, c2c_bytes

    def prefill_cycles(self, cfg, alloc: ChipletAllocation,
                       seq: int) -> Tuple[int, int]:
        """Prefill S tokens: weight-stationary streaming, tokens pipelined
        through the layer chain (chiplet pipeline): time ~ per-layer stream
        of S tokens + pipeline fill.  One whole-prompt chunk of the
        chunked form below (``ctx_before == 0`` keeps the float arithmetic
        bit-identical to the pre-chunking closed form — locked by the
        timeline golden)."""
        return self.prefill_chunk_cycles(cfg, alloc, seq, 0)

    def prefill_chunk_cycles(self, cfg, alloc: ChipletAllocation,
                             chunk: int, ctx_before: int) -> Tuple[int, int]:
        """(cycles, c2c_bytes) to prefill ``chunk`` prompt tokens on top of
        ``ctx_before`` already-cached context tokens — the unit of chunked
        prefill (vLLM-style), so one long prompt is spread over several
        engine iterations instead of monopolizing one.

        Same decomposition as the whole-prompt form: the streamed SMAC
        wave and pipeline fill depend only on the chunk, while the
        FlashAttention term now has a ``chunk x ctx_before`` rectangle
        (new queries attending to cached context) on top of the causal
        triangle within the chunk.  Each chunk re-pays the pipeline fill;
        summing chunks therefore costs slightly MORE than one monolithic
        prefill — the price of interleaving.

        LRU-memoized on the exact ``(chunk, ctx_before)`` shape (the
        quadratic attention term has no affine shortcut): the serving
        engine re-prices the queue head's prefill every admission check,
        so repeated shapes dominate."""
        if self.memoize:
            key = (id(alloc), cfg.d_model, cfg.q_dim, chunk, ctx_before,
                   self._cal_ver)
            memo = self._prefill_memo
            entry = memo.get(key)
            if entry is not None:
                self._stats["prefill_hits"] += 1
                memo.move_to_end(key)
                return entry[0]
            self._stats["prefill_misses"] += 1
            result = self._prefill_chunk_walk(cfg, alloc, chunk, ctx_before)
            memo[key] = (result, alloc)
            while len(memo) > self.prefill_memo_max:
                memo.popitem(last=False)
                self._stats["prefill_evictions"] += 1
            return result
        return self._prefill_chunk_walk(cfg, alloc, chunk, ctx_before)

    def _prefill_chunk_walk(self, cfg, alloc: ChipletAllocation,
                            chunk: int, ctx_before: int) -> Tuple[int, int]:
        d = cfg.d_model
        stages = len(alloc.assignments)
        # Prefill is token-PIPELINED through the chiplet chain (weight
        # stationary): steady-state per-token cost = total SMAC work over
        # the pipeline depth.  This is why Table II throughput is decode-
        # dominated (prefill ~3% of wall time at 512/512).
        total_smac = sum(self.smac_cycles(ld) for ld, _ in alloc.assignments)
        stream_cyc = chunk * total_smac / max(alloc.n_chiplets, 1)
        # attention quadratic term: with many tokens in flight the flash
        # inner loop partially unrolls across ALL router DMAC lanes
        n_attn = sum(1 for ld, _ in alloc.assignments if ld.kind == "attn")
        lanes = self.mesh.dmac_lanes * 1024 * 0.5
        attn_macs = (2.0 * (cfg.q_dim or d) * chunk * (chunk + 1) / 2
                     + 2.0 * (cfg.q_dim or d) * chunk * ctx_before)
        attn_cyc = n_attn * attn_macs / lanes
        fill = stages * self.c2c_latency
        cyc = stream_cyc + attn_cyc + fill
        c2c_bytes = chunk * d * max(0, alloc.n_chiplets - 1)
        return int(cyc * self.alpha), c2c_bytes


# ---------------------------------------------------------------------------
# Batched cost surface (the sweep engine's cell-major view)
# ---------------------------------------------------------------------------

class DecodeCostSurface:
    """Cell-major batched view of :meth:`CycleModel.decode_affine`.

    Where ``decode_affine`` exports the affine decode decomposition for one
    ``(alloc, b)`` at a time, the surface tabulates it for every batch size
    ``1..max_batch`` so a whole grid of cells can price one decode round in
    a handful of numpy ops::

        cyc = int((base[b] + n_attn[b] * int(cpp * ctx_sum)) * alpha)

    evaluated elementwise over cell vectors ``b_vec`` / ``ctx_sum_vec``.
    Each lane performs exactly the scalar engine's arithmetic (same
    truncation points, same float64 ops), so per-cell results are
    bit-identical to pricing the cells one at a time.

    The surface shares the model's memo (building it populates the decode
    LRU; rebuilds after a hit are O(1) lookups) and its invalidation
    story: ``cal_ver`` snapshots the model's ``__setattr__`` calibration
    stamp, so mutating ``alpha`` & friends on the shared model invalidates
    every cell of every sweep at once — callers re-validate with
    :meth:`refresh` before each use.

    ``affine[b]`` is False for batch sizes where a subclass made the cost
    non-affine (or ``memoize`` is off, in which case every lane is False);
    cells at those batch sizes must fall back to the scalar walk.
    """

    def __init__(self, model: CycleModel, cfg, alloc: ChipletAllocation,
                 max_batch: int):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.model = model
        self.cfg = cfg
        self.alloc = alloc
        self.max_batch = int(max_batch)
        self._build()

    # chunk/ctx_before shapes the closed-form prefill lane is verified
    # against the model's own pricing at build time; any mismatch (a
    # subclass overriding the walk) disables the lane for the surface
    _PREFILL_PROBES = ((1, 0), (64, 0), (128, 4096), (257, 65537))

    def _build(self) -> None:
        m = self.model
        n = self.max_batch + 1          # index directly by batch size
        self.base = np.zeros(n, dtype=np.int64)
        self.base_compute = np.zeros(n, dtype=np.int64)
        self.c2c_cyc = np.zeros(n, dtype=np.int64)
        self.n_attn = np.zeros(n, dtype=np.int64)
        self.c2c_bytes = np.zeros(n, dtype=np.int64)
        self.affine = np.zeros(n, dtype=bool)
        for b in range(1, n):
            aff = m.decode_affine_split(self.cfg, self.alloc, b)
            if aff is None:
                continue
            base_c, n_attn, c2c_cyc, c2cb, _cpp, _alpha, _ver = aff
            self.base[b] = base_c + c2c_cyc   # decode_affine's folded base
            self.base_compute[b] = base_c
            self.c2c_cyc[b] = c2c_cyc
            self.n_attn[b] = n_attn
            self.c2c_bytes[b] = c2cb
            self.affine[b] = True
        self.cpp = float(m.ctx_cycles_per_pos)
        self.alpha = float(m.alpha)
        self.cal_ver = m._cal_ver
        self._build_prefill()

    def _build_prefill(self) -> None:
        """Snapshot the closed-form prefill-chunk constants and verify
        them against the model's own pricing (`prefill_chunk_cycles`) at
        a few probe shapes — a subclass overriding the walk silently
        demotes the vectorized lane to the memo-backed gather."""
        m, cfg, alloc = self.model, self.cfg, self.alloc
        d = cfg.d_model
        self._pf_smac = sum(m.smac_cycles(ld)
                            for ld, _ in alloc.assignments)
        self._pf_den = max(alloc.n_chiplets, 1)
        self._pf_qd2 = 2.0 * (cfg.q_dim or d)
        self._pf_nattn = sum(1 for ld, _ in alloc.assignments
                             if ld.kind == "attn")
        self._pf_lanes = m.mesh.dmac_lanes * 1024 * 0.5
        self._pf_fill = len(alloc.assignments) * m.c2c_latency
        self._pf_c2cb = d * max(0, alloc.n_chiplets - 1)
        self.prefill_closed = True
        for c, cb in self._PREFILL_PROBES:
            want = m.prefill_chunk_cycles(cfg, alloc, c, cb)
            got_c, got_b = self._prefill_closed_form(
                np.array([c], dtype=np.int64),
                np.array([cb], dtype=np.int64))
            if (int(got_c[0]), int(got_b[0])) != want:
                self.prefill_closed = False
                break

    def _prefill_closed_form(self, chunk: np.ndarray, before: np.ndarray
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """`CycleModel._prefill_chunk_walk` as elementwise numpy — the
        same float64 ops at the same points in the same order, so each
        lane reproduces the scalar walk bit-for-bit."""
        stream_cyc = chunk * self._pf_smac / self._pf_den
        attn_macs = (self._pf_qd2 * chunk * (chunk + 1) / 2
                     + self._pf_qd2 * chunk * before)
        attn_cyc = self._pf_nattn * attn_macs / self._pf_lanes
        cyc = stream_cyc + attn_cyc + self._pf_fill
        c2cb = chunk * self._pf_c2cb
        return (cyc * self.alpha).astype(np.int64), c2cb

    def valid(self) -> bool:
        return self.cal_ver == self.model._cal_ver

    def refresh(self) -> bool:
        """Rebuild iff the model's calibration stamp moved since the last
        build.  Returns True when a rebuild happened (callers holding
        per-cell snapshots of base/n_attn must re-gather)."""
        if self.valid():
            return False
        self._build()
        return True

    def decode_cycles(self, b_vec, ctx_sum_vec) -> np.ndarray:
        """Pre-CCPG cycles of one decode round per cell — vectorized over
        cells.  ``b_vec`` are per-cell batch sizes (1..max_batch, affine
        lanes only), ``ctx_sum_vec`` per-cell context sums."""
        b = np.asarray(b_vec, dtype=np.int64)
        ctx = np.asarray(ctx_sum_vec, dtype=np.int64)
        cyc = self.base[b] + self.n_attn[b] * (self.cpp * ctx).astype(np.int64)
        return (cyc.astype(np.float64) * self.alpha).astype(np.int64)

    def prefill_chunk_cycles(self, chunk_vec, ctx_before_vec
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """(cycles, c2c_bytes) per cell for prefill chunk shapes — array
        in, array out.  When the build-time probes matched the model
        (``prefill_closed``), shapes are priced by the closed-form walk
        vectorized directly over the array — no memo traffic at all;
        otherwise (a subclass overrode the walk) each lane gathers
        through the model's shared prefill LRU."""
        chunk = np.asarray(chunk_vec, dtype=np.int64)
        before = np.asarray(ctx_before_vec, dtype=np.int64)
        if chunk.shape != before.shape:
            raise ValueError("chunk/ctx_before shape mismatch")
        if self.prefill_closed:
            return self._prefill_closed_form(chunk, before)
        cyc = np.empty(chunk.shape, dtype=np.int64)
        c2cb = np.empty(chunk.shape, dtype=np.int64)
        m, cfg, alloc = self.model, self.cfg, self.alloc
        flat_c, flat_b = chunk.ravel(), before.ravel()
        out_c, out_b = cyc.ravel(), c2cb.ravel()
        for i in range(flat_c.size):
            out_c[i], out_b[i] = m.prefill_chunk_cycles(
                cfg, alloc, int(flat_c[i]), int(flat_b[i]))
        return cyc, c2cb
