"""Partitioning of static weights and dynamic tensors (paper §III-1).

Static matrices (W_Q/K/V/O, FFN) are tiled to the 256x256 PE crossbar
capacity along both row and column dimensions; dynamic tensors (Q/K/V/S)
are tiled to the 32 KB scratchpads.  Partitioning the weights induces the
collective pattern (input broadcast along rows of tiles, partial-output
reduction along columns of tiles) that `scheduling.py` turns into
spanning-tree traffic.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple


@dataclass(frozen=True)
class PEArraySpec:
    rows: int = 256
    cols: int = 256
    bits_per_cell: int = 8          # RRAM conductance levels (weight slice)
    weight_bits: int = 8            # one cell per weight at 8-bit inference

    @property
    def weights_per_array(self) -> int:
        return self.rows * self.cols


@dataclass(frozen=True)
class TileGrid:
    """A weight matrix partitioned into an r x c grid of PE arrays."""
    name: str
    shape: Tuple[int, int]          # logical (in_dim, out_dim)
    grid: Tuple[int, int]           # tiles along (rows, cols)
    pe: PEArraySpec

    @property
    def n_tiles(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def utilization(self) -> float:
        used = self.shape[0] * self.shape[1]
        return used / (self.n_tiles * self.pe.weights_per_array)

    def tile_shape(self, i: int, j: int) -> Tuple[int, int]:
        r = min(self.pe.rows, self.shape[0] - i * self.pe.rows)
        c = min(self.pe.cols, self.shape[1] - j * self.pe.cols)
        return (r, c)


def partition_matrix(name: str, in_dim: int, out_dim: int,
                     pe: PEArraySpec = PEArraySpec()) -> TileGrid:
    grid = (-(-in_dim // pe.rows), -(-out_dim // pe.cols))
    return TileGrid(name=name, shape=(in_dim, out_dim), grid=grid, pe=pe)


def attention_grids(d_model: int, q_dim: int, kv_dim: int,
                    pe: PEArraySpec = PEArraySpec()) -> List[TileGrid]:
    return [
        partition_matrix("W_Q", d_model, q_dim, pe),
        partition_matrix("W_K", d_model, kv_dim, pe),
        partition_matrix("W_V", d_model, kv_dim, pe),
        partition_matrix("W_O", q_dim, d_model, pe),
    ]


def ffn_grids(d_model: int, d_ff: int, gated: bool = True,
              pe: PEArraySpec = PEArraySpec()) -> List[TileGrid]:
    grids = [partition_matrix("W_gate", d_model, d_ff, pe),
             partition_matrix("W_up", d_model, d_ff, pe)]
    if not gated:
        grids = grids[:1]
    grids.append(partition_matrix("W_down", d_ff, d_model, pe))
    return grids


@dataclass(frozen=True)
class ScratchpadPlan:
    """Dynamic tensor striped across scratchpads (paper: cyclic KV store)."""
    name: str
    elem_bytes: int
    row_elems: int                  # elements per (token) row
    n_pads: int                     # scratchpads allocated
    pad_bytes: int = 32 * 1024

    @property
    def rows_capacity(self) -> int:
        """Token rows storable across the allocated pads."""
        per_pad = self.pad_bytes // (self.row_elems * self.elem_bytes)
        return per_pad * self.n_pads

    def pad_of_token(self, t: int) -> int:
        """Cyclic striping: token t lives in pad t mod n_pads — balanced
        utilization regardless of sequence length (paper §III 'KV cache')."""
        return t % self.n_pads


def plan_kv_cache(kv_dim: int, n_pads: int, elem_bytes: int = 1,
                  pad_bytes: int = 32 * 1024) -> ScratchpadPlan:
    return ScratchpadPlan("KV", elem_bytes, kv_dim, n_pads, pad_bytes)
