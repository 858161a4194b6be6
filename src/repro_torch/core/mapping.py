"""Spatial mapping of weight tiles onto the 32x32 router-PE grid
(paper §III-2, Fig 6).

Each matrix is constrained to a column-wise rectangular region; the mapper
optimizes three factors (paper's heuristic):
  1. intra-matrix shape — the (rows x cols) aspect of each matrix region,
  2. inter-matrix shape — how the K-Q-V-O (or FFN) regions pack side by side,
  3. row-column order  — whether tile rows advance along mesh rows or cols.

The objective mirrors the paper's goal of balanced, non-congestive traffic:
minimize (a) broadcast-tree depth of input rows into each region, and
(b) reduction-tree depth of partial outputs along tile columns, with
scratchpads for Q/K/V/S co-located in the producing region ("reduction in
the vicinity").
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .noc import Mesh2D, MeshConfig
from .partition import TileGrid

Coord = Tuple[int, int]


@dataclass
class Region:
    """A rectangular router-PE region holding one matrix's tile grid."""
    grid: TileGrid
    origin: Coord                    # top-left router
    shape: Tuple[int, int]           # (rows, cols) in routers
    row_major: bool = True           # row-column order factor

    def router_of_tile(self, i: int, j: int) -> Coord:
        r, c = self.shape
        if self.row_major:
            rr, cc = i % r, (i // r) * self.grid.grid[1] + j
            if cc >= c:  # fold overflow columns downward
                rr, cc = rr + (cc // c) * self.grid.grid[0] % r, cc % c
        else:
            rr, cc = j % r, (j // r) * self.grid.grid[0] + i
            rr, cc = rr % r, cc % c
        return (self.origin[0] + rr % r, self.origin[1] + cc % c)

    @property
    def routers(self) -> List[Coord]:
        return [(self.origin[0] + r, self.origin[1] + c)
                for r in range(self.shape[0]) for c in range(self.shape[1])]


@dataclass
class LayerMapping:
    regions: Dict[str, Region]
    mesh: Mesh2D
    cost: float = 0.0

    def scratchpad_region(self, tensor: str) -> Optional[Region]:
        """Q/K/V/S live in the scratchpads of their producing weight region
        (paper: 'Q is stored in the scratchpads of the router-PE pairs
        where W_Q has been pre-placed')."""
        owner = {"Q": "W_Q", "K": "W_K", "V": "W_V", "S": "W_Q"}
        return self.regions.get(owner.get(tensor, tensor))


def _region_cost(mesh: Mesh2D, region: Region) -> float:
    """Broadcast depth (input rows) + reduction depth (output columns)."""
    tg = region.grid
    # input broadcast: along tile-rows (same input row block feeds a row)
    bc = region.shape[0] + region.shape[1]        # tree depth bound in region
    # partial-output reduction: along tile-columns of the matrix
    red = tg.grid[0]                              # operands per output
    return bc + 2.0 * red


def _pack_columns(grids: Sequence[TileGrid], mesh_rows: int,
                  order: Sequence[int], row_major: bool,
                  mesh: Mesh2D) -> Optional[LayerMapping]:
    """Pack each grid as a column-band (the paper's column-wise rectangular
    constraint), in the given inter-matrix order."""
    regions: Dict[str, Region] = {}
    col = 0
    for gi in order:
        tg = grids[gi]
        n = tg.n_tiles
        rows = min(mesh_rows, n)
        cols = -(-n // rows)
        if col + cols > mesh.cfg.cols:
            # fold: not enough columns — try shorter rows
            rows = mesh_rows
            cols = -(-n // rows)
            if col + cols > mesh.cfg.cols:
                return None
        regions[tg.name] = Region(tg, (0, col), (rows, cols), row_major)
        col += cols
    cost = sum(_region_cost(mesh, r) for r in regions.values())
    # inter-matrix adjacency cost: Q->S->O chain wants Q,K adjacent etc.
    names = [grids[i].name for i in order]
    for a, b in zip(names, names[1:]):
        ra, rb = regions[a], regions[b]
        cost += mesh.hops((ra.origin[0], ra.origin[1] + ra.shape[1] // 2),
                          (rb.origin[0], rb.origin[1] + rb.shape[1] // 2)) * 0.1
    return LayerMapping(regions=regions, mesh=mesh, cost=cost)


def map_layer(grids: Sequence[TileGrid],
              mesh: Mesh2D | None = None) -> LayerMapping:
    """Heuristic search over the paper's three factors.  For K-Q-V-O the
    optimum found matches Fig 6: K-Q-V-O channel bands left to right with
    column-major tile order inside each band."""
    mesh = mesh or Mesh2D(MeshConfig())
    best: Optional[LayerMapping] = None
    names = list(range(len(grids)))
    # canonical paper order first (K, Q, V, O) if those names exist
    paper_order = sorted(
        names, key=lambda i: {"W_K": 0, "W_Q": 1, "W_V": 2, "W_O": 3}.get(
            grids[i].name, 4 + i))
    orders = [paper_order] + [list(p) for p in itertools.permutations(names)] \
        if len(names) <= 4 else [paper_order, names]
    for order in orders:
        for mesh_rows in (8, 16, 32):
            for row_major in (True, False):
                m = _pack_columns(grids, mesh_rows, order, row_major, mesh)
                if m is None:
                    continue
                if best is None or m.cost < best.cost:
                    best = m
    if best is None:
        raise ValueError(
            f"layer does not fit one chiplet: "
            f"{sum(g.n_tiles for g in grids)} tiles > "
            f"{mesh.n_routers} router-PE pairs")
    return best


def fits_one_chiplet(grids: Sequence[TileGrid],
                     mesh: Mesh2D | None = None) -> bool:
    mesh = mesh or Mesh2D(MeshConfig())
    return sum(g.n_tiles for g in grids) <= mesh.n_routers
