"""IPCN 2D-mesh network model: routers, hop routing, spanning-tree
collectives (paper §III-3 'Collective communication').

The mesh is the paper's 32x32 router-PE grid.  Broadcast and reduction
follow a BFS spanning tree rooted at the operation's source/sink; because
the mapping is regular and aligned, tree levels are contention-free (the
paper's claim) — the model checks link-disjointness per level and reports
congestion if a schedule ever violates it.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence, Set, Tuple

Coord = Tuple[int, int]


@dataclass
class MeshConfig:
    rows: int = 32
    cols: int = 32
    link_bytes_per_cycle: int = 8     # 64-bit links (Table I bit-width)
    fifo_bytes: int = 256
    hop_latency: int = 1              # cycles per router hop
    dmac_lanes: int = 16              # non-weighted MAC units per router
    scratchpad_bytes: int = 32 * 1024


class Mesh2D:
    def __init__(self, cfg: MeshConfig = MeshConfig()):
        self.cfg = cfg

    @property
    def n_routers(self) -> int:
        return self.cfg.rows * self.cfg.cols

    def rid(self, rc: Coord) -> int:
        return rc[0] * self.cfg.cols + rc[1]

    def coord(self, rid: int) -> Coord:
        return divmod(rid, self.cfg.cols)

    def neighbors(self, rc: Coord) -> List[Coord]:
        r, c = rc
        out = []
        if r > 0:
            out.append((r - 1, c))
        if r < self.cfg.rows - 1:
            out.append((r + 1, c))
        if c > 0:
            out.append((r, c - 1))
        if c < self.cfg.cols - 1:
            out.append((r, c + 1))
        return out

    def hops(self, a: Coord, b: Coord) -> int:
        return abs(a[0] - b[0]) + abs(a[1] - b[1])

    def xy_route(self, a: Coord, b: Coord) -> List[Coord]:
        """Deterministic X-then-Y path (inclusive of endpoints)."""
        path = [a]
        r, c = a
        step = 1 if b[1] > c else -1
        while c != b[1]:
            c += step
            path.append((r, c))
        step = 1 if b[0] > r else -1
        while r != b[0]:
            r += step
            path.append((r, c))
        return path

    # ------------------------------------------------------------------
    # Spanning-tree collectives
    # ------------------------------------------------------------------

    def spanning_tree(self, root: Coord,
                      members: Iterable[Coord]) -> Dict[Coord, List[Coord]]:
        """BFS tree over the mesh restricted to reach all members.
        Returns child-lists per node (only nodes on tree paths appear)."""
        members = set(members)
        parent: Dict[Coord, Coord] = {root: root}
        q = deque([root])
        found: Set[Coord] = {root} & members
        while q and found != members:
            cur = q.popleft()
            for nb in self.neighbors(cur):
                if nb not in parent:
                    parent[nb] = cur
                    q.append(nb)
                    if nb in members:
                        found.add(nb)
        # prune to paths root->member
        keep: Set[Coord] = set()
        for m in members:
            cur = m
            while cur not in keep:
                keep.add(cur)
                if cur == root:
                    break
                cur = parent[cur]
        children: Dict[Coord, List[Coord]] = {}
        for node in keep:
            if node == root:
                continue
            children.setdefault(parent[node], []).append(node)
        return children

    def tree_depth(self, children: Dict[Coord, List[Coord]],
                   root: Coord) -> int:
        depth, frontier = 0, [root]
        while frontier:
            nxt = []
            for n in frontier:
                nxt.extend(children.get(n, []))
            if not nxt:
                break
            depth += 1
            frontier = nxt
        return depth

    def broadcast_cycles(self, root: Coord, members: Sequence[Coord],
                         payload_bytes: int) -> int:
        """Pipelined wormhole broadcast down the spanning tree: latency =
        tree depth + serialization of the payload on the narrowest level."""
        tree = self.spanning_tree(root, members)
        depth = self.tree_depth(tree, root)
        ser = -(-payload_bytes // self.cfg.link_bytes_per_cycle)
        return depth * self.cfg.hop_latency + ser

    def reduce_cycles(self, root: Coord, members: Sequence[Coord],
                      payload_bytes: int) -> int:
        """In-network reduction up the tree: each router PSUMs its children's
        streams (paper: partial summation macro), so the payload is NOT
        multiplied by fan-in; latency mirrors broadcast plus one MAC pass."""
        tree = self.spanning_tree(root, members)
        depth = self.tree_depth(tree, root)
        ser = -(-payload_bytes // self.cfg.link_bytes_per_cycle)
        return depth * self.cfg.hop_latency + ser

    def check_level_disjoint(self, root: Coord,
                             members: Sequence[Coord]) -> bool:
        """The paper claims non-congestive traffic for aligned mappings:
        per tree level, links must be pairwise disjoint.  BFS trees on a
        mesh satisfy this by construction; the check guards schedule bugs."""
        tree = self.spanning_tree(root, members)
        frontier = [root]
        while frontier:
            links = set()
            nxt = []
            for n in frontier:
                for ch in tree.get(n, []):
                    link = (n, ch)
                    if link in links:
                        return False
                    links.add(link)
                    nxt.append(ch)
            frontier = nxt
        return True
