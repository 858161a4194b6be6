"""Rules that hold one run of the port to another: ``graph_vs_eager``,
which holds the train step captured as a CUDA graph
(``launch.steps.CompiledTrainStep``) to the eager step on the card.
Used by ``chip_smoke.py`` and the card tests; nothing in the port calls
it."""
from __future__ import annotations


def graph_vs_eager(graph, eager_a, eager_b):
    """The rule that holds a captured train step to the eager one, over
    lists of {name: value} (floats or tensors, a step each): where the
    eager step is bit-equal to itself (two runs from one state), the graph
    must be bit-equal to it; where it is not, within twice eager's own
    spread, relative (a third draw of the same rounding: |G - A| <= |G -
    B| + |B - A|).  Returns (the names eager is not bit-equal on, the
    worst ratio of the graph's distance to its bound there, the
    failures)."""
    def equal(x, y):
        return x == y if isinstance(x, float) else x.equal(y)

    def dist(x, y):
        if isinstance(x, float):
            return abs(x - y) / max(abs(y), 1e-30)
        x, y = x.double(), y.double()
        return float((x - y).norm() / y.norm().clamp_min(1e-30))

    spread, worst, bad = set(), 0.0, []
    for i, (g, a, b) in enumerate(zip(graph, eager_a, eager_b)):
        for k, want in a.items():
            if equal(want, b[k]):
                if not equal(g[k], want):
                    bad.append((i, k, dist(g[k], want), 0.0))
                continue
            spread.add(k)
            bound = 2 * dist(b[k], want)
            worst = max(worst, dist(g[k], want) / bound)
            if dist(g[k], want) > bound:
                bad.append((i, k, dist(g[k], want), bound))
    return spread, worst, bad
