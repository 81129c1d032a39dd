"""
Small graph utilities used by the phasing pipelines (counterpart of the
reference's whatshap/graph.py):

- ComponentFinder: disjoint-set union where the representative of every
  component is its MINIMUM element.  Phase blocks are named after the
  left-most variant position they contain, so ``find`` must return the
  minimum, not an arbitrary root.
- Graph.toposorted(): dependency ordering for pedigree recombination-cost
  propagation; raises CyclicGraphError on cyclic pedigrees.
"""

from typing import Generic, Hashable, Iterable, List, TypeVar

V = TypeVar("V", bound=Hashable)


class ComponentFinder(Generic[V]):
    """Union-find over an explicit universe of values.

    Invariant: the root of every tree is the smallest value in its
    component, so ``find`` needs no extra minimum tracking.  Paths are
    halved during lookup for near-constant amortized finds.
    """

    __slots__ = ("_parent",)

    def __init__(self, universe: Iterable[V]):
        self._parent = {v: v for v in universe}

    def _root(self, v: V) -> V:
        p = self._parent
        while p[v] != v:
            p[v] = p[p[v]]  # path halving
            v = p[v]
        return v

    def merge(self, a: V, b: V) -> None:
        assert a != b
        ra, rb = self._root(a), self._root(b)
        if ra == rb:
            return
        # keep the smaller value on top
        if rb < ra:
            ra, rb = rb, ra
        self._parent[rb] = ra

    def find(self, v: V) -> V:
        return self._root(v)

    def print(self) -> None:
        for v in sorted(self._parent):
            print(v, "is in component", self._root(v))


class CyclicGraphError(Exception):
    pass


class Graph:
    """Directed graph; ``toposorted`` lists each edge's head before its
    tail (i.e. for u -> v, v comes before u), matching the reference's
    convention for pedigree ordering."""

    def __init__(self):
        self._out: dict = {}

    def add_edge(self, u, v) -> None:
        """Add the directed edge u -> v (nodes are created on demand)."""
        self._out.setdefault(u, []).append(v)
        self._out.setdefault(v, [])

    def toposorted(self) -> List:
        NEW, OPEN, DONE = 0, 1, 2
        state = dict.fromkeys(self._out, NEW)
        order: List = []
        for start in self._out:
            if state[start] != NEW:
                continue
            # iterative DFS; a node is appended once all successors finish
            stack = [(start, iter(self._out[start]))]
            state[start] = OPEN
            while stack:
                node, succ = stack[-1]
                advanced = False
                for nxt in succ:
                    if state[nxt] == NEW:
                        state[nxt] = OPEN
                        stack.append((nxt, iter(self._out[nxt])))
                        advanced = True
                        break
                    if state[nxt] == OPEN:
                        raise CyclicGraphError(
                            f"Cycle involving {node!r} and {nxt!r} detected"
                        )
                if not advanced:
                    stack.pop()
                    state[node] = DONE
                    order.append(node)
        return order
