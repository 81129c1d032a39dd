"""
Cluster editing heuristic for the read similarity graph.

Behavior parity with the reference's
src/polyphase/{staticsparsegraph,edgeheap,inducedcostheuristic,
clustereditingsolution,clustereditingsolver}.{h,cpp}: a pseudo-complete
graph with implicit zero edges, clique tracking for permanent/forbidden
implications, paired max-structures over icf/icp (induced cost of making an
edge forbidden/permanent), and the greedy editing loop.

All edge-weight arithmetic is float32 like the C++ (EdgeWeight = float).
"""

import struct
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

from .trianglesparse import TriangleSparseMatrix

INF = float("inf")
FORBIDDEN = -INF  # StaticSparseGraph::Forbidden
PERMANENT = INF  # StaticSparseGraph::Permanent

_F32 = struct.Struct("f")
_f32_pack = _F32.pack
_f32_unpack = _F32.unpack


def _f32(v: float) -> float:
    return _f32_unpack(_f32_pack(v))[0]


def _edge(u: int, v: int) -> Tuple[int, int]:
    return (u, v) if u < v else (v, u)


def _edge_id(e: Tuple[int, int]) -> int:
    # staticsparsegraph.h Edge::id(): v*(v-1)/2 + u with u < v
    u, v = e
    return v * (v - 1) // 2 + u


class StaticSparseGraph:
    """staticsparsegraph.cpp; the rank/offset bitvectors are replaced by a
    dict from edge id to rank (same observable behavior)."""

    def __init__(self, m: TriangleSparseMatrix):
        self.size = m.getMaxDim()
        ids = m.getIndices()  # sorted matrix indices minus one == edge ids
        self._rank: Dict[int, int] = {}
        self._rank_t: Dict[Tuple[int, int], int] = {}  # same map, tuple-keyed
        self.weightv: List[float] = [0.0]
        self.edges: List[Tuple[int, int]] = [(0xFFFFFFFF, 0xFFFFFFFF)]
        self.unprunedNeighbours: List[List[int]] = [[] for _ in range(self.size)]
        self.nonzeroNeighbours: List[List[int]] = [[] for _ in range(self.size)]
        self.cliqueOfNode: List[int] = list(range(self.size))
        self.cliques: List[List[int]] = [[i] for i in range(self.size)]
        self.forbidden: List[Set[int]] = [set() for _ in range(self.size)]
        for eid in ids:
            # decode: larger node first (compile() in the reference)
            v = _ceil_sqrt_node(eid)
            u = eid - v * (v - 1) // 2
            e = _edge(u, v)
            w = m.get(u, v)
            self._rank[eid] = len(self.weightv)
            self._rank_t[e] = len(self.weightv)
            self.weightv.append(w)
            self.edges.append(e)
            r = len(self.weightv) - 1
            if w == FORBIDDEN:
                self.setForbidden(e, r)
            elif w == PERMANENT:
                self.setPermanent(e, r)
            self._refreshEdgeMetaData(e, 0.0, w)

    def findIndex(self, e) -> int:
        if type(e) is tuple:
            return self._rank_t.get(e, 0)
        return self._rank.get(e, 0)

    def getWeight(self, e) -> float:
        if type(e) is tuple:
            return self.weightv[self._rank_t.get(e, 0)]
        return self.weightv[e]

    def isPermanent(self, e: Tuple[int, int]) -> bool:
        return self.cliqueOfNode[e[0]] == self.cliqueOfNode[e[1]]

    def isForbidden(self, e: Tuple[int, int]) -> bool:
        return self.cliqueOfNode[e[1]] in self.forbidden[self.cliqueOfNode[e[0]]]

    def setPermanent(self, e: Tuple[int, int], r: Optional[int] = None) -> None:
        if r is None:
            r = self.findIndex(e)
            if r == 0:
                return
        cu = self.cliqueOfNode[e[0]]
        cv = self.cliqueOfNode[e[1]]
        if cv in self.forbidden[cu]:
            print(f"Making forbidden edge permanent ({e[0]}, {e[1]}).")
            return
        if len(self.cliques[cu]) < len(self.cliques[cv]):
            merged, discarded = cv, cu
        else:
            merged, discarded = cu, cv
        if merged != discarded:
            for d in self.cliques[discarded]:
                self.cliqueOfNode[d] = merged
                self.cliques[merged].append(d)
            self.cliques[discarded] = []
            for f in sorted(self.forbidden[discarded]):
                self.forbidden[merged].add(f)
                self.forbidden[f].add(merged)
                self.forbidden[f].discard(discarded)
            self.forbidden[discarded] = set()
        self._refreshEdgeMetaData(e, self.weightv[r], PERMANENT)
        if r > 0:
            self.weightv[r] = PERMANENT

    def setForbidden(self, e: Tuple[int, int], r: Optional[int] = None) -> None:
        if r is None:
            r = self.findIndex(e)
            if r == 0:
                return
        cu = self.cliqueOfNode[e[0]]
        cv = self.cliqueOfNode[e[1]]
        if cu == cv:
            print(f"Making permanent edge forbidden ({e[0]}, {e[1]}).")
            return
        self.forbidden[cu].add(cv)
        self.forbidden[cv].add(cu)
        self._refreshEdgeMetaData(e, self.weightv[r], FORBIDDEN)
        if r > 0:
            self.weightv[r] = FORBIDDEN

    def numNodes(self) -> int:
        return self.size

    def numEdges(self) -> int:
        return len(self.weightv) - 1

    def getCliqueOf(self, v: int) -> List[int]:
        return self.cliques[self.cliqueOfNode[v]]

    def getForbiddenNeighbors(self, v: int) -> List[int]:
        out = []
        for fc in sorted(self.forbidden[self.cliqueOfNode[v]]):
            out.extend(self.cliques[fc])
        return out

    def getCliqueIdOf(self, v: int) -> int:
        return self.cliqueOfNode[v]

    def getUnprunedNeighbours(self, v: int) -> List[int]:
        return self.unprunedNeighbours[v]

    def getNonZeroNeighbours(self, v: int) -> List[int]:
        return self.nonzeroNeighbours[v]

    def _refreshEdgeMetaData(self, e, oldW: float, newW: float) -> None:
        oldPruned = oldW in (FORBIDDEN, PERMANENT, 0.0)
        newPruned = newW in (FORBIDDEN, PERMANENT, 0.0)
        if oldPruned and not newPruned:
            self.unprunedNeighbours[e[0]].append(e[1])
            self.unprunedNeighbours[e[1]].append(e[0])
        elif not oldPruned and newPruned:
            _swap_remove(self.unprunedNeighbours[e[0]], e[1])
            _swap_remove(self.unprunedNeighbours[e[1]], e[0])
        if oldW == 0.0 and newW != 0.0:
            self.nonzeroNeighbours[e[0]].append(e[1])
            self.nonzeroNeighbours[e[1]].append(e[0])
        elif oldW != 0.0 and newW == 0.0:
            _swap_remove(self.nonzeroNeighbours[e[0]], e[1])
            _swap_remove(self.nonzeroNeighbours[e[1]], e[0])


def _ceil_sqrt_node(eid: int) -> int:
    import math

    return int(math.ceil(math.sqrt(2 * (eid + 1) + 0.25) - 0.5))


def _swap_remove(vec: List[int], v: int) -> bool:
    for i, x in enumerate(vec):
        if x == v:
            vec[i] = vec[-1]
            vec.pop()
            return True
    return False


class EdgeHeap:
    """edgeheap.cpp: paired max-heaps over per-edge icf/icp with edge
    bundles (array-backed binary heaps with position indices)."""

    def __init__(self, graph: StaticSparseGraph):
        self.graph = graph
        n = 1 + graph.numEdges()
        self.unprocessed = 0
        self.edges: List[Optional[Tuple[int, int]]] = [None] * n
        self.icf = [FORBIDDEN] * n
        self.icp = [FORBIDDEN] * n
        self.forb_rank2edge: List[int] = []
        self.perm_rank2edge: List[int] = []
        self.edge2forb_rank = [0] * n
        self.edge2perm_rank = [0] * n
        self.edgeToBundle = list(range(n))
        self.edgeBundles: List[List[int]] = [[i] for i in range(n)]

    def initInducedCosts(self) -> None:
        g = self.graph
        higher: List[List[int]] = [[] for _ in range(g.numNodes())]
        for u in range(g.numNodes()):
            for v in g.getNonZeroNeighbours(u):
                if v < u:
                    continue
                uv = (u, v)
                rId = g.findIndex(uv)
                self.edges[rId] = uv
                self.icf[rId] = 0.0
                self.icp[rId] = 0.0
                w_uv = g.getWeight(rId)
                if w_uv == 0.0 or w_uv == FORBIDDEN or w_uv == PERMANENT:
                    continue
                self.unprocessed += 1
                higher[u].append(v)
                if w_uv >= 0:
                    self.icf[rId] = _f32(self.icf[rId] + w_uv)
                else:
                    self.icp[rId] = _f32(self.icp[rId] - w_uv)
            higher[u].sort()
        for u in range(g.numNodes()):
            hu = higher[u]
            for i, v in enumerate(hu):
                rUV = g.findIndex((u, v))
                w_uv = g.getWeight(rUV)
                hv = set(higher[v])
                for w in hu[i:]:
                    if w not in hv:
                        continue
                    rUW = g.findIndex(_edge(u, w))
                    rVW = g.findIndex(_edge(v, w))
                    w_uw = g.getWeight(rUW)
                    w_vw = g.getWeight(rVW)
                    self.icf[rUV] = _f32(self.icf[rUV] + icf_triple(w_uw, w_vw))
                    self.icp[rUV] = _f32(self.icp[rUV] + icp_triple(w_uw, w_vw))
                    self.icf[rUW] = _f32(self.icf[rUW] + icf_triple(w_uv, w_vw))
                    self.icp[rUW] = _f32(self.icp[rUW] + icp_triple(w_uv, w_vw))
                    self.icf[rVW] = _f32(self.icf[rVW] + icf_triple(w_uv, w_uw))
                    self.icp[rVW] = _f32(self.icp[rVW] + icp_triple(w_uv, w_uw))
        n = len(self.icf)
        self.forb_rank2edge = sorted(range(n), key=lambda a: -_key(self.icf[a]))
        self.perm_rank2edge = sorted(range(n), key=lambda a: -_key(self.icp[a]))
        for i in range(n):
            self.edge2forb_rank[self.forb_rank2edge[i]] = i
            self.edge2perm_rank[self.perm_rank2edge[i]] = i

    def getMaxIcfEdge(self) -> Optional[Tuple[int, int]]:
        if len(self.forb_rank2edge) <= 1:
            return None
        ei = self.forb_rank2edge[0]
        if self.icf[ei] < 0:
            return None
        return self.edges[ei]

    def getMaxIcpEdge(self) -> Optional[Tuple[int, int]]:
        if len(self.perm_rank2edge) <= 1:
            return None
        ei = self.perm_rank2edge[0]
        if self.icp[ei] < 0:
            return None
        return self.edges[ei]

    def getIcf(self, e: Tuple[int, int]) -> float:
        return self.icf[self.edgeToBundle[self.graph.findIndex(e)]]

    def getIcp(self, e: Tuple[int, int]) -> float:
        return self.icp[self.edgeToBundle[self.graph.findIndex(e)]]

    def increaseIcf(self, e: Tuple[int, int], w: float) -> None:
        self.increaseIcf_r(self.graph._rank_t.get(e, 0), w)

    def increaseIcp(self, e: Tuple[int, int], w: float) -> None:
        self.increaseIcp_r(self.graph._rank_t.get(e, 0), w)

    def increaseIcf_r(self, rId: int, w: float) -> None:
        if rId > 0 and self.icf[self.edgeToBundle[rId]] >= 0:
            eb = self.edgeToBundle[rId]
            self.icf[eb] = max(_f32(self.icf[eb] + w), 0.0)
            self._updateHeap(self.forb_rank2edge, eb, w, self.edge2forb_rank, self.icf)

    def increaseIcp_r(self, rId: int, w: float) -> None:
        if rId > 0 and self.icp[self.edgeToBundle[rId]] >= 0:
            eb = self.edgeToBundle[rId]
            self.icp[eb] = max(_f32(self.icp[eb] + w), 0.0)
            self._updateHeap(self.perm_rank2edge, eb, w, self.edge2perm_rank, self.icp)

    def mergeEdges(self, e1: Tuple[int, int], e2: Tuple[int, int]) -> None:
        r1 = self.graph.findIndex(e1)
        r2 = self.graph.findIndex(e2)
        if (r1 & r2) == 0:  # reference quirk: bitwise AND of the rank ids
            return
        eb1 = self.edgeToBundle[r1]
        eb2 = self.edgeToBundle[r2]
        if eb1 == eb2:
            return
        if len(self.edgeBundles[eb1]) > len(self.edgeBundles[eb2]):
            src, dst = eb2, eb1
        else:
            src, dst = eb1, eb2
        for toDelete in self.edgeBundles[src]:
            self.edgeBundles[dst].append(toDelete)
            self.edgeToBundle[toDelete] = dst
        self.edgeBundles[src] = []
        if self.icf[src] >= 0.0:
            self.icf[dst] = _f32(self.icf[dst] + self.icf[src])
        if self.icp[src] >= 0.0:
            self.icp[dst] = _f32(self.icp[dst] + self.icp[src])
        self.removeEdgeByRank(src)

    def removeEdge(self, e: Tuple[int, int]) -> None:
        self.removeEdgeByRank(self.graph.findIndex(e))

    def removeEdgeByRank(self, rId: int) -> None:
        if rId == 0:
            return
        if self.icf[rId] != FORBIDDEN and self.icp[rId] != FORBIDDEN:
            self.icf[rId] = FORBIDDEN
            self.icp[rId] = FORBIDDEN
            self._updateHeap(self.forb_rank2edge, rId, FORBIDDEN, self.edge2forb_rank, self.icf)
            self._updateHeap(self.perm_rank2edge, rId, FORBIDDEN, self.edge2perm_rank, self.icp)
            self.unprocessed -= 1

    def numUnprocessed(self) -> int:
        return self.unprocessed

    def _updateHeap(
        self,
        heap: List[int],
        e: int,
        change: float,
        index: List[int],
        score: List[float],
    ) -> None:
        # edgeheap.cpp:221-256
        pos = index[e]
        n = len(heap)
        if change > 0:
            parent = (pos - 1) // 2 if pos > 0 else 0
            while pos > 0 and score[heap[parent]] < score[heap[pos]]:
                heap[pos], heap[parent] = heap[parent], heap[pos]
                index[heap[pos]] = pos
                index[heap[parent]] = parent
                pos = parent
                parent = (pos - 1) // 2 if pos > 0 else 0
        else:
            while True:
                l = 2 * pos + 1 if 2 * pos + 1 < n else pos
                r = 2 * pos + 2 if 2 * pos + 2 < n else pos
                nxt = l if score[heap[r]] <= score[heap[l]] else r
                if not (score[heap[pos]] < score[heap[nxt]]):
                    break
                heap[pos], heap[nxt] = heap[nxt], heap[pos]
                index[heap[pos]] = pos
                index[heap[nxt]] = nxt
                pos = nxt


def _key(v: float) -> float:
    return v


def icf_triple(uw: float, vw: float) -> float:
    # edgeheap.h getIcf(uw, vw)
    if uw > 0 and vw > 0:
        return min(uw, vw)
    return 0.0


def icp_triple(uw: float, vw: float) -> float:
    # edgeheap.h getIcp(uw, vw)
    if uw < 0 and vw > 0:
        return min(vw, -uw)
    if uw > 0 and vw < 0:
        return min(-vw, uw)
    return 0.0


class ClusterEditingSolution:
    def __init__(self, totalCost: float = 0.0, clusters: Optional[List[List[int]]] = None):
        self.valid = clusters is not None
        self.totalCost = totalCost
        self.clusters = clusters or []

    def isValid(self) -> bool:
        return self.valid

    def getTotalCost(self) -> float:
        return self.totalCost

    def getNumClusters(self) -> int:
        return len(self.clusters)

    def getCluster(self, index: int) -> List[int]:
        return self.clusters[index]


class InducedCostHeuristic:
    def __init__(self, graph: StaticSparseGraph, bundleEdges: bool):
        self.bundleEdges = bundleEdges
        self.graph = graph
        self.edgeHeap = EdgeHeap(graph)
        self.totalCost = 0.0
        self.edgeHeap.initInducedCosts()
        if not self._resolvePermanentForbidden():
            self.totalCost = INF
        self.totalEdges = self.edgeHeap.numUnprocessed()

    def solve(self) -> ClusterEditingSolution:
        if self.totalCost == INF:
            print("Instance is infeasible!")
            return ClusterEditingSolution()
        g = self.graph
        for _ in range(g.numEdges() + 1):
            eIcf = self.edgeHeap.getMaxIcfEdge()
            eIcp = self.edgeHeap.getMaxIcpEdge()
            if eIcf is None or eIcp is None:
                break
            mIcf = self.edgeHeap.getIcf(eIcf)
            mIcp = self.edgeHeap.getIcp(eIcp)
            if mIcf >= mIcp:
                self._choosePermanentEdge(eIcf)
            else:
                self._chooseForbiddenEdge(eIcp)

        clusters: List[List[int]] = []
        clusterOfNode = [-1] * g.numNodes()
        for u in range(g.numNodes()):
            if clusterOfNode[u] == -1:
                c = len(clusters)
                clusterOfNode[u] = c
                clusters.append([u])
                for v in g.getCliqueOf(u):
                    if u == v:
                        continue
                    clusterOfNode[v] = c
                    clusters[c].append(v)
        for cluster in clusters:
            cluster.sort()
        return ClusterEditingSolution(self.totalCost, clusters)

    def _choosePermanentEdge(self, eIcf: Tuple[int, int]) -> None:
        g = self.graph
        u, v = eIcf
        implications = []
        for x in g.getCliqueOf(u):
            for y in g.getCliqueOf(v):
                if x == y:
                    continue
                e = _edge(x, y)
                if g.findIndex(e) == 0 or (x == u and y == v):
                    continue
                implications.append(e)
        implicationsForbidden = []
        for f in g.getForbiddenNeighbors(u):
            if g.isForbidden(_edge(v, f)):
                continue
            for x in g.getCliqueOf(v):
                e = _edge(f, x)
                if g.findIndex(e) != 0 and not g.isForbidden(e):
                    implicationsForbidden.append(e)
        for f in g.getForbiddenNeighbors(v):
            if g.isForbidden(_edge(u, f)):
                continue
            for x in g.getCliqueOf(u):
                e = _edge(f, x)
                if g.findIndex(e) != 0 and not g.isForbidden(e):
                    implicationsForbidden.append(e)

        self._setPermanent(eIcf)
        self.edgeHeap.removeEdge(eIcf)
        for e in implications:
            self._setPermanent(e)
            self.edgeHeap.removeEdge(e)
        for e in implicationsForbidden:
            self._setForbidden(e)
            self.edgeHeap.removeEdge(e)

        if self.bundleEdges:
            cliqueToRepresentative: Dict[int, Tuple[int, int]] = {}
            uClique = list(g.getCliqueOf(u))
            uClique.extend(g.getCliqueOf(v))
            uSet = set(uClique)
            for x in uClique:
                for xn in list(g.getUnprunedNeighbours(x)):
                    ex = _edge(x, xn)
                    cxn = g.getCliqueIdOf(xn)
                    if xn in uSet:
                        continue
                    if g.findIndex(ex) == 0:
                        continue
                    if cxn not in cliqueToRepresentative:
                        cliqueToRepresentative[cxn] = ex
                    else:
                        self.edgeHeap.mergeEdges(ex, cliqueToRepresentative[cxn])

    def _chooseForbiddenEdge(self, eIcp: Tuple[int, int]) -> None:
        g = self.graph
        u, v = eIcp
        implications = []
        for x in g.getCliqueOf(u):
            for y in g.getCliqueOf(v):
                if x == y:
                    continue
                e = _edge(x, y)
                if g.findIndex(e) == 0 or (x == u and y == v):
                    continue
                implications.append(e)
        self._setForbidden(eIcp)
        self.edgeHeap.removeEdge(eIcp)
        for e in implications:
            self._setForbidden(e)
            self.edgeHeap.removeEdge(e)

    def _resolvePermanentForbidden(self) -> bool:
        g = self.graph
        processed = [False] * g.numNodes()
        cliques = []
        for u in range(g.numNodes()):
            if processed[u]:
                continue
            clique = []
            remaining = deque([u])
            processed[u] = True
            while remaining:
                current = remaining.popleft()
                clique.append(current)
                for v in g.getCliqueOf(current):
                    if not processed[v]:
                        remaining.append(v)
                        processed[v] = True
            cliques.append(clique)
            for i in range(len(clique)):
                for j in range(i + 1, len(clique)):
                    e = _edge(clique[i], clique[j])
                    w = g.getWeight(e)
                    if w == FORBIDDEN:
                        return False
                    self.edgeHeap.removeEdge(e)
                    if w < 0.0:
                        self.totalCost = _f32(self.totalCost - w)
                    if w != PERMANENT:
                        g.setPermanent(e)
        for k in range(len(cliques)):
            for l in range(k + 1, len(cliques)):
                found = False
                for x in cliques[k]:
                    if found:
                        break
                    for y in cliques[l]:
                        if x == y:
                            continue
                        if g.getWeight(_edge(x, y)) == FORBIDDEN:
                            found = True
                            break
                if found:
                    for x in cliques[k]:
                        for y in cliques[l]:
                            e = _edge(x, y)
                            self.edgeHeap.removeEdge(e)
                            w = g.getWeight(e)
                            if w > 0.0:
                                self.totalCost = _f32(self.totalCost + w)
                            if w != FORBIDDEN:
                                g.setForbidden(e)
        return True

    def _setForbidden(self, e: Tuple[int, int]) -> None:
        # inducedcostheuristic.cpp setForbidden (rank lookups hoisted)
        g = self.graph
        rank_t = g._rank_t
        weightv = g.weightv
        u, v = e
        rid = rank_t.get(e, 0)
        uv = weightv[rid]
        for w in list(g.unprunedNeighbours[u]):
            if w == v:
                continue
            r = rank_t.get((v, w) if v < w else (w, v), 0)
            if r > 0:
                self._updateTripleForbiddenUW(uv, (u, w) if u < w else (w, u), weightv[r])
        for w in list(g.unprunedNeighbours[v]):
            if w == u:
                continue
            r = rank_t.get((u, w) if u < w else (w, u), 0)
            if r > 0:
                self._updateTripleForbiddenUW(uv, (v, w) if v < w else (w, v), weightv[r])
        if uv > 0:
            self.totalCost = _f32(self.totalCost + uv)
        if rid > 0:
            g.setForbidden(e, rid)

    def _setPermanent(self, e: Tuple[int, int]) -> None:
        # inducedcostheuristic.cpp setPermanent (incl. the findIndex(r)
        # quirk in the second loop, which treats a rank id as an edge id)
        g = self.graph
        rank_t = g._rank_t
        rank_i = g._rank
        weightv = g.weightv
        u, v = e
        rid = rank_t.get(e, 0)
        uv = weightv[rid]
        for w in list(g.unprunedNeighbours[u]):
            if w == v:
                continue
            r = rank_t.get((v, w) if v < w else (w, v), 0)
            if r > 0:
                self._updateTriplePermanentUW(uv, (u, w) if u < w else (w, u), weightv[r])
        for w in list(g.unprunedNeighbours[v]):
            if w == u:
                continue
            r = rank_t.get((u, w) if u < w else (w, u), 0)
            if rank_i.get(r, 0) > 0:
                self._updateTriplePermanentUW(uv, (v, w) if v < w else (w, v), weightv[r])
        if uv < 0:
            self.totalCost = _f32(self.totalCost - uv)
        if rid > 0:
            g.setPermanent(e, rid)

    def _updateTripleForbiddenUW(self, uv: float, uw: Tuple[int, int], vw: float) -> None:
        icf_t = min(uv, vw) if (uv > 0 and vw > 0) else 0.0
        if uv < 0 and vw > 0:
            icp_t = min(vw, -uv)
        elif uv > 0 and vw < 0:
            icp_t = min(-vw, uv)
        else:
            icp_t = 0.0
        icfChange = _f32(0.0 - icf_t)
        icpChange = _f32((vw if vw > 0 else 0.0) - icp_t)
        if icfChange != 0 or icpChange != 0:
            r = self.graph._rank_t.get(uw, 0)
            if icfChange != 0:
                self.edgeHeap.increaseIcf_r(r, icfChange)
            if icpChange != 0:
                self.edgeHeap.increaseIcp_r(r, icpChange)

    def _updateTriplePermanentUW(self, uv: float, uw: Tuple[int, int], vw: float) -> None:
        icf_t = min(uv, vw) if (uv > 0 and vw > 0) else 0.0
        if uv < 0 and vw > 0:
            icp_t = min(vw, -uv)
        elif uv > 0 and vw < 0:
            icp_t = min(-vw, uv)
        else:
            icp_t = 0.0
        icfChange = _f32((vw if vw > 0 else 0.0) - icf_t)
        icpChange = _f32((-vw if vw < 0 else 0.0) - icp_t)
        if icfChange != 0 or icpChange != 0:
            r = self.graph._rank_t.get(uw, 0)
            if icfChange != 0:
                self.edgeHeap.increaseIcf_r(r, icfChange)
            if icpChange != 0:
                self.edgeHeap.increaseIcp_r(r, icpChange)


class ClusterEditingSolver:
    """solver.pyx ClusterEditingSolver: run() returns the clusters as a
    list of sorted node-id lists."""

    def __init__(self, m: TriangleSparseMatrix, bundleEdges: bool):
        self.m = m
        self.bundleEdges = bundleEdges

    def run(self) -> List[List[int]]:
        native = self._run_native()
        if native is not None:
            return native
        sGraph = StaticSparseGraph(self.m)
        instance = InducedCostHeuristic(sGraph, self.bundleEdges)
        solution = instance.solve()
        return [solution.getCluster(i) for i in range(solution.getNumClusters())]

    def _run_native(self) -> Optional[List[List[int]]]:
        """C++ engine (csrc/host/clusterlib.cpp, built at first use), same
        algorithm and float32 semantics; differential-tested against the
        Python path, which runs where hostlib.clusterlib is None."""
        import numpy as np

        from ..hostlib import clusterlib

        if clusterlib is None:
            return None
        m = self.m
        n_nodes = m.getMaxDim()
        if n_nodes == 0:
            return []
        # decode all edge ids in one vectorized pass (same formula as
        # _ceil_sqrt_node; the stored keys are index+1 in ascending order)
        keys = np.fromiter(m.m.keys(), dtype=np.int64, count=len(m.m))
        vals = np.fromiter(m.m.values(), dtype=np.float64, count=len(m.m))
        order = np.argsort(keys)
        eids = keys[order] - 1
        vs = np.ceil(np.sqrt(2.0 * (eids + 1) + 0.25) - 0.5).astype(np.int64)
        us = eids - vs * (vs - 1) // 2
        return clusterlib.run(
            n_nodes,
            us.astype(np.int32),
            vs.astype(np.int32),
            vals[order].astype(np.float32),
            self.bundleEdges,
        )
