"""
Binary max-heap with vector-valued priorities and score lookup/update by
item.  Parity with whatshap/priorityqueue.pyx — the heap's (unstable) tie
behavior is part of the read-selection output contract, so the sift/swap
logic is replicated operation for operation.
"""

from typing import Dict, List, Optional, Tuple, Union

Score = Tuple[int, ...]

from . import hostlib


def _score_tuple(score) -> Score:
    if isinstance(score, int):
        return (score,)
    try:
        result = tuple(score)
    except TypeError:
        raise ValueError(
            "Score parameter must be either int, or an iterable object yielding ints"
        )
    if not all(isinstance(i, int) for i in result):
        raise ValueError(
            "Score parameter must be either int, or an iterable object yielding ints"
        )
    return result


def _vector_score_lower(first: Score, second: Score) -> bool:
    for a, b in zip(first, second):
        if a < b:
            return True
        if a > b:
            return False
    return len(first) < len(second)


class _PriorityQueuePython:
    def __init__(self):
        self._heap: List[List] = []  # entries [score_tuple, item]
        self._positions: Dict[int, int] = {}

    def push(self, score, item: int) -> None:
        self.c_push(_score_tuple(score), item)

    def c_push(self, score: Score, item: int) -> None:
        newindex = len(self._heap)
        self._heap.append([score, item])
        self._positions[item] = newindex
        self._sift_up(newindex)

    def _swap(self, index1: int, index2: int) -> None:
        entry1 = self._heap[index1]
        pos1 = self._positions[entry1[1]]
        entry2 = self._heap[index2]
        pos2 = self._positions[entry2[1]]
        self._positions[entry1[1]] = pos2
        self._positions[entry2[1]] = pos1
        self._heap[index1] = entry2
        self._heap[index2] = entry1

    def _score_lower(self, index1: int, index2: int) -> bool:
        return _vector_score_lower(self._heap[index1][0], self._heap[index2][0])

    def _sift_up(self, index: int) -> None:
        parentindex = (index - 1) // 2
        assert parentindex != index
        if parentindex >= 0:
            if self._score_lower(parentindex, index):
                self._swap(parentindex, index)
                self._sift_up(parentindex)

    def _sift_down(self, index: int) -> None:
        rchildindex = 2 * index + 2
        lchildindex = 2 * index + 1
        n = len(self._heap)
        if rchildindex < n:
            if self._score_lower(lchildindex, rchildindex):
                if self._score_lower(index, rchildindex):
                    self._swap(rchildindex, index)
                    self._sift_down(rchildindex)
            else:
                if self._score_lower(index, lchildindex):
                    self._swap(lchildindex, index)
                    self._sift_down(lchildindex)
        elif lchildindex < n:
            if self._score_lower(index, lchildindex):
                self._swap(lchildindex, index)
                self._sift_down(lchildindex)

    def pop(self) -> Tuple[Union[int, Score], int]:
        score, item = self.c_pop()
        if len(score) == 1:
            return score[0], item
        return score, item

    def c_pop(self) -> Tuple[Score, int]:
        if not self._heap:
            raise IndexError("PriorityQueue empty.")
        last_entry = self._heap[-1]
        first_entry = self._heap[0]
        if len(self._heap) == 1:
            del self._positions[first_entry[1]]
            self._heap.pop()
        else:
            self._heap[0] = last_entry
            self._heap.pop()
            self._positions[last_entry[1]] = 0
            del self._positions[first_entry[1]]
            self._sift_down(0)
        return first_entry[0], first_entry[1]

    def change_score(self, item: int, new_score) -> None:
        self.c_change_score(item, _score_tuple(new_score))

    def c_change_score(self, item: int, new_score: Score) -> None:
        position = self._positions[item]
        old_score = self._heap[position][0]
        self._heap[position][0] = new_score
        if _vector_score_lower(old_score, new_score):
            self._sift_up(position)
        else:
            self._sift_down(position)

    def get_score_by_item(self, item: int) -> Optional[Union[int, Score]]:
        score = self.c_get_score_by_item(item)
        if score is None:
            return None
        if len(score) == 1:
            return score[0]
        return score

    def c_get_score_by_item(self, item: int) -> Optional[Score]:
        pos = self._positions.get(item)
        if pos is None:
            return None
        return self._heap[pos][0]

    def __len__(self) -> int:
        return len(self._heap)

    def size(self) -> int:
        return len(self._heap)

    def is_empty(self) -> bool:
        return not self._heap

    def c_is_empty(self) -> bool:
        return not self._heap


class _PriorityQueueNative:
    """Wrapper over the CPython extension heap (csrc/host/pqext.cpp) — same
    operation-for-operation heap layout as the Python implementation, so
    the unstable tie behavior (part of the read-selection output contract)
    is preserved exactly; differentially tested."""

    __slots__ = ("_pq",)

    def __init__(self):
        self._pq = hostlib.pqext.PriorityQueueExt()

    def push(self, score, item: int) -> None:
        self._pq.c_push(_score_tuple(score), item)

    def c_push(self, score: Score, item: int) -> None:
        self._pq.c_push(score if isinstance(score, tuple) else tuple(score), item)

    def pop(self):
        score, item = self._pq.c_pop()
        if len(score) == 1:
            return score[0], item
        return score, item

    def c_pop(self):
        return self._pq.c_pop()

    def change_score(self, item: int, new_score) -> None:
        self._pq.c_change_score(item, _score_tuple(new_score))

    def c_change_score(self, item: int, new_score: Score) -> None:
        self._pq.c_change_score(
            item, new_score if isinstance(new_score, tuple) else tuple(new_score)
        )

    def get_score_by_item(self, item: int):
        score = self._pq.c_get_score_by_item(item)
        if score is None:
            return None
        if len(score) == 1:
            return score[0]
        return score

    def c_get_score_by_item(self, item: int):
        return self._pq.c_get_score_by_item(item)

    def __len__(self) -> int:
        return len(self._pq)

    def size(self) -> int:
        return len(self._pq)

    def is_empty(self) -> bool:
        return self._pq.c_is_empty()

    def c_is_empty(self) -> bool:
        return self._pq.c_is_empty()


def PriorityQueue():
    """A new heap: the extension's (hostlib.pqext, built at first use), or
    the Python one where hostlib.pqext is None."""
    return _PriorityQueueNative() if hostlib.pqext is not None else _PriorityQueuePython()
