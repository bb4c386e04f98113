"""Faithful re-implementation of libstdc++'s std::priority_queue heap ops.

The reference router runs Dijkstra with a std::priority_queue over
(Road*, double) pairs compared only on the double (reference:
router.cpp:160-243).  Grid scenarios produce many EQUAL path costs, and which
equal-cost road pops first decides the chosen route — so bit-exact routing
requires reproducing the exact push_heap / pop_heap element movements
(bits/stl_heap.h algorithm: sift-up on push; pop moves the last element into
the hole via __adjust_heap's "go down to a leaf then sift up" strategy).

``less(a, b)`` must be the priority_queue comparator (for a min-heap on cost:
``lambda a, b: a.cost > b.cost``). The queue's "largest" element per ``less``
sits at index 0.
"""


class StdPriorityQueue:
    def __init__(self, less):
        self._less = less
        self._heap = []

    def __len__(self):
        return len(self._heap)

    def empty(self):
        return not self._heap

    def top(self):
        return self._heap[0]

    def push(self, value):
        # std::priority_queue::push: c.push_back(x); std::push_heap(...)
        a = self._heap
        a.append(value)
        self._push_heap(a, len(a) - 1, 0, value)

    def pop(self):
        # std::priority_queue::pop: std::pop_heap(...); c.pop_back()
        a = self._heap
        value = a[-1]
        top = a[0]
        a.pop()
        if a:
            self._adjust_heap(a, 0, len(a), value)
        return top

    def _push_heap(self, a, hole, top, value):
        less = self._less
        parent = (hole - 1) // 2
        while hole > top and less(a[parent], value):
            a[hole] = a[parent]
            hole = parent
            parent = (hole - 1) // 2
        a[hole] = value

    def _adjust_heap(self, a, hole, length, value):
        # libstdc++ __adjust_heap: walk the hole down to a leaf along the
        # larger child, then sift the tail value up from the leaf.
        less = self._less
        top = hole
        second = hole
        while second < (length - 1) // 2:
            second = 2 * (second + 1)
            if less(a[second], a[second - 1]):
                second -= 1
            a[hole] = a[second]
            hole = second
        if length % 2 == 0 and second == (length - 2) // 2:
            second = 2 * (second + 1)
            a[hole] = a[second - 1]
            hole = second - 1
        self._push_heap(a, hole, top, value)
