"""Faithful re-implementation of libstdc++'s std::sort (introsort).

The reference sorts conflict crosses per lanelink with std::sort under a
strict-weak "<" on distance (reference: roadnet.cpp:568-575). Crosses at equal
distance are COMMON (lanelinks fanning out of one point all cross at 0), and
the resulting tie order is whatever introsort produces — it feeds the
cross-yielding scan order, so bit-exact simulation requires reproducing it.

This follows the published libstdc++ algorithm (bits/stl_algo.h): introsort
loop with median-of-3 unguarded partition, depth limit 2*floor(log2(n)) with
heap-sort fallback, threshold 16, then a final insertion-sort pass.
"""

import math


_THRESHOLD = 16


def std_sort(a, less):
    """In-place std::sort(a.begin(), a.end(), less) — libstdc++ semantics."""
    n = len(a)
    if n <= 1:
        return a
    depth = 2 * int(math.floor(math.log2(n)))
    _introsort_loop(a, 0, n, depth, less)
    _final_insertion_sort(a, 0, n, less)
    return a


def _introsort_loop(a, first, last, depth_limit, less):
    while last - first > _THRESHOLD:
        if depth_limit == 0:
            _heap_sort(a, first, last, less)
            return
        depth_limit -= 1
        cut = _unguarded_partition_pivot(a, first, last, less)
        _introsort_loop(a, cut, last, depth_limit, less)
        last = cut


def _move_median_to_first(a, result, x, y, z, less):
    if less(a[x], a[y]):
        if less(a[y], a[z]):
            a[result], a[y] = a[y], a[result]
        elif less(a[x], a[z]):
            a[result], a[z] = a[z], a[result]
        else:
            a[result], a[x] = a[x], a[result]
    elif less(a[x], a[z]):
        a[result], a[x] = a[x], a[result]
    elif less(a[y], a[z]):
        a[result], a[z] = a[z], a[result]
    else:
        a[result], a[y] = a[y], a[result]


def _unguarded_partition(a, first, last, pivot, less):
    while True:
        while less(a[first], a[pivot]):
            first += 1
        last -= 1
        while less(a[pivot], a[last]):
            last -= 1
        if not (first < last):
            return first
        a[first], a[last] = a[last], a[first]
        first += 1


def _unguarded_partition_pivot(a, first, last, less):
    mid = first + (last - first) // 2
    _move_median_to_first(a, first, first + 1, mid, last - 1, less)
    return _unguarded_partition(a, first + 1, last, first, less)


def _final_insertion_sort(a, first, last, less):
    if last - first > _THRESHOLD:
        _insertion_sort(a, first, first + _THRESHOLD, less)
        for i in range(first + _THRESHOLD, last):
            _unguarded_linear_insert(a, i, less)
    else:
        _insertion_sort(a, first, last, less)


def _insertion_sort(a, first, last, less):
    if first == last:
        return
    for i in range(first + 1, last):
        if less(a[i], a[first]):
            val = a[i]
            # copy_backward(first, i, i+1)
            a[first + 1:i + 1] = a[first:i]
            a[first] = val
        else:
            _unguarded_linear_insert(a, i, less)


def _unguarded_linear_insert(a, last, less):
    val = a[last]
    nxt = last - 1
    while less(val, a[nxt]):
        a[last] = a[nxt]
        last = nxt
        nxt -= 1
    a[last] = val


# ---- heap-sort fallback (partial_sort over the whole range) ----

def _heap_sort(a, first, last, less):
    _make_heap(a, first, last, less)
    for end in range(last, first + 1, -1):
        a[first], a[end - 1] = a[end - 1], a[first]
        _adjust_heap(a, first, 0, end - 1 - first, a[first], less)


def _make_heap(a, first, last, less):
    length = last - first
    if length < 2:
        return
    parent = (length - 2) // 2
    while True:
        value = a[first + parent]
        _adjust_heap(a, first, parent, length, value, less)
        if parent == 0:
            return
        parent -= 1


def _push_heap(a, first, hole, top, value, less):
    parent = (hole - 1) // 2
    while hole > top and less(a[first + parent], value):
        a[first + hole] = a[first + parent]
        hole = parent
        parent = (hole - 1) // 2
    a[first + hole] = value


def _adjust_heap(a, first, hole, length, value, less):
    top = hole
    second = hole
    while second < (length - 1) // 2:
        second = 2 * (second + 1)
        if less(a[first + second], a[first + second - 1]):
            second -= 1
        a[first + hole] = a[first + second]
        hole = second
    if length & 1 == 0 and second == (length - 2) // 2:
        second = 2 * (second + 1)
        a[first + hole] = a[first + second - 1]
        hole = second - 1
    _push_heap(a, first, hole, top, value, less)
