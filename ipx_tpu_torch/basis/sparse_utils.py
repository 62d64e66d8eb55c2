"""Sparse graph utilities: nonrecursive DFS and augmenting-path matching.

Counterpart of the reference graph utilities (reference:
src/sparse_utils.{h,cc}, which adapt CSparse cs_dfs/cs_augment [T. Davis,
"Direct methods for sparse linear systems" (2006)]). Re-implemented here as
iterative Python over CSC index arrays.

The port's copy of ipx_tpu/basis/sparse_utils.py.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def depth_first_search(istart: int, Ap, Ai, colmap: Optional[np.ndarray],
                       top: int, istack: np.ndarray, marked: np.ndarray,
                       marker: int, work: np.ndarray) -> int:
    """DFS in the graph of A: the neighbours of node i are the row indices in
    column colmap[i] (or column i when colmap is None; negative = none).
    Reached previously-unmarked nodes are pushed to istack[newtop..top-1] in
    topological (reverse finish) order; returns newtop."""
    head = 0
    istack_pos = work          # per-depth edge pointers
    stack = [0] * 0
    # use istack's lower part as the DFS node stack
    node_stack = np.empty(len(istack), dtype=np.int64)
    node_stack[0] = istart
    head = 0
    while head >= 0:
        i = int(node_stack[head])
        j = int(colmap[i]) if colmap is not None else i
        if marked[i] != marker:
            marked[i] = marker
            istack_pos[head] = Ap[j] if j >= 0 else 0
        done = True
        pend = Ap[j + 1] if j >= 0 else 0
        p = int(istack_pos[head])
        while p < pend:
            inew = int(Ai[p])
            p += 1
            if marked[inew] != marker:
                istack_pos[head] = p
                head += 1
                node_stack[head] = inew
                done = False
                break
        if done:
            head -= 1
            top -= 1
            istack[top] = i
    return top


def augmenting_path(jstart: int, Ap, Ai, jmatch: np.ndarray,
                    cheap: np.ndarray, marked: np.ndarray,
                    work: np.ndarray, work2: np.ndarray,
                    work3: np.ndarray) -> bool:
    """Tries to extend a row-column matching by an alternating augmenting path
    starting at column jstart (cs_augment semantics, reference:
    src/sparse_utils.h:32-57). jmatch[i] = j>=0 matched, -1 unmatched
    eligible, < -1 excluded. Returns True if matched."""
    found = False
    head = 0
    js = work       # column stack
    is_ = work2     # row stack positions
    ps = work3      # pause stack
    js[0] = jstart
    while head >= 0:
        j = int(js[head])
        if marked[j] != jstart:
            marked[j] = jstart
            # cheap assignment: find unmatched eligible row in column j
            p = int(cheap[j])
            found_row = -1
            while p < Ap[j + 1]:
                i = int(Ai[p])
                if jmatch[i] == -1:
                    found_row = i
                    p += 1
                    break
                p += 1
            cheap[j] = p
            if found_row >= 0:
                is_[head] = found_row
                found = True
                break
            ps[head] = Ap[j]
        if found:
            break
        # depth first search over matched rows
        p = int(ps[head])
        advanced = False
        while p < Ap[j + 1]:
            i = int(Ai[p])
            jm = int(jmatch[i])
            p += 1
            if jm < 0:
                continue            # unmatched-excluded or handled by cheap
            if marked[jm] == jstart:
                continue
            ps[head] = p
            is_[head] = i
            head += 1
            js[head] = jm
            advanced = True
            break
        if not advanced:
            head -= 1
    if found:
        # augment along the path
        for h in range(head, -1, -1):
            jmatch[int(is_[h])] = int(js[h])
    return found
