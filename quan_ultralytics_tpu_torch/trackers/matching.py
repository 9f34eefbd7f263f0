"""Optimal linear assignment for tracker association (counterpart of the JAX
package's ``trackers/matching.py``).

The reference (ultralytics/trackers/utils/matching.py ``linear_assignment``)
solves min-cost matching with ``lap.lapjv`` or scipy's
``linear_sum_assignment`` and drops matches costing more than ``thresh``.
This is a dependency-free O(n^2 m) shortest-augmenting-path Hungarian with
dual potentials, which gives the optimal matching scipy gives on the
<= 300-detection cost matrices a tracker sees.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _solve_lsa(cost: np.ndarray) -> np.ndarray:
    """Min-cost assignment of an n x m matrix with n <= m: ``col[i]`` is the
    column assigned to row i (augmenting paths over dual potentials u, v; the
    inner relaxation vectorized)."""
    n, m = cost.shape
    if n > m:
        raise ValueError(f"_solve_lsa needs rows <= columns, got {cost.shape}")
    INF = np.inf
    u = np.zeros(n + 1)
    v = np.zeros(m + 1)
    p = np.zeros(m + 1, dtype=np.int64)  # p[j]: row (1-based) matched to column j
    way = np.zeros(m + 1, dtype=np.int64)
    c = np.empty((n + 1, m + 1))
    c[1:, 1:] = cost
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(m + 1, INF)
        used = np.zeros(m + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            free = ~used
            free[0] = False
            cur = c[i0, :] - u[i0] - v
            upd = free & (cur < minv)
            minv[upd] = cur[upd]
            way[upd] = j0
            mfree = np.where(free, minv, INF)
            j1 = int(np.argmin(mfree))
            delta = mfree[j1]
            u[p[used]] += delta
            v[used] -= delta
            minv[~used] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    col = np.zeros(n, dtype=np.int64)
    for j in range(1, m + 1):
        if p[j] > 0:
            col[p[j] - 1] = j - 1
    return col


def linear_assignment(cost: np.ndarray, thresh: float) -> Tuple[List[Tuple[int, int]], List[int], List[int]]:
    """Optimal min-cost matching with a gate: matches costing more than
    ``thresh`` are dropped (the reference's scipy path).

    Returns ``(matches [(i, j)], unmatched rows, unmatched columns)``.
    """
    na, nb = cost.shape
    if cost.size == 0:
        return [], list(range(na)), list(range(nb))
    cost = np.asarray(cost, dtype=np.float64)
    # impossible pairs get a finite cost above every feasible one, so that they
    # never displace a feasible pair
    big = max(thresh, float(np.nanmax(np.where(np.isfinite(cost), cost, thresh)))) + 1.0
    cg = np.where(np.isfinite(cost), np.minimum(cost, big), big)
    if na <= nb:
        col = _solve_lsa(cg)
        pairs = [(i, int(col[i])) for i in range(na)]
    else:
        row = _solve_lsa(cg.T)
        pairs = [(int(row[j]), j) for j in range(nb)]
    matches = [(i, j) for i, j in pairs if cost[i, j] <= thresh]
    ma = {i for i, _ in matches}
    mb = {j for _, j in matches}
    return matches, [i for i in range(na) if i not in ma], [j for j in range(nb) if j not in mb]
