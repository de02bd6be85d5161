"""Dynamic-programming optimal binning oracle (paper Sec. V-D, Fig. 15).

    OPT(i, j) = max( OPT(i+1, j),  OPT(i + c(i), j-1) + c(i) )

where c(i) is the number of points covered by the window [v_i, v_i + W]
starting at sorted point i.  (The paper's pseudo-code prints the recurrence
with the two branch arguments swapped; the text's description above is the
correct one and is what we implement.)

No binning strategy can cover more points with k width-W bins than this DP;
it is the oracle the paper compares top-k against (Figs. 13/14).  The paper
notes the O(n * 2^B) memory makes it impractical at scale -- here it exists
for tests and the binning benchmark only.

We run the DP over *unique* sorted values with multiplicities, which is
equivalent (a bin covering any point at value v covers all duplicates) and
keeps memory at O(n_unique * k).

A copy of the reference's NumPy oracle (``core/dp_oracle.py``): it runs
on the host, in tests and benches only, and the port keeps its own copy.
"""
from __future__ import annotations

from itertools import combinations

import numpy as np


def _prep(values: np.ndarray):
    vals = np.sort(np.asarray(values, np.float64).ravel())
    uniq, counts = np.unique(vals, return_counts=True)
    cum = np.concatenate([[0], np.cumsum(counts)])  # points before uniq[i]
    return uniq, counts, cum


def dp_max_coverage(values: np.ndarray, width: float, k: int) -> int:
    """Max number of points coverable by k closed windows of width W."""
    uniq, counts, cum = _prep(values)
    nu = uniq.size
    if nu == 0 or k <= 0:
        return 0
    # nxt[i]: first unique index with value > uniq[i] + width
    nxt = np.searchsorted(uniq, uniq + width, side="right")
    cover = cum[nxt] - cum[:-1]          # c(i) in point counts

    # Bottom-up over i descending; opt[j] == OPT(i, j) for current i.
    opt = np.zeros((nu + 1, k + 1), dtype=np.int64)
    for i in range(nu - 1, -1, -1):
        skip = opt[i + 1]
        take = opt[nxt[i]]
        opt[i, 1:] = np.maximum(skip[1:], take[:-1] + cover[i])
    return int(opt[0, k])


def dp_select_bins(values: np.ndarray, width: float, k: int):
    """Like dp_max_coverage but also backtracks the chosen window starts."""
    uniq, counts, cum = _prep(values)
    nu = uniq.size
    if nu == 0 or k <= 0:
        return 0, np.zeros(0)
    nxt = np.searchsorted(uniq, uniq + width, side="right")
    cover = cum[nxt] - cum[:-1]
    opt = np.zeros((nu + 1, k + 1), dtype=np.int64)
    for i in range(nu - 1, -1, -1):
        opt[i, 1:] = np.maximum(opt[i + 1, 1:], opt[nxt[i], :-1] + cover[i])
    starts = []
    i, j = 0, k
    while i < nu and j > 0:
        if opt[i, j] == opt[i + 1, j]:
            i += 1
        else:
            starts.append(uniq[i])
            i, j = nxt[i], j - 1
    return int(opt[0, k]), np.asarray(starts)


def brute_force_max_coverage(values: np.ndarray, width: float,
                             k: int) -> int:
    """Exponential check for tiny inputs (tests): windows anchored at points.

    An optimal solution always exists with every window starting at a data
    point (slide each window right until it hits one), so enumerating
    anchor subsets is exact.
    """
    uniq, counts, cum = _prep(values)
    nu = uniq.size
    if nu == 0 or k <= 0:
        return 0
    nxt = np.searchsorted(uniq, uniq + width, side="right")
    best = 0
    for combo in combinations(range(nu), min(k, nu)):
        covered = np.zeros(nu, bool)
        for i in combo:
            covered[i:nxt[i]] = True
        best = max(best, int(counts[covered].sum()))
    return best


def coverage_of_centers(values: np.ndarray, centers: np.ndarray,
                        error_bound: float) -> int:
    """#points within error_bound of some center (strategy comparison)."""
    vals = np.sort(np.asarray(values, np.float64).ravel())
    centers = np.sort(np.asarray(centers, np.float64).ravel())
    covered = 0
    for c in centers:
        lo = np.searchsorted(vals, c - error_bound, side="left")
        hi = np.searchsorted(vals, c + error_bound, side="right")
        covered += hi - lo
        vals = np.concatenate([vals[:lo], vals[hi:]])
    return int(covered)


__all__ = ["dp_max_coverage", "dp_select_bins", "brute_force_max_coverage",
           "coverage_of_centers"]
