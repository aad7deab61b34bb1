"""Convex-hull pruning (paper §3.2 optimisation step).

After each slice, interior vertices are discarded so the vertex count
does not grow quadratically with successive slices.  The paper names
QuickHull [Barber et al. 1996]; ``scipy.spatial.ConvexHull`` *is*
qhull's QuickHull, so we use it for D >= 2 and handle the degenerate
cases (1-D, collinear/coplanar point sets) ourselves — degeneracy is the
common case here because slicing a D-polytope that is flat along some
axis produces rank-deficient vertex sets qhull refuses.
"""

from __future__ import annotations

import numpy as np

_MAX_NO_PRUNE = 8  # hull of <= D+2 points rarely worth the qhull call


def convex_hull_prune(points: np.ndarray) -> np.ndarray:
    """Return the subset of ``points`` on their convex hull.

    Never raises on degenerate input: falls back to an exact
    rank-reduction (project onto the affine span, recurse) and, at worst,
    returns the input unchanged — pruning is an optimisation, not a
    correctness requirement.
    """
    pts = np.asarray(points, np.float64)
    n, d = pts.shape
    if n <= 2 or d == 0:
        return pts
    if d == 1:
        return np.array([[pts[:, 0].min()], [pts[:, 0].max()]])
    if n <= d + 1:
        return pts

    # Rank of the affine span decides whether qhull can run directly.
    centered = pts - pts.mean(0)
    # SVD is cheap: slicing keeps vertex counts small (hull-pruned).
    u, s, vt = np.linalg.svd(centered, full_matrices=False)
    scale = s[0] if s[0] > 0 else 1.0
    rank = int((s > 1e-12 * scale).sum())
    if rank == 0:
        return pts[:1]
    if rank < d:
        # Project to the span, prune there, lift back by selecting rows.
        proj = centered @ vt[:rank].T
        keep = _hull_indices(proj)
        return pts[keep]
    keep = _hull_indices(pts)
    return pts[keep]


def _hull_indices(pts: np.ndarray) -> np.ndarray:
    n, d = pts.shape
    if d == 1:
        return np.unique([int(pts[:, 0].argmin()), int(pts[:, 0].argmax())])
    if n <= d + 1:
        return np.arange(n)
    if d == 2:
        # 2-D is the hot case (the last slicing stage before the 1-D
        # leaves): Andrew's monotone chain in pure numpy beats the
        # scipy/qhull call overhead ~5× at these tiny sizes.
        return _monotone_chain(pts)
    try:
        from scipy.spatial import ConvexHull

        return np.unique(ConvexHull(pts).vertices)
    except Exception:
        # qhull can still fail on near-degenerate input; joggle once.
        try:
            from scipy.spatial import ConvexHull

            return np.unique(ConvexHull(pts, qhull_options="QJ").vertices)
        except Exception:
            return np.arange(n)


def _monotone_chain(pts: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain 2-D convex hull → vertex indices."""
    order = np.lexsort((pts[:, 1], pts[:, 0]))

    def half(idx_iter):
        out: list[int] = []
        for i in idx_iter:
            while len(out) >= 2:
                o, a = pts[out[-2]], pts[out[-1]]
                cross = ((a[0] - o[0]) * (pts[i][1] - o[1])
                         - (a[1] - o[1]) * (pts[i][0] - o[0]))
                # strict `<= 0`: an absolute epsilon here misclassifies
                # subnormal-coordinate hulls (hypothesis-found bug) —
                # keeping a nearly-collinear vertex is harmless, losing
                # a true hull vertex loses extracted points.
                if cross <= 0.0:
                    out.pop()
                else:
                    break
            out.append(int(i))
        return out[:-1]

    lower = half(order)
    upper = half(order[::-1])
    hull = lower + upper
    if not hull:          # all collinear
        return np.unique([int(order[0]), int(order[-1])])
    return np.unique(hull)
