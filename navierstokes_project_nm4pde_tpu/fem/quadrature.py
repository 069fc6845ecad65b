"""Gauss quadrature on simplices (cells) and their facets.

The reference uses deal.II `QGaussSimplex(degree+1)` conical-product rules
(ref: src/NavierStokes2D.cpp:45-53) -- 9 points on triangles / 27 on tets for
P2.  We instead tabulate compact symmetric rules with the same polynomial
exactness (degree 5): Dunavant's 7-point triangle rule and Keast's 15-point
tetrahedron rule -- fewer quadrature points means proportionally fewer
FLOPs per operator application with identical integration accuracy for the
affine Taylor-Hood forms.

All rules return ``(points, weights)`` where ``points`` are reference-cell
coordinates [n_q, dim] and ``weights`` are absolute (they sum to the
reference-cell measure: 1/2 for the triangle, 1/6 for the tet, the interval
length for edges).
"""

from __future__ import annotations

import numpy as np


def _from_barycentric(bary: np.ndarray) -> np.ndarray:
    """[n, dim+1] barycentric -> [n, dim] reference coords (drop lam0)."""
    return np.asarray(bary, dtype=np.float64)[:, 1:]


def _sym_orbits_tri(groups):
    pts, wts = [], []
    for w, bary in groups:
        seen = set()
        from itertools import permutations

        for perm in permutations(bary):
            if perm in seen:
                continue
            seen.add(perm)
            pts.append(perm)
            wts.append(w)
    return np.array(pts, dtype=np.float64), np.array(wts, dtype=np.float64)


def triangle_rule(degree: int):
    """Symmetric triangle rules. Weights sum to 1/2 (reference area)."""
    if degree <= 1:
        bary = np.array([[1 / 3, 1 / 3, 1 / 3]])
        w = np.array([0.5])
    elif degree <= 2:
        bary = np.array(
            [[2 / 3, 1 / 6, 1 / 6], [1 / 6, 2 / 3, 1 / 6], [1 / 6, 1 / 6, 2 / 3]]
        )
        w = np.full(3, 1 / 6)
    elif degree <= 4:
        # Dunavant degree 4, 6 points.
        a1, w1 = 0.445948490915965, 0.223381589678011
        a2, w2 = 0.091576213509771, 0.109951743655322
        bary, w = _sym_orbits_tri(
            [(w1, (1 - 2 * a1, a1, a1)), (w2, (1 - 2 * a2, a2, a2))]
        )
        w = w * 0.5
    else:
        # Dunavant degree 5, 7 points.
        b1, w1 = 0.470142064105115, 0.132394152788506
        b2, w2 = 0.101286507323456, 0.125939180544827
        bary, w = _sym_orbits_tri(
            [
                (0.225, (1 / 3, 1 / 3, 1 / 3)),
                (w1, (1 - 2 * b1, b1, b1)),
                (w2, (1 - 2 * b2, b2, b2)),
            ]
        )
        w = w * 0.5
        if degree > 5:
            raise NotImplementedError(f"triangle rule degree {degree}")
    return _from_barycentric(bary), w


def _sym_orbits_tet(groups):
    from itertools import permutations

    pts, wts = [], []
    for w, bary in groups:
        seen = set()
        for perm in permutations(bary):
            if perm in seen:
                continue
            seen.add(perm)
            pts.append(perm)
            wts.append(w)
    return np.array(pts, dtype=np.float64), np.array(wts, dtype=np.float64)


def tet_rule(degree: int):
    """Symmetric tetrahedron rules. Weights sum to 1/6 (reference volume)."""
    if degree <= 1:
        bary = np.array([[0.25, 0.25, 0.25, 0.25]])
        w = np.array([1 / 6])
    elif degree <= 2:
        # 4-point degree-2 rule.
        a = 0.585410196624969  # (5 + 3*sqrt(5)) / 20
        b = 0.138196601125011  # (5 - sqrt(5)) / 20
        bary, w = _sym_orbits_tet([(1 / 24, (a, b, b, b))])
    else:
        # Keast degree 5, 15 points (weights already sum to 1/6).
        g2 = 1.0 / 3.0
        bary, w = _sym_orbits_tet(
            [
                (0.030283678097089, (0.25, 0.25, 0.25, 0.25)),
                (0.006026785714286, (g2, g2, g2, 0.0)),
                (0.011645249086029, (1 / 11, 1 / 11, 1 / 11, 8 / 11)),
                (0.010949141561386, (0.066550153573664, 0.066550153573664,
                                     0.433449846426336, 0.433449846426336)),
            ]
        )
        if degree > 5:
            raise NotImplementedError(f"tet rule degree {degree}")
    return _from_barycentric(bary), w


def gauss_1d(n: int):
    """n-point Gauss-Legendre on [0, 1]; exact to degree 2n-1."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def cell_rule(dim: int, degree: int):
    """Volume rule on the reference simplex of dimension `dim`."""
    if dim == 2:
        return triangle_rule(degree)
    if dim == 3:
        return tet_rule(degree)
    raise ValueError(f"unsupported dim {dim}")


def face_rule(dim: int, degree: int):
    """Rule on the reference facet (interval for dim=2, triangle for dim=3)."""
    if dim == 2:
        x, w = gauss_1d((degree + 2) // 2)
        return x[:, None], w
    if dim == 3:
        return triangle_rule(degree)
    raise ValueError(f"unsupported dim {dim}")
