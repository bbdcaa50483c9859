"""Hierarchic Raviart-Thomas element on the reference triangle.

A from-scratch construction of the Boffi-Brezzi-Fortin style hierarchic RT_k
element the reference builds through Basix custom elements
(``python/dolfinx_eqlb/elmtlib/e_raviart_thomas.py:40-196``).  Differences by
design (the *space* is identical, the dof functionals are better conditioned):

* facet functionals use shifted **Legendre** moments
  ``l_{e,m}(v) = int_0^1 v(x_e(s)) . rot(t_e) P~_m(s) ds``
  instead of monomial moments ``s^j`` — under facet reversal (s -> 1-s,
  normal flip) a dof transforms as ``(-1)^(m+1)``, i.e. the reference's
  upper-triangular binomial transformation (``se/KernelData.cpp:46-64``)
  becomes a diagonal sign, which batches trivially.
* cell "divergence" functionals use orthonormal Dubiner modes of P_{k-1}
  (minus the constant) instead of monomials ``x^l y^m`` (reference
  ``e_raviart_thomas.py:104-112``); interior functionals
  ``int v.e2 x^l y^m`` (l >= 1, l+m <= k-2) match the reference
  (``e_raviart_thomas.py:114-121``).

Key invariant preserved (SURVEY.md 2.1): facet dof 0 is the constant normal
moment and the divergence of a member is controlled *only* by the facet-0
dofs and the divergence cell dofs, which is what makes the semi-explicit
equilibration step and the H(div=0) minimisation space explicit.

The contravariant Piola map ``sigma(x) = (1/detJ) J sigma^(xhat)`` relates
reference and physical functions; with the rot(t) facet functionals the
identity ``J^T rot(J t) = detJ rot(t)`` makes facet dofs Piola-invariant up
to an orientation sign (computed in ``fem.dofmap``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .polynomials import (
    dubiner_basis,
    legendre_shifted,
    poly_diff,
    poly_eval,
)
from .quadrature import (
    REF_EDGE_ROTT,
    facet_param_points,
    gauss_interval,
    gauss_triangle,
)

__all__ = ["HierarchicRT", "rt_cached"]


class HierarchicRT:
    def __init__(self, degree: int):
        if degree < 1:
            raise ValueError("RT degree must be >= 1")
        k = self.degree = degree
        self.ndofs = k * (k + 2)
        self.ndofs_facet = k
        self.ndofs_cell = k * (k - 1)
        # cell dofs split: divergence moments then interior moments
        self.ndofs_cell_div = k * (k + 1) // 2 - 1
        self.ndofs_cell_int = (k - 1) * (k - 2) // 2
        assert self.ndofs_cell == self.ndofs_cell_div + self.ndofs_cell_int

        # --- spanning set of RT_k = P_{k-1}^2 + x * P~_{k-1}(homogeneous)
        dub = dubiner_basis(k - 1)
        ndg = len(dub)
        deg_max = k + 1  # coeff array size
        spans = []  # list of (Cx, Cy)
        Z = np.zeros((deg_max, deg_max))

        def pad(C):
            out = Z.copy()
            out[: C.shape[0], : C.shape[1]] = C
            return out

        for C in dub:
            spans.append((pad(C), Z.copy()))
        for C in dub:
            spans.append((Z.copy(), pad(C)))
        for a in range(k):  # (x, y) * x^a y^(k-1-a)
            Cx = Z.copy()
            Cx[a + 1, k - 1 - a] = 1.0
            Cy = Z.copy()
            Cy[a, k - a] = 1.0
            spans.append((Cx, Cy))
        assert len(spans) == self.ndofs

        # --- dof functionals applied to the span set
        V = np.zeros((self.ndofs, self.ndofs))
        leg = legendre_shifted(k - 1)  # (k, k) coeffs in s

        # facet moments (exact Gauss: integrand degree <= 2k-1)
        s, w = gauss_interval(k + 1)
        pts_e = facet_param_points(s)  # (3, nq, 2)
        legvals = np.array(
            [np.polyval(leg[m, ::-1], s) for m in range(k)]
        )  # (k, nq)
        for b, (Cx, Cy) in enumerate(spans):
            for e in range(3):
                vx = poly_eval(Cx, pts_e[e])
                vy = poly_eval(Cy, pts_e[e])
                vn = REF_EDGE_ROTT[e, 0] * vx + REF_EDGE_ROTT[e, 1] * vy
                for m in range(k):
                    V[e * k + m, b] = np.sum(w * legvals[m] * vn)

        # cell moments via quadrature (exact for polynomials and numerically
        # stable; tri_integrate carries cancellation error at high degree)
        cpts, cw = gauss_triangle(2 * k + 1)
        dubvals = np.array([poly_eval(C, cpts) for C in dub])  # (ndg, nq)
        row = 3 * k
        for b, (Cx, Cy) in enumerate(spans):
            div = pad(poly_diff(Cx, 0))
            dY = poly_diff(Cy, 1)
            div[: dY.shape[0], : dY.shape[1]] += dY
            divv = poly_eval(div, cpts)
            for p in range(1, ndg):
                V[row + p - 1, b] = np.sum(cw * divv * dubvals[p])

        # interior moments int v_y x^l y^m, l >= 1, l + m <= k - 2
        row = 3 * k + self.ndofs_cell_div
        n = 0
        for l in range(1, k - 1):
            for m in range(0, k - 1 - l):
                mono = cpts[:, 0] ** l * cpts[:, 1] ** m
                for b, (Cx, Cy) in enumerate(spans):
                    V[row + n, b] = np.sum(cw * poly_eval(Cy, cpts) * mono)
                n += 1
        assert n == self.ndofs_cell_int

        self._dual_cond = np.linalg.cond(V)
        Vinv = np.linalg.inv(V)

        # basis i (dual to functional i): coeff arrays (ndofs, 2, d, d)
        self.coeffs = np.zeros((self.ndofs, 2, deg_max, deg_max))
        for i in range(self.ndofs):
            for b in range(self.ndofs):
                c = Vinv[b, i]
                if c != 0.0:
                    self.coeffs[i, 0] += c * spans[b][0]
                    self.coeffs[i, 1] += c * spans[b][1]

        # divergence coeff arrays (ndofs, d, d)
        self.div_coeffs = np.zeros((self.ndofs, deg_max, deg_max))
        for i in range(self.ndofs):
            dX = poly_diff(self.coeffs[i, 0], 0)
            dY = poly_diff(self.coeffs[i, 1], 1)
            self.div_coeffs[i, : dX.shape[0], : dX.shape[1]] += dX
            self.div_coeffs[i, : dY.shape[0], : dY.shape[1]] += dY

    # --- tabulation ---------------------------------------------------------

    def tabulate(self, pts: np.ndarray) -> np.ndarray:
        """Reference basis values, (ndofs, 2, npts)."""
        out = np.zeros((self.ndofs, 2, len(pts)))
        for i in range(self.ndofs):
            out[i, 0] = poly_eval(self.coeffs[i, 0], pts)
            out[i, 1] = poly_eval(self.coeffs[i, 1], pts)
        return out

    def tabulate_div(self, pts: np.ndarray) -> np.ndarray:
        """Reference divergence values, (ndofs, npts)."""
        return np.array([poly_eval(C, pts) for C in self.div_coeffs])

    def facet_moment_weights(self, nq: int) -> tuple[np.ndarray, np.ndarray]:
        """Quadrature (s, W) with W (k, nq): dof_m(v) = sum_q W[m,q] vn(s_q).

        ``vn`` is v . rot(tangent) along the facet in its canonical direction.
        """
        s, w = gauss_interval(nq)
        leg = legendre_shifted(self.degree - 1)
        W = np.array(
            [np.polyval(leg[m, ::-1], s) * w for m in range(self.degree)]
        )
        return s, W


@lru_cache(maxsize=None)
def rt_cached(degree: int) -> HierarchicRT:
    return HierarchicRT(degree)
