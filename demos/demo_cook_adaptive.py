"""Demo: adaptive weakly-symmetric stress equilibration on Cook's membrane.

Mirror of reference ``demo/elasticity_adaptive/demo_cook.py``: clamped left
edge, traction (0, 1/16) on the right edge, guaranteed estimator driving
Doerfler marking + bisection refinement.  The deficient pure-traction
corner patches (right edge) are handled by the engine's patch GROUPING
(reference ``se/reconstruction.hpp:166-234``) — the user's mesh is never
modified.

True-error reporting (reference ``demo_cook.py:14-17``): a numerical
overkill solution (final mesh uniformly refined once, degree + 1) serves
as reference.  All meshes are nested (bisection/red refinements of one
base), so with the Galerkin identities the energy error in the a-norm
|||v|||^2 = a(v, v) = int 2 eps:eps + pi_1 div^2 reduces to the traction
functional difference

    |||u_ref - u_h|||^2 = L(u_ref) - L(u_h),   L(v) = int_right t . v ds,

and needs no cross-mesh interpolation.  I_eff is reported against this
a-norm (the uniform-mesh elasticity demo uses the equivalent
eps:eps + pi_1 div^2 norm; the two differ by at most sqrt(2)).
"""

import os as _os
import sys as _sys

# self-locate: make `python demos/<demo>.py` work without PYTHONPATH
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)

from dolfinx_eqlb_tpu.mesh import cook_membrane, refine_marked, refine_uniform
from dolfinx_eqlb_tpu.fem import FunctionSpace, local_projection, expr_from_callable
from dolfinx_eqlb_tpu.models import ElasticitySolver, stress_row_expr
from dolfinx_eqlb_tpu.eqlb import FluxEqlbSE, fluxbc
from dolfinx_eqlb_tpu.estimation import estimate_elasticity, doerfler_mark

PI_1 = 1.0
TRACTION = 1.0 / 16.0


def _solve_primal(msh, order_prime, rtol=1e-11):
    V = FunctionSpace(msh, "P", order_prime, vs=2)
    left = msh.locate_boundary_facets(lambda x: np.isclose(x[..., 0], 0.0))
    right = msh.locate_boundary_facets(lambda x: np.isclose(x[..., 0], 48.0))
    solver = ElasticitySolver(V, PI_1)
    uh = solver.solve(
        expr_from_callable(
            lambda x: np.zeros(x.shape[:-1] + (2,)), msh, value_size=2
        ),
        left,
        expr_from_callable(
            lambda x: np.zeros(x.shape[:-1] + (2,)), msh, value_size=2
        ),
        tractions=[
            (right, lambda x: np.stack(
                [np.zeros(x.shape[:-1]), TRACTION * np.ones(x.shape[:-1])], -1
            ))
        ],
        rtol=rtol,
    )
    return uh, left, right


def _load_functional(msh, uh, right):
    """L(u) = int_right (0, TRACTION) . u ds (2-pt Gauss per facet)."""
    from dolfinx_eqlb_tpu.elements.quadrature import (
        LOCAL_EDGE_VERTICES as LOC, gauss_interval)

    t, w = gauss_interval(3)
    vref = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    pts = np.concatenate([
        vref[a][None] + t[:, None] * (vref[b] - vref[a])[None]
        for a, b in LOC
    ], 0)  # (3*nq, 2)
    vals = np.asarray(uh.evaluate(pts)).reshape(
        msh.num_cells, 3, len(t), 2)
    c, l = msh.facet_cells[right, 0], msh.facet_local[right, 0]
    uy = vals[c, l][..., 1]  # (nF, nq)
    gv = msh.facet_vertices[right]
    hF = np.linalg.norm(msh.points[gv[:, 1]] - msh.points[gv[:, 0]], axis=1)
    return float(TRACTION * np.einsum("q,fq,f->", w, uy, hF))


def run(order_prime=2, degree=None, theta=0.5, max_iter=6, n0=2,
        verbose=True):
    if degree is None:
        degree = order_prime + 1  # estimator-grade (see demo_elasticity.py)
    msh = cook_membrane(n0, n0)
    history = []
    solutions = []
    for it in range(max_iter):
        uh, left, right = _solve_primal(msh, order_prime)
        other = np.setdiff1d(msh.boundary_facets,
                             np.concatenate([left, right]))

        Vf = FunctionSpace(msh, "DG", degree - 1, vs=2)
        Vr = FunctionSpace(msh, "DG", degree - 1)
        sigma_proj = local_projection(
            Vf,
            [stress_row_expr(uh, PI_1, 0, -1.0),
             stress_row_expr(uh, PI_1, 1, -1.0)],
        )
        rhs_proj = local_projection(
            Vr, [lambda x: np.zeros(x.shape[:-1])] * 2
        )
        # deficient pure-traction corner patches are grouped automatically
        eq = FluxEqlbSE(degree, msh, rhs_proj, sigma_proj,
                        equilibrate_stress=True, estimate_korn_constant=True)
        # flux BCs: the equilibrated rows are -sigma rows, so sigma.n = t
        # becomes row_i . n = -t_i on traction/free boundaries; the clamped
        # (Dirichlet) edge leaves the flux free.
        bcs_row0 = [fluxbc(0.0, np.concatenate([right, other]))]
        bcs_row1 = [
            fluxbc(-TRACTION, right),
            fluxbc(0.0, other),
        ]
        eq.set_boundary_conditions([left, left], [bcs_row0, bcs_row1])
        eq.equilibrate_fluxes()

        eta, comps, cell_eta = estimate_elasticity(
            [lambda x: np.zeros(x.shape[:-1])] * 2,
            PI_1, sigma_proj, eq.list_flux, eq.get_korn_constants(),
        )
        L_h = _load_functional(msh, uh, right)
        history.append([msh.num_cells, eta, L_h, comps[0], comps[1],
                        comps[2]])
        if verbose:
            print(f"it {it}: cells {msh.num_cells:6d}  eta {eta:.4e} "
                  f"(sig {comps[0]:.2e}, wsym {comps[1]:.2e}, "
                  f"osc {comps[2]:.2e})  L(u_h) {L_h:.8e}", flush=True)
        if it + 1 < max_iter:
            msh = refine_marked(msh, doerfler_mark(np.asarray(cell_eta),
                                                   theta))

    # overkill reference: final mesh refined once, degree + 1
    msh_ref = refine_uniform(msh)
    u_ref, _, right_ref = _solve_primal(msh_ref, order_prime + 1,
                                        rtol=1e-12)
    L_ref = _load_functional(msh_ref, u_ref, right_ref)
    if verbose:
        print(f"overkill: cells {msh_ref.num_cells}, "
              f"P{order_prime + 1}, L(u_ref) {L_ref:.8e}", flush=True)
    out = []
    for cells, eta, L_h, *c in history:
        err = float(np.sqrt(max(L_ref - L_h, 0.0)))
        ieff = eta / err if err > 0 else float("inf")
        out.append((cells, eta, err, ieff, *c))
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--max-iter", type=int, default=6)
    p.add_argument("--theta", type=float, default=0.5)
    p.add_argument("--order-prime", type=int, default=2)
    p.add_argument("--degree", type=int, default=None)
    p.add_argument("--outfile", default=None)
    a = p.parse_args()
    hist = run(order_prime=a.order_prime, degree=a.degree,
               max_iter=a.max_iter, theta=a.theta)
    print(f"\n{'cells':>7} {'eta':>11} {'err':>11} {'I_eff':>7}")
    for cells, eta, err, ieff, *_ in hist:
        print(f"{cells:>7} {eta:>11.4e} {err:>11.4e} {ieff:>7.3f}")
    h = np.array([(c, e) for c, e, *_ in hist])
    rate = np.polyfit(np.log(h[1:, 0]), np.log(h[1:, 1]), 1)[0]
    print(f"eta ~ ncells^{rate:.2f}")
    if a.outfile:
        import csv

        with open(a.outfile, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["ncells", "eta", "err", "I_eff", "eta_sig",
                        "eta_wsym", "eta_osc"])
            w.writerows(hist)
        print(f"written to {a.outfile}")
