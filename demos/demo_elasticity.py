"""Demo: weakly symmetric stress equilibration for linear elasticity.

Mirror of reference ``demo/elasticity/demo_reconstruction.py`` +
``demo_error_estimation.py``, both primal formulations:

* ``--formulation u``:  displacement, sigma = 2 eps(u) + pi_1 div(u) I
* ``--formulation up``: Herrmann displacement-pressure (Taylor-Hood
  P_{k+1} x P_k, reference ``demo_reconstruction.py:353-377``), sigma =
  2 eps(u) + p I, with the C_a-weighted constitutive-mismatch term in the
  guaranteed bound (reference ``demo_error_estimation.py:113-119``).

Equilibrates the negated stress rows with weak symmetry + Korn constants
and reports the guaranteed bound and its efficiency index vs the energy
error (reference ``demo_error_estimation.py:185-208``).

Equilibration degree: ``--degree`` defaults to ``order_prime + 1``.  At
``degree == order_prime`` (the reference demo's default) the corrector
carries an intrinsic O(h^{degree-1}) term — the hat-weighted target
``psi_z sigma_proj`` sits O(h^{k-1}) away from RT_k per patch, and unlike
the Poisson (gradient-data) case the patch deviations do not telescope for
stress-row data — so eta decays one order slower than the error and I_eff
grows under refinement (measured: 34.6 -> 134.8 over n = 4..32 at
porder = degree = 2; rates study in ``scripts/diag_target_distance.py``).
One extra degree restores eta ~ error (measured I_eff 8.0 -> 6.0,
decreasing, at degree = 3).  The same holds for the reference's
formulation (``FluxEqlbEV.py:116-134`` fits the same hat-weighted target).
"""

import os as _os
import sys as _sys

# self-locate: make `python demos/<demo>.py` work without PYTHONPATH
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)

from dolfinx_eqlb_tpu.mesh import unit_square
from dolfinx_eqlb_tpu.fem import FunctionSpace, local_projection, expr_from_callable
from dolfinx_eqlb_tpu.models import ElasticitySolver, stress_row_expr
from dolfinx_eqlb_tpu.models.elasticity import (
    ElasticitySolverUP,
    pressure_mismatch_expr,
    stress_row_expr_up,
)
from dolfinx_eqlb_tpu.eqlb import (
    FluxEqlbSE,
    check_divergence_condition,
    check_jump_condition,
    check_weak_symmetry_condition,
)
from dolfinx_eqlb_tpu.estimation import estimate_elasticity

PI_1 = 1.0


# manufactured solution (divergence free)
def u_exact(x):
    return np.stack(
        [
            np.sin(np.pi * x[..., 0]) * np.cos(np.pi * x[..., 1]),
            -np.cos(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1]),
        ],
        -1,
    )


def f_body(x):
    # f = -div sigma(u) with div u = 0: f = -2 div eps(u) = -laplace(u)
    return 2 * np.pi**2 * u_exact(x)


def _energy_error(msh, uh, ph, formulation):
    """Reference energy norms (``demo_error_estimation.py:185-208``)."""
    from dolfinx_eqlb_tpu.elements.quadrature import gauss_triangle

    pts, w = gauss_triangle(12)
    xq = msh.map_points(pts)
    g = np.asarray(uh.evaluate_grad(pts))  # (nc, nq, 2, 2)
    # exact gradient of u_exact
    c, s_ = np.cos, np.sin
    pi = np.pi
    gex = np.empty_like(g)
    gex[..., 0, 0] = pi * c(pi * xq[..., 0]) * c(pi * xq[..., 1])
    gex[..., 0, 1] = -pi * s_(pi * xq[..., 0]) * s_(pi * xq[..., 1])
    gex[..., 1, 0] = pi * s_(pi * xq[..., 0]) * s_(pi * xq[..., 1])
    gex[..., 1, 1] = -pi * c(pi * xq[..., 0]) * c(pi * xq[..., 1])
    de = g - gex
    eps = 0.5 * (de + np.swapaxes(de, -1, -2))
    adet = np.abs(msh.detJ)
    if formulation == "u":
        dens = np.einsum("cqab,cqab->cq", eps, eps) + (
            de[..., 0, 0] + de[..., 1, 1]
        ) ** 2
    else:
        dp = np.asarray(ph.evaluate(pts))[..., 0] / PI_1  # div u_exact = 0
        dens = 2.0 * np.einsum("cqab,cqab->cq", eps, eps) + dp**2
    return float(np.sqrt(np.einsum("q,cq,c->", w, dens, adet)))


def run(n=8, order_prime=2, degree=2, check=True, formulation="u"):
    msh = unit_square(n)
    Vf = FunctionSpace(msh, "DG", degree - 1, vs=2)
    Vr = FunctionSpace(msh, "DG", degree - 1)
    # project the body force FIRST and use the projected data in the primal
    # solve too: the weak-symmetry compatibility of interior patches rests on
    # the rotational Galerkin orthogonality of the primal residual, which
    # requires identical data on both sides (cf. reference demos feeding the
    # projected RHS to the primal problem).
    rhs_proj = local_projection(
        Vr, [lambda x: f_body(x)[..., 0], lambda x: f_body(x)[..., 1]],
        quadrature_degree=2 * degree + 8,
    )
    from dolfinx_eqlb_tpu.fem import as_vector

    pressure_term = None
    if formulation == "u":
        V = FunctionSpace(msh, "P", order_prime, vs=2)
        solver = ElasticitySolver(V, PI_1)
        uh = solver.solve(
            as_vector(rhs_proj, msh),
            msh.boundary_facets,
            expr_from_callable(u_exact, msh, value_size=2),
            rtol=1e-12,
        )
        ph = None
        print(f"Primal elasticity solved ({solver.last_iterations} CG iters)")
        rows = [stress_row_expr(uh, PI_1, 0, -1.0),
                stress_row_expr(uh, PI_1, 1, -1.0)]
    else:
        Vu = FunctionSpace(msh, "P", order_prime + 1, vs=2)
        Vp = FunctionSpace(msh, "P", order_prime)
        solver = ElasticitySolverUP(Vu, Vp, PI_1)
        uh, ph = solver.solve(
            as_vector(rhs_proj, msh),
            msh.boundary_facets,
            expr_from_callable(u_exact, msh, value_size=2),
            rtol=1e-12,
        )
        print(f"Primal u-p elasticity solved ({solver.last_iterations} MINRES iters)")
        rows = [stress_row_expr_up(uh, ph, 0, -1.0),
                stress_row_expr_up(uh, ph, 1, -1.0)]
        pressure_term = pressure_mismatch_expr(uh, ph, PI_1)

    sigma_proj = local_projection(Vf, rows)
    eq = FluxEqlbSE(degree, msh, rhs_proj, sigma_proj,
                    equilibrate_stress=True, estimate_korn_constant=True)
    eq.set_boundary_conditions([msh.boundary_facets] * 2, [[], []])
    eq.equilibrate_fluxes()

    if check:
        for i in range(2):
            assert check_divergence_condition(eq.list_flux[i], sigma_proj[i], rhs_proj[i])
            assert check_jump_condition(eq.list_flux[i], sigma_proj[i])
        assert check_weak_symmetry_condition(eq.list_flux, sigma_proj)
        print("Equilibration conditions (incl. weak symmetry) fulfilled")

    eta, comps, cell_eta = estimate_elasticity(
        [lambda x: f_body(x)[..., 0], lambda x: f_body(x)[..., 1]],
        PI_1, sigma_proj, eq.list_flux, eq.get_korn_constants(),
        pressure_term=pressure_term,
    )
    err = _energy_error(msh, uh, ph, formulation)
    print(f"guaranteed bound eta = {eta:.4e} "
          f"(eta_sig {comps[0]:.3e}, eta_wsym {comps[1]:.3e}, eta_osc {comps[2]:.3e})")
    print(f"energy error = {err:.4e}, I_eff = {eta / err:.3f}")
    return eta, comps, err


def study(ns, order_prime, degree, formulation, outfile):
    """Refinement convergence study: eta components, energy error, I_eff per
    level, written as CSV (reference ``demo_error_estimation.py:185-208``
    and the committed Poisson ConvStudy CSV)."""
    import csv

    rows_out = []
    for n in ns:
        eta, comps, err = run(n, order_prime, degree, check=False,
                              formulation=formulation)
        rows_out.append([n, 1.0 / n, eta, comps[0], comps[1], comps[2],
                         err, eta / err])
    with open(outfile, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["n", "h", "eta", "eta_sig", "eta_wsym", "eta_osc",
                    "energy_error", "I_eff"])
        w.writerows(rows_out)
    print(f"\n{'n':>4} {'eta':>11} {'eta_sig':>11} {'eta_wsym':>11} "
          f"{'err':>11} {'I_eff':>8} {'rate(err)':>9}")
    for i, r in enumerate(rows_out):
        rate = (np.log(rows_out[i - 1][6] / r[6]) / np.log(2.0)
                if i else float("nan"))
        print(f"{r[0]:>4} {r[2]:>11.4e} {r[3]:>11.4e} {r[4]:>11.4e} "
              f"{r[6]:>11.4e} {r[7]:>8.3f} {rate:>9.2f}")
    print(f"study written to {outfile}")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=8)
    p.add_argument("--order-prime", type=int, default=2)
    p.add_argument("--degree", type=int, default=None,
                   help="equilibration degree; default = displacement "
                        "order + 1 (u: order_prime + 1, up: order_prime + "
                        "2) — one degree lower loses one order in the "
                        "bound, see module docstring)")
    p.add_argument("--formulation", choices=["u", "up"], default="u")
    p.add_argument("--study", action="store_true",
                   help="run the n = 4..32 refinement study, write CSV")
    p.add_argument("--outfile", default=None)
    a = p.parse_args()
    if a.degree is None:
        # displacement order + 1: the Herrmann (up) displacement space is
        # P_{order_prime + 1} (Taylor-Hood)
        a.degree = a.order_prime + (1 if a.formulation == "u" else 2)
    if a.study:
        out = a.outfile or (
            f"ConvStudyElasticity-{a.formulation}_porder-{a.order_prime}"
            f"_eorder-{a.degree}.csv"
        )
        study((4, 8, 16, 32), a.order_prime, a.degree, a.formulation, out)
    else:
        run(a.n, a.order_prime, a.degree, formulation=a.formulation)
