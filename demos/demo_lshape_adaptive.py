"""Demo: adaptive Poisson on the L-shaped domain.

Mirror of reference ``demo/poisson_adaptive/demo_lshape.py``: the singular
corner solution u = r^(2/3) sin(2 theta / 3) (f = 0, Dirichlet data from the
exact solution), equilibrated-estimator driven Doerfler marking and
longest-edge-bisection refinement down to a target energy error.
"""

import os as _os
import sys as _sys

# self-locate: make `python demos/<demo>.py` work without PYTHONPATH
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)

from dolfinx_eqlb_tpu.mesh import lshape, refine_marked
from dolfinx_eqlb_tpu.fem import (
    FunctionSpace,
    local_projection,
    expr_from_callable,
    cell_integrals_sq,
    grad,
)
from dolfinx_eqlb_tpu.models import PoissonSolver
from dolfinx_eqlb_tpu.eqlb import FluxEqlbSE, FluxEqlbEV
from dolfinx_eqlb_tpu.estimation import estimate_poisson, doerfler_mark


def _polar(x):
    r = np.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)
    th = np.arctan2(x[..., 1], x[..., 0])
    th = np.where(th < 0, th + 2 * np.pi, th)
    return r, th


def u_exact(x):
    r, th = _polar(x)
    return r ** (2.0 / 3.0) * np.sin(2.0 * th / 3.0)


def grad_u_exact(x):
    r, th = _polar(x)
    r = np.maximum(r, 1e-300)
    ur = (2.0 / 3.0) * r ** (-1.0 / 3.0) * np.sin(2.0 * th / 3.0)
    ut = (2.0 / 3.0) * r ** (-1.0 / 3.0) * np.cos(2.0 * th / 3.0)
    c, s = np.cos(th), np.sin(th)
    return np.stack([ur * c - ut * s, ur * s + ut * c], axis=-1)


def adaptive_loop(order_prime=1, order_eqlb=1, theta=0.5, tol=1e-2,
                  max_iter=20, n0=2, Equilibrator=FluxEqlbSE, verbose=True,
                  csv_path=None):
    msh = lshape(n0)
    history = []
    for it in range(max_iter):
        k = order_eqlb
        V = FunctionSpace(msh, "P", order_prime)
        Vr = FunctionSpace(msh, "DG", k - 1)
        Vf = FunctionSpace(msh, "DG", k - 1, vs=2)
        rhs_proj = local_projection(Vr, [lambda x: np.zeros(x.shape[:-1])])
        uh = PoissonSolver(V).solve(
            rhs_proj[0], msh.boundary_facets, u_exact, rtol=1e-12
        )
        sigma_proj = local_projection(Vf, [-1.0 * grad(uh)])
        eq = Equilibrator(k, msh, rhs_proj, sigma_proj)
        eq.set_boundary_conditions([msh.boundary_facets], [[]])
        eq.equilibrate_fluxes()
        sig_arg = None if Equilibrator is FluxEqlbEV else sigma_proj[0]
        eta, eta_sig, eta_osc, cell_eta = estimate_poisson(
            lambda x: np.zeros(x.shape[:-1]), uh, eq.list_flux[0], sig_arg
        )
        err = grad(uh) - expr_from_callable(grad_u_exact, msh, value_size=2)
        err_h1 = float(np.sqrt(cell_integrals_sq(err, 12).sum()))
        history.append((msh.num_cells, err_h1, eta, eta / max(err_h1, 1e-300)))
        if verbose:
            print(f"it {it:2d}: cells {msh.num_cells:6d}  err {err_h1:.4e}  "
                  f"eta {eta:.4e}  I_eff {eta/err_h1:.3f}", flush=True)
        if csv_path is not None:
            # re-written every iteration: a long run killed mid-way still
            # leaves a complete trace (reference writes per-level CSVs too,
            # poisson_adaptive/demo_lshape.py:200-216)
            with open(csv_path, "w") as f:
                f.write("iteration,ncells,eta,err_h1,I_eff\n")
                for j, (nc_j, e_j, eta_j, ie_j) in enumerate(history):
                    f.write(f"{j},{nc_j},{eta_j:.12e},{e_j:.12e},{ie_j:.6f}\n")
        if eta <= tol:
            break
        marked = doerfler_mark(np.asarray(cell_eta), theta)
        msh = refine_marked(msh, marked)
    return msh, history


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--tol", type=float, default=1e-1)
    p.add_argument("--theta", type=float, default=0.5)
    p.add_argument("--max-iter", type=int, default=25)
    p.add_argument("--order-prime", type=int, default=1)
    p.add_argument("--degree", type=int, default=1)
    p.add_argument("--csv", type=str, default=None,
                   help="write the per-iteration trace (ncells, eta, err, "
                        "I_eff) to this CSV, updated every iteration")
    a = p.parse_args()
    msh, hist = adaptive_loop(a.order_prime, a.degree, a.theta, a.tol,
                              a.max_iter, csv_path=a.csv)
    h = np.array(hist)
    # adaptive convergence rate w.r.t. ncells (optimal: -p/2 for P_p)
    rate = np.polyfit(np.log(h[3:, 0]), np.log(h[3:, 2]), 1)[0]
    print(f"final: {int(h[-1,0])} cells, eta {h[-1,2]:.3e}, "
          f"eta ~ ncells^{rate:.2f} (optimal {-a.order_prime / 2})")
