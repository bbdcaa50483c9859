"""Demo: a-posteriori error estimation for Poisson (convergence study).

Mirror of reference ``demo/poisson/demo_error_estimation.py``: uniform
refinement series, equilibrated Ern-Vohralik estimator, true H1 error,
convergence rates and efficiency index, CSV output.
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
from dolfinx_eqlb_tpu.fem import expr_from_callable, cell_integrals_sq, grad
from dolfinx_eqlb_tpu.eqlb import FluxEqlbEV, FluxEqlbSE
from dolfinx_eqlb_tpu.estimation import estimate_poisson

from demo_reconstruction import exact_solution, rhs, solve_and_equilibrate


def grad_u(x):
    return np.stack(
        [
            2 * np.pi * np.cos(2 * np.pi * x[..., 0]) * np.cos(2 * np.pi * x[..., 1]),
            -2 * np.pi * np.sin(2 * np.pi * x[..., 0]) * np.sin(2 * np.pi * x[..., 1]),
        ],
        axis=-1,
    )


def run(Equilibrator, order_prime, order_eqlb, bc_type, nref, n0=2):
    rows = np.zeros((nref, 8))
    for i in range(nref):
        n = n0 * 2**i
        msh = unit_square(n)
        uh, sigma_proj, eq = solve_and_equilibrate(
            msh, order_prime, order_eqlb, bc_type, Equilibrator, check=False
        )
        sig_arg = (
            None if Equilibrator is FluxEqlbEV else sigma_proj
        )
        eta, eta_sig, eta_osc, _ = estimate_poisson(
            rhs, uh, eq.list_flux[0], sig_arg
        )
        err = grad(uh) - expr_from_callable(grad_u, msh, value_size=2)
        err_h1 = float(np.sqrt(cell_integrals_sq(err, 12).sum()))
        rows[i] = [1.0 / n, msh.num_cells, err_h1, 0.0, eta, eta_sig, eta_osc,
                   eta / err_h1]
    rows[1:, 3] = np.log(rows[1:, 2] / rows[:-1, 2]) / np.log(
        rows[1:, 0] / rows[:-1, 0]
    )
    return rows


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--eqlb", default="SE", choices=["SE", "EV"])
    p.add_argument("--order-prime", type=int, default=1)
    p.add_argument("--degree", type=int, default=1)
    p.add_argument("--bc", default="dirichlet")
    p.add_argument("--nref", type=int, default=5)
    a = p.parse_args()
    Eq = FluxEqlbSE if a.eqlb == "SE" else FluxEqlbEV
    rows = run(Eq, a.order_prime, a.degree, a.bc, a.nref)
    header = "h, n_elmt, err_u_h1, convrate_u_h1, eta, eta_sig, eta_osc, I_eff"
    out = f"ConvStudyFluxEqlb-{a.eqlb}_porder-{a.order_prime}_eorder-{a.degree}.csv"
    np.savetxt(out, rows, delimiter=",", header=header)
    print(header)
    for r in rows:
        print(", ".join(f"{v:.4e}" for v in r))
