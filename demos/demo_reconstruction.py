"""Demo: H(div)-conforming flux equilibration for a Poisson problem.

Batched mirror of the reference ``demo/poisson/demo_reconstruction.py``:
solve -div(grad u) = f with the manufactured solution
u = sin(2 pi x) cos(2 pi y), project flux/RHS, equilibrate (SE or EV),
check the equilibration conditions.

Run:  PYTHONPATH=<repo> python demo_reconstruction.py [--eqlb SE|EV]
      [--degree k] [--bc dirichlet|neumann_hom|neumann_inhom] [--n 10]
"""

import os as _os
import sys as _sys

# self-locate: make `python demos/<demo>.py` work without PYTHONPATH
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import time

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)

from dolfinx_eqlb_tpu.mesh import unit_square, permute_vertices
from dolfinx_eqlb_tpu.fem import (
    FunctionSpace,
    local_projection,
    project_facet_trace,
    grad,
)
from dolfinx_eqlb_tpu.models import PoissonSolver
from dolfinx_eqlb_tpu.eqlb import (
    FluxEqlbEV,
    FluxEqlbSE,
    fluxbc,
    check_divergence_condition,
    check_jump_condition,
)


def exact_solution(x):
    return np.sin(2 * np.pi * x[..., 0]) * np.cos(2 * np.pi * x[..., 1])


def rhs(x):
    return 8 * np.pi**2 * exact_solution(x)


def ux(x):  # du/dx
    return 2 * np.pi * np.cos(2 * np.pi * x[..., 0]) * np.cos(2 * np.pi * x[..., 1])


def solve_and_equilibrate(msh, order_prime, order_eqlb, bc_type, Equilibrator,
                          check=True):
    k = order_eqlb
    V = FunctionSpace(msh, "P", order_prime)
    Vr = FunctionSpace(msh, "DG", k - 1)
    Vf = FunctionSpace(msh, "DG", k - 1, vs=2)

    left = msh.locate_boundary_facets(lambda x: np.isclose(x[..., 0], 0.0))
    right = msh.locate_boundary_facets(lambda x: np.isclose(x[..., 0], 1.0))
    bot = msh.locate_boundary_facets(lambda x: np.isclose(x[..., 1], 0.0))
    top = msh.locate_boundary_facets(lambda x: np.isclose(x[..., 1], 1.0))

    rhs_proj = local_projection(Vr, [rhs], quadrature_degree=2 * k + 8)
    solver = PoissonSolver(V)
    if bc_type == "dirichlet":
        fcts_prime, bcs, neumann = msh.boundary_facets, [], None
    elif bc_type == "neumann_hom":
        fcts_prime = np.concatenate([bot, top])
        bcs = [fluxbc(0.0, np.concatenate([left, right]))]
        neumann = None  # u_x = 0 on x in {0, 1} for this solution
    else:  # neumann_inhom on x in {0,1}: share the projected trace data
        fcts_prime = np.concatenate([bot, top])
        gl = project_facet_trace(msh, left, lambda x: -ux(x), k)
        gr = project_facet_trace(msh, right, ux, k)
        neumann = [(left, gl), (right, gr)]
        bcs = [fluxbc(-gl, left), fluxbc(-gr, right)]  # sigma.n = -grad(u).n

    t0 = time.perf_counter()
    uh = solver.solve(rhs_proj[0], fcts_prime, exact_solution, neumann=neumann,
                      rtol=1e-13)
    print(f"Primal problem solved in {time.perf_counter()-t0:.4e} s "
          f"({solver.last_iterations} CG iterations)")

    sigma_proj = local_projection(Vf, [-1.0 * grad(uh)])
    eq = Equilibrator(k, msh, rhs_proj, sigma_proj)
    eq.set_boundary_conditions([fcts_prime], [bcs])
    t0 = time.perf_counter()
    eq.equilibrate_fluxes()
    print(f"Equilibration solved in {time.perf_counter()-t0:.4e} s")

    if check:
        assert check_divergence_condition(
            eq.list_flux[0], sigma_proj[0], rhs_proj[0]
        ), "Divergence conditions not fulfilled"
        if Equilibrator is FluxEqlbSE:
            assert check_jump_condition(
                eq.list_flux[0], sigma_proj[0]
            ), "Jump conditions not fulfilled"
        print("Equilibration conditions fulfilled")
    return uh, sigma_proj[0], eq


def write_output(outdir, msh, uh, sigma_proj, eq):
    """XDMF/VTU export for ParaView (reference
    ``demo/poisson/demo_reconstruction.py:534-540``)."""
    import os

    from dolfinx_eqlb_tpu.fem.expressions import as_expr
    from dolfinx_eqlb_tpu.utils import (
        flux_cell_values, write_vtu, write_xdmf,
    )

    os.makedirs(outdir, exist_ok=True)
    # vertex values of the primal solution: corner evaluation, scatter-mean
    corners = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    uv = np.asarray(as_expr(uh).evaluate(corners))  # (nc, 3)
    num = np.zeros(msh.num_vertices)
    cnt = np.zeros(msh.num_vertices)
    np.add.at(num, msh.cells.reshape(-1), uv.reshape(-1))
    np.add.at(cnt, msh.cells.reshape(-1), 1.0)
    point_data = {"u": num / np.maximum(cnt, 1.0)}
    cell_data = {
        "sigma_proj": flux_cell_values(sigma_proj),
        "sigma_R": flux_cell_values(eq.list_flux[0], sigma_proj),
    }
    write_xdmf(os.path.join(outdir, "reconstruction.xdmf"), msh,
               point_data, cell_data)
    write_vtu(os.path.join(outdir, "reconstruction.vtu"), msh,
              point_data, cell_data)
    print(f"ParaView output written to {outdir}/reconstruction.{{xdmf,vtu}}")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--eqlb", default="SE", choices=["SE", "EV"])
    p.add_argument("--degree", type=int, default=1)
    p.add_argument("--order-prime", type=int, default=1)
    p.add_argument("--bc", default="dirichlet",
                   choices=["dirichlet", "neumann_hom", "neumann_inhom"])
    p.add_argument("--n", type=int, default=10)
    p.add_argument("--reversed-mesh", action="store_true")
    p.add_argument("--outdir", default=None,
                   help="write XDMF/VTU ParaView output to this directory")
    a = p.parse_args()

    msh = unit_square(a.n)
    if a.reversed_mesh:
        msh = permute_vertices(msh, seed=1)
    Eq = FluxEqlbSE if a.eqlb == "SE" else FluxEqlbEV
    uh, sp, eq = solve_and_equilibrate(msh, a.order_prime, a.degree, a.bc, Eq)
    if a.outdir:
        write_output(a.outdir, msh, uh, sp, eq)
