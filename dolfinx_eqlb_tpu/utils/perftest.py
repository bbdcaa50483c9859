"""Performance-measurement harness.

Mirror of the reference's ``python/test/performance/perftest.py:26-228`` +
``perftest_basics.py:150-382``: times primal assembly / solve, projection,
and SE/EV equilibration over a series of uniformly refined meshes x flux
orders for the reference's testcases

    poisson     — P_k primal, SE + EV equilibration        (orders 1-4)
    elasticity  — vector P_k, weakly-symmetric SE stress    (orders 2-4)
    biot        — u-p-pt poro-elasticity, 3-field SE stress (orders 2-4)

This is the reference's complete implemented testcase set: its registry
also *declares* a 2-field ``Biot_up`` (``perftest_basics.py:156``) but
``setup_testcase`` raises "Unknown testcase" for it — only the 3-field
``poroelasticity_problem_upp`` exists (``perftest_basics.py:160-169``).

min/max over repeats, CSV output with the reference's column layout
(ncells, nnodes, tp_assembly, tp_solve, t_projection, t_eqlb_*).
"""

from __future__ import annotations

import csv
import time

import numpy as np

from ..mesh import unit_square
from ..fem import FunctionSpace, local_projection, grad, expr_from_callable
from ..models import PoissonSolver
from ..eqlb import FluxEqlbEV, FluxEqlbSE

__all__ = ["run_perftest"]

TESTCASES = ("poisson", "elasticity", "biot")


def _timeit(fn, repeats):
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        ts.append(time.perf_counter() - t0)
    return min(ts), max(ts), out


def _setup_poisson(msh, order):
    u_ext = lambda x: np.sin(2 * np.pi * x[..., 0]) * np.cos(2 * np.pi * x[..., 1])
    f_ext = lambda x: 8 * np.pi**2 * u_ext(x)
    V = FunctionSpace(msh, "P", order)
    Vr = FunctionSpace(msh, "DG", order - 1)
    Vf = FunctionSpace(msh, "DG", order - 1, vs=2)
    rhs_proj = local_projection(Vr, [f_ext])

    ta0 = time.perf_counter()
    solver = PoissonSolver(V)  # element tensors + dof tables = assembly
    t_asm = time.perf_counter() - ta0

    def solve():
        return solver.solve(rhs_proj[0], msh.boundary_facets, u_ext,
                            rtol=1e-10)

    def project(uh):
        return local_projection(Vf, [-1.0 * grad(uh)])

    def make_eqlbs(sigma_proj):
        out = []
        for name, Eq in (("SE", FluxEqlbSE), ("EV", FluxEqlbEV)):
            eq = Eq(order, msh, rhs_proj, sigma_proj)
            eq.set_boundary_conditions([msh.boundary_facets], [[]])
            out.append((name, eq))
        return out

    return V.ndofs, t_asm, solve, project, make_eqlbs


def _setup_elasticity(msh, order, hierarchy=None):
    from ..models.elasticity import ElasticitySolver, stress_row_expr

    u_ext = lambda x: np.stack(
        [np.sin(np.pi * x[..., 0]) * np.cos(np.pi * x[..., 1]),
         -np.cos(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1])], -1)
    pi_1 = 1.0
    V = FunctionSpace(msh, "P", order, vs=2)
    Vr = FunctionSpace(msh, "DG", order - 1)
    Vf = FunctionSpace(msh, "DG", order - 1, vs=2)
    # div u_ext = 0: f = -div sigma = 2 pi^2 u_ext (mu = 1)
    rhs_proj = local_projection(
        Vr,
        [lambda x: 2 * np.pi**2 * u_ext(x)[..., 0],
         lambda x: 2 * np.pi**2 * u_ext(x)[..., 1]],
        quadrature_degree=2 * order + 6,
    )

    ta0 = time.perf_counter()
    solver = ElasticitySolver(V, pi_1)
    mg = None
    if hierarchy is not None:
        from ..fem.multigrid import GeometricMG, vector_eps_tensors

        mg = GeometricMG(
            hierarchy, order,
            lambda m: vector_eps_tensors(m, order, div_coeff=pi_1),
            block_size=2)
    t_asm = time.perf_counter() - ta0

    from ..fem import as_vector

    def solve():
        return solver.solve(
            as_vector(rhs_proj, msh), msh.boundary_facets,
            expr_from_callable(u_ext, msh, value_size=2), rtol=1e-10,
            mg_meshes=mg)

    def project(uh):
        return local_projection(
            Vf, [stress_row_expr(uh, pi_1, 0, -1.0),
                 stress_row_expr(uh, pi_1, 1, -1.0)])

    def make_eqlbs(sigma_proj):
        eq = FluxEqlbSE(order, msh, rhs_proj, sigma_proj,
                        equilibrate_stress=True)
        eq.set_boundary_conditions([msh.boundary_facets] * 2, [[], []])
        return [("SE", eq)]

    return V.ndofs, t_asm, solve, project, make_eqlbs


def _setup_biot(msh, order, hierarchy=None):
    from ..models.biot import BiotSolverUPP, BiotMG, biot_fields

    f_ext = lambda x: np.stack(
        [0.7 * np.sin(1.5 * np.pi * x[..., 0])
         * 1.5 * np.cos(0.7 * np.pi * x[..., 1]),
         0.7 * np.cos(1.5 * np.pi * x[..., 0])
         * 1.5 * np.sin(0.7 * np.pi * x[..., 1])], -1)
    g_ext = lambda x: (1.5 * np.sin(0.7 * np.pi * x[..., 0])
                       * 1.5 * np.sin(0.7 * np.pi * x[..., 1]))[..., None]
    Vu = FunctionSpace(msh, "P", order, vs=2)
    Vp = FunctionSpace(msh, "P", order)
    Vpt = FunctionSpace(msh, "P", order - 1)
    Vdg2 = FunctionSpace(msh, "DG", order - 1, vs=2)
    Vdg1 = FunctionSpace(msh, "DG", order - 1)
    fe = local_projection(
        Vdg2, [expr_from_callable(f_ext, msh, value_size=2)],
        quadrature_degree=2 * order + 6)[0]
    ge = local_projection(
        Vdg1, [expr_from_callable(g_ext, msh, value_size=1)],
        quadrature_degree=2 * order + 6)[0]

    ta0 = time.perf_counter()
    solver = BiotSolverUPP(Vu, Vp, Vpt)
    # block-MG preconditioner setup is assembly-stage work (the reference's
    # BoomerAMG/MUMPS setup likewise happens before the timed solve)
    mg = BiotMG(solver, hierarchy) if hierarchy is not None else None
    t_asm = time.perf_counter() - ta0

    def solve():
        return solver.solve(fe, ge, msh.boundary_facets, rtol=1e-10, mg=mg)

    def project(sol):
        uh, ph, pth = sol
        return biot_fields(uh, ph, pth, fe, ge, order)

    def make_eqlbs(fields):
        sigma_proj, rhs_proj = fields
        eq = FluxEqlbSE(order, msh, rhs_proj, sigma_proj,
                        equilibrate_stress=True)
        eq.set_boundary_conditions([msh.boundary_facets] * 3, [[], [], []])
        return [("SE", eq)]

    return (Vu.ndofs + Vp.ndofs + Vpt.ndofs), t_asm, solve, project, \
        make_eqlbs


_SETUPS = {"poisson": _setup_poisson, "elasticity": _setup_elasticity,
           "biot": _setup_biot}


def run_perftest(
    testcase="poisson",
    orders=(1, 2, 3, 4),
    nrefs=4,
    n0=10,
    repeats=3,
    out_csv="perftest.csv",
    dtype=None,
):
    """Reference perftest.py driver for one testcase.  Stress testcases
    (elasticity, biot) need order >= 2 — lower orders are skipped like the
    reference's degree validation would reject them."""
    if testcase not in _SETUPS:
        raise ValueError(f"unknown testcase {testcase!r}; one of {TESTCASES}")
    setup = _SETUPS[testcase]

    # elasticity/biot solves ride geometric-multigrid preconditioners,
    # which need nested meshes: their refinement series is the
    # red-refinement hierarchy of the coarse mesh (same cell/vertex/dof
    # counts per level as the built-in crossed series; only the
    # sub-triangle geometry differs)
    hierarchy = None
    if testcase in ("biot", "elasticity"):
        from ..fem.multigrid import mesh_hierarchy

        hierarchy = mesh_hierarchy(unit_square(n0), nrefs)

    rows = []
    for order in orders:
        if testcase != "poisson" and order < 2:
            continue
        for i in range(nrefs):
            n = n0 * 2**i
            if hierarchy is not None:
                msh = hierarchy[i]
                ndofs, t_asm, solve, project, make_eqlbs = setup(
                    msh, order, hierarchy[: i + 1])
            else:
                msh = unit_square(n)
                ndofs, t_asm, solve, project, make_eqlbs = setup(msh, order)

            t_solve_min, t_solve_max, sol = _timeit(solve, repeats)
            t_proj_min, t_proj_max, projected = _timeit(
                lambda: project(sol), repeats)

            row = {
                "testcase": testcase,
                "order": order,
                "ncells": msh.num_cells,
                "nnodes": msh.num_vertices,
                "ndofs_prime": ndofs,
                "tp_assembly": t_asm,
                "t_solve_min": t_solve_min,
                "t_solve_max": t_solve_max,
                "t_proj_min": t_proj_min,
                "t_proj_max": t_proj_max,
            }
            for name, eq in make_eqlbs(projected):
                if dtype is not None:
                    eq.engine.dtype = dtype

                def run_eq(eq=eq):
                    eq.equilibrate_fluxes()
                    eq.list_flux[0].x.block_until_ready()

                run_eq()  # warm-up/compile
                tmin, tmax, _ = _timeit(run_eq, repeats)
                row[f"t_eqlb_{name}_min"] = tmin
                row[f"t_eqlb_{name}_max"] = tmax
            rows.append(row)
            print(", ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                            for k, v in row.items()), flush=True)

    if out_csv:
        fields = sorted({k for r in rows for k in r}, key=lambda k: (
            ["testcase", "order", "ncells", "nnodes", "ndofs_prime",
             "tp_assembly", "t_solve_min", "t_solve_max", "t_proj_min",
             "t_proj_max", "t_eqlb_SE_min", "t_eqlb_SE_max",
             "t_eqlb_EV_min", "t_eqlb_EV_max"].index(k)))
        with open(out_csv, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=fields)
            w.writeheader()
            w.writerows(rows)
    return rows
