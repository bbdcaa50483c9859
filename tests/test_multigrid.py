"""Geometric-multigrid preconditioning (fem.multigrid) — the device-resident
stand-in for the reference's PETSc solver configs (CG+BoomerAMG for SPD,
MUMPS/superlu_dist for the mixed saddle systems,
``python/test/performance/perftest_basics.py:34-160``).

Invariants: exact P_k transfer on nested red refinements, V-cycle symmetry
(MINRES/CG admissibility), mesh-independent Krylov iteration counts, and
agreement of the preconditioned solves with the plain-Jacobi ones."""

import numpy as np
import pytest
import jax.numpy as jnp

from dolfinx_eqlb_tpu.fem import FunctionSpace, mesh_hierarchy
from dolfinx_eqlb_tpu.fem.multigrid import (
    GeometricMG,
    scalar_stiffness_tensors,
    vector_eps_tensors,
)
from dolfinx_eqlb_tpu.fem.krylov import minres
from dolfinx_eqlb_tpu.mesh import unit_square


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_prolongation_exact_on_pk(degree):
    """Coarse CG_k functions transfer exactly: prolongation of the coarse
    interpolant of a degree-k polynomial equals the fine interpolant."""
    meshes = mesh_hierarchy(unit_square(3), 2)
    k = degree

    def poly(x):
        return (x[..., 0] ** k + 0.5 * x[..., 1] ** k
                + (x[..., 0] * x[..., 1]) ** (k // 2) - 0.25)

    mg = GeometricMG(meshes, k, lambda m: scalar_stiffness_tensors(m, k, 1.0),
                     bc_dofs_fn=None)
    from dolfinx_eqlb_tpu.fem.interpolate import interpolate

    vals = []
    for msh in meshes:
        V = FunctionSpace(msh, "P", k)
        vals.append(jnp.asarray(interpolate(V, poly).x))
    fine = mg._prolong(mg.operands()[1], vals[0])
    assert float(jnp.max(jnp.abs(fine - vals[1]))) < 1e-12


@pytest.mark.parametrize("block_size", [1, 2])
def test_vcycle_symmetric(block_size):
    """<B r1, r2> == <r1, B r2>: the V-cycle is a symmetric operator, as
    MINRES/CG preconditioning requires."""
    meshes = mesh_hierarchy(unit_square(3), 3)
    k = 2
    fn = ((lambda m: scalar_stiffness_tensors(m, k)) if block_size == 1
          else (lambda m: vector_eps_tensors(m, k)))
    mg = GeometricMG(meshes, k, fn, block_size=block_size)
    ops = mg.operands()
    o = ops[-1]
    n = o["Dinv"].shape[0]
    rng = np.random.default_rng(0)
    r1 = jnp.asarray(rng.standard_normal(n)) * o["free"]
    r2 = jnp.asarray(rng.standard_normal(n)) * o["free"]
    z1, z2 = mg.apply(r1, ops), mg.apply(r2, ops)
    dev = abs(float(jnp.dot(z1, r2) - jnp.dot(r1, z2)))
    assert dev < 1e-12 * float(jnp.linalg.norm(z1) * jnp.linalg.norm(r2))


def _poisson_its(nlevels, k, psolve_kind):
    """MINRES iterations on the CG_k Poisson system of the finest level."""
    meshes = mesh_hierarchy(unit_square(4), nlevels)
    mg = GeometricMG(meshes, k, lambda m: scalar_stiffness_tensors(m, k))
    ops = mg.operands()
    o = ops[-1]
    n = o["Dinv"].shape[0]
    rng = np.random.default_rng(1)
    b = jnp.asarray(rng.standard_normal(n)) * o["free"]

    def matvec(v, op):
        return mg._matvec(op[-1], v)

    Minv = mg.apply if psolve_kind == "mg" else o["Dinv"]
    st = minres(matvec, b, jnp.zeros(n), Minv, o["free"] > 0,
                rtol=1e-10, maxiter=2000, operands=ops)
    assert float(st["phibar"]) < 1e-9 * float(jnp.linalg.norm(b))
    return int(st["it"])


def test_poisson_mesh_independent_iterations():
    """V-cycle-preconditioned iteration counts are small and do not grow
    with refinement (Jacobi's grow like 1/h)."""
    its2 = _poisson_its(2, 2, "mg")
    its3 = _poisson_its(3, 2, "mg")
    its_jacobi = _poisson_its(2, 2, "jacobi")
    assert its3 <= 25 and its2 <= 25
    assert its3 <= its2 + 5  # mesh-independent
    assert its_jacobi > 3 * its3  # Jacobi pays the 1/h factor


def test_biot_mg_matches_jacobi_and_is_mesh_independent():
    """Block-MG MINRES (BiotMG) reproduces the Jacobi-MINRES solution with
    a small, refinement-stable iteration count."""
    from dolfinx_eqlb_tpu.models.biot import BiotSolverUPP, BiotMG
    from dolfinx_eqlb_tpu.fem import expr_from_callable, local_projection
    from tests.test_biot import f_body, g_flow

    k = 2
    its = {}
    sols = {}
    for nlevels in (2, 3):
        meshes = mesh_hierarchy(unit_square(3), nlevels)
        msh = meshes[-1]
        Vu = FunctionSpace(msh, "P", k, vs=2)
        Vp = FunctionSpace(msh, "P", k)
        Vpt = FunctionSpace(msh, "P", k - 1)
        fe = local_projection(
            FunctionSpace(msh, "DG", k - 1, vs=2),
            [expr_from_callable(f_body, msh, value_size=2)],
            quadrature_degree=2 * k + 6)[0]
        ge = local_projection(
            FunctionSpace(msh, "DG", k - 1),
            [expr_from_callable(g_flow, msh, value_size=1)],
            quadrature_degree=2 * k + 6)[0]
        solver = BiotSolverUPP(Vu, Vp, Vpt)
        uh, ph, pth = solver.solve(fe, ge, msh.boundary_facets, rtol=1e-12,
                                   mg=BiotMG(solver, meshes))
        its[nlevels] = solver.last_iterations
        sols[nlevels] = (solver, fe, ge, uh, ph, pth)
    assert its[2] <= 80 and its[3] <= 80, its
    assert its[3] <= its[2] + 10, its  # mesh-independent

    # same solution as the Jacobi path on the finer mesh
    solver, fe, ge, uh, ph, pth = sols[3]
    uj, pj, ptj = solver.solve(fe, ge, solver.Vu.mesh.boundary_facets,
                               rtol=1e-12)
    assert solver.last_iterations > 3 * its[3]  # Jacobi is far slower
    scale = float(jnp.max(jnp.abs(uj.x))) + 1.0
    assert float(jnp.max(jnp.abs(uh.x - uj.x))) < 1e-8 * scale
    assert float(jnp.max(jnp.abs(ph.x - pj.x))) < 1e-8 * scale
    assert float(jnp.max(jnp.abs(pth.x - ptj.x))) < 1e-8 * scale


def test_elasticity_displacement_mg_matches_jacobi():
    """The displacement-form CG with the eps+div V-cycle agrees with the
    Jacobi path and converges in few iterations (the perftest's order-4
    1M-dof solve took 363 s on Jacobi's 1/h iteration growth)."""
    from dolfinx_eqlb_tpu.models.elasticity import ElasticitySolver
    from dolfinx_eqlb_tpu.fem import expr_from_callable

    meshes = mesh_hierarchy(unit_square(3), 3)
    msh = meshes[-1]
    k, pi_1 = 2, 1.0
    V = FunctionSpace(msh, "P", k, vs=2)

    def u_ext(x):
        return np.stack(
            [np.sin(np.pi * x[..., 0]) * np.cos(np.pi * x[..., 1]),
             -np.cos(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1])], -1)

    f_expr = expr_from_callable(lambda x: 2 * np.pi ** 2 * u_ext(x), msh,
                                value_size=2)
    ud = expr_from_callable(u_ext, msh, value_size=2)
    s = ElasticitySolver(V, pi_1)
    u_mg = s.solve(f_expr, msh.boundary_facets, ud, rtol=1e-12,
                   mg_meshes=meshes)
    its_mg = s.last_iterations
    u_j = s.solve(f_expr, msh.boundary_facets, ud, rtol=1e-12)
    assert its_mg <= 30
    assert s.last_iterations > 3 * its_mg
    scale = float(jnp.max(jnp.abs(u_j.x))) + 1.0
    assert float(jnp.max(jnp.abs(u_mg.x - u_j.x))) < 1e-8 * scale


def test_herrmann_mg_matches_jacobi():
    """The Herrmann (Taylor-Hood u-p) MINRES with the displacement-block
    V-cycle agrees with the Jacobi path and converges in few iterations."""
    from dolfinx_eqlb_tpu.models.elasticity import ElasticitySolverUP

    meshes = mesh_hierarchy(unit_square(3), 3)
    msh = meshes[-1]
    k = 2
    Vu = FunctionSpace(msh, "P", k, vs=2)
    Vp = FunctionSpace(msh, "P", k - 1)

    def u_ext(x):
        return np.stack(
            [np.sin(np.pi * x[..., 0]) * np.cos(np.pi * x[..., 1]),
             -np.cos(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1])], -1)

    f = lambda x: 2 * np.pi ** 2 * u_ext(x)
    from dolfinx_eqlb_tpu.fem import expr_from_callable

    f_expr = expr_from_callable(f, msh, value_size=2)
    ud = expr_from_callable(u_ext, msh, value_size=2)
    s_mg = ElasticitySolverUP(Vu, Vp, pi_1=1.0)
    u_mg, p_mg = s_mg.solve(f_expr, msh.boundary_facets, ud, rtol=1e-12,
                            mg_meshes=meshes)
    its_mg = s_mg.last_iterations
    s_j = ElasticitySolverUP(Vu, Vp, pi_1=1.0)
    u_j, p_j = s_j.solve(f_expr, msh.boundary_facets, ud, rtol=1e-12)
    assert its_mg <= 120
    assert s_j.last_iterations > 2 * its_mg
    scale = float(jnp.max(jnp.abs(u_j.x))) + 1.0
    assert float(jnp.max(jnp.abs(u_mg.x - u_j.x))) < 1e-8 * scale
    assert float(jnp.max(jnp.abs(p_mg.x - p_j.x))) < 1e-7 * scale
