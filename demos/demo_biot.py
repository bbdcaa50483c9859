"""Demo: 3-field poro-elasticity (Biot u-p-pt) equilibration.

The workload behind BASELINE config 5 (reference
``python/test/performance/perftest_basics.py:294-382``, testcase
``Biot_upp``): one coupled primal solve yields three simultaneously
equilibrated fields — two weakly-symmetric (negated total) stress rows and
the Darcy flux — through a single ``FluxEqlbSE`` call.

Run: ``python demos/demo_biot.py [n] [order]``.
"""

import os as _os
import sys as _sys

# self-locate: make `python demos/<demo>.py` work without PYTHONPATH
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import time

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)

from dolfinx_eqlb_tpu.mesh import unit_square
from dolfinx_eqlb_tpu.fem import (
    FunctionSpace,
    expr_from_callable,
    local_projection,
)
from dolfinx_eqlb_tpu.models.biot import BiotSolverUPP, biot_fields
from dolfinx_eqlb_tpu.eqlb import (
    FluxEqlbSE,
    check_divergence_condition,
    check_jump_condition,
    check_weak_symmetry_condition,
)
from dolfinx_eqlb_tpu.utils.io import write_vtu


def f_body(x):
    return np.stack(
        [
            0.7 * np.sin(1.5 * np.pi * x[..., 0])
            * 1.5 * np.cos(0.7 * np.pi * x[..., 1]),
            0.7 * np.cos(1.5 * np.pi * x[..., 0])
            * 1.5 * np.sin(0.7 * np.pi * x[..., 1]),
        ],
        -1,
    )


def g_flow(x):
    return (
        1.5 * np.sin(0.7 * np.pi * x[..., 0])
        * 1.5 * np.sin(0.7 * np.pi * x[..., 1])
    )[..., None]


def main(n=16, order=2):
    # nested red-refinement hierarchy: the primal solve rides a block
    # geometric-multigrid MINRES (diag(A_uu, K_p + M_p, M_pt) V-cycles,
    # models.biot.BiotMG) with mesh-independent iteration counts — the
    # device-resident analog of the reference's CG+BoomerAMG / MUMPS configs
    from dolfinx_eqlb_tpu.fem import mesh_hierarchy

    nlevels = max(1, int(np.log2(max(n // 4, 1))) + 1)
    meshes = mesh_hierarchy(unit_square(max(n >> (nlevels - 1), 1)), nlevels)
    msh = meshes[-1]
    Vu = FunctionSpace(msh, "P", order, vs=2)
    Vp = FunctionSpace(msh, "P", order)
    Vpt = FunctionSpace(msh, "P", order - 1)
    Vdg2 = FunctionSpace(msh, "DG", order - 1, vs=2)
    Vdg1 = FunctionSpace(msh, "DG", order - 1)

    # project data into DG_{k-1} before the solve: the patch-ring
    # compatibility of the equilibration then holds exactly by Galerkin
    # orthogonality (cf. tests/test_biot.py)
    fe = local_projection(
        Vdg2, [expr_from_callable(f_body, msh, value_size=2)],
        quadrature_degree=2 * order + 6)[0]
    ge = local_projection(
        Vdg1, [expr_from_callable(g_flow, msh, value_size=1)],
        quadrature_degree=2 * order + 6)[0]

    t0 = time.perf_counter()
    solver = BiotSolverUPP(Vu, Vp, Vpt)
    uh, ph, pth = solver.solve(fe, ge, msh.boundary_facets, rtol=1e-12,
                               mg=meshes if len(meshes) > 1 else None)
    print(f"Biot primal (u-p-pt) solved in {time.perf_counter()-t0:.2f} s "
          f"({solver.last_iterations} block-MG MINRES iterations, residual "
          f"{solver.last_residual:.2e})")

    sigma_proj, rhs_proj = biot_fields(uh, ph, pth, fe, ge, order)

    t0 = time.perf_counter()
    eq = FluxEqlbSE(order, msh, rhs_proj, sigma_proj,
                    equilibrate_stress=True)
    eq.set_boundary_conditions([msh.boundary_facets] * 3, [[], [], []])
    eq.equilibrate_fluxes()
    print(f"3-field equilibration (2 stress rows + Darcy flux) in "
          f"{time.perf_counter()-t0:.2f} s")

    names = ["stress row 0", "stress row 1", "Darcy flux"]
    for i in range(3):
        err = check_divergence_condition(
            eq.list_flux[i], sigma_proj[i], rhs_proj[i], return_error=True)
        jump = check_jump_condition(eq.list_flux[i], sigma_proj[i])
        print(f"  {names[i]:<13}: divergence residual {err:.3e}, "
              f"H(div)-conforming: {jump}")
    wsym = check_weak_symmetry_condition(eq.list_flux[:2], sigma_proj[:2])
    print(f"  weak symmetry of the stress rows: {wsym}")

    out = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)),
                        "biot_pressure.vtu")
    nv = msh.num_vertices  # P-space dofs 0..nv-1 are the vertex values
    write_vtu(out, msh, {"p": np.asarray(ph.x)[:nv],
                         "pt": np.asarray(pth.x)[:nv]})
    print(f"pressures written to {out}")


if __name__ == "__main__":
    main(
        int(_sys.argv[1]) if len(_sys.argv) > 1 else 16,
        int(_sys.argv[2]) if len(_sys.argv) > 2 else 2,
    )
