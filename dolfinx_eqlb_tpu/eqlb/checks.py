"""Post-hoc verification of the equilibration conditions.

Pure-JAX re-implementation of the reference's
``eqlb/check_eqlb_conditions.py`` (SURVEY.md 2.1): divergence condition,
jump (H(div)-conformity) condition — both as an interpolation residual and
per facet — boundary conditions, and the weak symmetry condition.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..elements.quadrature import facet_param_points, gauss_triangle
from ..fem.spaces import Function, FunctionSpace
from ..fem.expressions import as_expr
from ..fem.interpolate import interpolate
from ..fem.assemble import cell_integrals_sq

__all__ = [
    "mesh_has_reversed_edges",
    "reconstructed_flux_expr",
    "check_divergence_condition",
    "divergence_error_scale",
    "check_jump_condition",
    "check_jump_condition_per_facet",
    "check_boundary_conditions",
    "check_weak_symmetry_condition",
]


def mesh_has_reversed_edges(mesh) -> bool:
    """True if any interior facet runs anti-aligned in one of its cells
    (reference ``check_eqlb_conditions.py:19-86`` via facet permutations;
    here the orientation bit is explicit in the topology)."""
    f = ~mesh.is_boundary_facet
    a0 = mesh.edge_aligned[mesh.facet_cells[f, 0], mesh.facet_local[f, 0]]
    a1 = mesh.edge_aligned[mesh.facet_cells[f, 1], mesh.facet_local[f, 1]]
    bf = mesh.boundary_facets
    ab = mesh.edge_aligned[mesh.facet_cells[bf, 0], mesh.facet_local[bf, 0]]
    return bool((a0 != a1).any() or (~ab).any())


def reconstructed_flux_expr(sigma_eq: Function, sigma_proj: Function):
    """sigma_R: the flux itself (EV / conforming RT) or corrector + projected
    flux (SE / discontinuous RT), cf. reference ``FluxEqlbSE.py:176-186``."""
    if sigma_eq.space.family == "RT":
        return as_expr(sigma_eq)
    return as_expr(sigma_eq) + as_expr(sigma_proj)


def check_divergence_condition(
    sigma_eq: Function,
    sigma_proj: Function,
    rhs_proj: Function,
    atol: float = 1e-8,
    return_error: bool = False,
):
    """div(sigma_R) == projected RHS, checked at quadrature points per cell
    (reference ``check_eqlb_conditions.py:183-291`` point-evaluates on a
    random test set; a quadrature lattice is equivalent and deterministic).
    """
    sig = reconstructed_flux_expr(sigma_eq, sigma_proj)
    k = sigma_eq.space.degree
    pts, _ = gauss_triangle(2 * k + 2)
    dv = sig.evaluate_div(pts)[..., 0]
    rv = as_expr(rhs_proj).evaluate(pts)[..., 0]
    err = float(jnp.max(jnp.abs(dv - rv)))
    scale = float(jnp.max(jnp.abs(rv))) + 1.0
    if return_error:
        return err
    return err < atol * scale


def divergence_error_scale(sigma_eq: Function, sigma_proj: Function) -> float:
    """Inverse-estimate magnitude max|sigma_R| / h_min of the reconstructed
    flux.  The divergence residual max|div sigma_R - f| of an f64 result is
    round-off in dofs amplified by the divergence operator (1/detJ ~ 2 n^2
    on an n x n crossed square), so ``err / scale`` is the mesh-size
    comparable accuracy number; h_min = sqrt(2 min|detJ|)."""
    sig = reconstructed_flux_expr(sigma_eq, sigma_proj)
    pts, _ = gauss_triangle(2 * sigma_eq.space.degree + 2)
    vmax = float(jnp.max(jnp.abs(sig.evaluate(pts))))
    detJ = np.asarray(sigma_eq.space.mesh.detJ)
    return vmax / float(np.sqrt(2.0 * np.min(np.abs(detJ))))


def check_jump_condition(
    sigma_eq: Function, sigma_proj: Function, atol: float = 1e-12
):
    """H(div)-conformity via the interpolation residual: sigma_R must equal
    its conforming-RT interpolant in the H(div) norm (reference
    ``check_eqlb_conditions.py:294-359``)."""
    sig = reconstructed_flux_expr(sigma_eq, sigma_proj)
    V_rt = FunctionSpace(sigma_eq.space.mesh, "RT", sigma_eq.space.degree)
    interp = interpolate(V_rt, sig)
    err = as_expr(interp) - sig
    k = sigma_eq.space.degree
    e2 = cell_integrals_sq(err, 2 * k + 2)
    # divergence part
    pts, w = gauss_triangle(2 * k + 2)
    dv = err.evaluate_div(pts)[..., 0]
    adet = jnp.abs(jnp.asarray(sigma_eq.space.mesh.detJ))
    e2 = e2 + adet * jnp.einsum("q,cq,cq->c", jnp.asarray(w), dv, dv)
    return float(e2.sum()) < atol


def check_jump_condition_per_facet(
    sigma_eq: Function, sigma_proj: Function, atol: float = 1e-9
):
    """Pointwise two-sided normal-trace comparison on every interior facet
    (reference ``check_eqlb_conditions.py:362-473``)."""
    sig = reconstructed_flux_expr(sigma_eq, sigma_proj)
    msh = sigma_eq.space.mesh
    k = sigma_eq.space.degree
    s = np.linspace(0.0, 1.0, k + 4)[1:-1]
    pts_e = facet_param_points(s)
    # (3, nc, nq, 2): flux values on each local edge's parameter lattice
    V = np.stack([np.asarray(sig.evaluate(pts_e[e])) for e in range(3)])
    scale = float(np.max(np.abs(V))) + 1.0
    fint = np.where(msh.facet_cells[:, 1] >= 0)[0]
    if len(fint) == 0:
        return True
    T = msh.facet_tangent[fint]
    rotT = np.stack([T[:, 1], -T[:, 0]], axis=1)
    rotT /= np.linalg.norm(rotT, axis=1, keepdims=True)
    traces = []
    for side in (0, 1):
        c = msh.facet_cells[fint, side]
        e = msh.facet_local[fint, side]
        v = V[e, c]  # (nfint, nq, 2)
        rev = ~msh.edge_aligned[c, e]
        v = np.where(rev[:, None, None], v[:, ::-1], v)
        traces.append(np.einsum("fqa,fa->fq", v, rotT))
    return bool(np.allclose(traces[0], traces[1], atol=atol * scale))


def check_boundary_conditions(
    sigma_eq: Function,
    sigma_proj: Function,
    boundary_function: Function,
    boundary_facets: np.ndarray,
    atol: float = 1e-9,
):
    """Facet dofs of sigma_R on the given boundary facets must equal the BC
    function's dofs (reference ``check_eqlb_conditions.py:90-179``)."""
    sig = reconstructed_flux_expr(sigma_eq, sigma_proj)
    V_rt = boundary_function.space
    assert V_rt.family == "RT"
    interp = interpolate(V_rt, sig)
    k = V_rt.degree
    fcts = np.asarray(boundary_facets, dtype=np.int64)
    idx = (fcts[:, None] * k + np.arange(k)[None, :]).ravel()
    a = np.asarray(interp.x)[idx]
    b = np.asarray(boundary_function.x)[idx]
    scale = float(np.max(np.abs(b))) + 1.0
    return bool(np.allclose(a, b, atol=atol * scale))


def check_weak_symmetry_condition(list_sigma_eq, list_sigma_proj=None, atol=1e-9):
    """(sigma_01 - sigma_10, v) == 0 for all v in continuous P1 (reference
    ``check_eqlb_conditions.py:476-521``). Row i of the stress is flux i."""
    s0 = list_sigma_eq[0]
    msh = s0.space.mesh
    if list_sigma_proj is None:
        rows = [as_expr(s) for s in list_sigma_eq]
    else:
        rows = [
            reconstructed_flux_expr(se, sp)
            for se, sp in zip(list_sigma_eq, list_sigma_proj)
        ]
    k = s0.space.degree
    pts, w = gauss_triangle(2 * k + 2)
    v01 = rows[0].evaluate(pts)[..., 1]
    v10 = rows[1].evaluate(pts)[..., 0]
    V1 = FunctionSpace(msh, "P", 1)
    tab = jnp.asarray(V1.tabulate(pts))  # (3, nq)
    adet = jnp.abs(jnp.asarray(msh.detJ))
    be = adet[:, None] * jnp.einsum("q,cq,iq->ci", jnp.asarray(w), v01 - v10, tab)
    L = jnp.zeros(V1.ndofs).at[jnp.asarray(V1.cell_dofs)].add(be)
    scale = float(jnp.max(jnp.abs(adet))) + 1.0
    return bool(np.allclose(np.asarray(L), 0.0, atol=atol * scale))
