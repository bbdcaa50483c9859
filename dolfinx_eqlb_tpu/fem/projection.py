"""Cell-local L2 projection and local solvers.

Device-resident equivalent of the reference's local-solver path
(``cpp/dolfinx_eqlb/base/local_solver.hpp:37-187`` +
``python/dolfinx_eqlb/lsolver``): instead of a per-cell Eigen factorisation
loop, all cells are solved in one batched XLA program.

* DG targets use the orthonormal Dubiner basis, so projection is a pure
  quadrature moment evaluation — no linear solve at all.
* P / RT / DRT targets use a batched Cholesky of the per-cell mass matrices
  (``local_solver_cholesky``, reference ``local_solver.hpp:213-224``).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..elements.quadrature import gauss_triangle
from .spaces import Function, FunctionSpace
from .expressions import as_expr

__all__ = ["local_projection", "local_solver_cholesky", "local_solver_lu", "local_solver_cg"]


def _proj_quadrature(V: FunctionSpace, exprs, quadrature_degree):
    if quadrature_degree is None:
        quadrature_degree = 2 * V.degree + 2
    return gauss_triangle(quadrature_degree)


def local_projection(V: FunctionSpace, data, quadrature_degree=None):
    """L2-project each expression in ``data`` into ``V`` cell-locally.

    Mirrors ``local_projection`` (reference ``lsolver/projection.py:46-77``).
    Returns a list of Functions.
    """
    exprs = [as_expr(d, V.mesh) for d in data]
    pts, w = _proj_quadrature(V, exprs, quadrature_degree)
    msh = V.mesh

    out = []
    if V.family == "DG":
        tab = jnp.asarray(V.tabulate(pts))  # (nd, nq)
        nd = V.element.ndofs
        for e in exprs:
            vals = e.evaluate(pts)  # (nc, nq, vs)
            if e.value_size != V.block_size:
                raise ValueError("value size mismatch")
            # dof_m = sum_q w_q expr Q_m   (detJ cancels: orthonormal basis)
            mom = jnp.einsum("q,cqa,dq->acd", jnp.asarray(w), vals, tab)
            # layout: component-major blocks, cell-major inside
            x = mom.reshape(V.block_size * msh.num_cells * nd)
            out.append(Function(V, x))
        return out

    if V.family in ("RT", "DRT"):
        tab = jnp.asarray(V.element.tabulate(pts))  # (nd, 2, nq)
        J = jnp.asarray(msh.J)
        adet = jnp.abs(jnp.asarray(msh.detJ))
        sdet = jnp.sign(jnp.asarray(msh.detJ))
        # M_c = (1/|detJ|) (J^T J)_{ab} Mhat_ab
        Mhat = jnp.einsum("q,iaq,jbq->abij", jnp.asarray(w), tab, tab)
        JtJ = jnp.einsum("cka,ckb->cab", J, J)
        M = jnp.einsum("cab,abij->cij", JtJ, Mhat) / adet[:, None, None]
        if V.dof_signs is not None:
            sg = jnp.asarray(V.dof_signs)
            M = M * sg[:, :, None] * sg[:, None, :]
        for e in exprs:
            vals = e.evaluate(pts)  # (nc, nq, 2)
            rhs = sdet[:, None] * jnp.einsum(
                "q,cqa,cab,ibq->ci", jnp.asarray(w), vals, J, tab
            )
            if V.dof_signs is not None:
                rhs = rhs * jnp.asarray(V.dof_signs)
            sol = jnp.linalg.solve(M, rhs[..., None])[..., 0]
            x = jnp.zeros(V.ndofs).at[jnp.asarray(V.cell_dofs)].set(sol)
            out.append(Function(V, x))
        return out

    if V.family == "P":
        tab = jnp.asarray(V.tabulate(pts))  # (nd, nq)
        adet = jnp.abs(jnp.asarray(msh.detJ))
        Mhat = jnp.einsum("q,iq,jq->ij", jnp.asarray(w), tab, tab)
        M = adet[:, None, None] * Mhat[None]
        for e in exprs:
            vals = e.evaluate(pts)
            xs = []
            for b in range(V.block_size):
                rhs = adet[:, None] * jnp.einsum(
                    "q,cq,iq->ci", jnp.asarray(w), vals[..., b], tab
                )
                sol = jnp.linalg.solve(M, rhs[..., None])[..., 0]
                xb = jnp.zeros(V.ndofs_scalar).at[jnp.asarray(V.cell_dofs)].set(sol)
                xs.append(xb)
            out.append(Function(V, jnp.concatenate(xs)))
        return out

    raise ValueError(f"local projection into {V.family} not supported")


# reference API parity (wrappers.cpp:52-82 exposes lu/cholesky/cg variants;
# on XLA they are all the same batched dense solve)
def local_solver_cholesky(V, data, quadrature_degree=None):
    return local_projection(V, data, quadrature_degree)


def local_solver_lu(V, data, quadrature_degree=None):
    return local_projection(V, data, quadrature_degree)


def local_solver_cg(V, data, quadrature_degree=None):
    return local_projection(V, data, quadrature_degree)
