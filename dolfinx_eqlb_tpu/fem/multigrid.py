"""Geometric multigrid preconditioning on red-refinement hierarchies.

The reference solves its primal systems with PETSc — CG + BoomerAMG for the
SPD cases and MUMPS / superlu_dist for the mixed saddle systems
(``python/test/performance/perftest_basics.py:34-160``).  The device-resident
equivalent built here is a matrix-free geometric V-cycle:

* the mesh hierarchy comes from ``mesh.refine_uniform`` (red refinement) —
  child cells live in four index blocks of the parent cell count and the
  four child->parent reference maps are mesh-independent constants, so the
  grid transfer is one gather, one ``(4, nd, nd)`` einsum against a fixed
  tabulation tensor, and one scatter: no sparse matrices anywhere;
* smoothing is Chebyshev-accelerated Jacobi (the standard matrix-free AMG
  smoother) — a fixed-degree polynomial in ``D^{-1} A`` whose application
  is pure batched element einsums on the MXU;
* the coarsest level is solved by a precomputed dense inverse (one matmul).

The V-cycle with equal pre-/post-smoothing is a fixed symmetric positive
definite linear operator, so it drops into CG / MINRES as a
preconditioner.  Dirichlet conditions are handled by free-dof masking on
every level (the domain boundary is preserved under red refinement).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..elements.quadrature import gauss_triangle
from .spaces import FunctionSpace

__all__ = [
    "GeometricMG",
    "mesh_hierarchy",
    "prolongation_tensor",
    "scalar_stiffness_tensors",
    "vector_eps_tensors",
]


def mesh_hierarchy(coarse, nlevels: int):
    """``[coarse, refine_uniform(coarse), ...]`` — ``nlevels`` meshes,
    coarse -> fine, nested for :class:`GeometricMG` (the finest has
    ``4**(nlevels-1)`` times the coarse cell count)."""
    from ..mesh import refine_uniform

    meshes = [coarse]
    for _ in range(nlevels - 1):
        meshes.append(refine_uniform(meshes[-1]))
    return meshes

# Parent-reference vertex coordinates of the four red children produced by
# mesh.refine_uniform (child b of parent c is fine cell b * nc + c):
#   c0 = (v0, m2, m1), c1 = (v1, m0, m2), c2 = (v2, m1, m0),
#   c3 = (m0, m1, m2)
# with v = reference vertices, m_i = midpoint of the edge opposite v_i.
_CHILD_VERTS = np.array(
    [
        [[0.0, 0.0], [0.5, 0.0], [0.0, 0.5]],
        [[1.0, 0.0], [0.5, 0.5], [0.5, 0.0]],
        [[0.0, 1.0], [0.0, 0.5], [0.5, 0.5]],
        [[0.5, 0.5], [0.0, 0.5], [0.5, 0.0]],
    ]
)


def prolongation_tensor(degree: int) -> np.ndarray:
    """``P[b, i, j]``: coarse basis i at the parent-reference location of
    fine Lagrange node j inside red child b — mesh-independent, so CG_k
    coarse-to-fine interpolation is a single constant tensor."""
    from ..elements.lagrange import lagrange_cached

    el = lagrange_cached(degree)
    nodes = el.nodes  # (nd, 2) fine-element reference nodes
    P = np.empty((4, el.ndofs, el.ndofs))
    for b in range(4):
        V = _CHILD_VERTS[b]
        mapped = V[0] + np.einsum(
            "ja,ab->jb", nodes, np.stack([V[1] - V[0], V[2] - V[0]])
        )
        P[b] = el.tabulate(mapped)  # (i, j)
    return P


def scalar_stiffness_tensors(msh, degree: int, mass_coeff: float = 0.0,
                             quadrature_degree=None) -> np.ndarray:
    """Element tensors of ``(grad u, grad v) + mass_coeff (u, v)`` on CG_k
    -> ``(nc, nd, nd)`` (the Poisson operator / the Biot ``K_p + M_p``
    pressure block)."""
    el = FunctionSpace(msh, "P", degree).element
    pts, w = gauss_triangle(quadrature_degree or 2 * degree)
    tg = el.tabulate_grad(pts)  # (nd, 2, nq)
    g = np.einsum("cba,ibq->ciaq", msh.K, tg)
    adet = np.abs(msh.detJ)
    A = np.einsum("q,ciaq,cjaq,c->cij", w, g, g, adet)
    if mass_coeff:
        t = el.tabulate(pts)
        A += mass_coeff * np.einsum("q,iq,jq,c->cij", w, t, t, adet)
    return A


def vector_eps_tensors(msh, degree: int, quadrature_degree=None,
                       div_coeff: float = 0.0) -> np.ndarray:
    """Element tensors of ``2 (eps(u), eps(v)) + div_coeff (div u, div v)``
    on (CG_k)^2, local index flattened ``i * 2 + a`` ->
    ``(nc, 2 nd, 2 nd)`` (the Biot / elasticity displacement block,
    reference ``perftest_basics.py:294-330``; ``div_coeff = pi_1`` matches
    the primal displacement formulation of ``models.ElasticitySolver``)."""
    el = FunctionSpace(msh, "P", degree).element
    pts, w = gauss_triangle(quadrature_degree or 2 * degree)
    tg = el.tabulate_grad(pts)
    g = np.einsum("cba,ibq->ciaq", msh.K, tg)
    adet = np.abs(msh.detJ)
    nd = el.ndofs
    gg = np.einsum("q,ciaq,cjbq->ciajb", w, g, g)
    A = np.zeros((len(msh.K), nd, 2, nd, 2))
    gij = np.einsum("q,cixq,cjxq->cij", w, g, g)
    for a in range(2):
        A[:, :, a, :, a] += gij
    A += np.einsum("ciajb->cibja", gg)
    if div_coeff:
        A += div_coeff * gg
    A *= adet[:, None, None, None, None]
    return A.reshape(len(msh.K), 2 * nd, 2 * nd)


def _boundary_scalar_dofs(msh, space: FunctionSpace) -> np.ndarray:
    """Scalar CG dofs on the whole domain boundary (vertex + edge dofs of
    boundary facets)."""
    k = space.degree
    bf = msh.boundary_facets.astype(np.int64)
    dofs = [msh.facet_vertices[bf].ravel().astype(np.int64)]
    if k >= 2:
        nv = msh.num_vertices
        dofs.append(
            (nv + bf[:, None] * (k - 1) + np.arange(k - 1)[None, :]).ravel()
        )
    return np.unique(np.concatenate(dofs))


class GeometricMG:
    """Symmetric V-cycle on a red-refinement hierarchy of CG_k spaces.

    Parameters
    ----------
    meshes : list of TriMesh, coarse -> fine, each produced from the
        previous by ``mesh.refine_uniform``.
    degree : CG degree of the preconditioned space.
    elem_tensors_fn : ``msh -> (nc, nd * bs, nd * bs)`` NumPy element
        tensors of the level operator, local index flattened ``i * bs + a``
        with component-major global layout ``dof = scalar_dof + a * nds``.
    bc_dofs_fn : ``(msh, scalar_space) -> constrained scalar dofs`` (applied
        to every component); default = whole boundary.  ``None`` entries /
        ``lambda *a: []`` give a pure-Neumann level (the operator must then
        be nonsingular, e.g. carry a mass term).
    block_size : components per scalar dof (1 = scalar, 2 = 2D vector).
    smooth_degree : Chebyshev polynomial degree per pre-/post-smooth.
    eig_ratio : smoothing interval [lmax / eig_ratio, lmax].
    """

    def __init__(self, meshes, degree: int, elem_tensors_fn,
                 bc_dofs_fn=_boundary_scalar_dofs, block_size: int = 1,
                 smooth_degree: int = 3, eig_ratio: float = 8.0,
                 dtype=None):
        if bc_dofs_fn is None:
            bc_dofs_fn = lambda msh, sp: np.empty(0, dtype=np.int64)
        self.dtype = dtype or (
            jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
        self.bs = bs = block_size
        self.degree = degree
        self.m = smooth_degree
        self.eig_ratio = float(eig_ratio)
        self.nlevels = len(meshes)
        for lo, hi in zip(meshes[:-1], meshes[1:]):
            if hi.num_cells != 4 * lo.num_cells:
                raise ValueError(
                    "hierarchy must be consecutive red refinements "
                    f"({hi.num_cells} != 4 * {lo.num_cells})")

        Ptab = prolongation_tensor(degree)
        self._ops = []
        self._nds = []
        for l, msh in enumerate(meshes):
            sp = FunctionSpace(msh, "P", degree)
            cds = sp.cell_dofs.astype(np.int64)  # (nc, nd) scalar
            nc, nd = cds.shape
            nds = sp.ndofs_scalar
            Ae = np.asarray(elem_tensors_fn(msh))
            # flattened (i, a) operator dof table, component-major global
            cd = np.concatenate(
                [cds[:, :, None] + a * nds for a in range(bs)], axis=2
            ).reshape(nc, nd * bs)
            free = np.ones(nds * bs, dtype=bool)
            bc = np.asarray(bc_dofs_fn(msh, sp), dtype=np.int64)
            for a in range(bs):
                free[bc + a * nds] = False
            diag = np.zeros(nds * bs)
            np.add.at(diag, cd, np.einsum("cii->ci", Ae))
            Dinv = np.where(free & (np.abs(diag) > 0), 1.0 / diag, 0.0)
            o = dict(
                cd=jnp.asarray(cd, jnp.int32),
                Ae=jnp.asarray(Ae, self.dtype),
                Dinv=jnp.asarray(Dinv, self.dtype),
                free=jnp.asarray(free.astype(np.float64), self.dtype),
            )
            if l == 0:
                A = np.zeros((nds * bs, nds * bs))
                np.add.at(A, (cd[:, :, None], cd[:, None, :]), Ae)
                fix = ~free
                A[fix, :] = 0.0
                A[:, fix] = 0.0
                A[fix, fix] = 1.0
                Ainv = np.linalg.inv(A)
                Ainv[fix, :] = 0.0
                Ainv[:, fix] = 0.0
                o["Ainv"] = jnp.asarray(Ainv, self.dtype)
            else:
                # transfer tables: fine cells in 4 red blocks of the coarse
                # cell count; owner mask picks one (cell, local) occurrence
                # per global fine dof so restriction is the exact transpose
                cds4 = cds.reshape(4, nc // 4, nd)
                flat = cds4.reshape(-1)
                owner = np.zeros(flat.shape, dtype=bool)
                owner[np.unique(flat, return_index=True)[1]] = True
                o["cds_f"] = jnp.asarray(cds4, jnp.int32)
                o["owner"] = jnp.asarray(
                    owner.reshape(4, nc // 4, nd).astype(np.float64),
                    self.dtype)
                o["Ptab"] = jnp.asarray(Ptab, self.dtype)
                o["cds_c"] = self._ops[l - 1]["cds_scalar"]
            o["cds_scalar"] = jnp.asarray(cds, jnp.int32)
            # lmax of Dinv A (power iteration, deterministic start) in host
            # NumPy from the assembly-side arrays: a per-level jit would
            # cost one compile per level, and only the scalar is kept
            rng = np.random.default_rng(7)
            v = rng.standard_normal(nds * bs)
            DinvF = Dinv  # zero on constrained dofs already
            lam = 1.0
            for _ in range(20):
                v /= np.linalg.norm(v) + 1e-30
                ve = np.where(free, v, 0.0)[cd]
                y = np.zeros(nds * bs)
                np.add.at(y, cd, np.einsum("cij,cj->ci", Ae, ve))
                v = DinvF * np.where(free, y, 0.0)
                lam = np.linalg.norm(v)
            o["lmax"] = jnp.asarray(1.1 * lam, self.dtype)
            self._ops.append(o)
            self._nds.append(nds)

    # --- level operations (all jit-friendly; ``ops`` rides as arguments) --

    def _matvec(self, o, x):
        xe = (x * o["free"])[o["cd"]]
        y = jnp.einsum("cij,cj->ci", o["Ae"], xe)
        n = o["Dinv"].shape[0]
        return jnp.zeros(n, x.dtype).at[o["cd"]].add(y) * o["free"]

    def _cheb(self, o, r):
        """z ~ A^{-1} r: degree-m Chebyshev on D^{-1}A over
        [lmax / eig_ratio, lmax] from a zero initial guess."""
        lmax = o["lmax"]
        lmin = lmax / self.eig_ratio
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        d = (o["Dinv"] * r) / theta
        z = d
        rho = 1.0 / sigma
        for _ in range(self.m - 1):
            r = r - self._matvec(o, d)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (o["Dinv"] * r)
            z = z + d
            rho = rho_new
        return z

    def _prolong(self, o, xc):
        """Coarse level vector (bs * ndc,) -> fine (bs * ndf,)."""
        bs = self.bs
        xcs = xc.reshape(bs, -1)
        vc = xcs[:, o["cds_c"]]  # (bs, ncc, nd)
        vf = jnp.einsum("bij,sci->sbcj", o["Ptab"], vc)
        ndf = o["Dinv"].shape[0] // bs
        out = jnp.zeros((bs, ndf), xc.dtype)
        out = out.at[:, o["cds_f"]].add(vf * o["owner"][None])
        return out.reshape(-1)

    def _restrict(self, o, rf, ndc):
        """Exact transpose of ``_prolong`` (``ndc`` = coarse scalar size)."""
        bs = self.bs
        rfs = rf.reshape(bs, -1)
        vf = rfs[:, o["cds_f"]] * o["owner"][None]  # (bs, 4, ncc, nd)
        vc = jnp.einsum("bij,sbcj->sci", o["Ptab"], vf)
        out = jnp.zeros((bs, ndc), rf.dtype)
        out = out.at[:, o["cds_c"]].add(vc)
        return out.reshape(-1)

    def apply(self, r, ops):
        """One symmetric V-cycle: ``z ~ A^{-1} r`` on the free dofs.

        ``ops`` must be ``self.operands()`` passed through the surrounding
        jit as an argument (big tables must not bake in as constants)."""
        return self._vcycle(self.nlevels - 1, r * ops[-1]["free"], ops)

    def _vcycle(self, l, r, ops):
        o = ops[l]
        if l == 0:
            return o["Ainv"] @ r
        z = self._cheb(o, r)
        rc = self._restrict(o, r - self._matvec(o, z),
                            self._nds[l - 1])
        rc = rc * ops[l - 1]["free"]
        ec = self._vcycle(l - 1, rc, ops)
        z = z + self._prolong(o, ec) * o["free"]
        z = z + self._cheb(o, r - self._matvec(o, z))
        return z

    def operands(self):
        """Device pytree of every level's tables (pass as jit argument)."""
        return self._ops
