"""Primal linear-elasticity solver (displacement formulation).

Reference workload ``demo/elasticity/demo_reconstruction.py:271-442``:
sigma(u) = 2 eps(u) + pi_1 div(u) I  (mu = 1, lambda = pi_1), solved with a
vector-P_k space.  Matrix-free preconditioned CG like models.poisson — the
per-cell stiffness acts through batched einsum contractions of quadrature
tables with per-cell geometry.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..elements.quadrature import facet_param_points, gauss_interval, gauss_triangle
from ..fem.spaces import Function, FunctionSpace
from ..fem.expressions import as_expr
from .poisson import locate_dofs_on_facets

__all__ = ["ElasticitySolver", "ElasticitySolverUP", "stress_row_expr",
           "stress_row_expr_up", "pressure_mismatch_expr"]


class _StressRow:
    """Row i of sigma(u_h) = 2 eps(u_h) + pi_1 div(u_h) I as an expression
    (optionally scaled), for projecting the stress rows before equilibration
    (reference elasticity demo_reconstruction.py:480-489 projects the
    negated rows)."""

    def __init__(self, uh: Function, pi_1: float, row: int, scale: float = 1.0):
        self.uh, self.pi_1, self.row, self.scale = uh, pi_1, row, scale
        self.mesh = uh.space.mesh
        self.value_size = 2

    def evaluate(self, q):
        g = self.uh.evaluate_grad(q)  # (nc, nq, 2, 2): g[..., comp, deriv]
        eps = 0.5 * (g + jnp.swapaxes(g, -1, -2))
        divu = g[..., 0, 0] + g[..., 1, 1]
        sig_row = 2.0 * eps[..., self.row, :]
        sig_row = sig_row.at[..., self.row].add(self.pi_1 * divu)
        return self.scale * sig_row


def stress_row_expr(uh: Function, pi_1: float, row: int, scale: float = 1.0):
    from ..fem.expressions import Expr

    class _E(_StressRow, Expr):
        pass

    return _E(uh, pi_1, row, scale)


class ElasticitySolver:
    def __init__(self, V: FunctionSpace, pi_1: float, quadrature_degree=None):
        assert V.family == "P" and V.block_size == 2
        self.V = V
        self.pi_1 = pi_1
        msh = V.mesh
        k = V.degree
        qdeg = quadrature_degree or 2 * k
        pts, w = gauss_triangle(qdeg)
        tabg = V.element.tabulate_grad(pts)  # (nd, 2, nq) reference grads
        K = msh.K  # (nc, 2, 2)
        # physical gradients per cell: g[c, i, a, q] = K[c, b, a] tabg[i, b, q]
        g = np.einsum("cba,ibq->ciaq", K, tabg)
        nd = V.element.ndofs
        adet = np.abs(msh.detJ)
        # basis function (i, a): eps = 0.5 (e_a g_i^T + g_i e_a^T)
        # 2 eps(u):eps(v) = (e_a.e_b)(g_i.g_j) + (g_i)_b (g_j)_a
        gg = np.einsum("q,ciaq,cjbq->ciajb", w, g, g)  # (nc, nd,2, nd,2): (g_i)_a (g_j)_b
        A = np.zeros((len(K), nd, 2, nd, 2))
        gij = np.einsum("q,cixq,cjxq->cij", w, g, g)
        for a in range(2):
            A[:, :, a, :, a] += gij
        A += np.einsum("ciajb->cibja", gg)  # (g_i)_b (g_j)_a term -> indices (i,a,j,b) with swap
        # div u div v: (g_i)_a (g_j)_b
        A += pi_1 * gg
        A *= adet[:, None, None, None, None]
        self.Ae = jnp.asarray(A.reshape(len(K), 2 * nd, 2 * nd))
        # dof layout per cell: (i, a) -> a * ndofs_scalar + scalar dof
        cd = V.cell_dofs.astype(np.int64)
        dofs = np.concatenate(
            [cd + a * V.ndofs_scalar for a in range(2)], axis=1
        )  # (nc, 2*nd): [a=0 dofs..., a=1 dofs...]
        # reorder to match (i, a) flattening (i-major? A reshaped (nd,2)->
        # flat index i*2+a).  Build matching dof table:
        dofs_ia = np.empty((len(K), 2 * nd), dtype=np.int64)
        for i in range(nd):
            for a in range(2):
                dofs_ia[:, i * 2 + a] = cd[:, i] + a * V.ndofs_scalar
        self.cell_dofs = jnp.asarray(dofs_ia)
        self.ndofs = V.ndofs
        self._qpts, self._qw = pts, w
        self._tab = jnp.asarray(V.element.tabulate(pts))
        diag = jnp.einsum("cii->ci", self.Ae)
        self.diag = jnp.zeros(self.ndofs).at[self.cell_dofs].add(diag)

    def matvec(self, x):
        xe = x[self.cell_dofs]
        ye = jnp.einsum("cij,cj->ci", self.Ae, xe)
        return jnp.zeros_like(x).at[self.cell_dofs].add(ye)

    def load_vector(self, f_expr, tractions=None):
        """f: body force (value_size 2).  tractions: list of (facets, t)
        with t(x) -> (..., 2) the boundary traction sigma.n."""
        V, msh = self.V, self.V.mesh
        f = as_expr(f_expr, msh)
        vals = f.evaluate(self._qpts)  # (nc, nq, 2)
        adet = jnp.abs(jnp.asarray(msh.detJ))
        # be[(i,a)] = int f_a phi_i
        be = adet[:, None, None] * jnp.einsum(
            "q,cqa,iq->cia", jnp.asarray(self._qw), vals, self._tab
        )
        b = jnp.zeros(self.ndofs).at[self.cell_dofs].add(
            be.reshape(len(adet), -1)
        )
        for facets, t in tractions or []:
            b = b + self._traction_load(facets, t)
        return b

    def _traction_load(self, facets, t_fn):
        V, msh = self.V, self.V.mesh
        facets = np.asarray(facets, dtype=np.int64)
        s, w = gauss_interval(V.degree + 8)
        pts_e = facet_param_points(s)
        tabs = [jnp.asarray(V.element.tabulate(pts_e[e])) for e in range(3)]
        own = msh.facet_cells[facets, 0].astype(np.int64)
        loc = msh.facet_local[facets, 0].astype(np.int64)
        aligned = msh.edge_aligned[own, loc]
        lo = msh.points[msh.facet_vertices[facets, 0]]
        T = msh.facet_tangent[facets]
        xq = lo[:, None, :] + np.einsum("q,fa->fqa", s, T)
        tv = jnp.asarray(t_fn(xq))  # (nf, nq, 2)
        b = jnp.zeros(self.ndofs)
        wj = jnp.asarray(w)
        nd = V.element.ndofs
        for e in range(3):
            for al in (True, False):
                m = (loc == e) & (aligned == al)
                if not m.any():
                    continue
                fsel, csel = facets[m], own[m]
                tab = tabs[e][:, ::-1] if not al else tabs[e]
                scale = jnp.asarray(msh.facet_length[fsel])
                be = scale[:, None, None] * jnp.einsum(
                    "q,fqa,iq->fia", wj, tv[m], tab
                )
                b = b.at[self.cell_dofs[csel]].add(be.reshape(len(fsel), -1))
        return b

    def solve(self, f_expr, dirichlet_facets, u_d, tractions=None,
              rtol=1e-12, atol=1e-14, maxiter=None,
              mg_meshes=None) -> Function:
        """``mg_meshes``: optional nested red-refinement hierarchy (finest =
        the solver's mesh) — preconditions the CG with a geometric V-cycle
        on the full ``2 eps:eps + pi_1 div div`` operator, giving
        mesh-independent iteration counts (Jacobi pays the 1/h factor;
        363 s at 1M dofs order 4 in the perftest).  Needs u essential on
        the whole boundary.  Default: Jacobi."""
        V = self.V
        bscalar = locate_dofs_on_facets(
            FunctionSpace(V.mesh, "P", V.degree), dirichlet_facets
        )
        bdofs = np.concatenate([bscalar + a * V.ndofs_scalar for a in range(2)])
        free = np.ones(self.ndofs, dtype=bool)
        free[bdofs] = False
        free = jnp.asarray(free)

        from ..fem.interpolate import interpolate

        ud_fun = interpolate(V, u_d)
        x0 = jnp.where(free, 0.0, ud_fun.x)
        b = self.load_vector(f_expr, tractions)
        r0 = jnp.where(free, b - self.matvec(x0), 0.0)
        if mg_meshes is not None:
            from ..fem.multigrid import GeometricMG, vector_eps_tensors

            if len(np.setdiff1d(V.mesh.boundary_facets,
                                np.asarray(dirichlet_facets))):
                raise ValueError(
                    "the MG path assumes u essential on the whole boundary")
            if isinstance(mg_meshes, GeometricMG):
                mg = mg_meshes  # prebuilt (e.g. utils.perftest, reused
                # across repeats; must match this operator's pi_1)
            else:
                if mg_meshes[-1] is not V.mesh:
                    raise ValueError(
                        "mg_meshes[-1] must be the solver's mesh")
                k, p1 = V.degree, self.pi_1
                mg = GeometricMG(
                    mg_meshes, k,
                    lambda m: vector_eps_tensors(m, k, div_coeff=p1),
                    block_size=2)
            mg_ops = mg.operands()

            def psolve(r):
                return mg.apply(r, mg_ops)

            if maxiter is None:
                maxiter = 200
        else:
            diag_inv = jnp.where(self.diag > 0, 1.0 / self.diag, 1.0)

            def psolve(r):
                return diag_inv * r

            if maxiter is None:
                maxiter = 30 * int(np.sqrt(self.ndofs) + 100)

        def cg(x0, r0, b):
            z0 = psolve(r0)
            rz0 = jnp.dot(r0, z0)
            bnorm = jnp.sqrt(jnp.dot(b * free, b * free)) + atol

            def cond(st):
                _, r, _, _, it = st
                return (jnp.sqrt(jnp.dot(r, r)) > rtol * bnorm + atol) & (it < maxiter)

            def body(st):
                x, r, p, rz, it = st
                Ap = jnp.where(free, self.matvec(p), 0.0)
                alpha = rz / jnp.dot(p, Ap)
                x = x + alpha * p
                r = r - alpha * Ap
                z = psolve(r)
                rzn = jnp.dot(r, z)
                return x, r, z + (rzn / rz) * p, rzn, it + 1

            return jax.lax.while_loop(cond, body, (x0, r0, z0, rz0, 0))

        x, r, _, _, it = jax.jit(cg)(x0, r0, b)
        self.last_iterations = int(it)
        self.last_residual = float(jnp.linalg.norm(r))
        return Function(V, x)


class _StressRowUP:
    """Row i of sigma(u_h, p_h) = 2 eps(u_h) + p_h I (Herrmann
    displacement-pressure formulation, reference elasticity
    demo_reconstruction.py:355-377, 436-442), optionally scaled."""

    def __init__(self, uh: Function, ph: Function, row: int, scale: float = 1.0):
        self.uh, self.ph, self.row, self.scale = uh, ph, row, scale
        self.mesh = uh.space.mesh
        self.value_size = 2

    def evaluate(self, q):
        g = self.uh.evaluate_grad(q)  # (nc, nq, 2, 2)
        eps = 0.5 * (g + jnp.swapaxes(g, -1, -2))
        p = self.ph.evaluate(q)[..., 0]
        sig_row = 2.0 * eps[..., self.row, :]
        sig_row = sig_row.at[..., self.row].add(p)
        return self.scale * sig_row


def stress_row_expr_up(uh: Function, ph: Function, row: int, scale: float = 1.0):
    from ..fem.expressions import Expr

    class _E(_StressRowUP, Expr):
        pass

    return _E(uh, ph, row, scale)


class _PressureMismatch:
    """div(u_h) - p_h / pi_1: the Herrmann formulation's constitutive
    mismatch entering the guaranteed bound (reference
    demo_error_estimation.py:113-119)."""

    def __init__(self, uh: Function, ph: Function, pi_1: float):
        self.uh, self.ph, self.pi_1 = uh, ph, pi_1
        self.mesh = uh.space.mesh
        self.value_size = 1

    def evaluate(self, q):
        g = self.uh.evaluate_grad(q)
        divu = g[..., 0, 0] + g[..., 1, 1]
        p = self.ph.evaluate(q)[..., 0]
        return (divu - p / self.pi_1)[..., None]


def pressure_mismatch_expr(uh: Function, ph: Function, pi_1: float):
    from ..fem.expressions import Expr

    class _E(_PressureMismatch, Expr):
        pass

    return _E(uh, ph, pi_1)


class ElasticitySolverUP:
    """Herrmann displacement-pressure primal solver: Taylor-Hood
    P_{k+1}^2 x P_k with

        (2 eps(u), eps(v)) + (p, div v) = (f, v)
        (div u, q) - (1/pi_1)(p, q)     = 0

    (reference ``demo/elasticity/demo_reconstruction.py:353-377``).  The
    symmetric indefinite system is solved matrix-free with Jacobi-
    preconditioned MINRES (the reference uses a direct LU; an iterative
    Krylov method is the device-resident equivalent — the (1/pi_1) pressure mass
    block makes the system symmetric quasi-definite, so MINRES converges
    without a pressure nullspace)."""

    def __init__(self, Vu: FunctionSpace, Vp: FunctionSpace, pi_1: float,
                 quadrature_degree=None):
        assert Vu.family == "P" and Vu.block_size == 2
        assert Vp.family == "P" and Vp.block_size == 1
        assert Vu.degree == Vp.degree + 1, "Taylor-Hood pairing"
        self.Vu, self.Vp, self.pi_1 = Vu, Vp, pi_1
        msh = Vu.mesh
        ku = Vu.degree
        qdeg = quadrature_degree or 2 * ku
        pts, w = gauss_triangle(qdeg)
        K = msh.K
        adet = np.abs(msh.detJ)
        nc = len(K)

        tgu = Vu.element.tabulate_grad(pts)  # (ndu, 2, nq)
        gu = np.einsum("cba,ibq->ciaq", K, tgu)  # physical grads
        ndu = Vu.element.ndofs
        # 2 eps(u):eps(v) element matrix (same contraction as the
        # displacement solver with the volumetric term dropped)
        gg = np.einsum("q,ciaq,cjbq->ciajb", w, gu, gu)
        Auu = np.zeros((nc, ndu, 2, ndu, 2))
        gij = np.einsum("q,cixq,cjxq->cij", w, gu, gu)
        for a in range(2):
            Auu[:, :, a, :, a] += gij
        Auu += np.einsum("ciajb->cibja", gg)
        Auu *= adet[:, None, None, None, None]
        self.Ae_uu = jnp.asarray(Auu.reshape(nc, 2 * ndu, 2 * ndu))

        tp = Vp.element.tabulate(pts)  # (ndp, nq)
        ndp = Vp.element.ndofs
        # B[(j), (i,a)] = int q_j (grad u_i)_a   ((div u, q))
        Be = np.einsum("q,jq,ciaq,c->cjia", w, tp, gu, adet)
        self.Be = jnp.asarray(Be.reshape(nc, ndp, 2 * ndu))
        Mp = np.einsum("q,iq,jq,c->cij", w, tp, tp, adet)
        self.Me_p = jnp.asarray(Mp)

        # dof tables ((i, a)-flattened for u, matching Ae_uu)
        cdu = Vu.cell_dofs.astype(np.int64)
        dofs_ia = np.empty((nc, 2 * ndu), dtype=np.int64)
        for i in range(ndu):
            for a in range(2):
                dofs_ia[:, i * 2 + a] = cdu[:, i] + a * Vu.ndofs_scalar
        self.cdu = jnp.asarray(dofs_ia)
        self.cdp = jnp.asarray(Vp.cell_dofs.astype(np.int64))
        self.nu, self.np_ = Vu.ndofs, Vp.ndofs
        self._qpts, self._qw = pts, w
        self._tabu = jnp.asarray(Vu.element.tabulate(pts))

        du = jnp.zeros(self.nu).at[self.cdu].add(
            jnp.einsum("cii->ci", self.Ae_uu)
        )
        dp = jnp.zeros(self.np_).at[self.cdp].add(
            jnp.einsum("cii->ci", self.Me_p)
        ) / pi_1
        self.diag = jnp.concatenate([du, dp])

    def _operands(self):
        """Operator arrays, passed as jit ARGUMENTS to the Krylov loop (see
        fem.krylov.minres: constants lower multi-GB programs)."""
        return dict(Ae_uu=self.Ae_uu, Be=self.Be, Me_p=self.Me_p,
                    cdu=self.cdu, cdp=self.cdp)

    def matvec(self, x, ops=None):
        if ops is None:
            ops = self._operands()
        xu = x[: self.nu]
        xp = x[self.nu :]
        xue = xu[ops["cdu"]]
        xpe = xp[ops["cdp"]]
        yu = jnp.einsum("cij,cj->ci", ops["Ae_uu"], xue) + jnp.einsum(
            "cji,cj->ci", ops["Be"], xpe
        )
        yp = jnp.einsum("cij,cj->ci", ops["Be"], xue) - (1.0 / self.pi_1) * jnp.einsum(
            "cij,cj->ci", ops["Me_p"], xpe
        )
        return jnp.concatenate([
            jnp.zeros(self.nu).at[ops["cdu"]].add(yu),
            jnp.zeros(self.np_).at[ops["cdp"]].add(yp),
        ])

    def load_vector(self, f_expr):
        msh = self.Vu.mesh
        f = as_expr(f_expr, msh)
        vals = f.evaluate(self._qpts)  # (nc, nq, 2)
        adet = jnp.abs(jnp.asarray(msh.detJ))
        be = adet[:, None, None] * jnp.einsum(
            "q,cqa,iq->cia", jnp.asarray(self._qw), vals, self._tabu
        )
        bu = jnp.zeros(self.nu).at[self.cdu].add(
            be.reshape(len(adet), -1)
        )
        return jnp.concatenate([bu, jnp.zeros(self.np_)])

    def solve(self, f_expr, dirichlet_facets, u_d, rtol=1e-12, atol=1e-14,
              maxiter=None, mg_meshes=None):
        """Returns (uh, ph).

        ``mg_meshes``: optional nested red-refinement hierarchy (finest =
        the solver's mesh) — a geometric V-cycle then preconditions the
        displacement block (pressure keeps the mass-diagonal), the standard
        norm-equivalent Herrmann preconditioner diag(A_uu, M_p/pi_1); needs
        u essential on the whole boundary.  Default: Jacobi on both
        blocks."""
        Vu = self.Vu
        bscalar = locate_dofs_on_facets(
            FunctionSpace(Vu.mesh, "P", Vu.degree), dirichlet_facets
        )
        bdofs = np.concatenate([bscalar + a * Vu.ndofs_scalar for a in range(2)])
        free = np.ones(self.nu + self.np_, dtype=bool)
        free[bdofs] = False
        free = jnp.asarray(free)

        from ..fem.interpolate import interpolate

        ud_fun = interpolate(Vu, u_d)
        x0 = jnp.where(free, 0.0, jnp.concatenate([
            ud_fun.x, jnp.zeros(self.np_)
        ]))
        b = self.load_vector(f_expr)
        operands = self._operands()
        diag_inv = jnp.where(jnp.abs(self.diag) > 0,
                             1.0 / jnp.abs(self.diag), 1.0)
        if mg_meshes is not None:
            from ..fem.multigrid import GeometricMG, vector_eps_tensors

            if mg_meshes[-1] is not Vu.mesh:
                raise ValueError("mg_meshes[-1] must be the solver's mesh")
            if len(np.setdiff1d(Vu.mesh.boundary_facets,
                                np.asarray(dirichlet_facets))):
                raise ValueError(
                    "the MG path assumes u essential on the whole boundary")
            ku = Vu.degree
            mg_u = GeometricMG(mg_meshes, ku,
                               lambda m: vector_eps_tensors(m, ku),
                               block_size=2)
            nu = self.nu

            def Minv(r, ops):
                return jnp.concatenate([
                    mg_u.apply(r[:nu], ops["mg_u"]),
                    ops["dp_inv"] * r[nu:],
                ])

            operands = {**operands, "mg_u": mg_u.operands(),
                        "dp_inv": diag_inv[nu:]}
            if maxiter is None:
                maxiter = 400
        else:
            Minv = diag_inv
            if maxiter is None:
                maxiter = 60 * int(np.sqrt(self.nu + self.np_) + 100)

        from ..fem.krylov import minres

        st = minres(self.matvec, b, x0, Minv, free, rtol=rtol, atol=atol,
                    maxiter=maxiter, operands=operands)
        self.last_iterations = int(st["it"])
        self.last_residual = float(st["phibar"])
        x = st["x"]
        return Function(self.Vu, x[: self.nu]), Function(self.Vp, x[self.nu :])
