"""Primal Biot poro-elasticity solver (3-field u-p-pt formulation).

Reference workload ``python/test/performance/perftest_basics.py:294-382``
(testcase ``Biot_upp`` behind BASELINE config 5): displacement u in (CG_k)^2,
pore pressure p in CG_k, total pressure pt in CG_{k-1}, coupled by

    (2 eps(u) - pt I, eps(v_u))                  = (f, v_u)
    (div u + pt - p, v_pt)                       = 0
    ((p - pt), v_p) + (grad p, grad v_p)         = (g, v_p)

with u and p essential on the whole boundary.  The raw block system is
nonsymmetric (the u-pt coupling enters the momentum row with the opposite
sign of the mass-balance row); negating the p- and pt-equations restores
symmetry:

    [ A_uu      0            -B^T    ] [u ]   [  f ]
    [ 0        -(K_p + M_p)  +M_ppt  ] [p ] = [ -g ]
    [ -B       +M_ppt^T      -M_pt   ] [pt]   [  0 ]

a symmetric indefinite system solved matrix-free with Jacobi-preconditioned
MINRES (``fem.krylov``) — the device-resident equivalent of the reference's
direct MUMPS/LU solve.

The three physical fields fed to the equilibrator (reference
``perftest_basics.py:362-373``) are

    rows 0/1:  sigma_h = -2 eps(u_h) + (pt_h - p_h) I   (total stress,
               negated), with divergence data (f - grad p_h)_i
    row 2:     -grad p_h (Darcy flux), with divergence data
               g + pt_h - p_h

so one FluxEqlbSE(..., equilibrate_stress=True) call equilibrates the
coupled problem's stress rows (weakly symmetric) and flow flux together.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..elements.quadrature import gauss_triangle
from ..fem.spaces import Function, FunctionSpace
from ..fem.expressions import Expr, as_expr
from ..fem.krylov import minres
from .poisson import locate_dofs_on_facets

__all__ = ["BiotSolverUPP", "BiotMG", "biot_stress_row_expr",
           "darcy_flux_expr", "biot_flow_rhs_expr", "biot_fields",
           "biot_bench_fields"]


class BiotMG:
    """Block-diagonal geometric-multigrid preconditioner for the symmetric
    u-p-pt system: the Lee-Mardal-Winther norm-equivalent block operator

        P = diag( A_uu,  K_p + M_p,  M_pt )

    with V-cycles on the two elliptic blocks and the (lumped) mass diagonal
    on pt.  Device-resident stand-in for the reference's CG+BoomerAMG / MUMPS
    solver configs (``python/test/performance/perftest_basics.py:34-160``);
    gives mesh-independent MINRES iteration counts where plain Jacobi needs
    O(1/h) iterations.

    ``meshes``: nested red-refinement hierarchy (``fem.multigrid.
    mesh_hierarchy``), coarse -> fine, whose finest mesh IS the solver's
    mesh.  Assumes u and p are essential on the whole boundary (the
    reference testcase's layout) so every level can mask its own boundary.
    """

    def __init__(self, solver: "BiotSolverUPP", meshes, smooth_degree=3,
                 eig_ratio=8.0):
        from ..fem.multigrid import (GeometricMG, scalar_stiffness_tensors,
                                     vector_eps_tensors)

        if meshes[-1] is not solver.Vu.mesh:
            raise ValueError("meshes[-1] must be the solver's mesh")
        ku = solver.Vu.degree
        dt = solver.dtype
        self.nu, self.np_ = solver.nu, solver.np_
        self.mg_u = GeometricMG(
            meshes, ku, lambda m: vector_eps_tensors(m, ku),
            block_size=2, smooth_degree=smooth_degree, eig_ratio=eig_ratio,
            dtype=dt)
        self.mg_p = GeometricMG(
            meshes, ku, lambda m: scalar_stiffness_tensors(m, ku,
                                                           mass_coeff=1.0),
            smooth_degree=smooth_degree, eig_ratio=eig_ratio, dtype=dt)
        dpt = solver.diag[solver.nu + solver.np_:]
        self.dpt_inv = jnp.where(jnp.abs(dpt) > 0, 1.0 / jnp.abs(dpt), 1.0)

    def operands(self):
        """Device pytree; merge into the Krylov ``operands`` argument."""
        return dict(mg_u=self.mg_u.operands(), mg_p=self.mg_p.operands(),
                    dpt_inv=self.dpt_inv)

    def psolve(self, r, ops):
        nu, np_ = self.nu, self.np_
        return jnp.concatenate([
            self.mg_u.apply(r[:nu], ops["mg_u"]),
            self.mg_p.apply(r[nu: nu + np_], ops["mg_p"]),
            ops["dpt_inv"] * r[nu + np_:],
        ])


class BiotSolverUPP:
    """Monolithic u-p-pt solver; ``solve`` returns (uh, ph, pth)."""

    def __init__(self, Vu: FunctionSpace, Vp: FunctionSpace,
                 Vpt: FunctionSpace, quadrature_degree=None, dtype=None):
        """``dtype``: device precision of the operator tensors and the
        Krylov loop (default: f64 under x64, else f32).  Large benches
        pass float32 and a matching rtol to halve the operator's memory."""
        assert Vu.family == "P" and Vu.block_size == 2
        assert Vp.family == "P" and Vp.block_size == 1
        assert Vpt.family == "P" and Vpt.block_size == 1
        assert Vu.degree == Vp.degree and Vpt.degree == Vu.degree - 1, \
            "reference pairing: u, p in CG_k; pt in CG_{k-1}"
        self.Vu, self.Vp, self.Vpt = Vu, Vp, Vpt
        self.dtype = dtype or (jnp.float64 if jnp.zeros(
            0).dtype == jnp.float64 else jnp.float32)
        msh = Vu.mesh
        ku = Vu.degree
        qdeg = quadrature_degree or 2 * ku
        pts, w = gauss_triangle(qdeg)
        K = msh.K
        adet = np.abs(msh.detJ)
        nc = len(K)

        tgu = Vu.element.tabulate_grad(pts)  # (ndu, 2, nq)
        gu = np.einsum("cba,ibq->ciaq", K, tgu)
        ndu = Vu.element.ndofs
        # 2 eps(u):eps(v)
        gg = np.einsum("q,ciaq,cjbq->ciajb", w, gu, gu)
        Auu = np.zeros((nc, ndu, 2, ndu, 2))
        gij = np.einsum("q,cixq,cjxq->cij", w, gu, gu)
        for a in range(2):
            Auu[:, :, a, :, a] += gij
        Auu += np.einsum("ciajb->cibja", gg)
        Auu *= adet[:, None, None, None, None]
        dt = self.dtype
        self.Ae_uu = jnp.asarray(Auu.reshape(nc, 2 * ndu, 2 * ndu), dt)

        tp = Vp.element.tabulate(pts)  # (ndp, nq)
        tgp = Vp.element.tabulate_grad(pts)
        gp = np.einsum("cba,ibq->ciaq", K, tgp)
        tpt = Vpt.element.tabulate(pts)  # (ndpt, nq)
        ndp, ndpt = Vp.element.ndofs, Vpt.element.ndofs

        # B[(j_pt),(i,a)] = int pt_j (grad u_i)_a    ((div u, v_pt))
        Be = np.einsum("q,jq,ciaq,c->cjia", w, tpt, gu, adet)
        self.Be = jnp.asarray(Be.reshape(nc, ndpt, 2 * ndu), dt)
        self.Me_pt = jnp.asarray(
            np.einsum("q,iq,jq,c->cij", w, tpt, tpt, adet), dt)
        self.Me_ppt = jnp.asarray(
            np.einsum("q,iq,jq,c->cij", w, tp, tpt, adet), dt)  # (nc, ndp, ndpt)
        Kp = np.einsum("q,ciaq,cjaq,c->cij", w, gp, gp, adet)
        Mp = np.einsum("q,iq,jq,c->cij", w, tp, tp, adet)
        self.Ke_p = jnp.asarray(Kp + Mp, dt)  # (K_p + M_p) acts together

        # dof tables ((i, a)-flattened for u, matching Ae_uu)
        cdu = Vu.cell_dofs.astype(np.int64)
        dofs_ia = np.empty((nc, 2 * ndu), dtype=np.int64)
        for i in range(ndu):
            for a in range(2):
                dofs_ia[:, i * 2 + a] = cdu[:, i] + a * Vu.ndofs_scalar
        self.cdu = jnp.asarray(dofs_ia, jnp.int32)
        self.cdp = jnp.asarray(Vp.cell_dofs, jnp.int32)
        self.cdpt = jnp.asarray(Vpt.cell_dofs, jnp.int32)
        self.nu, self.np_, self.npt = Vu.ndofs, Vp.ndofs, Vpt.ndofs
        self._qpts, self._qw = pts, w
        self._tabu = jnp.asarray(Vu.element.tabulate(pts), dt)
        self._tabp = jnp.asarray(tp, dt)

        du = jnp.zeros(self.nu, dt).at[self.cdu].add(
            jnp.einsum("cii->ci", self.Ae_uu))
        dp = jnp.zeros(self.np_, dt).at[self.cdp].add(
            jnp.einsum("cii->ci", self.Ke_p))
        dpt = jnp.zeros(self.npt, dt).at[self.cdpt].add(
            jnp.einsum("cii->ci", self.Me_pt))
        self.diag = jnp.concatenate([du, dp, dpt])

    def _operands(self):
        """Device arrays of the operator, passed into the jitted Krylov
        loop as ARGUMENTS (baking them in as constants lowers multi-GB
        programs and recompiles for every mesh)."""
        return dict(Ae_uu=self.Ae_uu, Be=self.Be, Me_pt=self.Me_pt,
                    Me_ppt=self.Me_ppt, Ke_p=self.Ke_p, cdu=self.cdu,
                    cdp=self.cdp, cdpt=self.cdpt)

    def matvec(self, x, ops=None):
        if ops is None:
            ops = self._operands()
        nu, np_ = self.nu, self.np_
        xu, xp, xpt = x[:nu], x[nu: nu + np_], x[nu + np_:]
        xue = xu[ops["cdu"]]
        xpe = xp[ops["cdp"]]
        xpte = xpt[ops["cdpt"]]
        yu = jnp.einsum("cij,cj->ci", ops["Ae_uu"], xue) - jnp.einsum(
            "cji,cj->ci", ops["Be"], xpte)
        yp = -jnp.einsum("cij,cj->ci", ops["Ke_p"], xpe) + jnp.einsum(
            "cij,cj->ci", ops["Me_ppt"], xpte)
        ypt = (
            -jnp.einsum("cij,cj->ci", ops["Be"], xue)
            + jnp.einsum("cji,cj->ci", ops["Me_ppt"], xpe)
            - jnp.einsum("cij,cj->ci", ops["Me_pt"], xpte)
        )
        return jnp.concatenate([
            jnp.zeros(self.nu, yu.dtype).at[ops["cdu"]].add(yu),
            jnp.zeros(self.np_, yp.dtype).at[ops["cdp"]].add(yp),
            jnp.zeros(self.npt, ypt.dtype).at[ops["cdpt"]].add(ypt),
        ])

    def load_vector(self, f_expr, g_expr):
        """rhs = [ (f, v_u), -(g, v_p), 0 ] (p-/pt-rows negated to keep the
        block system symmetric)."""
        msh = self.Vu.mesh
        f = as_expr(f_expr, msh)
        g = as_expr(g_expr, msh)
        fv = f.evaluate(self._qpts)  # (nc, nq, 2)
        gv = g.evaluate(self._qpts)[..., 0]  # (nc, nq)
        adet = jnp.abs(jnp.asarray(msh.detJ))
        wj = jnp.asarray(self._qw)
        be = adet[:, None, None] * jnp.einsum("q,cqa,iq->cia", wj, fv,
                                              self._tabu)
        bu = jnp.zeros(self.nu, self.dtype).at[self.cdu].add(
            be.reshape(len(adet), -1).astype(self.dtype))
        bpe = adet[:, None] * jnp.einsum("q,cq,iq->ci", wj, gv, self._tabp)
        bp = jnp.zeros(self.np_, self.dtype).at[self.cdp].add(
            bpe.astype(self.dtype))
        return jnp.concatenate([bu, -bp, jnp.zeros(self.npt, self.dtype)])

    def solve(self, f_expr, g_expr, dirichlet_facets, rtol=1e-12, atol=1e-14,
              maxiter=None, chunk=None, mg=None):
        """Homogeneous essential data u = 0, p = 0 on ``dirichlet_facets``
        (the reference testcase uses zero functions); pt is unconstrained.
        Returns (uh, ph, pth).

        ``mg``: an optional :class:`BiotMG` (or a nested mesh hierarchy to
        build one from) — block-multigrid preconditioning with
        mesh-independent iteration counts; requires ``dirichlet_facets`` to
        be the whole boundary.  Default: Jacobi."""
        Vu, Vp = self.Vu, self.Vp
        bscalar = locate_dofs_on_facets(
            FunctionSpace(Vu.mesh, "P", Vu.degree), dirichlet_facets)
        bdofs_u = np.concatenate(
            [bscalar + a * Vu.ndofs_scalar for a in range(2)])
        bdofs_p = self.nu + locate_dofs_on_facets(Vp, dirichlet_facets)
        free = np.ones(self.nu + self.np_ + self.npt, dtype=bool)
        free[bdofs_u] = False
        free[bdofs_p] = False

        x0 = jnp.zeros(self.nu + self.np_ + self.npt, self.dtype)
        b = self.load_vector(f_expr, g_expr)
        operands = self._operands()
        if mg is not None:
            if not isinstance(mg, BiotMG):
                mg = BiotMG(self, mg)
            if len(np.setdiff1d(self.Vu.mesh.boundary_facets,
                                np.asarray(dirichlet_facets))):
                raise ValueError(
                    "BiotMG assumes u/p essential on the whole boundary")
            Minv = mg.psolve
            operands = {**operands, **mg.operands()}
            if maxiter is None:
                maxiter = 400  # mesh-independent with the block V-cycle
        else:
            Minv = jnp.where(jnp.abs(self.diag) > 0,
                             1.0 / jnp.abs(self.diag), 1.0)
            if maxiter is None:
                maxiter = 90 * int(
                    np.sqrt(self.nu + self.np_ + self.npt) + 100)
        st = minres(self.matvec, b, x0, Minv, jnp.asarray(free),
                    rtol=rtol, atol=atol, maxiter=maxiter,
                    operands=operands, chunk=chunk)
        self.last_iterations = int(st["it"])
        self.last_residual = float(st["phibar"])
        x = st["x"]
        return (Function(Vu, x[: self.nu]),
                Function(Vp, x[self.nu: self.nu + self.np_]),
                Function(self.Vpt, x[self.nu + self.np_:]))


class _BiotStressRow(Expr):
    """Row i of sigma_h = -2 eps(u_h) + (pt_h - p_h) I (the negated total
    stress, reference ``perftest_basics.py:362``)."""

    def __init__(self, uh: Function, ph: Function, pth: Function, row: int):
        self.uh, self.ph, self.pth, self.row = uh, ph, pth, row
        self.mesh = uh.space.mesh
        self.value_size = 2

    def evaluate(self, q):
        g = self.uh.evaluate_grad(q)  # (nc, nq, 2, 2)
        eps = 0.5 * (g + jnp.swapaxes(g, -1, -2))
        p = self.ph.evaluate(q)[..., 0]
        pt = self.pth.evaluate(q)[..., 0]
        sig_row = -2.0 * eps[..., self.row, :]
        return sig_row.at[..., self.row].add(pt - p)


def biot_stress_row_expr(uh, ph, pth, row: int) -> Expr:
    return _BiotStressRow(uh, ph, pth, row)


class _DarcyFlux(Expr):
    """-grad p_h (unit mobility, reference ``perftest_basics.py:372``)."""

    def __init__(self, ph: Function):
        self.ph = ph
        self.mesh = ph.space.mesh
        self.value_size = 2

    def evaluate(self, q):
        return -self.ph.evaluate_grad(q)[..., 0, :]


def darcy_flux_expr(ph) -> Expr:
    return _DarcyFlux(ph)


class _FlowRHS(Expr):
    """g + pt_h - p_h: the divergence of the Darcy flux (mass balance,
    reference ``perftest_basics.py:368``)."""

    def __init__(self, g_expr, ph: Function, pth: Function):
        self.g = as_expr(g_expr, ph.space.mesh)
        self.ph, self.pth = ph, pth
        self.mesh = ph.space.mesh
        self.value_size = 1

    def evaluate(self, q):
        return (
            self.g.evaluate(q)[..., 0]
            + self.pth.evaluate(q)[..., 0]
            - self.ph.evaluate(q)[..., 0]
        )[..., None]


def biot_flow_rhs_expr(g_expr, ph, pth) -> Expr:
    return _FlowRHS(g_expr, ph, pth)


class _MomentumRHSRow(Expr):
    """(f - grad p_h)_i: divergence data of stress row i (reference
    ``perftest_basics.py:367``)."""

    def __init__(self, f_expr, ph: Function, row: int):
        self.f = as_expr(f_expr, ph.space.mesh)
        self.ph, self.row = ph, row
        self.mesh = ph.space.mesh
        self.value_size = 1

    def evaluate(self, q):
        fv = self.f.evaluate(q)[..., self.row]
        gp = self.ph.evaluate_grad(q)[..., 0, self.row]
        return (fv - gp)[..., None]


def biot_fields(uh, ph, pth, f_expr, g_expr, degree_eqlb: int):
    """(list_proj_flux, list_rhs): DG_{k-1} projections of the three
    physical fields and their divergence data, ready for
    ``FluxEqlbSE(degree_eqlb, msh, list_rhs, list_proj_flux,
    equilibrate_stress=True)``."""
    from ..fem.projection import local_projection

    msh = uh.space.mesh
    k = degree_eqlb
    Vdg2 = FunctionSpace(msh, "DG", k - 1, vs=2)
    Vdg1 = FunctionSpace(msh, "DG", k - 1, vs=1)
    flux_exprs = [
        biot_stress_row_expr(uh, ph, pth, 0),
        biot_stress_row_expr(uh, ph, pth, 1),
        darcy_flux_expr(ph),
    ]
    rhs_exprs = [
        _MomentumRHSRow(f_expr, ph, 0),
        _MomentumRHSRow(f_expr, ph, 1),
        biot_flow_rhs_expr(g_expr, ph, pth),
    ]
    return (local_projection(Vdg2, flux_exprs),
            local_projection(Vdg1, rhs_exprs))


def biot_bench_fields(msh, k: int, rtol=1e-10, maxiter=20000,
                      dtype=None, chunk=500, mg_meshes=None):
    """Bench-grade data for the multi-field configuration: solve the Biot
    primal problem on ``msh`` (reference RHS family) and return the dof
    arrays (d_proj (3, nc, 2, ndg), d_rhs (3, nc, ndg)) for
    EqlbEngine.equilibrate.

    f and g are projected into DG_{k-1} BEFORE the solve (like the repo's
    Poisson/elasticity test drivers): the equilibration's patch-ring
    compatibility then follows exactly from Galerkin orthogonality instead
    of holding only up to the primal quadrature error.

    Everything runs on the default device.  An f32 ``dtype`` pins full f32
    matmul precision for the solve and the projections, so their
    contractions never drop to TF32 on the GPU."""
    import jax

    from ..fem.expressions import expr_from_callable
    from ..fem.projection import local_projection

    Vu = FunctionSpace(msh, "P", k, vs=2)
    Vp = FunctionSpace(msh, "P", k)
    Vpt = FunctionSpace(msh, "P", k - 1)

    def f_expr(x):
        return np.stack([
            0.7 * np.sin(1.5 * np.pi * x[..., 0])
            * 1.5 * np.cos(0.7 * np.pi * x[..., 1]),
            0.7 * np.cos(1.5 * np.pi * x[..., 0])
            * 1.5 * np.sin(0.7 * np.pi * x[..., 1]),
        ], axis=-1)

    def g_expr(x):
        return (1.5 * np.sin(0.7 * np.pi * x[..., 0])
                * 1.5 * np.sin(0.7 * np.pi * x[..., 1]))[..., None]

    Vdg2 = FunctionSpace(msh, "DG", k - 1, vs=2)
    Vdg1 = FunctionSpace(msh, "DG", k - 1, vs=1)
    with jax.default_matmul_precision("float32"):
        solver = BiotSolverUPP(Vu, Vp, Vpt, dtype=dtype)
        fe = local_projection(
            Vdg2, [expr_from_callable(f_expr, msh, value_size=2)],
            quadrature_degree=2 * k + 6)[0]
        ge = local_projection(
            Vdg1, [expr_from_callable(g_expr, msh, value_size=1)],
            quadrature_degree=2 * k + 6)[0]
        mg = BiotMG(solver, mg_meshes) if mg_meshes is not None else None
        uh, ph, pth = solver.solve(fe, ge, msh.boundary_facets, rtol=rtol,
                                   maxiter=maxiter, chunk=chunk, mg=mg)
        proj_flux, rhs = biot_fields(uh, ph, pth, fe, ge, k)

    ndg = k * (k + 1) // 2
    nc = msh.num_cells
    d_proj = np.stack([
        np.asarray(f.x).reshape(2, nc, -1).transpose(1, 0, 2)
        for f in proj_flux
    ])
    d_rhs = np.stack([np.asarray(f.x).reshape(nc, -1) for f in rhs])
    if d_proj.shape[-1] < ndg:
        pad = ndg - d_proj.shape[-1]
        d_proj = np.pad(d_proj, ((0, 0), (0, 0), (0, 0), (0, pad)))
        d_rhs = np.pad(d_rhs, ((0, 0), (0, 0), (0, ndg - d_rhs.shape[-1])))
    return d_proj, d_rhs
