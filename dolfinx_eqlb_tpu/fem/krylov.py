"""Matrix-free Krylov solvers for the primal problems (device-resident).

The reference solves its primal systems with PETSc (CG+BoomerAMG, MUMPS,
superlu_dist — ``python/test/performance/perftest_basics.py:34-160``); the
equivalents here are matrix-free jitted Krylov loops over batched
per-cell einsum matvecs: CG for SPD systems (models.poisson), MINRES for
the symmetric-indefinite mixed formulations (Herrmann elasticity,
Biot poro-elasticity)."""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["minres"]


def minres(matvec, b, x0, Minv, free, rtol=1e-12, atol=1e-14, maxiter=1000,
           operands=None, chunk=None):
    """Preconditioned MINRES (Paige & Saunders) on the free dofs.

    ``matvec`` is the raw operator; essential dofs are handled by
    projection: the iteration runs on r0 = free * (b - A x0) and keeps the
    constrained components of x fixed at x0.  ``Minv`` is either a vector
    (Jacobi: z = Minv * r) or a callable ``(r, operands) -> z`` applying an
    SPD operator on the free dofs (e.g. a block-diagonal geometric-multigrid
    V-cycle, ``fem.multigrid.GeometricMG`` — the device-resident stand-in for the
    reference's BoomerAMG preconditioner,
    ``python/test/performance/perftest_basics.py:34-160``); it must be a
    FIXED linear operator for the Lanczos recurrence to remain valid.
    Returns the state dict (x, phibar = preconditioned residual norm, it).

    ``operands``: optional pytree of device arrays the operator reads,
    called as ``matvec(v, operands)`` — REQUIRED for large systems so the
    element tensors enter the jitted loop as arguments, not as baked-in
    constants (multi-GB lowerings, and one compile per mesh).

    ``chunk``: bound each device dispatch to this many iterations and loop
    on the host, carrying the full Lanczos state, so that no single device
    execution runs unbounded over a multi-M-dof system.  Whether anything
    still needs this is open (ROADMAP item 3.4)."""
    def apply(v, ops):
        return matvec(v) if ops is None else matvec(v, ops)

    if callable(Minv):
        # the operator's tables ride inside ``operands``; Mv is a dummy so the
        # jitted signatures stay uniform with the Jacobi path
        def applyM(r, ops, Mv, M=Minv):
            return M(r, ops)

        Minv = jnp.zeros(0, b.dtype)
    else:
        def applyM(r, ops, Mv):
            return Mv * r

    def init(x0, b, Minv, free, ops):
        r0 = jnp.where(free, b - apply(x0, ops), 0.0)
        y = applyM(r0, ops, Minv)
        beta1 = jnp.sqrt(jnp.dot(r0, y))
        st0 = dict(
            x=x0, r=r0, r_old=jnp.zeros_like(r0), y=y,
            y_old=jnp.zeros_like(r0), beta=beta1, beta_old=1.0,
            dbar=0.0, epsln=0.0, cs=-1.0, sn=0.0, phibar=beta1,
            w_old=jnp.zeros_like(r0), w_old2=jnp.zeros_like(r0), it=0,
        )
        return st0, beta1 + atol

    def run(st0, bnorm, it_stop, Minv, free, ops):
        def Aop(v):
            return jnp.where(free, apply(jnp.where(free, v, 0.0), ops), 0.0)

        def cond(st):
            return (st["phibar"] > rtol * bnorm + atol) & (st["it"] < it_stop)

        def body(st):
            v = st["y"] / st["beta"]
            Av = Aop(v)
            alfa = jnp.dot(v, Av)
            ynew = applyM(Av, ops, Minv) - (alfa / st["beta"]) * st["y"] \
                - (st["beta"] / st["beta_old"]) * st["y_old"]
            rnew = Av - (alfa / st["beta"]) * st["r"] \
                - (st["beta"] / st["beta_old"]) * st["r_old"]
            beta_new = jnp.sqrt(
                jnp.maximum(jnp.dot(rnew, ynew), 0.0) + 1e-300
            )
            # QR via Givens
            dbar, epsln = st["dbar"], st["epsln"]
            oldeps = epsln
            delta = st["cs"] * dbar + st["sn"] * alfa
            gbar = st["sn"] * dbar - st["cs"] * alfa
            epsln = st["sn"] * beta_new
            dbar = -st["cs"] * beta_new
            gamma = jnp.sqrt(gbar**2 + beta_new**2) + 1e-300
            cs = gbar / gamma
            sn = beta_new / gamma
            phi = cs * st["phibar"]
            phibar = sn * st["phibar"]
            w = (v - oldeps * st["w_old2"] - delta * st["w_old"]) / gamma
            x = st["x"] + phi * w
            return dict(
                x=x, r=rnew, r_old=st["r"], y=ynew, y_old=st["y"],
                beta=beta_new, beta_old=st["beta"], dbar=dbar,
                epsln=epsln, cs=cs, sn=sn, phibar=phibar,
                w_old=w, w_old2=st["w_old"], it=st["it"] + 1,
            )

        return jax.lax.while_loop(cond, body, st0)

    free = jnp.asarray(free)
    st, bnorm = jax.jit(init)(x0, b, Minv, free, operands)
    jrun = jax.jit(run)
    if not chunk:
        return jrun(st, bnorm, jnp.int32(maxiter), Minv, free, operands)
    tol = rtol * float(bnorm) + atol
    it = 0
    while it < maxiter:
        it_stop = min(it + chunk, maxiter)
        # it_stop rides as a device scalar so every chunk reuses one
        # compiled executable
        st = jrun(st, bnorm, jnp.int32(it_stop), Minv, free, operands)
        it = int(st["it"])  # host sync bounds the device dispatch length
        if float(st["phibar"]) <= tol or it < it_stop:
            break
    return st
