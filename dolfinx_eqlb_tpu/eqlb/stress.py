"""Weakly symmetric stress equilibration.

After the row-wise flux equilibration of the first gdim stress rows, every
patch contribution (sigma_z0, sigma_z1) receives divergence-free, zero-trace
corrections (Delta_0, Delta_1) minimising sum_j ||sigma_zj + Delta_j|| under
the patch-local weak-symmetry constraint

    ((sigma_z + Delta)_01 - (sigma_z + Delta)_10, hat_v) = 0
                      for every continuous-P1 hat on the patch,

(reference ``se/stressmin_kernel.hpp:118-236`` assembles exactly these
blocks; ``se/solve_patch_weaksym.hpp`` solves them via a Schur complement).
Because each patch constrains its *own* hat-weighted contribution and every
global P1 test function restricted to a patch is a patch hat, the corrected
sum satisfies the global weak-symmetry condition — patches stay independent
and the solve batches exactly like the flux solve.

A scalar multiplier relaxes the constant-mode constraint (reference
``stressmin_kernel.hpp:225-235`` Ce column): for interior / pure-Neumann
patches the constant mode is redundant — its data vanishes by the rotational
Galerkin orthogonality of the primal solve (which is why stress equilibration
requires primal degree >= 2, reference ``se/reconstruction.hpp:357-388``).

KKT layout per patch (F = patch flux dofs, G = n*ndg, C = patch P1 nodes):
  [ M         -Bdiv^T           B1^T      ] [D0]   [-M c0]
  [      M            -Bdiv^T   B2^T      ] [D1]   [-M c1]
  [ Bdiv                    cp            ] [r0] = [ 0  ]
  [      Bdiv                   cp        ] [r1]   [ 0  ]
  [ B1   B2                          ch   ] [uc]   [-B1 c0 - B2 c1]
  [            cp^T                       ] [l0]   [ 0 ]
  [                   cp^T                ] [l1]   [ 0 ]
  [                        ch^T           ] [lc]   [ 0 ]
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

__all__ = ["weak_symmetry_bucket"]


def _bsym_canonical(engine, key, dv, refd):
    """Weak-symmetry coupling tensor Bsym[p, c, hat_slot, comp, slot] =
    int hat (Phi_slot)_comp dx in canonical per-cell order."""
    dt = engine.dtype
    J, detJ = dv["J"], dv["detJ"]
    sdet = jnp.sign(detJ)
    perm, signs = dv["perm"], dv["signs"]
    lv = dv["lv_hats"]  # (P, n, 3) local vertex index per hat slot
    Bsym = None
    for l in range(3):
        JR = jnp.einsum("pcab,bi->pcai", J, refd["Rlam"][l])  # (P,n,2,nrt)
        wl = (lv == l).astype(dt)  # (P, n, 3)
        term = wl[..., None, None] * JR[:, :, None]  # (P,n,3,2,nrt)
        Bsym = term if Bsym is None else Bsym + term
    Bsym = jnp.take_along_axis(Bsym, perm[:, :, None, None, :], axis=4)
    return Bsym * (sdet[..., None, None, None] * signs[:, :, None, None, :])


def weak_symmetry_bucket(engine, key, sol2, facet_kind2, d_proj2, dv, refd):
    if engine.mode == "semiexplicit":
        return weak_symmetry_bucket_reduced(
            engine, key, sol2, facet_kind2, d_proj2, dv, refd
        )
    return _weak_symmetry_bucket_kkt(
        engine, key, sol2, facet_kind2, d_proj2, dv, refd
    )


# ---------------------------------------------------------------------------
# batch-last reduced stress path with geometry caches
# ---------------------------------------------------------------------------


def bsym_combo_tensors(k: int):
    """Per-combo weak-symmetry reference tensors BsymC (6, 3, 2, nkeep):
    hat-slot l of a patch cell (0 = the patch vertex, 1 = entry-spoke end,
    2 = exit-spoke end) maps to a local vertex determined by the combo, and
    the canonical dof permutation is the combo's."""
    from ..elements.quadrature import LOCAL_EDGE_VERTICES as LOC
    from .engine import reference_tensors
    from .semiexplicit import _perm_q

    Rlam = reference_tensors(k)["Rlam"]  # (3, 2, nrt)
    nkeep = 2 * k + k * (k - 1)
    out = np.zeros((6, 3, 2, nkeep))
    for q in range(6):
        ln, pq = _perm_q(q, k)
        o = q % 2
        e1 = (ln + 1) % 3 if o == 0 else (ln + 2) % 3
        e2 = (ln + 2) % 3 if o == 0 else (ln + 1) % 3
        ends = []
        for e in (e1, e2):
            pair = LOC[e]
            ends.append(pair[1] if pair[0] == ln else pair[0])
        for slot, v in enumerate([ln, ends[0], ends[1]]):
            out[q, slot] = Rlam[v][:, pq]
    return out


def build_stress_cache(engine, key, dv, refd):
    """Geometry-only stress-system cache for one bucket (batch-last).

    The reduced weak-symmetry KKT matrix

        S = [ A_z        (B1 Z)^T ]      (D = 2 Dz + C + 1)
            [      A_z   (B2 Z)^T ]
            [ B1 Z B2 Z     ch    ]

    depends only on geometry.  Interior buckets also cache the constraint
    columns of S^{-1} (the per-call load has entries only in the C
    constraint rows), so the steady-state stress correction is one small
    contraction; boundary buckets keep S and re-mask per call."""
    from .semiexplicit import reduced_system_bl

    b = engine.buckets[key]
    t = engine.tables[key]
    st = engine.se_static[key]
    k = engine.k
    n, ns = b.ncells, b.nspokes
    P = dv["J_bl"].shape[-1]
    dt = engine.dtype
    Dz = st["Dz"]
    C = t["np1"]
    D = 2 * Dz + C + 1
    ilc = 2 * Dz + C

    J = dv["J_bl"]
    detJ = dv["detJ_bl"]
    adet = jnp.abs(detJ)
    sdet = jnp.sign(detJ)
    signs = dv["signs_bl"]
    BsymC = refd["BsymC"]

    # Bsym_bl (n, 3, 2, nkeep, P)
    Bsym = None
    for q in range(6):
        wq = (dv["combo_bl"] == q).astype(dt)  # (n, P)
        Jw = jnp.einsum("cabx,cx->cabx", J, wq)
        term = jnp.einsum("cabx,lbi->claix", Jw, BsymC[q])
        Bsym = term if Bsym is None else Bsym + term
    Bsym = Bsym * (sdet[:, None, None, None] * signs[:, None, None])

    Az = dv["Az_bl"]
    S = jnp.zeros((D, D, P), dt)
    S = S.at[:Dz, :Dz].set(Az)
    S = S.at[Dz : 2 * Dz, Dz : 2 * Dz].set(Az)

    p1idx = t["p1_idx"]
    U = st["uslots"]
    d0 = dv["cumalpha_bl"]
    for i in range(n):
        B1 = Bsym[i, :, 1]  # (3, nkeep, P)
        B2 = -Bsym[i, :, 0]
        wen = d0[i]
        wex = d0[st["exit_idx"][i]]
        rows = 2 * Dz + p1idx[i]
        for comp, Bi in ((0, B1), (1, B2)):
            off = comp * Dz
            bi0 = Bi[:, 0] * wen + Bi[:, k] * wex  # (3, P)
            S = S.at[rows, off].add(bi0)
            S = S.at[off, rows].add(bi0)
            if len(U):
                cols = off + st["ucols"][i]
                S = S.at[rows[:, None], cols[None, :]].add(Bi[:, U])
                S = S.at[cols[:, None], rows[None, :]].add(
                    jnp.swapaxes(Bi[:, U], 0, 1)
                )
        hi = jnp.broadcast_to(adet[i] / 6.0, (3, P))
        S = S.at[rows, ilc].add(hi)
        S = S.at[ilc, rows].add(hi)

    if not b.is_boundary:
        # constraint columns of S^{-1} restricted to the flux rows; S itself
        # is not needed at runtime for interior buckets (keeping it costs
        # ~3 GB at 1M cells)
        E = jnp.zeros((D, C, P), dt)
        E = E.at[2 * Dz + jnp.arange(C), jnp.arange(C)].set(1.0)
        X = engine._dense_solve_bl(S, E)  # (D, C, P)
        return {"Sinv_c": X[: 2 * Dz], "Bsym_bl": Bsym}
    return {"S_stress": S, "Bsym_bl": Bsym}


def weak_symmetry_bucket_bl(engine, key, sol2_bl, facet_kind2, dv, refd,
                            skip=None):
    """Batch-last weak-symmetry correction -> (2, nflux, P) deltas.

    sol2_bl (2, nflux, P): the equilibrated stress-row patch dofs.  The
    flux-block load vanishes by optimality of the flux solve, so the only
    data is the constraint residual g_h = -(B1 c0 + B2 c1)_h."""
    b = engine.buckets[key]
    t = engine.tables[key]
    st = engine.se_static[key]
    k = engine.k
    n, ns = b.ncells, b.nspokes
    P = dv["J_bl"].shape[-1]
    dt = engine.dtype
    Dz = st["Dz"]
    C = t["np1"]
    D = 2 * Dz + C + 1
    ilc = 2 * Dz + C
    kk1 = engine.V.element.ndofs_cell
    nflux = ns * k + n * kk1

    Bsym = dv["Bsym_bl"]  # (n, 3, 2, nkeep, P)
    pidx = t["patch_idx"]
    p1idx = t["p1_idx"]
    g = jnp.zeros((C, P), dt)
    nkeep = Bsym.shape[3]
    for i in range(n):
        c0 = sol2_bl[0][pidx[i]]  # (nkeep, P)
        c1 = sol2_bl[1][pidx[i]]
        B1 = Bsym[i, :, 1]
        B2 = -Bsym[i, :, 0]
        # unrolled s-contraction: the (3, nkeep) dot_general tile-pads the
        # MXU 20-40x at these sizes (same pathology as the load-moment and
        # JtJ einsums); explicit lane-wise FMAs stay on the VPU
        acc = None
        for s in range(nkeep):
            t_ = B1[:, s] * c0[s][None] + B2[:, s] * c1[s][None]
            acc = t_ if acc is None else acc + t_
        g = g.at[p1idx[i]].add(-acc)

    if not b.is_boundary and "Sinv_c" in dv:
        Sinv_c = dv["Sinv_c"]
        yf = None  # (2Dz, P); unrolled h-contraction (see above)
        for h in range(C):
            t_ = Sinv_c[:, h] * g[h][None]
            yf = t_ if yf is None else yf + t_
        if skip is not None:
            # grouped patches get their correction jointly (eqlb.grouping)
            yf = jnp.where(skip[None], 0.0, yf)
        y0, y1 = yf[:Dz], yf[Dz:]
    else:
        # boundary: mask essential flux columns / multiplier, then solve
        from .semiexplicit import z_mask_bl

        S = dv["S_stress"]
        bsp = dv["bspokes"]
        ess = facet_kind2[:, bsp] == 2  # (2, P, 2)
        fr = z_mask_bl(engine, key, jnp.moveaxis(ess, 1, -1))  # (2, Dz, P)
        free = jnp.ones((D, P), dtype=bool)
        free = free.at[:Dz].set(fr[0])
        free = free.at[Dz : 2 * Dz].set(fr[1])
        free = free.at[ilc].set(ess.all(axis=(0, 2)))
        if skip is not None:
            # grouped patches: identity system -> zero correction here
            free = free & (~skip)[None]
        ff = free[:, None] & free[None, :]
        eye = jnp.eye(D, dtype=dt)
        Sr = jnp.where(ff, S, 0.0) + eye[..., None] * (~free)[None]
        # Mixed-row traction patches (one row pure-traction, another with
        # free boundary spokes) can leave the constant constraint mode
        # v = 1/sqrt(C) on the multiplier rows structurally unreachable —
        # the masked system is rank-1 deficient with null vector exactly v
        # (the reference's Eigen LDLT tolerates the consistent singular
        # Schur complement, PatchData.hpp:598-638; exact LU NaNs).  Detect
        # ||Sr v|| ~ 0 per patch and apply the exact rank-1 regularization
        # alpha v v^T — on consistent data this selects the solution with
        # zero null component and perturbs nothing else.
        # float(): a np.float64 scalar is strongly typed and poisons the
        # where/scatter to f64 under an f32 engine (FutureWarning -> error)
        v = jnp.zeros((D, P), dt).at[2 * Dz : 2 * Dz + C].set(
            jnp.where(free[2 * Dz : 2 * Dz + C], float(1.0 / np.sqrt(C)), 0.0)
        )
        Sv = None
        for j in range(2 * Dz, 2 * Dz + C):
            t_ = Sr[:, j] * v[j][None]
            Sv = t_ if Sv is None else Sv + t_
        diag_scale = sum(jnp.abs(Sr[j, j]) for j in range(D)) / D
        sing = (
            jnp.sqrt(jnp.sum(Sv * Sv, axis=0))
            < 1e-6 * (diag_scale + 1e-30)
        ).astype(dt)
        Sr = Sr + (sing * diag_scale)[None, None] * v[:, None] * v[None]
        rhs = jnp.zeros((D, P), dt).at[2 * Dz : 2 * Dz + C].set(g)
        rhs = jnp.where(free, rhs, 0.0)
        y = engine._dense_solve_bl(Sr, rhs[:, None, :])[:, 0]  # (D, P)
        y0, y1 = y[:Dz], y[Dz : 2 * Dz]

    delta = jnp.zeros((2, nflux, P), dt)
    cum = dv["cumalpha_bl"]
    for row, yr in ((0, y0), (1, y1)):
        if Dz > 1:
            delta = delta.at[row, st["sel"]].add(yr[1:])
        delta = delta.at[row, 0 : ns * k : k].add(yr[0][None] * cum)
    return delta


def weak_symmetry_bucket_reduced(engine, key, sol2, facet_kind2, d_proj2, dv, refd):
    """Reduced weak-symmetry correction: both stress rows' corrections live
    in the explicit divergence-free patch basis Z (``eqlb.semiexplicit``), so
    the per-patch system is

        [ A_z        (B1 Z)^T ] [y'_0]   [ 0 ]
        [      A_z   (B2 Z)^T ] [y'_1] = [ 0 ]
        [ B1 Z B2 Z     ch    ] [ mu ]   [ -B1 c0 - B2 c1 ]

    of dimension 2 Dz + (1+ns) + 1 instead of the full KKT's 2F + 2G + C + 3
    (22 vs 95 at RT2 on a 6-cell patch).  The flux-block load vanishes by
    optimality of the flux solve over the same (masked) space Z; divergence
    constraints hold by construction of Z (no DG blocks, no per-row mean
    multipliers).  Same blocks as the reference's stress minimisation
    (``se/stressmin_kernel.hpp:118-236``) after static condensation.
    """
    from .semiexplicit import reduced_flux_system, z_mask_bl

    b = engine.buckets[key]
    t = engine.tables[key]
    st = engine.se_static[key]
    k = engine.k
    n, ns = b.ncells, b.nspokes
    P = dv["J"].shape[0]
    dt = engine.dtype
    Dz = st["Dz"]
    C = t["np1"]
    D = 2 * Dz + C + 1
    ilc = 2 * Dz + C
    kk1 = engine.V.element.ndofs_cell
    nflux = ns * k + n * kk1

    zeros2 = jnp.zeros_like(d_proj2)
    Mc, _Bc, _Fv, _Fq = engine._element_data(
        key, d_proj2, zeros2[..., 0, :], dv, refd
    )
    Az, _ = reduced_flux_system(engine, key, Mc, dv)
    Bsym = _bsym_canonical(engine, key, dv, refd)
    adet = jnp.abs(dv["detJ"])

    A = jnp.zeros((P, D, D), dt)
    A = A.at[:, :Dz, :Dz].set(Az)
    A = A.at[:, Dz : 2 * Dz, Dz : 2 * Dz].set(Az)
    rhs = jnp.zeros((P, D), dt)

    pidx = t["patch_idx"]
    p1idx = t["p1_idx"]
    U = st["uslots"]
    d0 = dv["cumalpha_bl"].T  # (P, ns)
    for i in range(n):
        B1 = Bsym[:, i, :, 1, :]  # (P, 3, nkeep)
        B2 = -Bsym[:, i, :, 0, :]
        wen = d0[:, i]
        wex = d0[:, st["exit_idx"][i]]
        rows = 2 * Dz + p1idx[i]  # (3,) static
        for comp, Bi in ((0, B1), (1, B2)):
            off = comp * Dz
            # d0 column
            bi0 = Bi[:, :, 0] * wen[:, None] + Bi[:, :, k] * wex[:, None]
            A = A.at[:, rows, off].add(bi0)
            A = A.at[:, off, rows].add(bi0)
            if len(U):
                cols = off + st["ucols"][i]
                A = A.at[:, rows[:, None], cols[None, :]].add(Bi[:, :, U])
                A = A.at[:, cols[:, None], rows[None, :]].add(
                    jnp.swapaxes(Bi[:, :, U], 1, 2)
                )
        # multiplier column int hat_h = |detJ|/6 per touched node
        hi = jnp.repeat(adet[:, i, None] / 6.0, 3, axis=1)
        A = A.at[:, rows, ilc].add(hi)
        A = A.at[:, ilc, rows].add(hi)
        # constraint data from the equilibrated stress rows
        c0 = sol2[0][:, pidx[i]]
        c1 = sol2[1][:, pidx[i]]
        rhs = rhs.at[:, rows].add(
            -jnp.einsum("phi,pi->ph", B1, c0)
            - jnp.einsum("phi,pi->ph", B2, c1)
        )

    # --- essential masking + multiplier activation ---------------------------
    free = jnp.ones((P, D), dtype=bool)
    if b.is_boundary:
        bsp = dv["bspokes"]
        ess = facet_kind2[:, bsp] == 2  # (2, P, 2)
        fr_bl = z_mask_bl(engine, key, jnp.moveaxis(ess, 1, -1))  # (2,Dz,P)
        for row in (0, 1):
            free = free.at[:, row * Dz : (row + 1) * Dz].set(fr_bl[row].T)
        lam_on = ess.all(axis=(0, 2))  # (P,)
    else:
        lam_on = jnp.ones((P,), dtype=bool)
    free = free.at[:, ilc].set(lam_on)

    ff = free[:, :, None] & free[:, None, :]
    eye = jnp.eye(D, dtype=dt)
    Ar = jnp.where(ff, A, 0.0) + eye * (~free)[..., None]
    br = jnp.where(free, rhs, 0.0)
    y = engine._dense_solve(Ar, br[..., None])[..., 0]  # (P, D)

    delta = jnp.zeros((2, P, nflux), dt)
    for row in (0, 1):
        yr = y[:, row * Dz : (row + 1) * Dz]
        if Dz > 1:
            delta = delta.at[row, :, st["sel"]].add(yr[:, 1:].T)
        delta = delta.at[row, :, 0 : ns * k : k].add(
            yr[:, 0:1] * d0
        )
    return delta


def _weak_symmetry_bucket_kkt(engine, key, sol2, facet_kind2, d_proj2, dv, refd):
    """Corrections for the two stress rows of one bucket.

    The objective minimises the *corrector* norm || (sigma_z - psi sigma_proj)
    + Delta || (reference ``stressmin_kernel.hpp:186-195`` loads
    -(sigma_r, phi) with sigma_r the step-1/2 corrector), so the flux load is
    -M c_row + (psi sigma_proj, phi).  The symmetry-constraint data may use
    sigma_z directly: the hat-weighted projected stress is pointwise
    symmetric, so its antisymmetric part vanishes.

    Args:
      engine: the EqlbEngine
      key: bucket key
      sol2 (2, P, nflux): patch-local flux solutions of stress rows 0, 1
      facet_kind2 (2, nf): facet kinds of the two rows
      d_proj2 (2, nc, 2, ndg): projected-stress row dofs (for the psi-moment)
      dv/refd: device-resident bucket tables / reference tensors (passed as
        jit arguments, see engine docstring)
    Returns (2, P, nflux) corrections.
    """
    b = engine.buckets[key]
    t = engine.tables[key]
    k = engine.k
    el = engine.V.element
    kk1 = el.ndofs_cell
    ndg = k * (k + 1) // 2
    n, ns = b.ncells, b.nspokes
    P = dv["J"].shape[0]  # padded patch count
    F = ns * k + n * kk1
    G = n * ndg
    C = t["np1"]

    dt = engine.dtype
    J, detJ = dv["J"], dv["detJ"]
    adet = jnp.abs(detJ)
    sdet = jnp.sign(detJ)
    perm, signs = dv["perm"], dv["signs"]

    # element mass in canonical order (same as the flux solve)
    JtJ = jnp.einsum("pcka,pckb->pcab", J, J)
    Mgeo = jnp.einsum("pcab,abij->pcij", JtJ, refd["Mhat"])
    Mgeo = Mgeo / adet[..., None, None]
    Mc = jnp.take_along_axis(Mgeo, perm[..., None], axis=2)
    Mc = jnp.take_along_axis(Mc, perm[..., None, :], axis=3)
    Mc = Mc * signs[..., :, None] * signs[..., None, :]

    Dg = refd["Dhat"][perm]
    Bc = sdet[..., None, None] * Dg * signs[..., None]  # (P,n,nkeep,ndg)

    # weak-symmetry coupling: Bsym[p,c,hat,a,idof]
    #   int hat_l (Phi_i)_a dx = sdet J_ab Rlam[l, b, i]
    # one-hot blend over the 3 local hat indices (avoids tiny-dim gathers)
    lv = dv["lv_hats"]  # (P, n, 3) local vertex index per hat slot
    Bsym = None
    for l in range(3):
        JR = jnp.einsum("pcab,bi->pcai", J, refd["Rlam"][l])  # (P,n,2,nrt)
        wl = (lv == l).astype(dt)  # (P, n, 3)
        term = wl[..., None, None] * JR[:, :, None]  # (P,n,3,2,nrt)
        Bsym = term if Bsym is None else Bsym + term
    Bsym = jnp.take_along_axis(Bsym, perm[:, :, None, None, :], axis=4)
    Bsym = Bsym * (sdet[..., None, None, None] * signs[:, :, None, None, :])

    cpen = refd["cpen"]

    # hat-weighted projected-stress moments Fv (canonical, like the engine)
    dp = d_proj2[:, dv["cells"]]  # (2, P, n, 2, ndg)
    Rh = refd["Rhat"][dv["lnode"]]  # (P, n, ndg, 2, nrt)
    Fv_full = jnp.einsum("rpcam,pcab,pcmbi->rpci", dp, J, Rh)
    Fv_full = Fv_full * sdet[None, ..., None]
    Fv = jnp.take_along_axis(Fv_full, perm[None].repeat(2, 0), axis=3) * signs[None]

    D = 2 * F + 2 * G + C + 3
    A = jnp.zeros((P, D, D), dt)
    rhs = jnp.zeros((P, D), dt)
    pidx = t["patch_idx"]
    p1idx = t["p1_idx"]
    iuc = 2 * F + 2 * G
    il0, il1, ilc = iuc + C, iuc + C + 1, iuc + C + 2

    c0 = sol2[0]
    c1 = sol2[1]

    for i in range(n):
        ix = pidx[i]
        for row in (0, 1):
            off_f = row * F
            off_r = 2 * F + row * G
            fx = off_f + ix
            qr = off_r + i * ndg + np.arange(ndg)
            A = A.at[:, fx[:, None], fx[None, :]].add(Mc[:, i])
            A = A.at[:, qr[:, None], fx[None, :]].add(jnp.swapaxes(Bc[:, i], 1, 2))
            A = A.at[:, fx[:, None], qr[None, :]].add(-Bc[:, i])
            lam = il0 if row == 0 else il1
            A = A.at[:, qr, lam].add(adet[:, i, None] * cpen[None, :])
            A = A.at[:, lam, qr].add(adet[:, i, None] * cpen[None, :])
            # L_flux = -(sigma_z - psi sigma_proj, phi) = -M c_row + Fv_row
            cloc = (c0 if row == 0 else c1)[:, ix]
            rhs = rhs.at[:, fx].add(
                Fv[row, :, i] - jnp.einsum("pij,pj->pi", Mc[:, i], cloc)
            )
        # symmetry constraint rows: B1 = +y-component, B2 = -x-component
        uc = iuc + p1idx[i]
        B1 = Bsym[:, i, :, 1, :]  # (P, 3, nkeep)
        B2 = -Bsym[:, i, :, 0, :]
        A = A.at[:, uc[:, None], (0 * F + pidx[i])[None, :]].add(B1)
        A = A.at[:, uc[:, None], (1 * F + pidx[i])[None, :]].add(B2)
        A = A.at[:, (0 * F + pidx[i])[:, None], uc[None, :]].add(
            jnp.swapaxes(B1, 1, 2)
        )
        A = A.at[:, (1 * F + pidx[i])[:, None], uc[None, :]].add(
            jnp.swapaxes(B2, 1, 2)
        )
        A = A.at[:, uc, ilc].add(_hat_int(adet[:, i]))
        A = A.at[:, ilc, uc].add(_hat_int(adet[:, i]))
        # L_c = -(B1 c0 + B2 c1)
        rhs = rhs.at[:, uc].add(
            -jnp.einsum("phi,pi->ph", B1, c0[:, pidx[i]])
            - jnp.einsum("phi,pi->ph", B2, c1[:, pidx[i]])
        )

    # --- essential conditions -------------------------------------------------
    mask = jnp.zeros((P, D), dtype=bool)
    if b.is_boundary:
        bsp = dv["bspokes"]  # (P, 2)
        kind = facet_kind2[:, bsp]  # (2, P, 2)
        ess = kind == 2
        for row in (0, 1):
            for e, sp in enumerate((0, ns - 1)):
                cols = row * F + sp * k + np.arange(k)
                mask = mask.at[:, cols].set(ess[row, :, e : e + 1])
        all_ess = ess.all(axis=(0, 2))  # (P,)
        lam_rows = {il0: ess[0].all(axis=1), il1: ess[1].all(axis=1), ilc: all_ess}
    else:
        ones = jnp.ones((P,), dtype=bool)
        lam_rows = {il0: ones, il1: ones, ilc: ones}
    for lam, on in lam_rows.items():
        mask = mask.at[:, lam].set(~on)

    eye = jnp.eye(D, dtype=dt)
    Ar = jnp.where(mask[..., None], eye[None], A)
    br = jnp.where(mask, 0.0, rhs)
    # the weak-symmetry KKT has nested singular Schur blocks; keep the
    # pivoting XLA LU here (it is not the throughput hot path)
    sol = jnp.linalg.solve(Ar, br[..., None])[..., 0]
    return jnp.stack([sol[:, :F], sol[:, F : 2 * F]])


def _hat_int(adet_i):
    """int of one hat over a cell = |detJ| / 6, as a column (P, 3)."""
    return jnp.repeat(adet_i[:, None] / 6.0, 3, axis=1)
