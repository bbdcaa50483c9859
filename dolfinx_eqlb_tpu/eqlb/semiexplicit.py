"""Semi-explicit patch equilibration: explicit step + reduced H(div=0) solve.

Batched re-design of the reference's SE fast path
(``se/solve_patch_semiexplt.hpp:211-1163``): instead of solving the full
per-patch KKT system (flux mass + divergence constraints + multiplier,
dimension 42-57 at RT2), exploit the *structure of the hierarchic RT
element* (``elements/rt.py``): its divergence moments against the Dubiner
DG_{k-1} basis are

    (div phi_i, dub_p)_ref = 0                   except
    (div phi_{e,0}, dub_0) = S_e (= +-sqrt(2))   facet-constant dofs
    (div phi_{div,t}, dub_{1+t}) = 1             divergence cell dofs

so the divergence constraints of a patch problem are solved *explicitly*:

  Step 1a: divergence cell dofs   sigma_div[i,t] = sdet_i * Fq[i,1+t]
  Step 1b: spoke constant moments from the ring recursion
             b_en_i sigma0(spoke_i) + b_ex_i sigma0(spoke_{i+1}) = Fq[i,0]
           (the reference's facet-moment recursion).  Its solution is a
           masked outer product, sigma0_j = cumalpha_j * sum_{i<j} gamma_i
           Fq0_i (+ pinned start), i.e. one batched cumulative sum — no scan.
  Step 2:  minimise over the explicit divergence-free basis Z:
             col 0           = the d0 "ring" mode (weights = cumalpha)
             per spoke j     = the k-1 hierarchic higher moments (unit cols)
             per cell i      = the (k-1)(k-2)/2 interior dofs  (unit cols)
           dim Dz = 1 + ns(k-1) + n(k-1)(k-2)/2 — an SPD system of dimension
           7 (RT2, 6-cell patch) instead of the 42-dim KKT; A_z = Z^T M Z is
           geometry-only, so interior patches factorise ONCE for all RHS
           (reference ``ev/solve_patch.hpp:160-213`` re-assembles only on
           patch-type change).

Layout: everything is **batch-last** — tensors are (small dims..., P) with
the patch batch as the minor (contiguous) axis, so every elementwise stage
streams whole patch rows.  The data-dependent dof permutation is folded
into SIX statically pre-permuted reference tensors blended with a one-hot
over the (lnode, walk-orientation) combo instead of a ``take_along_axis``.
This layout was chosen for an earlier backend; its cost on the GPU is
measured per layer in ROADMAP item 1.5.

Everything here is exact linear algebra on the same discrete problem as
``eqlb.engine._assemble_bucket`` — the two paths agree to round-off, which
``tests/test_semiexplicit.py`` asserts.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax.numpy as jnp

__all__ = [
    "se_static",
    "se_host_tables",
    "combo_tensors",
    "solve_bucket_semiexplicit",
    "reduced_flux_system",
]


@lru_cache(maxsize=None)
def _div_structure(k: int):
    """(S (3,), divdiag (ndiv,)): the nonzero divergence moments of the
    hierarchic RT_k basis (see module docstring; asserted dense in tests)."""
    from ..elements.lagrange import dubiner_cached
    from ..elements.quadrature import gauss_triangle
    from ..elements.rt import rt_cached

    rt = rt_cached(k)
    dub = dubiner_cached(k - 1)
    pts, w = gauss_triangle(2 * k + 2)
    Dhat = np.einsum("x,ix,px->ip", w, rt.tabulate_div(pts), dub.tabulate(pts))
    S = Dhat[[0, k, 2 * k], 0].copy()
    ndiv = rt.ndofs_cell_div
    divdiag = np.array([Dhat[3 * k + t, 1 + t] for t in range(ndiv)])
    return S, divdiag


def _perm_q(q: int, k: int):
    """Canonical-order dof permutation of combo q = 2*lnode + orient:
    orient 0 = entry edge is (lnode+1)%3."""
    ln, o = q // 2, q % 2
    e1 = (ln + 1) % 3 if o == 0 else (ln + 2) % 3
    e2 = (ln + 2) % 3 if o == 0 else (ln + 1) % 3
    return ln, np.concatenate(
        [e1 * k + np.arange(k), e2 * k + np.arange(k),
         3 * k + np.arange(k * (k - 1))]
    )


@lru_cache(maxsize=None)
def combo_tensors(k: int):
    """Reference tensors pre-permuted for each of the 6 (lnode, orientation)
    combos — replaces all data-dependent dof-permutation gathers with a
    one-hot contraction."""
    from .engine import reference_tensors, _HAT_GRADS

    ref = reference_tensors(k)
    nkeep = 2 * k + k * (k - 1)
    ndg = k * (k + 1) // 2
    MhatC = np.zeros((6, 2, 2, nkeep, nkeep))
    DhatC = np.zeros((6, nkeep, ndg))
    RhatC = np.zeros((6, ndg, 2, nkeep))
    T3C = np.zeros((6, ndg, ndg))
    hatgC = np.zeros((6, 2))
    for q in range(6):
        ln, pq = _perm_q(q, k)
        MhatC[q] = ref["Mhat"][:, :, pq][:, :, :, pq]
        DhatC[q] = ref["Dhat"][pq]
        RhatC[q] = ref["Rhat"][ln][:, :, pq]
        T3C[q] = ref["T3"][ln]
        hatgC[q] = _HAT_GRADS[ln]
    return dict(MhatC=MhatC, DhatC=DhatC, RhatC=RhatC, T3C=T3C, hatgC=hatgC)


def se_static(bucket, k: int):
    """Static (bucket-shape-only) index maps of the reduced basis.

    Column layout of Z: [d0 | spoke 0 moments 1..k-1 | ... | spoke ns-1 |
    cell 0 interior dofs | ... | cell n-1].
    """
    n, ns = bucket.ncells, bucket.nspokes
    kk1 = k * (k - 1)
    ndiv = k * (k + 1) // 2 - 1
    nint = (k - 1) * (k - 2) // 2
    Dz = 1 + ns * (k - 1) + n * nint

    # canonical slots of cell i that map to unit columns
    uslots = np.concatenate(
        [
            np.arange(1, k),  # entry spoke higher moments
            k + np.arange(1, k),  # exit spoke higher moments
            2 * k + ndiv + np.arange(nint),  # interior cell dofs
        ]
    ).astype(np.int64)

    exit_idx = np.array(
        [(i + 1) % ns if not bucket.is_boundary else i + 1 for i in range(n)],
        dtype=np.int64,
    )
    ucols = np.empty((n, len(uslots)), dtype=np.int64)
    for i in range(n):
        ucols[i] = np.concatenate(
            [
                1 + i * (k - 1) + np.arange(k - 1),
                1 + exit_idx[i] * (k - 1) + np.arange(k - 1),
                1 + ns * (k - 1) + i * nint + np.arange(nint),
            ]
        )

    # patch-dof position of every unit column (cols 1..Dz-1 in order)
    sel = np.concatenate(
        [
            (np.arange(ns)[:, None] * k + np.arange(1, k)[None, :]).reshape(-1),
            (
                ns * k
                + np.arange(n)[:, None] * kk1
                + ndiv
                + np.arange(nint)[None, :]
            ).reshape(-1),
        ]
    ).astype(np.int64)
    assert len(sel) == Dz - 1

    return dict(
        Dz=Dz, uslots=uslots, ucols=ucols, sel=sel, exit_idx=exit_idx,
        ndiv=ndiv, nint=nint,
    )


def se_host_tables(bucket, tables, mesh, k: int):
    """Geometry-dependent host tables of the explicit step.

    The ring recursion sigma0_{j+1} = alpha_j sigma0_j + beta_j Fq0_j has the
    closed form (alpha, beta = +-1, +-1/sqrt2 sign products)

        sigma0_j = cumalpha_j * (s0 + sum_{i<j} gamma_i Fq0_i),
        cumalpha_j = prod_{l<j} alpha_l,   gamma_i = beta_i / cumalpha_{i+1}

    so the device computes it with one cumulative sum.  cumalpha is
    simultaneously the d0 ring-mode weight vector (the homogeneous solution).
    """
    S, divdiag = _div_structure(k)
    n, ns = bucket.ncells, bucket.nspokes
    P = len(tables["signs"])
    sdet = np.sign(mesh.detJ[bucket.cells.astype(np.int64)])  # (P, n)
    signs = tables["signs"]
    b_en = sdet * S[bucket.entry_loc.astype(np.int64)] * signs[:, :, 0]
    b_ex = sdet * S[bucket.exit_loc.astype(np.int64)] * signs[:, :, k]
    alpha = -b_en / b_ex  # (P, n)
    beta = 1.0 / b_ex

    cum = np.ones((P, ns))
    for j in range(1, ns):
        cum[:, j] = cum[:, j - 1] * alpha[:, j - 1]
    if not bucket.is_boundary:
        closure = cum[:, -1] * alpha[:, -1]
        if not np.allclose(closure, 1.0, atol=1e-12):
            raise RuntimeError("interior patch d0 ring mode does not close")
    # gamma_i = beta_i / cumalpha_{i+1}; interior patches have ns == n and
    # cumalpha_n == closure == 1
    cum_next = (
        cum[:, 1:] if bucket.is_boundary
        else np.concatenate([cum[:, 1:], np.ones((P, 1))], axis=1)
    )
    gamma = beta / cum_next[:, :n]

    # combo id of every patch cell: 2*lnode + orientation
    lnode = bucket.lnode.astype(np.int64)
    combo = 2 * lnode + (bucket.entry_loc.astype(np.int64) != (lnode + 1) % 3)
    return dict(
        cumalpha=cum, gamma=gamma, divdiag=divdiag,
        combo=combo.astype(np.int8),
    )


# ---------------------------------------------------------------------------
# device-side solve (batch-last)
# ---------------------------------------------------------------------------


def mass_matrices_bl(engine, key, dv, refd):
    """Geometry-only canonical element mass matrices, batch-last:
    Mc (n, nkeep, nkeep, P).  Call-invariant — the engine caches the result
    (and the reduced matrices A_z) on device at table-build time.

    The one-hot combo contraction is accumulated per combo: a single fused
    einsum over the q axis materializes a 6x-size broadcast intermediate."""
    dt = engine.dtype
    J = dv["J_bl"]  # (n, 2, 2, P)
    detJ = dv["detJ_bl"]  # (n, P)
    signs = dv["signs_bl"]  # (n, nkeep, P)
    adet = jnp.abs(detJ)
    Mc = None
    for q in range(6):
        wq = (dv["combo_bl"] == q).astype(dt)  # (n, P)
        Mq = refd["MhatC"][q]
        # fully unrolled (a, b, k) broadcast sums instead of einsums /
        # dot_generals: only (n, P) arrays and the (n, nkeep, nkeep, P)
        # accumulator ever exist, never an intermediate with the tiny
        # (a, b) dims minor
        for a in range(2):
            for b in range(2):
                JtJw_ab = (J[:, 0, a] * J[:, 0, b]
                           + J[:, 1, a] * J[:, 1, b]) * wq  # (n, P)
                t = JtJw_ab[:, None, None, :] * Mq[a, b][None, :, :, None]
                Mc = t if Mc is None else Mc + t
    Mc = Mc / adet[:, None, None]
    return Mc * signs[:, :, None] * signs[:, None, :]


def _bx(a, n_rhs):
    """Broadcast a geometry tensor (..., P) along the folded RHS axis ->
    (..., n_rhs*P).  RHS-major fold (x = r*P + p): inside XLA fusion this is
    a free broadcast (an index computation), never a materialised copy."""
    if n_rhs == 1:
        return a
    P = a.shape[-1]
    return jnp.broadcast_to(
        a[..., None, :], a.shape[:-1] + (n_rhs, P)
    ).reshape(a.shape[:-1] + (n_rhs * P,))


def load_moments_bl(engine, key, dprT, dv, refd, src_packed=None):
    """Data-dependent canonical load moments, batch-last with the RHS axis
    FOLDED into the lane dimension: Fv (n, nkeep, X), Fq (n, ndg, X) where
    X = n_rhs * P (RHS-major).  Multi-RHS work thus rides the patch axis
    like extra patches — a leading n_rhs axis made every downstream op a
    per-RHS relayout.

    Args: dprT (n_rhs, 3, ndg, nc) — packed [sigma_proj rows 0/1 | rhs] so
    one gather per bucket fetches all per-cell data.  ``src_packed``
    (nc, n_rhs*3*ndg) is the same data CELL-MAJOR: a row gather then fetches
    all of a cell's dof data in one contiguous read instead of one read per
    scalar.

    Every contraction is an explicit broadcast-multiply-reduce, never a
    dot_general: a (6x6) product per batch point is far too small for a
    matrix unit, and the broadcast form is bandwidth-bound."""
    dt = engine.dtype
    detJ = dv["detJ_bl"]  # (n, P)
    n_rhs, _, ndg, nc = dprT.shape
    cb = dv["cells_bl"]  # (n, P)
    n, P = cb.shape
    J = _bx(dv["J_bl"], n_rhs)  # (n, 2, 2, X)
    K = _bx(dv["K_bl"], n_rhs)
    signs = _bx(dv["signs_bl"], n_rhs)  # (n, nkeep, X)
    adet = _bx(jnp.abs(detJ), n_rhs)  # (n, X)
    sdet = _bx(jnp.sign(detJ), n_rhs)
    combo = _bx(dv["combo_bl"], n_rhs)  # (n, X)

    if src_packed is not None:
        # cell-major row gather: one contiguous row per patch-cell instance
        # (source is padded to 128 columns; slice back to the logical width)
        w = n_rhs * 3 * ndg
        rows = src_packed[cb.reshape(-1)][:, :w]
        g = jnp.transpose(
            rows.reshape(n, P, n_rhs, 3, ndg), (3, 4, 0, 2, 1)
        ).reshape(3, ndg, n, n_rhs * P)
    else:
        # minor-axis gather from the flattened 2D (r*3*ndg, nc) source: a
        # >=3D source made XLA materialise the output with the tiny data
        # dims minor
        g = dprT.reshape(n_rhs * 3 * ndg, nc)[:, cb.reshape(-1)]
        g = g.reshape(n_rhs, 3, ndg, n, P)
        g = jnp.moveaxis(g, 0, 3).reshape(3, ndg, n, n_rhs * P)
    dpg = g[:2]  # (2, ndg, n, X)
    frg = g[2]  # (ndg, n, X)

    # dpJ[b,m,c,x] = sum_a dpg[a,m,c,x] * J[c,a,b,x]
    dpJ = jnp.stack(
        [
            dpg[0] * J[:, 0, 0][None] + dpg[1] * J[:, 1, 0][None],
            dpg[0] * J[:, 0, 1][None] + dpg[1] * J[:, 1, 1][None],
        ],
        axis=0,
    )  # (2, ndg, n, X)
    Fv = Fq = gpsi = None
    ndgk = dpJ.shape[1]
    for q in range(6):
        wq = (combo == q).astype(dt)  # (n, X)
        Rq = refd["RhatC"][q]  # (m, b, i)
        # unrolled (b, m) sums: the broadcast-reduce form materializes a
        # 5D (2, ndg, n, nkeep, X) product — 140 MB per instance per chunk,
        # which the x64 program rematerializes through bf16-compressed
        # tile-padded copies (10x slowdown at 490k cells, worker-killing
        # OOM at 1M); each unrolled term is only (n, nkeep, X)
        tv = None
        for bcomp in range(2):
            for m in range(ndgk):
                t = dpJ[bcomp, m][:, None, :] * Rq[m, bcomp][None, :, None]
                tv = t if tv is None else tv + t  # (c, i, x)
        tq = None
        for m in range(ndgk):
            t = frg[m][:, None, :] * refd["T3C"][q][m][None, :, None]
            tq = t if tq is None else tq + t  # (c, p, x)
        hg = refd["hatgC"][q]
        tg = (K[:, 0] * hg[0] + K[:, 1] * hg[1]) * wq[:, None]  # (c, a, x)
        tvw = tv * wq[:, None]
        tqw = tq * wq[:, None]
        Fv = tvw if Fv is None else Fv + tvw
        Fq = tqw if Fq is None else Fq + tqw
        gpsi = tg if gpsi is None else gpsi + tg
    Fv = Fv * sdet[:, None] * signs
    # gradient term: sum_a gpsi[c,a,x] * dpg[a,p,c,x]
    contr = dpg[0] * gpsi[:, 0][None] + dpg[1] * gpsi[:, 1][None]  # (p, c, x)
    Fq = (Fq + jnp.moveaxis(contr, 0, 1)) * adet[:, None]
    return Fv, Fq


def element_data_bl(engine, key, dprT, dv, refd, src_packed=None):
    """Batch-last canonical element tensors (Mc from the device cache when
    present): Mc (n, nkeep, nkeep, P), Fv (n_rhs, n, nkeep, P),
    Fq (n_rhs, n, ndg, P)."""
    Mc = dv.get("Mc_bl")
    if Mc is None:
        Mc = mass_matrices_bl(engine, key, dv, refd)
    Fv, Fq = load_moments_bl(engine, key, dprT, dv, refd, src_packed)
    return Mc, Fv, Fq


def boundary_ess_bl(engine, key, facet_kind, bvals, dv, refd):
    """(ess (2, X) bool, hatvals (2, k, X)) for a boundary bucket (folded
    X = n_rhs*P lane axis): essential markers and hat-weighted dof values
    of the two boundary spokes."""
    k = engine.k
    dt = engine.dtype
    bsp = dv["bspokes"]  # (P, 2)
    n_rhs = facet_kind.shape[0]
    P = bsp.shape[0]
    kind = facet_kind[:, bsp]  # (n_rhs, P, 2)
    z_lo = dv["z_is_lo"]  # (P, 2)
    scale = jnp.asarray(2.0 * np.arange(k) + 1.0, dt)
    alpha = bvals[:, bsp] * scale  # (n_rhs, P, 2, k)
    Wend = refd["Wend"]  # (2, k, k)
    Wsel = jnp.where(z_lo[..., None, None], Wend[0], Wend[1])
    hatvals = jnp.einsum("rpej,pejm->emrp", alpha, Wsel).reshape(
        2, k, n_rhs * P
    )
    ess = jnp.transpose(kind == 2, (2, 0, 1)).reshape(2, n_rhs * P)
    return ess, hatvals


def particular_bl(engine, key, Fq, ess, hatvals, dv):
    """Explicit step on the folded lane axis: (nflux, X) satisfying the
    divergence constraints and the essential boundary dofs
    (Fq (n, ndg, X), ess (2, X), hatvals (2, k, X))."""
    b = engine.buckets[key]
    st = engine.se_static[key]
    k = engine.k
    kk1 = engine.V.element.ndofs_cell
    n, ns = b.ncells, b.nspokes
    ndiv = st["ndiv"]
    dt = engine.dtype
    X = Fq.shape[-1]
    P = dv["detJ_bl"].shape[-1]
    n_rhs = X // P
    nflux = ns * k + n * kk1

    sdet = _bx(jnp.sign(dv["detJ_bl"]), n_rhs)  # (n, X)
    gamma = _bx(dv["gamma_bl"], n_rhs)  # (n, X)
    cum = _bx(dv["cumalpha_bl"], n_rhs)  # (ns, X)
    sp = jnp.zeros((nflux, X), dt)

    # step 1a: divergence cell dofs
    if ndiv:
        vals = Fq[:, 1 : 1 + ndiv] * (
            sdet[:, None] / dv["divdiag"][:, None]
        )  # (n, ndiv, X)
        if kk1 > ndiv:
            vals = jnp.concatenate(
                [vals, jnp.zeros((n, kk1 - ndiv, X), dt)], axis=1
            )
        sp = sp.at[ns * k :].set(vals.reshape(n * kk1, X))

    # step 1b: spoke constants via the closed-form recursion
    Fq0 = Fq[:, 0]  # (n, X)
    incl = jnp.cumsum(gamma * Fq0, axis=0)  # (n, X)
    rec = jnp.concatenate(
        [jnp.zeros((1, X), dt), incl], axis=0
    )[:ns] * cum
    if b.is_boundary:
        hv0 = hatvals[0, 0]  # (X,)
        hv1 = hatvals[1, 0]
        ess0, ess1 = ess[0], ess[1]  # (X,)
        s0 = jnp.where(
            ess0, hv0,
            jnp.where(ess1, (hv1 - rec[-1]) / cum[-1], 0.0),
        )
        sig0 = rec + cum * s0[None]
        # pure-Neumann patches: both ends pinned; the recursion reproduces
        # the far pin only up to the data-compatibility residual — enforce
        # the BC exactly (the residual lands in the last cell's constant
        # divergence moment, as in the reference's step 1)
        sig0 = sig0.at[-1].set(jnp.where(ess0 & ess1, hv1, sig0[-1]))
    else:
        sig0 = rec
    sp = sp.at[0 : ns * k : k].set(sig0)

    # higher essential moments on the two boundary spokes
    if b.is_boundary and k > 1:
        for e, spj in ((0, 0), (1, ns - 1)):
            rows = spj * k + np.arange(1, k)
            sp = sp.at[rows].set(
                jnp.where(ess[e][None], hatvals[e, 1:], 0.0)
            )
    return sp


def reduced_system_bl(engine, key, Mc, dv, resid=None, matrix=True):
    """A_z = Z^T M Z (Dz, Dz, P) and, given the canonical per-cell load
    residual ``resid`` (n, nkeep, X) on the FOLDED lane axis,
    b_z = Z^T resid (Dz, X).  ``matrix=False`` skips A_z (engine serves it
    from the device cache)."""
    b = engine.buckets[key]
    st = engine.se_static[key]
    k = engine.k
    n = b.ncells
    P = Mc.shape[-1]
    dt = engine.dtype
    Dz = st["Dz"]
    U = st["uslots"]
    d0 = dv["cumalpha_bl"]  # (ns, P)
    n_rhs = 1 if resid is None else resid.shape[-1] // P
    d0x = _bx(d0, n_rhs)

    # ALL indices below are static Python ints: accumulate into Python
    # grids and stack once instead of .at[].add() updates.  Even scalar
    # indexed adds lower to scatter-add ops, which a scatter combiner may
    # re-batch into one-hot broadcasts (Dz, Dz, P, u, u).  The stacked form
    # lowers to pure adds + one concatenate.
    grid = [[None] * Dz for _ in range(Dz)] if matrix else None
    brow = [None] * Dz if resid is not None else None

    def acc(g, r, c, v):
        g[r][c] = v if g[r][c] is None else g[r][c] + v

    def accb(r, v):
        brow[r] = v if brow[r] is None else brow[r] + v

    for i in range(n):
        Mi = Mc[i]  # (nkeep, nkeep, P)
        wen = d0[i]
        wex = d0[st["exit_idx"][i]]
        C_i = st["ucols"][i]
        if matrix:
            if len(U):
                for a in range(len(U)):
                    for c in range(len(U)):
                        acc(grid, int(C_i[a]), int(C_i[c]),
                            Mi[int(U[a]), int(U[c])])
                mU0 = Mi[U, 0] * wen + Mi[U, k] * wex  # (u, P)
                for a in range(len(U)):
                    acc(grid, int(C_i[a]), 0, mU0[a])
                    acc(grid, 0, int(C_i[a]), mU0[a])
            acc(grid, 0, 0,
                wen**2 * Mi[0, 0] + 2.0 * wen * wex * Mi[0, k]
                + wex**2 * Mi[k, k])
        if resid is not None:
            ri = resid[i]  # (nkeep, X)
            for a in range(len(U)):
                accb(int(C_i[a]), ri[int(U[a])])
            accb(0, d0x[i] * ri[0] + d0x[st["exit_idx"][i]] * ri[k])

    Az = bz = None
    if matrix:
        zero = jnp.zeros((P,), dt)
        Az = jnp.stack([
            jnp.stack([zero if v is None else v for v in row])
            for row in grid
        ])
    if resid is not None:
        zb = jnp.zeros((resid.shape[-1],), dt)
        bz = jnp.stack([zb if v is None else v for v in brow])
    return Az, bz


def z_mask_bl(engine, key, ess):
    """(n_rhs, Dz, P) True = column active.  Boundary-spoke columns die when
    that spoke carries essential data; the d0 ring mode dies when either
    does (its start value is then pinned by the explicit step)."""
    b = engine.buckets[key]
    st = engine.se_static[key]
    k = engine.k
    Dz = st["Dz"]
    n_rhs, _, P = ess.shape
    free = jnp.ones((n_rhs, Dz, P), dtype=bool)
    ess0, ess1 = ess[:, 0], ess[:, 1]  # (n_rhs, P)
    free = free.at[:, 0].set(~(ess0 | ess1))
    if k > 1:
        ns = b.nspokes
        free = free.at[:, 1:k].set(~ess0[:, None])
        rows = 1 + (ns - 1) * (k - 1) + np.arange(k - 1)
        free = free.at[:, rows].set(~ess1[:, None])
    return free


def z_mask_x(engine, key, ess):
    """Folded-lane variant of :func:`z_mask_bl`: ess (2, X) -> (Dz, X)
    True = column active."""
    b = engine.buckets[key]
    st = engine.se_static[key]
    k = engine.k
    Dz = st["Dz"]
    X = ess.shape[-1]
    free = jnp.ones((Dz, X), dtype=bool)
    ess0, ess1 = ess[0], ess[1]  # (X,)
    free = free.at[0].set(~(ess0 | ess1))
    if k > 1:
        ns = b.nspokes
        free = free.at[1:k].set(~ess0[None])
        rows = 1 + (ns - 1) * (k - 1) + np.arange(k - 1)
        free = free.at[rows].set(~ess1[None])
    return free


def solve_bucket_semiexplicit(
    engine, key, dprT, facet_kind, bvals, dv, refd, src_packed=None
):
    """Full reduced solve of one bucket (batch-last packed input
    dprT (n_rhs, 3, ndg, nc) = [sigma_proj | rhs]) ->
    (n_rhs, nflux, P) patch dofs, batch-last.

    Internally the whole pipeline runs on the FOLDED lane axis X = n_rhs*P
    (RHS-major): multi-RHS problems are just more lanes, so every stage is
    the n_rhs == 1 program at a wider batch — no leading-RHS relayouts."""
    b = engine.buckets[key]
    st = engine.se_static[key]
    k = engine.k
    n, ns = b.ncells, b.nspokes
    dt = engine.dtype
    n_rhs = dprT.shape[0]

    Mc, Fv, Fq = element_data_bl(engine, key, dprT, dv, refd, src_packed)
    P = Mc.shape[-1]
    if b.is_boundary:
        ess, hatvals = boundary_ess_bl(engine, key, facet_kind, bvals, dv, refd)
    else:
        ess = hatvals = None
    sp = particular_bl(engine, key, Fq, ess, hatvals, dv)  # (nflux, X)

    pidx = engine.tables[key]["patch_idx"]  # (n, nkeep) static
    sp_can = sp[pidx]  # (n, nkeep, X)
    # explicit b-reduce instead of an einsum: the per-point (nkeep x nkeep)
    # contraction is too small for a dot_general (the broadcast form is
    # bandwidth-bound)
    nkeep = Mc.shape[1]
    msp = None
    for bcol in range(nkeep):
        t = _bx(Mc[:, :, bcol, :], n_rhs) * sp_can[:, bcol, None, :]
        msp = t if msp is None else msp + t
    resid = Fv - msp  # (n, nkeep, X)

    if "Az_bl" in dv:
        _, bz = reduced_system_bl(engine, key, Mc, dv, resid=resid,
                                  matrix=False)
        Az = dv["Az_bl"]
    else:
        Az, bz = reduced_system_bl(engine, key, Mc, dv, resid=resid)
    Dz = st["Dz"]
    X = n_rhs * P

    if b.is_boundary:
        free = z_mask_x(engine, key, ess)  # (Dz, X)
        ff = free[:, None] & free[None, :]  # (Dz, Dz, X)
        eye = jnp.eye(Dz, dtype=dt)
        Ar = jnp.where(ff, _bx(Az, n_rhs), 0.0) + eye[:, :, None] * (
            ~free[None]
        )
        br = jnp.where(free, bz, 0.0)
        y = engine._dense_solve_bl(Ar, br[:, None, :])[:, 0]  # (Dz, X)
    elif "Ainv_bl" in dv:
        # geometry-only system with a cached explicit inverse.  Explicit
        # j-sum instead of an einsum/dot: it guarded against a NaN-writing
        # miscompile of the fused dot seen on an earlier backend (open:
        # ROADMAP item 1.5)
        Ainv = dv["Ainv_bl"]
        y = None
        for j in range(Dz):
            t = _bx(Ainv[:, j], n_rhs) * bz[j][None]  # (Dz, X)
            y = t if y is None else y + t
    else:
        # geometry-only matrix: factorise once, solve every RHS
        y = engine._dense_solve_bl(
            _bx(Az, n_rhs), bz[:, None, :]
        )[:, 0]  # (Dz, X)

    sol = sp
    if Dz > 1:
        sol = sol.at[st["sel"]].add(y[1:])
    sol = sol.at[0 : ns * k : k].add(
        y[0][None] * _bx(dv["cumalpha_bl"], n_rhs)
    )
    # unfold X -> (n_rhs, nflux, P) for the combine/stress consumers
    return jnp.moveaxis(sol.reshape(-1, n_rhs, P), 1, 0)


def reduced_flux_system(engine, key, Mc_bm, dv, resid=None):
    """Batch-major convenience wrapper for the stress path: Mc_bm
    (P, n, nkeep, nkeep) -> Az (P, Dz, Dz) [and bz (n_rhs, P, Dz)]."""
    Mc = jnp.moveaxis(Mc_bm, 0, -1)
    if resid is None:
        Az, _ = reduced_system_bl(engine, key, Mc, dv)
        return jnp.moveaxis(Az, -1, 0), None
    n_rhs, P = resid.shape[0], Mc.shape[-1]
    # batch-major resid (n_rhs, P, n, nkeep) -> folded (n, nkeep, n_rhs*P)
    rs = jnp.transpose(resid, (2, 3, 0, 1)).reshape(
        resid.shape[2], resid.shape[3], n_rhs * P
    )
    Az, bz = reduced_system_bl(engine, key, Mc, dv, resid=rs)
    return (
        jnp.moveaxis(Az, -1, 0),
        jnp.moveaxis(bz.reshape(-1, n_rhs, P), 0, -1),  # (n_rhs, P, Dz)
    )
