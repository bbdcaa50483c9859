"""Batched patch-wise constrained minimisation — the equilibration core.

Both reference equilibrators solve, for every mesh vertex z with hat
function psi_z, the same local problem on the patch omega_z (cf.
``ev/solve_patch.hpp`` and ``se/solve_patch_semiexplt.hpp``):

    minimise || sigma_z - psi_z sigma_proj ||_{L2(omega_z)}
    s.t.   (div sigma_z, q) = (psi_z f + grad(psi_z).sigma_proj, q)
                                          for all q in DG_{k-1}(omega_z)
           sigma_z . n = 0            on the outer ring of the patch
           sigma_z . n = psi_z g      on flux-essential boundary spokes
           sigma_z . n free           on primal-Dirichlet boundary spokes

(the EV mixed form, reference ``FluxEqlbEV.py:116-134``; the SE two-step
scheme computes the identical minimiser of the identical constraint set, so
one engine serves both).  The sum sigma_R = sum_z sigma_z satisfies
div(sigma_R) = P_{k-1} f and the prescribed normal traces exactly.

Design: one dense KKT system per patch
    [ M  -B^T  0 ] [sigma]   [F_v]
    [ B   0    c ] [  r  ] = [F_q]
    [ 0   c^T  0 ] [ lam ]   [ 0 ]
with the mean-value Lagrange multiplier ``lam`` active on interior /
pure-Neumann patches (the reference's penalty row, ``ev/assembly.hpp:280-305``
and ``se/PatchData.hpp:168-223``).  Element tensors are contractions of
constant reference tensors with per-cell geometry; patches are bucketed so
assembly is static block placement and the solve one batched LU per bucket.
Essential dofs stay in the system as identity rows (row replacement, like the
reference's BC rows ``ev/assembly.hpp:252-266``).

The whole equilibration (every bucket: assembly, batched solves, optional
weak symmetry, global dof combine) is ONE jitted XLA program, compiled for
whatever device JAX runs on (the GPU in production, the CPU in tests).  All
index tables and reference tensors are passed into the jit as *device
arguments*, never as baked constants: this keeps the compiled executable
reusable across meshes of identical bucket structure and keeps multi-GB
tables out of the compiled program.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

from ..elements.lagrange import dubiner_cached, lagrange_cached
from ..elements.polynomials import legendre_shifted
from ..elements.quadrature import gauss_interval, gauss_triangle
from ..elements.rt import rt_cached
from ..fem.spaces import FunctionSpace
from .patches import PatchBucket, bucket_dof_tables

__all__ = ["EqlbEngine", "reference_tensors"]

# fuse=False per-bucket executables, shared ACROSS engines so adaptive
# loops (fresh engine per refined mesh) reuse compiled bucket programs —
# see EqlbEngine._equilibrate_unfused
_UNFUSED_JIT_CACHE: dict = {}


_HAT_GRADS = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])


def _quantize_pad(target: int, f: float) -> int:
    """Next size on the geometric padding grid: powers of two below 128,
    tile-aligned ~f-ratio steps above (see EqlbEngine pad_quantize).  The
    grid is a fixed sequence independent of the query, so adaptive meshes
    land on recurring sizes."""
    if target <= 1:
        return 1
    if target < 128:
        return 1 << (target - 1).bit_length()
    size = 128
    while size < target:
        size = max(size + 128, -(-int(size * f) // 128) * 128)
    return size


@lru_cache(maxsize=None)
def reference_tensors(k: int):
    """Constant reference-cell tensors for RT_k / DG_{k-1} / P1-hat."""
    rt = rt_cached(k)
    dub = dubiner_cached(k - 1)
    hat = lagrange_cached(1)
    pts, w = gauss_triangle(2 * k + 2)
    phi = rt.tabulate(pts)  # (nrt, 2, nq)
    dphi = rt.tabulate_div(pts)  # (nrt, nq)
    q = dub.tabulate(pts)  # (ndg, nq)
    lam = hat.tabulate(pts)  # (3, nq)

    Mhat = np.einsum("x,iax,jbx->abij", w, phi, phi)
    Dhat = np.einsum("x,ix,px->ip", w, dphi, q)
    Rhat = np.einsum("x,lx,mx,iax->lmai", w, lam, q, phi)
    Rlam = np.einsum("x,lx,iax->lai", w, lam, phi)  # weak-symmetry coupling
    T3 = np.einsum("x,lx,mx,px->lmp", w, lam, q, q)
    cpen = np.einsum("x,px->p", w, q)  # only the constant mode is nonzero

    # hat-weighted Legendre products on [0,1] for boundary-spoke dofs:
    # W[end, j, m] = int lin_end(s) P~_j(s) P~_m(s) ds, lin_0 = 1-s, lin_1 = s
    s, ws = gauss_interval(k + 2)
    leg = legendre_shifted(k - 1)
    legv = np.array([np.polyval(leg[m, ::-1], s) for m in range(k)])
    Wend = np.stack(
        [
            np.einsum("x,jx,mx->jm", ws * (1.0 - s), legv, legv),
            np.einsum("x,jx,mx->jm", ws * s, legv, legv),
        ]
    )
    return dict(
        Mhat=Mhat, Dhat=Dhat, Rhat=Rhat, Rlam=Rlam, T3=T3, cpen=cpen, Wend=Wend
    )


class EqlbEngine:
    """Per-mesh, per-degree batched equilibration engine."""

    def __init__(
        self,
        V_flux: FunctionSpace,
        buckets: dict[tuple, PatchBucket],
        dtype=None,
        pad_to_multiple: int | None = None,
        max_patches_per_bucket: int | None = None,
        pad_quantize: float | None = None,
    ):
        """``dtype``: compute precision of the batched patch solves.  f64 is
        the default (the 1e-10-level invariant checks need it); f32 halves
        the memory traffic at single-precision accuracy of the dofs.

        ``pad_to_multiple``: pad every bucket's patch axis to a multiple of
        this (for even sharding across a device mesh).  Pad entries repeat
        the last patch but scatter to out-of-bounds global dofs, which XLA
        drops — so padding never perturbs the result.

        ``max_patches_per_bucket``: split large buckets into chunks of at
        most this many patches — bounds the peak device memory of the
        batched temporaries of one bucket program.

        ``pad_quantize``: round every bucket's padded patch count up to a
        geometric grid (next power of two below 128 patches, then
        128 * ceil(f^j) with f = pad_quantize).  Bucket shapes then RECUR
        across the meshes of an adaptive refinement loop, so recompiles hit
        the persistent compile cache (all tables enter the jit as
        arguments, so equal shapes mean equal HLO).  Costs at most a factor
        f of padded compute; 1.25 is a good default for adaptive runs.
        """
        assert V_flux.family == "RT"
        self.V = V_flux
        self.k = V_flux.degree
        self.mesh = V_flux.mesh
        # every bucket's patch axis ends in >= LANE_PAD pad entries: they
        # guarded against a miscompile seen on an earlier backend, which
        # wrote NaN into the last 128 entries of a large fused bucket
        # pipeline.  Pad entries are never read back (they scatter to
        # out-of-bounds dofs and are excluded from the combine tables).
        # Whether the pad is still needed is open (ROADMAP items 1.5, 3.4).
        LANE_PAD = 128
        self._chunk_target = {}
        if max_patches_per_bucket:
            from dataclasses import replace

            C = max_patches_per_bucket
            stride = C - LANE_PAD  # real patches per chunk; C incl. pad
            split = {}
            for key, b in buckets.items():
                P = b.npatches
                if P + LANE_PAD <= C:
                    split[key] = b
                    continue
                nchunks = -(-P // stride)
                for i in range(nchunks):
                    s = slice(i * stride, min((i + 1) * stride, P))
                    split[key + (i,)] = replace(
                        b,
                        nodes=b.nodes[s],
                        cells=b.cells[s],
                        lnode=b.lnode[s],
                        spokes=b.spokes[s],
                        entry_loc=b.entry_loc[s],
                        exit_loc=b.exit_loc[s],
                    )
                    # equal chunk sizes share one compiled executable; every
                    # chunk is padded up to C (pads scatter out of bounds)
                    self._chunk_target[key + (i,)] = C
            buckets = split
        self.buckets = buckets
        self.dtype = dtype or jnp.float64
        # "semiexplicit": explicit divergence step + reduced H(div=0) SPD
        # solve (the fast path, dimension 1 + ns(k-1) + n(k-1)(k-2)/2);
        # "kkt": full per-patch saddle-point system (reference path for
        # cross-checking, dimension nflux + n*ndg)
        self.mode = "semiexplicit"
        self.ref = reference_tensors(self.k)
        self.se_static = {}
        self.tables = {}
        msh = self.mesh
        from .semiexplicit import se_host_tables, se_static

        # gather per-patch geometry at the compute precision (halves the
        # host table-build memory traffic for f32 engines)
        np_dt = np.dtype(self.dtype)
        J_g = np.ascontiguousarray(msh.J, dtype=np_dt)
        K_g = np.ascontiguousarray(msh.K, dtype=np_dt)
        detJ_g = np.ascontiguousarray(msh.detJ, dtype=np_dt)
        for key, b in buckets.items():
            t = bucket_dof_tables(b, V_flux)
            self.se_static[key] = se_static(b, self.k)
            t.update(se_host_tables(b, t, msh, self.k))
            cells64 = b.cells.astype(np.int64)
            t["J"] = J_g[cells64]  # (P, n, 2, 2)
            t["detJ"] = detJ_g[cells64]
            t["K"] = K_g[cells64]
            # endpoint of each boundary spoke: is z the lower-global-id end?
            if b.is_boundary:
                fv = msh.facet_vertices[b.spokes[:, [0, -1]].astype(np.int64)]
                t["z_is_lo"] = fv[..., 0] == b.nodes[:, None]  # (P, 2)
                t["bspokes"] = b.spokes[:, [0, -1]].astype(np.int64)  # (P, 2)
            # unchunked buckets: tile-align and append the safety pad tile
            # (tiny buckets stay exact — their whole extent is one tile)
            target = self._chunk_target.get(
                key,
                b.npatches if b.npatches < 128
                else -(-(b.npatches + 128) // 128) * 128,
            )
            if pad_to_multiple:
                target += (-target) % pad_to_multiple
            if pad_quantize and key not in self._chunk_target:
                target = _quantize_pad(target, pad_quantize)
                if pad_to_multiple:
                    target += (-target) % pad_to_multiple
            if target > b.npatches:
                P = b.npatches
                pad = target - P
                if pad:
                    per_patch = ["perm", "signs", "gdofs", "lv_hats", "J",
                                 "detJ", "K", "z_is_lo", "bspokes", "cells",
                                 "lnode", "gamma", "cumalpha", "combo"]
                    t["cells"] = b.cells
                    t["lnode"] = b.lnode
                    for name in per_patch:
                        if name in t:
                            arr = t[name]
                            t[name] = np.concatenate(
                                [arr, np.repeat(arr[-1:], pad, axis=0)]
                            )
                    # pad rows scatter out of bounds -> dropped by XLA
                    t["gdofs"][P:] = self.V.ndofs
                t["n_valid"] = P
            self.tables[key] = t

        # --- combine tables: gather-based global accumulation ----------------
        # every global dof has at most 3 contributors (2 patches per facet
        # dof, 3 per cell dof), so the semi-explicit path gathers them from
        # the concatenated flat (nflux-major) bucket solutions instead of
        # scatter-adding (whether an atomic scatter-add is faster on the GPU
        # is open, ROADMAP item 1.4)
        ndofs = self.V.ndofs
        total = sum(
            int(np.prod(self.tables[key]["gdofs"].shape))
            for key in self.tables
        )
        from .. import native

        src = np.full((ndofs, 3), total, dtype=np.int32)  # total = pad slot
        cur = np.zeros(ndofs, dtype=np.uint8)
        use_native = native.available()
        off = 0
        for key in sorted(self.tables.keys()):
            g = self.tables[key]["gdofs"]  # (Ppad, nflux)
            Ppad, nflux = g.shape
            if use_native:
                native.combine_fill(ndofs, off, g, src, cur)
            else:
                pp, ff = np.nonzero((g >= 0) & (g < ndofs))
                gd = g[pp, ff].astype(np.int64)
                idx = off + ff * Ppad + pp
                # stable (p, f)-order column assignment per dof
                order = np.argsort(gd, kind="stable")
                sg, si = gd[order], idx[order]
                poscol = (
                    np.arange(len(sg))
                    - np.searchsorted(sg, sg, side="left")
                    + cur[sg]
                )
                if len(poscol) and poscol.max() > 2:
                    raise RuntimeError(
                        "dof with more than 3 patch contributions")
                src[sg, poscol] = si
                np.add.at(cur, gd, 1)
            off += Ppad * nflux
        nfk = self.V.mesh.num_facets * self.k
        assert np.all(src[:nfk, 2] == total), "facet dof with 3 contributors"
        # facet dofs have exactly 2 contributors, cell dofs 3: the combine
        # gathers columns 0 and 1 for every dof and column 2 for cell dofs
        self._combine = dict(nfk=nfk, src01=src[:, :2], src2=src[nfk:, 2:])

        self._dev = None
        self._ref_dev = None
        self._jit_eq = None

    @property
    def solver(self) -> str:
        """The batched dense solves are XLA's ``jnp.linalg.solve``; this is
        the only solver the engine has."""
        return "xla"

    @solver.setter
    def solver(self, value: str):
        if value != "xla":
            raise ValueError(
                f"solver {value!r} was removed: the batched patch solves "
                "always run through XLA (jnp.linalg.solve)"
            )

    # --- device-resident tables (passed as jit *arguments*) -----------------

    def _device_tables(self):
        if self._dev is not None:
            return self._dev, self._ref_dev
        dt = self.dtype
        iidx = jnp.int32
        dev = {}
        for key, t in self.tables.items():
            b = self.buckets[key]
            cells = t.get("cells", b.cells)
            # lean upload: only the batch-last tables (patch axis last) of
            # the default fused semi-explicit path.  The batch-major twins
            # (J, perm, gdofs, ...) are only needed by the KKT / unfused
            # paths and are uploaded lazily by _ensure_full_tables.
            d = {
                "divdiag": jnp.asarray(t["divdiag"], dt),
                "J_bl": jnp.asarray(
                    np.ascontiguousarray(np.moveaxis(t["J"], 0, -1)), dt),
                "K_bl": jnp.asarray(
                    np.ascontiguousarray(np.moveaxis(t["K"], 0, -1)), dt),
                "detJ_bl": jnp.asarray(
                    np.ascontiguousarray(t["detJ"].T), dt),
                "signs_bl": jnp.asarray(
                    np.ascontiguousarray(np.moveaxis(t["signs"], 0, -1)), dt),
                "combo_bl": jnp.asarray(
                    np.ascontiguousarray(t["combo"].T), jnp.int8),
                "cells_bl": jnp.asarray(
                    np.ascontiguousarray(cells.T), iidx),
                "gamma_bl": jnp.asarray(
                    np.ascontiguousarray(t["gamma"].T), dt),
                "cumalpha_bl": jnp.asarray(
                    np.ascontiguousarray(t["cumalpha"].T), dt),
            }
            if b.is_boundary:
                d["bspokes"] = jnp.asarray(t["bspokes"], iidx)
                d["z_is_lo"] = jnp.asarray(t["z_is_lo"])
            dev[key] = d
        refd = {
            name: jnp.asarray(arr, dt) for name, arr in self.ref.items()
        }
        refd["hat_grads"] = jnp.asarray(_HAT_GRADS, dt)
        # combine index tables (see _combine_flat)
        cm = self._combine
        refd["elem_c0"] = jnp.asarray(cm["src01"][:, 0], jnp.int32)
        refd["elem_c1"] = jnp.asarray(cm["src01"][:, 1], jnp.int32)
        refd["elem_c2"] = jnp.asarray(cm["src2"][:, 0], jnp.int32)
        from .semiexplicit import (
            combo_tensors, mass_matrices_bl, reduced_system_bl,
        )

        for name, arr in combo_tensors(self.k).items():
            refd[name] = jnp.asarray(arr, dt)
        from .stress import bsym_combo_tensors

        refd["BsymC"] = jnp.asarray(bsym_combo_tensors(self.k), dt)

        # geometry caches: element mass matrices and reduced H(div=0)
        # matrices are call-invariant — build them once per bucket shape.
        # Interior buckets additionally cache the explicit INVERSE (small,
        # well-conditioned SPD), turning the per-call batched solve into one
        # einsum; boundary buckets keep A_z (per-RHS essential masks modify
        # the system before solving).
        geom_jit = {}
        for key in sorted(self.tables.keys()):
            b = self.buckets[key]
            sig = (b.ncells, b.is_boundary, dev[key]["J_bl"].shape[-1])
            if sig not in geom_jit:
                def build(dvk, rf, _key=key, _inv=not b.is_boundary):
                    # see _equilibrate_impl_T: f32 matmul precision required
                    with jax.default_matmul_precision("float32"):
                        return build_inner(dvk, rf, _key, _inv)

                def build_inner(dvk, rf, _key, _inv):
                    Mc = mass_matrices_bl(self, _key, dvk, rf)
                    Az, _ = reduced_system_bl(self, _key, Mc, dvk)
                    if _inv:
                        Dz = Az.shape[0]
                        eye = jnp.broadcast_to(
                            jnp.eye(Dz, dtype=self.dtype)[..., None], Az.shape
                        )
                        # batch-last solve (no moveaxis relayouts)
                        Ainv = self._dense_solve_bl(Az, eye)
                        return Mc, Az, Ainv
                    return Mc, Az

                geom_jit[sig] = jax.jit(build)
            out = geom_jit[sig](dev[key], refd)
            dev[key]["Mc_bl"] = out[0]
            dev[key]["Az_bl"] = out[1]
            if len(out) == 3 and "EQLB_DISABLE_AINV" not in os.environ:
                dev[key]["Ainv_bl"] = out[2]
        self._dev, self._ref_dev = dev, refd
        return dev, refd

    def _ensure_full_tables(self):
        """Upload the batch-major table twins used by the legacy KKT /
        unfused / reduced-stress paths (the lean default upload carries only
        the batch-last semi-explicit tables)."""
        dev, _ = self._device_tables()
        if any("perm" in d for d in dev.values()):
            return
        dt = self.dtype
        iidx = jnp.int32
        for key, t in self.tables.items():
            b = self.buckets[key]
            cells = t.get("cells", b.cells)
            dev[key].update({
                "J": jnp.asarray(t["J"], dt),
                "detJ": jnp.asarray(t["detJ"], dt),
                "K": jnp.asarray(t["K"], dt),
                "perm": jnp.asarray(t["perm"], iidx),
                "signs": jnp.asarray(t["signs"], dt),
                "cells": jnp.asarray(cells, iidx),
                "lnode": jnp.asarray(t.get("lnode", b.lnode), iidx),
                "gdofs": jnp.asarray(t["gdofs"], iidx),
                "lv_hats": jnp.asarray(t["lv_hats"], iidx),
            })
        # dev pytree structure changed: retrace any captured jits
        self._jit_eq = None
        self._jit_eqT = None

    def ensure_stress_caches(self):
        """Build the geometry-only weak-symmetry caches (stress KKT matrix
        per bucket + constraint-column inverse blocks on interior buckets).
        Lazy: only stress workloads pay for them."""
        dev, refd = self._device_tables()
        if any("Bsym_bl" in d for d in dev.values()):
            return
        from .stress import build_stress_cache

        cache_jit = {}
        for key in sorted(self.tables.keys()):
            b = self.buckets[key]
            sig = (b.ncells, b.is_boundary, dev[key]["J_bl"].shape[-1])
            if sig not in cache_jit:
                def _build(dvk, rf, _key=key):
                    with jax.default_matmul_precision("float32"):
                        return build_stress_cache(self, _key, dvk, rf)

                cache_jit[sig] = jax.jit(_build)
            dev[key].update(cache_jit[sig](dev[key], refd))
        self._jit_eqT = None  # dev pytree changed: retrace

    # -------------------------------------------------------------------------

    def put_transposed(self, sigma_proj_dofs, rhs_dofs):
        """Host-transpose batch-major dof data to the semi-explicit path's
        batch-last layout and upload once; pass the result to ``equilibrate``
        with ``transposed_inputs=True`` to keep repeated calls free of
        host->device transfers."""
        dpT = jnp.asarray(
            np.ascontiguousarray(np.moveaxis(np.asarray(sigma_proj_dofs), 1, -1)),
            self.dtype,
        )
        drT = jnp.asarray(
            np.ascontiguousarray(np.moveaxis(np.asarray(rhs_dofs), 1, -1)),
            self.dtype,
        )
        return dpT, drT

    def equilibrate(
        self, sigma_proj_dofs, rhs_dofs, facet_kind, bvals,
        weak_symmetry=False, fuse=None, transposed_inputs=False,
        ws_skip_nodes=None,
    ):
        """Solve all patch problems; returns global RT dof vectors
        (n_rhs, ndofs_flux).

        Args (leading axis = n_rhs):
          sigma_proj_dofs (n_rhs, nc, 2, ndg): vector-DG dofs of sigma_proj
          rhs_dofs        (n_rhs, nc, ndg):    DG dofs of the projected RHS
          facet_kind      (n_rhs, nf) int8:    0 interior/outer, 1 flux-free
                                               (primal Dirichlet), 2 flux-
                                               essential (Neumann data)
          bvals           (n_rhs, nf, k):      facet dof values of the flux BC
          weak_symmetry:  treat rows 0, 1 as stress rows and apply the
                          patch-wise weak-symmetry correction before the
                          global scatter (reference FluxEqlbSE stress path)
        """
        dev, refd = self._device_tables()
        npatches = sum(b.npatches for b in self.buckets.values())
        if fuse is None:
            # one fused XLA program minimises dispatch overhead; the dense
            # KKT path rematerialises under memory pressure at large patch
            # counts, so it dispatches one executable per bucket there
            fuse = self.mode == "semiexplicit" or npatches <= 150_000
        ws_skip = None
        if weak_symmetry and ws_skip_nodes is not None and len(ws_skip_nodes):
            ws_skip = {}
            for key, b in self.buckets.items():
                P = self.tables[key]["J"].shape[0]
                m = np.zeros(P, dtype=bool)
                m[: b.npatches] = np.isin(b.nodes, ws_skip_nodes)
                ws_skip[key] = jnp.asarray(m)
        on_fused_se = fuse and self.mode == "semiexplicit"
        if transposed_inputs and not on_fused_se:
            raise ValueError(
                "transposed_inputs=True requires the fused semi-explicit "
                "path (mode='semiexplicit', fuse=True): the batch-major "
                "fallback would silently mis-gather batch-last arrays"
            )
        if ws_skip is not None and not fuse:
            raise ValueError(
                "fuse=False does not support ws_skip_nodes (grouped "
                "deficient patches): the unfused path would solve the "
                "singular per-patch weak-symmetry systems anyway"
            )
        if fuse and self.mode == "semiexplicit":
            if weak_symmetry:
                self.ensure_stress_caches()
            # transpose to batch-last on the host for host data; device
            # data is transposed on the device
            if transposed_inputs:
                dpT, drT = sigma_proj_dofs, rhs_dofs
            elif isinstance(sigma_proj_dofs, np.ndarray):
                dpT, drT = self.put_transposed(sigma_proj_dofs, rhs_dofs)
            else:
                dpT = jnp.moveaxis(jnp.asarray(sigma_proj_dofs, self.dtype), 1, -1)
                drT = jnp.moveaxis(jnp.asarray(rhs_dofs, self.dtype), 1, -1)
            if getattr(self, "_jit_eqT", None) is None:
                self._jit_eqT = jax.jit(
                    self._equilibrate_impl_T, static_argnames=("weak_symmetry",)
                )
            return self._jit_eqT(
                dpT, drT, jnp.asarray(facet_kind),
                jnp.asarray(bvals, self.dtype), dev, refd, ws_skip,
                weak_symmetry=weak_symmetry,
            )
        args = (
            jnp.asarray(sigma_proj_dofs, self.dtype),
            jnp.asarray(rhs_dofs, self.dtype),
            jnp.asarray(facet_kind),
            jnp.asarray(bvals, self.dtype),
        )
        self._ensure_full_tables()  # legacy paths use batch-major tables
        dev, refd = self._device_tables()
        if not fuse:
            return self._equilibrate_unfused(*args, dev, refd, weak_symmetry)
        if self._jit_eq is None:
            self._jit_eq = jax.jit(
                self._equilibrate_impl, static_argnames=("weak_symmetry",)
            )
        return self._jit_eq(*args, dev, refd, weak_symmetry=weak_symmetry)

    def _equilibrate_unfused(self, d_proj, d_rhs, facet_kind, bvals, dev,
                             refd, weak_symmetry):
        """Per-bucket dispatch (fuse=False): one jitted executable per
        (bucket signature, padded patch count) from a MODULE-LEVEL cache, so
        adaptive loops — a fresh engine per refined mesh — reuse compiled
        bucket programs whose shapes recur (with ``pad_quantize`` most do).
        The cached closure binds its creator engine; all per-mesh data flows
        through the dv/refd arguments, and the engine-side statics
        (patch_idx, se_static, reference tensors) are functions of
        (k, bucket signature) only, so reuse across engines is exact."""
        if not hasattr(self, "_jit_scatter"):
            self._jit_scatter = jax.jit(
                lambda x, sol, gd: x.at[:, gd].add(sol), donate_argnums=0
            )

        def make(key):
            def run(dp, dr, fk, bv, dv, rf):
                with jax.default_matmul_precision("float32"):
                    sol = self._solve_bucket(key, dp, dr, fk, bv, dv, rf)
                    if weak_symmetry:
                        from .stress import weak_symmetry_bucket

                        delta = weak_symmetry_bucket(
                            self, key, sol[:2], fk[:2], dp[:2], dv, rf
                        )
                        sol = sol.at[:2].add(delta)
                    return sol

            return jax.jit(run)

        n_rhs = d_proj.shape[0]
        x = jnp.zeros((n_rhs, self.V.ndofs), self.dtype)
        for key in sorted(self.buckets.keys()):
            # npatches (the true count) never enters the traced program —
            # pads are solved too and scatter out of bounds — so reuse is
            # keyed on the PADDED patch count only
            jkey = (
                self.k, str(np.dtype(self.dtype)), self.mode,
                key[:2], self.tables[key]["J"].shape[0], weak_symmetry,
            )
            fn = _UNFUSED_JIT_CACHE.get(jkey)
            if fn is None:
                if len(_UNFUSED_JIT_CACHE) >= 64:  # bound closure-held
                    _UNFUSED_JIT_CACHE.clear()  # engines (host tables)
                fn = _UNFUSED_JIT_CACHE[jkey] = make(key)
            sol = fn(d_proj, d_rhs, facet_kind, bvals, dev[key], refd)
            x = self._jit_scatter(x, sol, dev[key]["gdofs"])
        return x

    def _equilibrate_impl(
        self, d_proj, d_rhs, facet_kind, bvals, dev, refd, weak_symmetry=False
    ):
        if self.mode == "semiexplicit":
            return self._equilibrate_impl_T(
                jnp.moveaxis(d_proj, 1, -1), jnp.moveaxis(d_rhs, 1, -1),
                facet_kind, bvals, dev, refd, weak_symmetry=weak_symmetry,
            )
        n_rhs = d_proj.shape[0]
        x = jnp.zeros((n_rhs, self.V.ndofs), self.dtype)
        for key in sorted(self.buckets.keys()):
            sol = self._solve_bucket(
                key, d_proj, d_rhs, facet_kind, bvals, dev[key], refd
            )
            if weak_symmetry:
                from .stress import weak_symmetry_bucket

                delta = weak_symmetry_bucket(
                    self, key, sol[:2], facet_kind[:2], d_proj[:2], dev[key], refd
                )
                sol = sol.at[:2].add(delta)
            x = x.at[:, dev[key]["gdofs"]].add(sol)
        return x

    def _equilibrate_impl_T(
        self, dpT, drT, facet_kind, bvals, dev, refd, ws_skip=None,
        weak_symmetry=False,
    ):
        """Semi-explicit fused program on pre-transposed (batch-last) data:
        dpT (n_rhs, 2, ndg, nc), drT (n_rhs, ndg, nc)."""
        with jax.default_matmul_precision("float32"):
            return self._equilibrate_impl_T_inner(
                dpT, drT, facet_kind, bvals, dev, refd, ws_skip,
                weak_symmetry,
            )

    def _equilibrate_impl_T_inner(
        self, dpT, drT, facet_kind, bvals, dev, refd, ws_skip,
        weak_symmetry,
    ):
        # NOTE: full f32 matmul precision is load-bearing (see
        # _equilibrate_impl_T): a reduced-precision contraction (TF32 on the
        # GPU) would put a ~1e-3 relative error on the equilibrated dofs
        from .semiexplicit import solve_bucket_semiexplicit
        from .stress import weak_symmetry_bucket

        n_rhs = dpT.shape[0]
        dprT = jnp.concatenate([dpT, drT[:, None]], axis=1)
        # cell-major copy of the per-cell dof data, shared by every bucket's
        # row gather (see load_moments_bl): one gathered row holds every
        # field's moments of a cell.  The pad to 128 columns was sized for
        # an earlier backend's gather; whether it pays on the GPU is open
        # (ROADMAP item 1.5)
        nc = dprT.shape[-1]
        w = dprT.shape[1] * dprT.shape[2] * n_rhs
        # n_rhs == 1 keeps the minor-axis gather
        if 1 < n_rhs and w <= 128:
            src_packed = jnp.moveaxis(dprT.reshape(-1, nc), 0, 1)
            src_packed = jnp.pad(src_packed, ((0, 0), (0, 128 - w)))
            src_packed = jax.lax.optimization_barrier(src_packed)
        else:
            src_packed = None
        flats = []
        for key in sorted(self.buckets.keys()):
            sol_bl = solve_bucket_semiexplicit(
                self, key, dprT, facet_kind, bvals, dev[key], refd,
                src_packed=src_packed,
            )
            # fusion fence: guarded against a miscompile seen on an earlier
            # backend (NaN in one bucket pipeline fused with its
            # neighbours); whether it is still needed is open (ROADMAP 1.5)
            sol_bl = jax.lax.optimization_barrier(sol_bl)
            if weak_symmetry:
                if "Bsym_bl" in dev[key]:
                    from .stress import weak_symmetry_bucket_bl

                    delta = weak_symmetry_bucket_bl(
                        self, key, sol_bl[:2], facet_kind[:2], dev[key], refd,
                        skip=None if ws_skip is None else ws_skip[key],
                    )
                    delta = jax.lax.optimization_barrier(delta)
                    sol_bl = sol_bl.at[:2].add(delta)
                else:
                    d_proj2 = jnp.moveaxis(dpT[:2], -1, 1)
                    sol = jnp.moveaxis(sol_bl, -1, 1)  # (n_rhs, P, nflux)
                    delta = weak_symmetry_bucket(
                        self, key, sol[:2], facet_kind[:2], d_proj2,
                        dev[key], refd,
                    )
                    sol_bl = sol_bl.at[:2].add(jnp.moveaxis(delta, 1, -1))
            flats.append(sol_bl.reshape(n_rhs, -1))
        flat = jnp.concatenate(flats, axis=1)
        if os.environ.get("EQLB_SKIP_COMBINE"):
            # timing diagnostic ONLY: drop the dof-combine program tail
            # (output has the right (n_rhs, ndofs) shape but wrong values)
            return flat[:, : self.V.ndofs]
        return self._combine_flat(flat, refd)

    def _combine_flat(self, flat, refd):
        """Global accumulation of the concatenated flat bucket solutions
        (n_rhs, L) -> (n_rhs, ndofs) by an element gather: every dof sums
        its two facet-patch contributions (columns 0, 1) and, for cell
        dofs, a third (column 2).  Missing contributors read the zero pad
        slot at position L."""
        cm = self._combine
        with jax.named_scope("eqlb_combine"):
            flat = jnp.pad(flat, ((0, 0), (0, 1)))
            x = flat[:, refd["elem_c0"]] + flat[:, refd["elem_c1"]]
            return x.at[:, cm["nfk"]:].add(flat[:, refd["elem_c2"]])

    # -------------------------------------------------------------------------

    def _solve_bucket(self, key, d_proj, d_rhs, facet_kind, bvals, dv, refd):
        if self.mode == "semiexplicit":
            from .semiexplicit import solve_bucket_semiexplicit

            dpT = jnp.moveaxis(d_proj, 1, -1)
            drT = jnp.moveaxis(d_rhs, 1, -1)
            sol_bl = solve_bucket_semiexplicit(
                self, key, jnp.concatenate([dpT, drT[:, None]], axis=1),
                facet_kind, bvals, dv, refd,
            )
            return jnp.moveaxis(sol_bl, -1, 1)
        Ar, br, nflux = self._assemble_bucket(
            key, d_proj, d_rhs, facet_kind, bvals, dv, refd
        )
        sol = self._dense_solve(Ar, br[..., None])[..., 0]
        return sol[:, :, :nflux]

    def _dense_solve(self, A, b):
        """Batched pivoted solve (XLA LU): A (..., D, D), b (..., D, R)."""
        with jax.named_scope("eqlb_dense_solve"):
            return jnp.linalg.solve(A, b)

    def _dense_solve_bl(self, A, b):
        """Batch-last pivoted solve: A (D, D, X), b (D, R, X) -> (D, R, X).
        Pivoting matters for the indefinite weak-symmetry KKT systems:
        symmetric patches (e.g. the 8-cell stars of crossed meshes) put an
        exactly-zero pivot in the natural elimination order even though the
        matrix itself is well conditioned."""
        Ab = jnp.moveaxis(A, -1, 0)
        bb = jnp.moveaxis(b, -1, 0)
        return jnp.moveaxis(self._dense_solve(Ab, bb), 0, -1)

    def _element_data(self, key, d_proj, d_rhs, dv, refd):
        """Canonical per-cell element tensors of one bucket:
        Mc (P,n,nkeep,nkeep), Bc (P,n,nkeep,ndg), Fv (n_rhs,P,n,nkeep),
        Fq (n_rhs,P,n,ndg) — shared by the KKT and semi-explicit paths."""
        b = self.buckets[key]
        k = self.k
        ndg = k * (k + 1) // 2
        n = b.ncells
        P = dv["J"].shape[0]  # padded patch count
        n_rhs = d_proj.shape[0]
        dt = self.dtype
        J, detJ, K = dv["J"], dv["detJ"], dv["K"]
        adet = jnp.abs(detJ)
        sdet = jnp.sign(detJ)
        perm, signs = dv["perm"], dv["signs"]
        cells, lnode = dv["cells"], dv["lnode"]

        # --- element tensors in canonical order --------------------------------
        JtJ = jnp.einsum("pcka,pckb->pcab", J, J)
        Mgeo = jnp.einsum("pcab,abij->pcij", JtJ, refd["Mhat"])
        Mgeo = Mgeo / adet[..., None, None]
        Mc = jnp.take_along_axis(Mgeo, perm[..., None], axis=2)
        Mc = jnp.take_along_axis(Mc, perm[..., None, :], axis=3)
        Mc = Mc * signs[..., :, None] * signs[..., None, :]

        Dg = refd["Dhat"][perm]  # (P, n, nkeep, ndg)
        Bc = sdet[..., None, None] * Dg * signs[..., None]

        # --- per-cell RHS data ---------------------------------------------------
        # the hat-function index lnode takes only 3 values: contract against
        # each reference slice and blend with one-hot masks instead of
        # materialising gathered (P, n, ...) reference tables
        dp = d_proj[:, cells]  # (n_rhs, P, n, 2, ndg)
        fr = d_rhs[:, cells]  # (n_rhs, P, n, ndg)
        dpJ = jnp.einsum("rpcam,pcab->rpcbm", dp, J)  # (n_rhs, P, n, 2, ndg)
        Fv_full = jnp.zeros(dp.shape[:3] + (refd["Rhat"].shape[-1],), dt)
        Fq = jnp.zeros((n_rhs, P, n, ndg), dt)
        for l in range(3):
            wl = (lnode == l).astype(dt)  # (P, n)
            Fv_full = Fv_full + wl[None, ..., None] * jnp.einsum(
                "rpcbm,mbi->rpci", dpJ, refd["Rhat"][l]
            )
            Fq = Fq + wl[None, ..., None] * jnp.einsum(
                "rpcm,mq->rpcq", fr, refd["T3"][l]
            )
            # grad(psi)_a = K_{ba} ghat_b contribution
            gpsi_l = jnp.einsum("pcba,b->pca", K, refd["hat_grads"][l])
            Fq = Fq + wl[None, ..., None] * jnp.einsum(
                "pca,rpcaq->rpcq", gpsi_l, dp
            )
        Fv_full = Fv_full * sdet[None, ..., None]
        Fq = Fq * adet[None, ..., None]
        Fv = jnp.take_along_axis(
            Fv_full, perm[None].repeat(n_rhs, 0), axis=3
        ) * signs[None]
        return Mc, Bc, Fv, Fq

    def _boundary_ess(self, key, facet_kind, bvals, dv, refd):
        """Essential-spoke markers and hat-weighted dof values of a boundary
        bucket: (ess (n_rhs,P,2) bool, hatvals (n_rhs,P,2,k)).  (None, None)
        for interior buckets."""
        b = self.buckets[key]
        if not b.is_boundary:
            return None, None
        k = self.k
        dt = self.dtype
        bsp = dv["bspokes"]  # (P, 2)
        kind = facet_kind[:, bsp]  # (n_rhs, P, 2)
        z_lo = dv["z_is_lo"]  # (P, 2)
        # hat-weighted dof values on flux-essential spokes:
        # alpha_j = bvals_j * (2j+1); val_m = alpha_j Wend[end, j, m]
        scale = jnp.asarray(2.0 * np.arange(k) + 1.0, dt)
        alpha = bvals[:, bsp] * scale  # (n_rhs, P, 2, k)
        Wend = refd["Wend"]  # (2, k, k)
        Wsel = jnp.where(z_lo[..., None, None], Wend[0], Wend[1])
        hatvals = jnp.einsum("rpej,pejm->rpem", alpha, Wsel)
        return kind == 2, hatvals

    def _assemble_bucket(self, key, d_proj, d_rhs, facet_kind, bvals, dv, refd):
        b = self.buckets[key]
        t = self.tables[key]
        k = self.k
        kk1 = self.V.element.ndofs_cell
        ndg = k * (k + 1) // 2
        n, ns = b.ncells, b.nspokes
        P = dv["J"].shape[0]  # padded patch count
        n_rhs = d_proj.shape[0]

        D = ns * k + n * kk1 + n * ndg
        nflux = ns * k + n * kk1

        dt = self.dtype
        adet = jnp.abs(dv["detJ"])
        Mc, Bc, Fv, Fq = self._element_data(key, d_proj, d_rhs, dv, refd)

        # --- assemble the dense patch systems -----------------------------------
        A = jnp.zeros((P, D, D), dt)
        bvec = jnp.zeros((n_rhs, P, D), dt)
        cvec = jnp.zeros((P, n * ndg), dt)  # constraint mean-mode vector
        cpen = refd["cpen"]
        pidx = t["patch_idx"]  # (n, nkeep) static numpy
        for i in range(n):
            ix = pidx[i]
            qrow = ns * k + n * kk1 + i * ndg + np.arange(ndg)
            A = A.at[:, ix[:, None], ix[None, :]].add(Mc[:, i])
            A = A.at[:, qrow[:, None], ix[None, :]].add(
                jnp.swapaxes(Bc[:, i], 1, 2)
            )
            A = A.at[:, ix[:, None], qrow[None, :]].add(-Bc[:, i])
            cvec = cvec.at[:, i * ndg + np.arange(ndg)].add(
                adet[:, i, None] * cpen[None, :]
            )
            bvec = bvec.at[:, :, ix].add(Fv[:, :, i])
            bvec = bvec.at[:, :, qrow].add(Fq[:, :, i])

        # --- essential conditions ------------------------------------------------
        mask = jnp.zeros((n_rhs, P, D), dtype=bool)
        values = jnp.zeros((n_rhs, P, D), dt)
        if b.is_boundary:
            ess, hatvals = self._boundary_ess(key, facet_kind, bvals, dv, refd)
            for e, sp in enumerate((0, ns - 1)):
                cols = sp * k + np.arange(k)
                mask = mask.at[:, :, cols].set(ess[:, :, e : e + 1])
                values = values.at[:, :, cols].set(
                    jnp.where(ess[:, :, e : e + 1], hatvals[:, :, e], 0.0)
                )
            # multiplier active only if both spokes are flux-essential
            lam_on = ess[:, :, 0] & ess[:, :, 1]
        else:
            lam_on = jnp.ones((n_rhs, P), dtype=bool)

        # mean-value multiplier as an exact rank-1 regularization: the
        # constraint Schur complement B M^-1 B^T is PSD with null space
        # spanned by the constant mode c on interior / pure-Neumann patches;
        # adding beta c c^T to the r-block leaves sigma unchanged (B^T c = 0)
        # and makes every pivot of the [sigma | r] ordering structurally
        # nonzero — the bordered-lambda form of the reference
        # (ev/assembly.hpp:280-305) has an exactly-zero diagonal entry
        R1 = cvec[:, :, None] * cvec[:, None, :] / (
            jnp.einsum("pq,pq->p", cvec, cvec)[:, None, None]
        )
        Ar = jnp.broadcast_to(A[None], (n_rhs,) + A.shape)
        Ar = Ar + jnp.where(
            lam_on[..., None, None],
            jnp.pad(R1, ((0, 0), (nflux, 0), (nflux, 0)))[None],
            0.0,
        )
        eye = jnp.eye(D, dtype=dt)
        Ar = jnp.where(mask[..., None], eye[None, None], Ar)
        br = jnp.where(mask, values, bvec)
        return Ar, br, nflux
