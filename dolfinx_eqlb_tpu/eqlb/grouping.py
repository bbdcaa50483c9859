"""Patch grouping for deficient pure-traction boundary patches.

A boundary patch whose (<= 2) boundary spokes all carry traction data cannot
satisfy the weak-symmetry constraints at flux degree 2: the free correction
space (1 hierarchic spoke moment per stress row) is smaller than the patch
P1 constraint space.  The reference merges such patches with an adjacent
interior patch and imposes weak symmetry jointly on the union
(``se/reconstruction.hpp:166-234``, ``se/Patch.cpp:60-104``
``group_boundary_patches``, ``se/solve_patch_weaksym.hpp:100-143`` re-reads
the global vector for the modified patch).

Here: the batched engine SKIPS the per-patch weak-symmetry
correction for every grouped member (deficient patches and their interior
partners), then this module applies one small joint correction per group as
a host-driven post-pass on the global flux rows:

* correction space = direct sum of the members' divergence-free bases Z_w
  (so the divergence conditions stay intact patch by patch),
* constraints = P1 hats of the union domain,
* constraint data = the residual antisymmetric moments of the global
  reconstructed stress (after the per-patch pass, every non-member patch's
  contribution to these moments vanishes by its own constraint, so the
  global moments ARE the group residuals — the reference's global re-read).

Groups are rare (traction-boundary corners), so the per-group dense solves
run on host-sized data.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..elements.quadrature import gauss_triangle
from .patches import deficient_stress_vertices

__all__ = ["build_groups", "grouped_weak_symmetry"]


def build_groups(engine, facet_kind2: np.ndarray):
    """Find deficient pure-traction boundary patches and pair each with an
    adjacent interior patch (reference ``adjacent_internal_patch``,
    ``se/Patch.cpp:761-784``).  Deficient patches sharing a partner merge
    into one group.  Returns (groups, skip_nodes): groups = list of lists of
    vertex ids (partner first), skip_nodes = all grouped vertices."""
    mesh = engine.mesh
    bad = deficient_stress_vertices(mesh, np.asarray(facet_kind2))
    if len(bad) == 0:
        return [], np.zeros(0, dtype=np.int64)
    interior = ~mesh.is_boundary_vertex
    partner_of = {}
    for z in bad:
        partner = -1
        for c in mesh.vertex_cells(int(z)):
            for v in mesh.cells[c]:
                if interior[v]:
                    partner = int(v)
                    break
            if partner >= 0:
                break
        if partner < 0:
            raise ValueError(
                f"Incompatible mesh: deficient pure-traction patch at vertex "
                f"{int(z)} has no adjacent interior patch to group with."
            )
        partner_of.setdefault(partner, []).append(int(z))
    groups = [[p] + zs for p, zs in partner_of.items()]

    # merge groups whose constraint-node neighbourhoods intersect: group A's
    # correction perturbs the residual moments Lmom[v] exactly for the
    # vertices v of A's member-patch cells, so two groups sharing such a
    # vertex must be solved as one joint system (sequential solves would use
    # stale residuals and invalidate each other's enforced constraints)
    def neighborhood(g):
        nodes = set()
        for z in g:
            for c in mesh.vertex_cells(int(z)):
                nodes.update(int(v) for v in mesh.cells[c])
        return nodes

    hoods = [neighborhood(g) for g in groups]
    merged = True
    while merged:
        merged = False
        for i in range(len(groups)):
            for j in range(i + 1, len(groups)):
                if hoods[i] & hoods[j]:
                    groups[i] = groups[i] + groups[j]
                    hoods[i] |= hoods[j]
                    del groups[j], hoods[j]
                    merged = True
                    break
            if merged:
                break
    skip = np.array(sorted({v for g in groups for v in g}), dtype=np.int64)
    return groups, skip


def _member_data(engine, z: int):
    """Locate vertex z's patch: (bucket key, position) plus host views of
    the tables the joint system needs."""
    for key, b in engine.buckets.items():
        idx = np.where(b.nodes == z)[0]
        if len(idx):
            return key, int(idx[0])
    raise KeyError(z)


def grouped_weak_symmetry(engine, x, facet_kind2, groups):
    """Joint weak-symmetry corrections for ``groups`` applied to the global
    stress rows x (2, ndofs).  Returns the corrected x.

    Device-resident steady state: the joint KKT systems S depend only on
    geometry and the (static) group structure, so their minimum-norm
    inverses are folded — once, at first call — into per-group linear maps
    ``delta_dofs = -M @ Lmom`` (``_group_operators``).  The per-call pass is
    then one small jitted program (gather one-ring dofs -> residual moments
    -> matmul -> scatter-add); no host NumPy between equilibrate calls
    (VERDICT round-3 item 8)."""
    if not groups:
        return x
    ops = _group_operators(engine, np.asarray(facet_kind2), groups)
    if getattr(engine, "_group_apply_jit", None) is None:
        import jax

        engine._group_apply_jit = jax.jit(_grouped_apply)
    return engine._group_apply_jit(jnp.asarray(x), ops)


def _grouped_apply(x, ops):
    """Jitted device pass: residual antisymmetry moments over the groups'
    one-ring cells, then the precomputed correction maps.

    L_n = (sigma_R01 - sigma_R10, hat_n): after the per-patch corrections
    every NON-member patch's contribution to L_n vanishes by its own
    constraint, so L restricted to a group's nodes IS that group's residual
    (the projected stress is pointwise symmetric and drops out).  Merged
    groups have disjoint one-ring neighbourhoods (build_groups), so all
    corrections apply from the same moment vector."""
    gath = x[:, ops["cd_loc"]] * ops["signs_loc"][None]
    ref = jnp.einsum("rcd,daq->rcqa", gath, ops["tab"])
    phys = jnp.einsum("cab,rcqb->rcqa", ops["J_loc"], ref) / (
        ops["detJ_loc"][None, :, None, None]
    )
    asym = phys[0, :, :, 1] - phys[1, :, :, 0]  # (nloc, nq)
    be = jnp.einsum("q,cq,lq,c->cl", ops["w"], asym, ops["hat"],
                    ops["adet_loc"])
    # compressed scatter: node ids outside the constraint set map to the
    # out-of-bounds slot C_tot and are dropped by the jit scatter semantics
    C_tot = ops["M"].shape[-1]
    Lmom = jnp.zeros(C_tot).at[ops["node_sel"].reshape(-1)].add(
        be.reshape(-1), mode="drop"
    )
    delta = -jnp.einsum("rdc,c->rd", ops["M"], Lmom)
    return x.at[:, ops["gdofs"]].add(delta)


def _group_operators(engine, fk2, groups):
    """Host precompute (cached per engine + group structure + BC kinds):
    the static tables of ``_grouped_apply``."""
    gkey = (tuple(tuple(g) for g in groups), fk2.tobytes())
    cache = getattr(engine, "_group_ops_cache", None)
    if cache is not None and cache[0] == gkey:
        return cache[1]
    mesh = engine.mesh
    k = engine.k
    kk1 = engine.V.element.ndofs_cell
    dev, refd = engine._device_tables()
    engine.ensure_stress_caches()

    # one-ring cells of all groups' constraint nodes
    need_nodes = set()
    for g in groups:
        for z in g:
            for c in mesh.vertex_cells(int(z)):
                need_nodes.update(int(v) for v in mesh.cells[c])
    loc_cells = np.unique(np.concatenate(
        [mesh.vertex_cells(v) for v in sorted(need_nodes)]
    )).astype(np.int64)

    pts, w = gauss_triangle(2 * k + 2)
    el = engine.V.element
    tab = el.tabulate(pts)  # (nrt, 2, nq)
    hat = np.stack([1 - pts[:, 0] - pts[:, 1], pts[:, 0], pts[:, 1]])
    cd_loc = engine.V.cell_dofs[loc_cells].astype(np.int64)
    J_loc, detJ_loc = mesh.J[loc_cells], mesh.detJ[loc_cells]

    # per-group correction maps: dof_delta_r = -(M_g)_r @ Lmom[nodes_all].
    # y = S^+ rhs is linear in the moment vector (rhs has entries -Lmom on
    # the constraint block), so expanding S^+ through the member Z bases
    # gives the map directly; pinv == the lstsq minimum-norm solution.
    gdofs_parts, M_parts, nodes_parts = [], [], []
    for group in groups:
        S, members, freecols, offs, total, nodes_all, node_id = \
            _group_system(engine, dev, fk2, group, k)
        C = len(nodes_all)
        Sp = np.linalg.pinv(S)
        # columns of S^+ for unit constraint data, expanded through Z
        nf_g = sum(len(m["gdofs"]) for m in members)
        Mg = np.zeros((2, nf_g, C))
        dof_off = 0
        for mi, mem in enumerate(members):
            st = mem["st"]
            b = mem["b"]
            n, ns = b.ncells, b.nspokes
            nflux = ns * k + n * kk1
            fc = freecols[mi]
            for row in range(2):
                ysl = Sp[row * total + offs[mi]:
                         row * total + offs[mi] + len(fc),
                         2 * total: 2 * total + C]  # (len(fc), C)
                yw = np.zeros((st["Dz"], C))
                yw[fc] = ysl
                dd = np.zeros((nflux, C))
                dd[st["sel"]] += yw[1:]
                dd[0: ns * k: k] += yw[0][None] * mem["cum"][:, None]
                Mg[row, dof_off: dof_off + nflux] = dd
            dof_off += nflux
        gdofs_parts.append(np.concatenate(
            [m["gdofs"] for m in members]))
        M_parts.append(Mg)
        nodes_parts.append(nodes_all)

    # concatenate groups (disjoint constraint sets) into one block map
    gdofs = np.concatenate(gdofs_parts)
    C_tot = sum(len(nn) for nn in nodes_parts)
    NF = sum(m.shape[1] for m in M_parts)
    M = np.zeros((2, NF, C_tot))
    ro = co = 0
    for Mg in M_parts:
        M[:, ro: ro + Mg.shape[1], co: co + Mg.shape[2]] = Mg
        ro += Mg.shape[1]
        co += Mg.shape[2]
    # vertex -> compressed constraint index (C_tot == dropped)
    vmap = np.full(mesh.num_vertices, C_tot, dtype=np.int64)
    co = 0
    for nn in nodes_parts:
        vmap[nn] = co + np.arange(len(nn))
        co += len(nn)
    node_sel = vmap[mesh.cells[loc_cells]]  # (nloc, 3)

    ops = dict(
        cd_loc=jnp.asarray(cd_loc),
        signs_loc=jnp.asarray(engine.V.dof_signs[loc_cells]),
        tab=jnp.asarray(tab),
        hat=jnp.asarray(hat),
        w=jnp.asarray(w),
        J_loc=jnp.asarray(J_loc),
        detJ_loc=jnp.asarray(detJ_loc),
        adet_loc=jnp.asarray(np.abs(detJ_loc)),
        node_sel=jnp.asarray(node_sel),
        gdofs=jnp.asarray(gdofs),
        M=jnp.asarray(M),
    )
    engine._group_ops_cache = (gkey, ops)
    engine._group_apply_jit = None  # ops pytree changed: retrace
    return ops


def _group_system(engine, dev, fk2, group, k):
    """Assemble one group's joint KKT system S (host, build-time only).
    Returns (S, members, freecols, offs, total, nodes_all, node_id)."""
    mesh = engine.mesh
    members = []
    cells_all = []
    for z in group:
        key, p = _member_data(engine, z)
        b = engine.buckets[key]
        st = engine.se_static[key]
        t = engine.tables[key]
        mem = dict(
            key=key, p=p, z=z, b=b, st=st,
            cells=b.cells[p].astype(np.int64),
            spokes=b.spokes[p].astype(np.int64),
            gdofs=t["gdofs"][p].astype(np.int64),
            Az=np.asarray(dev[key]["Az_bl"][..., p]),
            Bsym=np.asarray(dev[key]["Bsym_bl"][..., p]),
            cum=np.asarray(dev[key]["cumalpha_bl"][:, p]),
        )
        members.append(mem)
        cells_all.extend(mem["cells"].tolist())
    cells_all = np.unique(cells_all)
    nodes_all = np.unique(mesh.cells[cells_all].reshape(-1))
    node_id = {int(v): i for i, v in enumerate(nodes_all)}
    C = len(nodes_all)

    # free columns of each member's Z (deficient members: boundary
    # spokes essential -> d0 and their higher moments are pinned)
    offs, total = [], 0
    freecols = []
    for mem in members:
        st = mem["st"]
        Dz = st["Dz"]
        free = np.ones(Dz, dtype=bool)
        if mem["b"].is_boundary:
            bsp = mem["spokes"][[0, -1]]
            ess = (fk2[:, bsp] == 2).any(axis=0)
            if ess[0] or ess[1]:
                free[0] = False
            if k > 1 and ess[0]:
                free[1:k] = False
            if k > 1 and ess[1]:
                ns = mem["b"].nspokes
                free[1 + (ns - 1) * (k - 1) : 1 + ns * (k - 1)] = False
        freecols.append(np.where(free)[0])
        offs.append(total)
        total += int(free.sum())

    D = 2 * total + C + 1
    S = np.zeros((D, D))

    adet = np.abs(mesh.detJ[cells_all])

    # member blocks
    for mi, mem in enumerate(members):
        st = mem["st"]
        fc = freecols[mi]
        off = offs[mi]
        Azm = mem["Az"][np.ix_(fc, fc)]
        for row in range(2):
            o = row * total + off
            S[o : o + len(fc), o : o + len(fc)] = Azm
        # constraint coupling: per cell, hat slots -> union nodes
        b = mem["b"]
        n, ns = b.ncells, b.nspokes
        for i in range(n):
            # hat slot -> global vertex: slot 0 = z; 1/2 = spoke ends
            lv = [mem["z"]]
            for sp_ in (mem["spokes"][i], mem["spokes"][(i + 1) % ns if not b.is_boundary else i + 1]):
                fv = mesh.facet_vertices[sp_]
                lv.append(int(fv[1] if fv[0] == mem["z"] else fv[0]))
            B1 = mem["Bsym"][i, :, 1]  # (3, nkeep)
            B2 = -mem["Bsym"][i, :, 0]
            # reduce to member Z columns
            U = st["uslots"]
            ucols = st["ucols"][i]
            wen = mem["cum"][i]
            wex = mem["cum"][st["exit_idx"][i]]
            for comp, Bi in ((0, B1), (1, B2)):
                red = np.zeros((3, st["Dz"]))
                red[:, 0] = Bi[:, 0] * wen + Bi[:, k] * wex
                if len(U):
                    red[:, ucols] += Bi[:, U]
                red = red[:, fc]
                for sl in range(3):
                    h = 2 * total + node_id[lv[sl]]
                    o = comp * total + off
                    S[h, o : o + len(fc)] += red[sl]
                    S[o : o + len(fc), h] += red[sl]

    # multiplier column: int hat_h over the union
    hint = np.zeros(C)
    for ci, c in enumerate(cells_all):
        for l in range(3):
            hint[node_id[int(mesh.cells[c][l])]] += adet[ci] / 6.0
    S[2 * total + np.arange(C), D - 1] = hint
    S[D - 1, 2 * total + np.arange(C)] = hint

    return S, members, freecols, offs, total, nodes_all, node_id
