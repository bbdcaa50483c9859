"""Multi-GPU equilibration via patch-parallel SPMD.

The reference scales through MPI-distributed DOLFINx meshes: each rank owns
its vertices' patches and the (rare) shared data moves via ghost updates
(SURVEY.md section 2.7).  Here the equivalent is data parallelism over the
*patch batch*: every bucket's patch axis is sharded across a 1-D device
mesh; the per-patch assembly and batched solves are embarrassingly
parallel, and the only communication is the final combine into the
replicated global flux vector (each facet dof receives contributions from
exactly the two patches of its facet's endpoints), which GSPMD lowers to
collectives that XLA hands to NCCL.  On one host the GPUs are joined all to
all by NVLink, so the 1-D mesh follows the algorithm alone.  Pad patches
scatter out of bounds and are dropped.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..eqlb.engine import EqlbEngine

__all__ = ["ShardedEqlbEngine"]


class ShardedEqlbEngine:
    """Wraps an EqlbEngine so every bucket's tables are sharded over a
    1-D device mesh along the patch axis, inputs/outputs replicated."""

    def __init__(self, engine: EqlbEngine, mesh: Mesh, axis: str = "patches"):
        self.engine = engine
        self.mesh = mesh
        self.axis = axis
        ndev = mesh.devices.size
        for key, t in engine.tables.items():
            npad = t["J"].shape[0]
            if npad % ndev != 0:
                raise ValueError(
                    "construct the engine with pad_to_multiple=n_devices"
                )
        engine.ensure_stress_caches()  # dryruns exercise weak symmetry
        dev, refd = engine._device_tables()
        repl = NamedSharding(mesh, P())
        self.dev = {}
        for key, d in dev.items():
            npad = engine.tables[key]["J"].shape[0]
            out = {}
            for name, a in d.items():
                # shard along the patch axis wherever it sits: leading for
                # the batch-major tables, trailing for the batch-last ones
                # (gflat is nflux-major, so contiguous chunks are full
                # patch-ranges of one dof slot — still patch-parallel)
                if name.endswith("_bl") or name in ("S_stress", "Sinv_c"):
                    spec = P(*([None] * (a.ndim - 1) + [axis]))
                elif a.ndim >= 1 and a.shape[0] == npad:
                    spec = P(axis)
                else:
                    spec = P()
                out[name] = jax.device_put(a, NamedSharding(mesh, spec))
            self.dev[key] = out
        self.refd = jax.tree.map(lambda a: jax.device_put(a, repl), refd)
        # shard the FUSED batch-last program — the same code path the
        # single-chip fast path runs (semi-explicit + weak symmetry +
        # grouping skip masks)
        self._jit = jax.jit(
            engine._equilibrate_impl_T,
            static_argnames=("weak_symmetry",),
            out_shardings=repl,
        )

    def equilibrate(self, sigma_proj_dofs, rhs_dofs, facet_kind, bvals,
                    weak_symmetry=False, ws_skip_nodes=None):
        """Replicated-in/replicated-out equilibrate.  ``ws_skip_nodes``:
        patch vertices whose per-patch weak-symmetry correction must be
        skipped (deficient grouped patches — the joint group correction is
        a host post-pass, same as the single-device orchestration in
        equilibrators.py)."""
        eng = self.engine
        repl = NamedSharding(self.mesh, P())
        ws_skip = None
        if weak_symmetry and ws_skip_nodes is not None and len(ws_skip_nodes):
            shard_p = NamedSharding(self.mesh, P(self.axis))
            ws_skip = {}
            for key, b in eng.buckets.items():
                m = np.zeros(eng.tables[key]["J"].shape[0], bool)
                m[: b.npatches] = np.isin(b.nodes, ws_skip_nodes)
                ws_skip[key] = jax.device_put(jnp.asarray(m), shard_p)
        dpT = np.ascontiguousarray(
            np.moveaxis(np.asarray(sigma_proj_dofs, eng.dtype), 1, -1))
        drT = np.ascontiguousarray(
            np.moveaxis(np.asarray(rhs_dofs, eng.dtype), 1, -1))
        args = [
            jax.device_put(jnp.asarray(dpT), repl),
            jax.device_put(jnp.asarray(drT), repl),
            jax.device_put(jnp.asarray(facet_kind), repl),
            jax.device_put(jnp.asarray(bvals, eng.dtype), repl),
        ]
        return self._jit(*args, self.dev, self.refd, ws_skip,
                         weak_symmetry=weak_symmetry)
