"""Headline benchmark: patches/sec equilibrated at RT2 on a 1M-cell mesh.

One equilibrate call over a 1M-cell triangular mesh (all 501k vertex
patches batched, semi-explicit strategy at RT2) on one GPU.
``vs_baseline`` = (0.1 s) / (measured seconds per equilibrate): the ratio
against a 100 ms reference latency, the original target for this call.

Runs on the GPU only: on any other backend it prints a structured error
line and exits non-zero.  Compute dtype is float32 by default; ``--mixed``
switches to float64 data (native f64, XLA solves) and reports the on-device
divergence residual alongside the latency — the accuracy-grade
configuration.  All index tables enter the jitted program as device
arguments.

The strict per-call latency JSON line is printed BEFORE the pipelined loop,
so even a mid-run kill captures the primary metric.  Compiled executables
persist in the compile cache (``dolfinx_eqlb_tpu.utils.compile_cache``).

Steady state is measured two ways: ``latency`` (block_until_ready after
every call) and ``pipelined`` (8 calls in flight, one wait) — the latter is
the headline: repeated equilibrations (the adaptive-loop usage) never wait
in between.
"""

import json
import os
import sys
import time

import numpy as np

_t_start = time.perf_counter()


def log(msg):
    print(f"[{time.perf_counter()-_t_start:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def emit(payload):
    print(json.dumps(payload), flush=True)


def fail(stage, detail, metric="RT2 flux equilibration throughput"):
    """Structured failure: one parseable JSON line on stdout, then exit 3.
    vs_baseline 0.0 marks the run red without requiring a reader to
    special-case a non-JSON traceback."""
    log(f"FAILED at {stage}: {detail}")
    emit({
        "metric": metric,
        "value": 0.0,
        "unit": "patches/s",
        "vs_baseline": 0.0,
        "error": f"{stage}: {detail}",
    })
    sys.exit(3)


def make_data(msh, k, n_fields, stress, biot, dtype, mg_meshes=None):
    """Per-cell dof data for the bench.  ``biot`` replaces the random
    multi-field data with the three physical fields of a poro-elasticity
    primal solve (BASELINE config 5 made honest — reference
    perftest_basics.py:294-360): two stress rows + the Darcy flux.
    ``mg_meshes`` (the bench mesh's red-refinement hierarchy) switches the
    solve to block-multigrid MINRES: mesh-independent iteration counts at
    rtol 1e-6 even in f32, where Jacobi needed 20k+ iterations."""
    ndg = k * (k + 1) // 2
    nc = msh.num_cells
    nf = max(n_fields, 2) if stress else n_fields
    if biot:
        from dolfinx_eqlb_tpu.models.biot import biot_bench_fields

        # f32 compute caps the attainable MINRES residual; the bench only
        # needs physically coupled fields, not f64-grade dofs (the
        # equilibration invariants and its timing are data-independent).
        # chunk = MINRES iterations per device dispatch; with the V-cycle
        # each iteration is ~10 matvec-equivalents, so chunk drops to 25
        rtol = 1e-10 if dtype == np.float64 else (
            1e-6 if mg_meshes is not None else 1e-4)
        t0 = time.perf_counter()
        import jax.numpy as _jnp

        sdt = _jnp.float64 if dtype == np.float64 else _jnp.float32
        d_proj, d_rhs = biot_bench_fields(
            msh, k, rtol=rtol, dtype=sdt,
            chunk=25 if mg_meshes is not None else 100,
            maxiter=(20000 if dtype == np.float64 else
                     (400 if mg_meshes is not None else 1000)),
            mg_meshes=mg_meshes)
        nf = d_proj.shape[0]
        log(f"biot primal fields: {nf} fields from the coupled solve "
            f"({time.perf_counter()-t0:.1f}s)")
    elif dtype == np.float64:
        # accuracy-grade (f64) run: the divergence invariant is NOT
        # data-independent — the semi-explicit step needs the hat-function
        # compatibility sum_patch(hat_i f - grad hat_i . sigma_proj) = 0,
        # which Galerkin solutions satisfy by construction and raw random
        # dofs do not (measured: 144 residual at 4k cells).  Random data
        # that IS exactly compatible: sigma_proj = curl z for a random C0
        # P_k function z (discretely divergence-free against every hat),
        # f = 0.  Dense dofs, identical op counts — timing is unaffected.
        import jax.numpy as _jnp

        from dolfinx_eqlb_tpu.eqlb.equilibrators import _dg_dofs
        from dolfinx_eqlb_tpu.fem import (
            Function, FunctionSpace, grad, local_projection,
        )

        t0 = time.perf_counter()
        rng = np.random.default_rng(0)
        Vp = FunctionSpace(msh, "P", k)
        Vf = FunctionSpace(msh, "DG", k - 1, vs=2)
        rows = []
        for r in range(nf):
            z = Function(Vp, _jnp.asarray(rng.normal(size=Vp.ndofs)))
            d = _dg_dofs(local_projection(Vf, [grad(z)])[0], ndg)
            rows.append(np.stack([d[:, 1], -d[:, 0]], axis=1))
        d_proj = np.stack(rows)
        d_rhs = np.zeros((nf, nc, ndg))
        log(f"compatible curl-field data ({time.perf_counter()-t0:.1f}s)")
    else:
        rng = np.random.default_rng(0)
        d_proj = rng.normal(size=(nf, nc, 2, ndg))
        d_rhs = rng.normal(size=(nf, nc, ndg))
    facet_kind = (
        np.where(msh.is_boundary_facet, 1, 0).astype(np.int8)[None]
        .repeat(nf, 0)
    )
    bvals = np.zeros((nf, msh.num_facets, k))
    return (d_proj.astype(dtype), d_rhs.astype(dtype), facet_kind,
            bvals.astype(dtype), nf)


def divergence_residual(msh, k, x, d_proj, d_rhs):
    """On-device f64 divergence residual of one equilibrated field:
    ``(err, scale)`` with err = max|div sigma_R - Pi f| and scale =
    max|sigma_R| / h_min (``checks.divergence_error_scale``).  Valid on
    hat-compatible data only (see make_data): raw random dofs violate the
    invariant regardless of solver accuracy."""
    import jax.numpy as jnp

    from dolfinx_eqlb_tpu.eqlb.checks import (
        check_divergence_condition, divergence_error_scale,
    )
    from dolfinx_eqlb_tpu.fem import Function, FunctionSpace

    V = FunctionSpace(msh, "RT", k)
    Vdg2 = FunctionSpace(msh, "DG", k - 1, vs=2)
    Vdg1 = FunctionSpace(msh, "DG", k - 1, vs=1)
    sig = Function(V, jnp.asarray(x, jnp.float64))
    ps = Function(Vdg2, jnp.asarray(d_proj.transpose(1, 0, 2).reshape(-1),
                                    jnp.float64))
    pf = Function(Vdg1, jnp.asarray(d_rhs.reshape(-1), jnp.float64))
    err = check_divergence_condition(sig, ps, pf, return_error=True)
    return err, divergence_error_scale(sig, ps)


def main(n=500, k=2, repeats=5, n_fields=1, stress=False, mixed=False,
         biot=False):
    """``n_fields > 1`` benchmarks the multi-field (poro-elasticity-style)
    configuration: several RHS equilibrated simultaneously through the
    shared patch factorizations (reference perftest_basics.py Biot test
    cases).  ``stress`` runs the weakly-symmetric stress configuration.
    ``mixed`` runs float64 data and reports the divergence residual
    (accuracy-grade configuration).  ``biot`` feeds the multi-field run
    with the three physical fields of a Biot poro-elasticity solve."""
    import jax
    import jax.numpy as jnp

    from dolfinx_eqlb_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    backend = jax.default_backend()
    if backend != "gpu":
        fail("backend", f"default backend is {backend!r}; the bench "
             "measures the GPU only")
    log(f"backend: {backend} {jax.devices()}")

    from dolfinx_eqlb_tpu.mesh import unit_square
    from dolfinx_eqlb_tpu.fem import FunctionSpace
    from dolfinx_eqlb_tpu.eqlb.patches import build_patches
    from dolfinx_eqlb_tpu.eqlb.engine import EqlbEngine

    t0 = time.perf_counter()
    mg_meshes = None
    if biot:
        # the Biot primal solve rides a block-geometric-multigrid MINRES,
        # which needs a nested mesh hierarchy: the bench mesh becomes the
        # red-refinement of a crossed base (same dof structure per cell;
        # n is rounded to the nearest power-of-two multiple of 16 —
        # n=500 -> 512, i.e. 1,048,576 cells, ~4.9% above 4n^2)
        from dolfinx_eqlb_tpu.fem.multigrid import mesh_hierarchy

        nlevels = max(1, round(np.log2(max(n, 16) / 16))) + 1
        mg_meshes = mesh_hierarchy(unit_square(16), nlevels)
        msh = mg_meshes[-1]
    else:
        msh = unit_square(n)  # crossed: 4 n^2 cells
    log(f"mesh: {msh.num_cells} cells, {msh.num_vertices} vertices "
        f"({time.perf_counter()-t0:.1f}s)")
    t0 = time.perf_counter()
    buckets = build_patches(msh)
    npatches = sum(b.npatches for b in buckets.values())
    log(f"patches: {npatches} in {len(buckets)} buckets "
        f"({time.perf_counter()-t0:.1f}s)")

    dtype = jnp.float64 if mixed else jnp.float32
    V = FunctionSpace(msh, "RT", k)

    # data prep BEFORE the engine tables are uploaded: the Biot prep's
    # multigrid operator hierarchy and the engine tables need not coexist
    np_dt = np.float64 if mixed else np.float32
    d_proj, d_rhs, facet_kind, bvals, nf = make_data(
        msh, k, n_fields, stress, biot, np_dt, mg_meshes=mg_meshes)

    t0 = time.perf_counter()
    # bucket chunking bounds the live intermediates of one bucket program;
    # f64 doubles every live buffer, so it defaults to half the chunk.  The
    # sizes have not been re-tuned for the GPU (ROADMAP item 3.4)
    chunk = int(os.environ.get(
        "EQLB_BENCH_CHUNK", 65536 if mixed else 131072))
    engine = EqlbEngine(V, buckets, dtype=dtype,
                        max_patches_per_bucket=chunk)
    log(f"engine tables ({time.perf_counter()-t0:.1f}s)")
    # upload once in the engine's batch-last layout so the steady-state
    # timing measures device work, not per-call host transfers
    t0 = time.perf_counter()
    dpT, drT = engine.put_transposed(d_proj, d_rhs)
    fk = jnp.asarray(facet_kind)
    bv = jnp.asarray(bvals, dtype)
    jax.block_until_ready((dpT, drT, fk, bv))
    log(f"data upload ({time.perf_counter()-t0:.1f}s)")

    def call():
        return engine.equilibrate(dpT, drT, fk, bv, transposed_inputs=True,
                                  weak_symmetry=stress)

    t0 = time.perf_counter()
    x = call().block_until_ready()
    log(f"first call (upload + compile): {time.perf_counter()-t0:.1f}s")
    if bool(jnp.isnan(x).any()):
        fail("first call", "NaN in equilibrated flux")

    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        x = call().block_until_ready()
        times.append(time.perf_counter() - t0)
    lat = min(times)
    log(f"steady state (per-call wait): {lat*1000:.1f} ms")

    field_tag = f", {nf} fields" if nf > 1 else ""
    if stress:
        field_tag = ", weakly-symmetric stress"
    if biot:
        field_tag += " (Biot primal data)"
    prec_tag = "f64" if mixed else "f32"
    metric = (f"RT{k} flux equilibration throughput, "
              f"{msh.num_cells}-cell mesh, single chip, {prec_tag}{field_tag}")

    extras = {}
    if mixed:
        # on-device accuracy in native f64.  Valid because f64 data is
        # hat-compatible curl-field data (see make_data)
        err, scale = divergence_residual(msh, k, np.asarray(x[0]),
                                         d_proj[0], d_rhs[0])
        extras["divergence_max_err"] = err
        extras["divergence_rel_err"] = err / scale
        log(f"divergence residual (f64 on device): {err:.3e} absolute, "
            f"{err / scale:.3e} relative to max|sigma|/h_min = {scale:.3e}")

    # strict-latency line FIRST: a mid-run kill still captures the primary
    # metric.  The pipelined headline follows as the LAST line.
    emit({
        "metric": metric + " [strict latency]",
        "value": round(npatches / lat, 1),
        "unit": "patches/s",
        "vs_baseline": round(0.1 / lat, 3),
        "latency_ms": round(lat * 1000, 2),
        **extras,
    })

    nchain = 8
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(nchain):
            x = call()
        x.block_until_ready()
        times.append((time.perf_counter() - t0) / nchain)
    dt = min(times)
    log(f"steady state (pipelined x{nchain}): {dt*1000:.1f} ms per "
        f"equilibrate ({npatches/dt/1e6:.2f} M patches/s)")

    emit({
        "metric": metric,
        "value": round(npatches / dt, 1),
        "unit": "patches/s",
        "vs_baseline": round(0.1 / dt, 3),
        "latency_ms": round(lat * 1000, 2),
        "pipelined_ms": round(dt * 1000, 2),
        **extras,
    })
    return dt


if __name__ == "__main__":
    argv = sys.argv[1:]
    stress = "--stress" in argv
    mixed = "--mixed" in argv
    biot = "--biot" in argv
    args = [a for a in argv if not a.startswith("--")]
    n = int(args[0]) if len(args) > 0 else 500
    n_fields = int(args[1]) if len(args) > 1 else 1
    try:
        main(n=n, n_fields=n_fields, stress=stress, mixed=mixed, biot=biot)
    except Exception as e:  # noqa: BLE001 — report as a JSON line, exit 3
        import traceback

        traceback.print_exc(file=sys.stderr)
        fail("run", f"{type(e).__name__}: {e}")
