"""Bring-up check of the equilibration pipeline on an NVIDIA GPU.

    python chip_smoke.py            # one GPU: phases 1-4
    python chip_smoke.py --multi    # four GPUs: phase 1 and phase 5 only

Phases, in one process (the 1M-cell mesh and its patch tables are built
once and shared):

1. device: JAX devices and version, the card's name and power limit from
   nvidia-smi, and whether the native host library or the NumPy fallback
   builds the tables.  Fails unless JAX's default backend is the GPU.
2. user path, f64, 1M cells: ``demos/demo_reconstruction.py``'s flow on the
   crossed ``unit_square(500)`` (1,000,000 cells, 501,001 patches):
   ``PoissonSolver`` (P2) -> ``local_projection`` -> ``FluxEqlbSE(2)`` ->
   divergence and jump checks -> ``estimate_poisson``.
3. engine, 1M cells, RT2: ``EqlbEngine.equilibrate`` on ``bench.py``'s
   hat-compatible data for 1 field, the weakly symmetric stress and 3
   fields, each in f32 and f64: first call (compile and upload), three
   timed calls, peak device bytes, a NaN check and f32 against f64.
4. references, ``unit_square(64)``, k = 2 and 3, with and without weak
   symmetry: the fused semi-explicit result on the card against the plain
   per-patch KKT solve on the card (``mode="kkt"``) and against an f64 run
   on the in-process CPU device.
5. ``--multi``: ``parallel.ShardedEqlbEngine`` over 4 GPUs on the phase-3
   stress configuration in f64, against the single-GPU result.

The last line of standard output is ``{"ok": true, "device": {...}}``; it
is printed only when every phase passed.  Any failure (no GPU, an
exception, a tolerance exceeded) exits 1 without it.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
import traceback

import numpy as np
import jax
import jax.numpy as jnp

from dolfinx_eqlb_tpu import native
from dolfinx_eqlb_tpu.eqlb import (
    FluxEqlbSE, check_divergence_condition, check_jump_condition,
)
from dolfinx_eqlb_tpu.eqlb.checks import divergence_error_scale
from dolfinx_eqlb_tpu.eqlb.engine import EqlbEngine
from dolfinx_eqlb_tpu.eqlb.equilibrators import _mesh_patches
from dolfinx_eqlb_tpu.eqlb.patches import build_patches
from dolfinx_eqlb_tpu.estimation import estimate_poisson
from dolfinx_eqlb_tpu.fem import FunctionSpace, grad, local_projection
from dolfinx_eqlb_tpu.mesh import unit_square
from dolfinx_eqlb_tpu.models import PoissonSolver
from dolfinx_eqlb_tpu.utils.compile_cache import configure_compile_cache

from bench import make_data

# --- tolerances ---------------------------------------------------------------
# Phase 2: max|div sigma_R - Pi f| relative to max|sigma_R| / h_min.  The
# absolute residual of an f64 result is dof round-off amplified by the
# divergence operator (1/detJ ~ 2 n^2 = 5e5 at n = 500), so only the
# relative form is comparable across mesh sizes; f64 round-off puts it near
# 1e-11, and the primal CG stops at a relative residual of 1e-13.
DIV_REL_TOL = 1e-9
# Phase 3: f32 against f64 on the card, max|x32 - x64| <= F32_TOL max|x64|.
# f32 round-off (6e-8) amplified by the condition of the small reduced
# patch systems and of the weak-symmetry KKT systems.
F32_TOL = 1e-3
# Phases 4 and 5: f64 results that differ only in algebra (reduced vs full
# KKT) or summation order (XLA on the GPU vs the CPU, one card vs four)
# agree to round-off times the patch systems' condition (~1e5).
REF_TOL = 1e-10

N_FULL = 500  # unit_square(500): 1,000,000 cells, 501,001 patches
N_REF = 64  # unit_square(64): 16,384 cells


def log(msg):
    print(msg, flush=True)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def peak_bytes(device):
    stats = device.memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _arrays(out):
    """The device arrays in a result: Functions stand for their dofs."""
    if isinstance(out, (list, tuple)):
        return [_arrays(o) for o in out]
    return getattr(out, "x", out)


class Stages:
    """Wall-clock seconds of named stages, each ended by a wait for the
    device work that produced its result."""

    def __init__(self, phase):
        self.phase = phase
        self.t0 = time.perf_counter()

    def __call__(self, name, fn, *args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(_arrays(out))
        log(f"  [{self.phase}] {name}: {time.perf_counter() - t:.3f} s")
        return out

    def done(self):
        log(f"[{self.phase}] done in {time.perf_counter() - self.t0:.1f} s")


# --- phase 1 -------------------------------------------------------------------

def phase_device():
    """The card, or an error before anything else is built."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(
            f"JAX's default backend is {backend!r}, not 'gpu': "
            "chip_smoke.py needs an NVIDIA GPU")
    devices = jax.devices()
    log(f"[device] jax {jax.__version__}, devices {devices}, "
        f"kind {devices[0].device_kind!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        log(f"[device] nvidia-smi name, power.limit: {line.strip()}")
    if native.available():
        log(f"[device] host tables: native library {native.library_path()}")
    else:
        log("[device] host tables: NumPy fallback (native library not built)")
    return devices[0]


# --- phase 2 -------------------------------------------------------------------

def _exact(x):
    return np.sin(2 * np.pi * x[..., 0]) * np.cos(2 * np.pi * x[..., 1])


def _rhs(x):
    return 8 * np.pi**2 * _exact(x)


def phase_user_path(msh, device):
    """demo_reconstruction's flow (Dirichlet, P2 primal, SE at RT2) in f64."""
    st = Stages("user path")
    k = 2
    V = FunctionSpace(msh, "P", 2)
    Vr = FunctionSpace(msh, "DG", k - 1)
    Vf = FunctionSpace(msh, "DG", k - 1, vs=2)
    rhs_proj = st("project rhs", local_projection, Vr, [_rhs],
                  quadrature_degree=2 * k + 8)
    solver = st("primal setup", PoissonSolver, V)
    uh = st("primal CG solve", solver.solve, rhs_proj[0],
            msh.boundary_facets, _exact, rtol=1e-13)
    log(f"  [user path] CG: {solver.last_iterations} iterations, "
        f"residual {solver.last_residual:.3e}")
    sigma_proj = st("project flux", local_projection, Vf, [-1.0 * grad(uh)])
    eq = st("FluxEqlbSE setup", FluxEqlbSE, k, msh, rhs_proj, sigma_proj)
    eq.set_boundary_conditions([msh.boundary_facets], [[]])
    for call in ("first", "second"):
        st(f"equilibrate ({call} call)",
           lambda: (eq.equilibrate_fluxes(), eq.list_flux[0])[1])
    flux = eq.list_flux[0]
    err = st("divergence check", check_divergence_condition, flux,
             sigma_proj[0], rhs_proj[0], return_error=True)
    scale = divergence_error_scale(flux, sigma_proj[0])
    jump_ok = st("jump check", check_jump_condition, flux, sigma_proj[0])
    eta, eta_sig, eta_osc, _ = st("estimate", estimate_poisson, _rhs, uh,
                                  flux, sigma_proj[0])
    log(f"  [user path] divergence residual {err:.3e} absolute, "
        f"{err / scale:.3e} relative to max|sigma_R|/h_min = {scale:.3e} "
        f"(tolerance {DIV_REL_TOL:.0e})")
    log(f"  [user path] jump condition: {jump_ok}")
    log(f"  [user path] eta = {float(eta):.6e} (flux {float(eta_sig):.6e}, "
        f"oscillation {float(eta_osc):.6e})")
    log(f"  [user path] peak device bytes: {peak_bytes(device)}")
    require(err / scale <= DIV_REL_TOL, "divergence condition")
    require(jump_ok, "jump condition")
    require(np.isfinite(float(eta)) and float(eta) > 0, "estimator")
    st.done()


# --- phase 3 -------------------------------------------------------------------

ENGINE_CONFIGS = (("1-field", 1, False), ("stress", 2, True),
                  ("3-field", 3, False))


def phase_engine(msh, buckets, device, repeats=3):
    """The three engine configurations at RT2, f32 and f64, on one mesh."""
    st = Stages("engine")
    k = 2
    V = FunctionSpace(msh, "RT", k)
    d_proj, d_rhs, fk, bv, _ = st(
        "bench data (3 hat-compatible fields)", make_data, msh, k, 3,
        False, False, np.float64)
    results = {}
    for dt in (jnp.float32, jnp.float64):
        tag = np.dtype(dt).name
        engine = st(f"{tag} engine tables (host)", EqlbEngine, V, buckets,
                    dtype=dt)
        st(f"{tag} device tables + inverse build", engine._device_tables)
        for name, nf, stress in ENGINE_CONFIGS:
            if stress:
                st(f"{tag} stress caches", engine.ensure_stress_caches)
            dpT, drT = engine.put_transposed(d_proj[:nf], d_rhs[:nf])
            args = (dpT, drT, jnp.asarray(fk[:nf]), jnp.asarray(bv[:nf], dt))

            def call():
                return engine.equilibrate(*args, transposed_inputs=True,
                                          weak_symmetry=stress)

            t = time.perf_counter()
            x = call().block_until_ready()
            first = time.perf_counter() - t
            times = []
            for _ in range(repeats):
                t = time.perf_counter()
                x = call().block_until_ready()
                times.append(time.perf_counter() - t)
            x = np.asarray(x)
            log(f"  [engine] {name} {tag}: first call {first:.3f} s, then "
                + ", ".join(f"{s * 1e3:.3f}" for s in times)
                + f" ms; peak device bytes {peak_bytes(device)}")
            require(np.isfinite(x).all(), f"{name} {tag}: NaN or Inf")
            results[name, tag] = x
            del args, dpT, drT
        del engine
        gc.collect()
    for name, _, _ in ENGINE_CONFIGS:
        x32 = results[name, "float32"].astype(np.float64)
        x64 = results[name, "float64"]
        rel = np.abs(x32 - x64).max() / np.abs(x64).max()
        log(f"  [engine] {name}: max|x32 - x64| / max|x64| = {rel:.3e} "
            f"(tolerance {F32_TOL:.0e})")
        require(rel <= F32_TOL, f"{name}: f32 against f64")
    st.done()
    return results


# --- phase 4 -------------------------------------------------------------------

def compare_with_references(n, device, cpu, degrees=(2, 3)):
    """Fused semi-explicit result on ``device`` against the per-patch KKT
    solve on ``device`` and the same program on ``cpu``, in f64, on
    hat-compatible two-row data.  Returns {(k, weak_symmetry): (rel_kkt,
    rel_cpu)} and raises when either exceeds REF_TOL."""
    msh = unit_square(n)
    buckets = build_patches(msh)
    out = {}
    for k in degrees:
        V = FunctionSpace(msh, "RT", k)
        with jax.default_device(device):
            data = make_data(msh, k, 2, True, False, np.float64)[:4]
        for ws in (False, True):
            xs = {}
            for where, dev, mode in (("se", device, "semiexplicit"),
                                     ("kkt", device, "kkt"),
                                     ("cpu", cpu, "semiexplicit")):
                with jax.default_device(dev):
                    eng = EqlbEngine(V, buckets)
                    eng.mode = mode
                    xs[where] = np.asarray(
                        eng.equilibrate(*data, weak_symmetry=ws))
            scale = np.abs(xs["se"]).max()
            rel = tuple(float(np.abs(xs["se"] - xs[w]).max() / scale)
                        for w in ("kkt", "cpu"))
            log(f"  [references] n={n} k={k} weak_symmetry={ws}: "
                f"vs KKT {rel[0]:.3e}, vs CPU f64 {rel[1]:.3e} "
                f"(tolerance {REF_TOL:.0e})")
            require(max(rel) <= REF_TOL,
                    f"k={k} weak_symmetry={ws}: reference comparison")
            out[k, ws] = rel
    return out


def phase_references(device):
    st = Stages("references")
    compare_with_references(N_REF, device, jax.devices("cpu")[0])
    st.done()


# --- phase 5 -------------------------------------------------------------------

def sharded_stress(n, devices, repeats=3):
    """Stress configuration (f64, RT2) sharded over ``devices`` against the
    single-device result of the same engine.  Returns the relative
    deviation and raises when it exceeds REF_TOL."""
    from jax.sharding import Mesh

    from dolfinx_eqlb_tpu.parallel import ShardedEqlbEngine

    st = Stages(f"multi x{len(devices)}")
    msh = st("mesh", unit_square, n)
    buckets = st("patches", build_patches, msh)
    V = FunctionSpace(msh, "RT", 2)
    data = st("bench data", make_data, msh, 2, 2, True, False,
              np.float64)[:4]
    engine = st("engine tables", EqlbEngine, V, buckets,
                pad_to_multiple=len(devices))
    x1 = st("single device, first call", engine.equilibrate, *data,
            weak_symmetry=True)
    st("single device, second call", engine.equilibrate, *data,
       weak_symmetry=True)
    sharded = st("sharded tables", ShardedEqlbEngine, engine,
                 Mesh(np.array(devices), ("patches",)))
    xs = st("sharded, first call", sharded.equilibrate, *data,
            weak_symmetry=True)
    for i in range(repeats):
        st(f"sharded, call {i + 2}", sharded.equilibrate, *data,
           weak_symmetry=True)
    x1, xs = np.asarray(x1), np.asarray(xs)
    rel = float(np.abs(xs - x1).max() / np.abs(x1).max())
    log(f"  [multi x{len(devices)}] sharded vs single device: "
        f"max|dx| / max|x| = {rel:.3e} (tolerance {REF_TOL:.0e})")
    require(np.isfinite(xs).all(), "sharded result: NaN or Inf")
    require(rel <= REF_TOL, "sharded against single device")
    st.done()
    return rel


# --- main ----------------------------------------------------------------------

def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if any(a != "--multi" for a in argv):
        log(f"usage: python chip_smoke.py [--multi] (got {argv})")
        return 2
    multi = "--multi" in argv
    t0 = time.perf_counter()
    try:
        configure_compile_cache()
        device = phase_device()
        if multi:
            devices = jax.devices()
            require(len(devices) >= 4, f"--multi needs 4 GPUs, found "
                    f"{len(devices)}")
            sharded_stress(N_FULL, devices[:4])
        else:
            st = Stages("mesh")
            msh = st("unit_square(500)", unit_square, N_FULL)
            buckets = st("patch tables", _mesh_patches, msh)
            log(f"[mesh] {msh.num_cells} cells, "
                f"{sum(b.npatches for b in buckets.values())} patches in "
                f"{len(buckets)} buckets")
            phase_user_path(msh, device)
            gc.collect()
            phase_engine(msh, buckets, device)
            gc.collect()
            phase_references(device)
    except Exception:  # noqa: BLE001 — any failure fails the smoke
        traceback.print_exc(file=sys.stdout)
        log(f"chip_smoke FAILED after {time.perf_counter() - t0:.1f} s")
        return 1
    log(f"chip_smoke passed in {time.perf_counter() - t0:.1f} s")
    devices = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
