"""Per-layer device time of one steady ``EqlbEngine.equilibrate`` call on
the GPU, from a ``jax.profiler`` trace.

    python scripts/trace_layers.py [--n 500] [--out traces/trace_layers]

For the 1-field, stress and 3-field configurations at RT2 on the crossed
``unit_square(n)`` (n = 500: 1,000,000 cells), in f32 and f64, it warms the
call up, traces one steady call, and reduces the trace to the device time
of three layers:

* ``solve``: XLA's batched dense solves (``jnp.linalg.solve`` inside the
  ``eqlb_dense_solve`` scope: boundary buckets and the weak-symmetry
  systems; interior buckets use the cached inverse);
* ``combine``: the element-gather dof combine (``eqlb_combine`` scope),
  with its bytes moved against the card's 3.35 TB/s;
* ``other``: everything else (loads, explicit step, reduced systems).

Each device kernel is attributed through its HLO op: the compiled
program's HLO text maps op names to the named scopes in their metadata.
It also reports the set-up time of the device tables (element mass
matrices, reduced systems and the interior-bucket inverse build), which
includes their compile.  Results go to ``<out>/trace_layers.json``; the
raw traces stay under ``<out>/`` too.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dolfinx_eqlb_tpu.eqlb.engine import EqlbEngine  # noqa: E402
from dolfinx_eqlb_tpu.eqlb.patches import build_patches  # noqa: E402
from dolfinx_eqlb_tpu.fem import FunctionSpace  # noqa: E402
from dolfinx_eqlb_tpu.mesh import unit_square  # noqa: E402
from dolfinx_eqlb_tpu.utils.compile_cache import (  # noqa: E402
    configure_compile_cache,
)

from bench import make_data  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
CONFIGS = (("1-field", 1, False), ("stress", 2, True), ("3-field", 3, False))
SCOPES = (("combine", "eqlb_combine"), ("solve", "eqlb_dense_solve"))

_OP_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name=\"([^\"]*)\"")


def layer_of(op_name: str) -> str:
    for name, scope in SCOPES:
        if scope in op_name:
            return name
    return "other"


def _key(op: str) -> str:
    # kernels are named after their HLO op with "." spelled "_"
    return op.replace(".", "_")


def scope_of_ops(hlo_text: str) -> dict:
    """HLO op name -> layer, from the op_name metadata of the optimized
    HLO (fusions and custom calls carry the named scope of their root)."""
    out = {}
    for line in hlo_text.splitlines():
        m = _OP_RE.match(line)
        if m:
            out[_key(m.group(1))] = layer_of(m.group(2))
    return out


def device_events(trace_dir: str):
    """(name, start_ns, duration_ns, stats) of every event on the GPU
    planes of the newest trace under ``trace_dir``."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                          "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    data = jax.profiler.ProfileData.from_file(paths[-1])
    events = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                events.append((ev.name, ev.start_ns, ev.duration_ns,
                               dict(ev.stats)))
    return events


def reduce_events(events, layer_of_op: dict):
    """Per-layer device time and busy time (union of intervals)."""
    per_layer = {"combine": 0.0, "solve": 0.0, "other": 0.0}
    kernels = {}
    spans = []
    for name, start, dur, stats in events:
        op = str(stats.get("hlo_op", name))
        # the op_name of the kernel's HLO op when the trace carries it;
        # kernels inside a command buffer (CUDA graph) carry only their
        # own name, which is their fusion's HLO name
        if "name" in stats:
            layer = layer_of(str(stats["name"]))
        else:
            layer = layer_of_op.get(_key(op)) or layer_of_op.get(_key(name))
        if layer is None:
            low = name.lower()
            layer = ("solve" if any(s in low for s in
                                    ("getrf", "getrs", "trsm", "lu_"))
                     else "other")
        per_layer[layer] += dur
        k = kernels.setdefault(name, {"ns": 0.0, "count": 0, "layer": layer,
                                      "hlo_op": op})
        k["ns"] += dur
        k["count"] += 1
        spans.append((start, start + dur))
    spans.sort()
    busy, end = 0.0, -1.0
    first = spans[0][0] if spans else 0.0
    for a, b in spans:
        if a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = (end - first) if spans else 0.0
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["ns"])[:25]
    return per_layer, busy, window, top


def combine_bytes(engine, n_rhs: int) -> int:
    """Least bytes the element-gather combine must move: every dof gathers
    two contributions (cell dofs a third) and reads their int32 indices,
    and writes one value."""
    itemsize = np.dtype(engine.dtype).itemsize
    ndofs = engine.V.ndofs
    ncell = ndofs - engine._combine["nfk"]
    gathers = 2 * ndofs + ncell
    return n_rhs * itemsize * (gathers + ndofs) + 4 * gathers


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=500)
    ap.add_argument("--out", default="traces/trace_layers")
    a = ap.parse_args(argv)
    configure_compile_cache()
    if jax.default_backend() != "gpu":
        raise SystemExit("trace_layers.py measures the GPU only")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(f"card: {card}", flush=True)
    msh = unit_square(a.n)
    buckets = build_patches(msh)
    V = FunctionSpace(msh, "RT", 2)
    d_proj, d_rhs, fk, bv, _ = make_data(msh, 2, 3, False, False,
                                          np.float64)
    report = {"card": card, "n": a.n, "cells": msh.num_cells, "runs": []}
    for dt in (jnp.float32, jnp.float64):
        tag = np.dtype(dt).name
        engine = EqlbEngine(V, buckets, dtype=dt)
        t = time.perf_counter()
        jax.block_until_ready(engine._device_tables())
        setup = time.perf_counter() - t
        t = time.perf_counter()
        engine.ensure_stress_caches()
        jax.block_until_ready(engine._device_tables())
        setup_stress = time.perf_counter() - t
        print(f"{tag}: device tables + inverse build {setup:.3f} s, "
              f"stress caches {setup_stress:.3f} s (compile included)",
              flush=True)
        for name, nf, stress in CONFIGS:
            dev, refd = engine._device_tables()
            dpT, drT = engine.put_transposed(d_proj[:nf], d_rhs[:nf])
            args = (dpT, drT, jnp.asarray(fk[:nf]), jnp.asarray(bv[:nf], dt))
            kw = dict(transposed_inputs=True, weak_symmetry=stress)
            for _ in range(2):
                engine.equilibrate(*args, **kw).block_until_ready()
            t = time.perf_counter()
            engine.equilibrate(*args, **kw).block_until_ready()
            wall = time.perf_counter() - t
            hlo = engine._jit_eqT.lower(
                dpT, drT, args[2], args[3], dev, refd, None,
                weak_symmetry=stress).compile().as_text()
            tdir = os.path.join(a.out, f"{name}_{tag}")
            with jax.profiler.trace(tdir):
                engine.equilibrate(*args, **kw).block_until_ready()
            events = device_events(tdir)
            report.setdefault("sample_event_stats", [
                (ev[0], ev[3]) for ev in events[:8]])
            per_layer, busy, window, top = reduce_events(
                events, scope_of_ops(hlo))
            total = sum(per_layer.values())
            nbytes = combine_bytes(engine, nf)
            comb = per_layer["combine"]
            run = {
                "config": name, "dtype": tag, "wall_s": wall,
                "device_kernel_ns": total, "device_busy_ns": busy,
                "device_window_ns": window,
                "layer_ns": per_layer,
                "layer_share": {k: (v / total if total else None)
                                for k, v in per_layer.items()},
                "combine_bytes": nbytes,
                "combine_roofline_share": (
                    nbytes / HBM_BYTES_PER_S / (comb * 1e-9)
                    if comb else None),
                "setup_device_tables_s": setup,
                "setup_stress_caches_s": setup_stress,
                "top_kernels": top,
            }
            report["runs"].append(run)
            print(f"{name} {tag}: wall {wall * 1e3:.3f} ms, kernels "
                  f"{total / 1e6:.3f} ms, busy {busy / 1e6:.3f} ms; shares "
                  + ", ".join(f"{k} {v:.3f}" for k, v in
                              run["layer_share"].items() if v is not None)
                  + f"; combine {nbytes / 1e6:.1f} MB, roofline share "
                  f"{run['combine_roofline_share']}", flush=True)
        del engine
    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(a.out, "trace_layers.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)


if __name__ == "__main__":
    main()
