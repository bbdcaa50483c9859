"""Bring-up plumbing: the compile-cache location, the native library build,
and chip_smoke.py's phases (run here on the CPU, on the card as a whole)."""

import hashlib
import os
import subprocess

import jax
import pytest

import chip_smoke
from dolfinx_eqlb_tpu import native
from dolfinx_eqlb_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_set", [False, True])
def test_compile_cache_location(env_set, monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX's own reading of it stands
    and no other directory is set; without it, <repo>/.jax_cache."""
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert compile_cache.configure_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = compile_cache.configure_compile_cache()
            assert path == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_native_library_built_from_source():
    """The library is built from topology.cpp into the git-ignored build
    directory, under a name keyed by the source's hash; no shared library
    lives anywhere else in the package or is tracked by git."""
    assert native.available()
    path = native.library_path()
    assert os.path.exists(path)
    build = os.path.join(os.path.dirname(native.__file__), "build")
    assert os.path.dirname(path) == build
    with open(os.path.join(os.path.dirname(native.__file__),
                           "topology.cpp"), "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest()[:16] in path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "dolfinx_eqlb_tpu/native/build/" in f.read().split()
    pkg = os.path.join(REPO, "dolfinx_eqlb_tpu")
    for root, _, files in os.walk(pkg):
        if root != build:
            assert not [f for f in files if f.endswith(".so")], root
    if os.path.isdir(os.path.join(REPO, ".git")):
        out = subprocess.run(["git", "ls-files", "*.so"], cwd=REPO,
                             capture_output=True, text=True, check=True)
        assert out.stdout.strip() == ""


def test_chip_smoke_fails_off_the_card(capsys, monkeypatch):
    """On the CPU the device phase fails before any mesh is built, and main
    returns non-zero without the final ok line."""
    built = []
    monkeypatch.setattr(chip_smoke, "unit_square",
                        lambda *a, **k: built.append(a))
    rc = chip_smoke.main([])
    out = capsys.readouterr().out
    assert rc != 0
    assert built == []
    assert "not 'gpu'" in out
    assert '"ok": true' not in out


def test_chip_smoke_reference_comparison_cpu():
    """Phase 4's routine: fused semi-explicit vs per-patch KKT vs the CPU
    run (here all on the CPU), with and without weak symmetry."""
    cpu = jax.devices("cpu")[0]
    out = chip_smoke.compare_with_references(5, cpu, cpu, degrees=(2,))
    assert set(out) == {(2, False), (2, True)}
    assert max(max(v) for v in out.values()) <= chip_smoke.REF_TOL


def test_chip_smoke_sharded_stress_virtual_devices():
    """Phase 5's routine on four virtual CPU devices."""
    rel = chip_smoke.sharded_stress(4, jax.devices("cpu")[:4], repeats=1)
    assert rel <= chip_smoke.REF_TOL


@pytest.mark.gpu
def test_reference_comparison_on_gpu(gpu_device):
    """Phase 4 at a small size on the card.  Runs only when the GPU was
    requested explicitly: JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu
    -p no:xdist tests/ (one process, since each reserves the card)."""
    out = chip_smoke.compare_with_references(16, gpu_device,
                                             jax.devices("cpu")[0])
    assert max(max(v) for v in out.values()) <= chip_smoke.REF_TOL
