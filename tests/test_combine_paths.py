"""Dof combine: the engine accumulates the global RT dofs by an element
gather over the concatenated per-bucket solutions (engine._combine_flat).
It is pinned here against the plain scatter-add ``x.at[:, gdofs].add(sol)``
of the same per-bucket solutions, and the f32 engine against the f64 one."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dolfinx_eqlb_tpu.eqlb.engine import EqlbEngine
from dolfinx_eqlb_tpu.eqlb.patches import build_patches
from dolfinx_eqlb_tpu.eqlb.semiexplicit import solve_bucket_semiexplicit
from dolfinx_eqlb_tpu.fem import FunctionSpace
from dolfinx_eqlb_tpu.mesh import unit_square


def _random_data(msh, k, n_rhs, seed):
    rng = np.random.default_rng(seed)
    nc, ndg = msh.num_cells, k * (k + 1) // 2
    dp = rng.normal(size=(n_rhs, nc, 2, ndg))
    dr = rng.normal(size=(n_rhs, nc, ndg))
    fk = np.where(msh.is_boundary_facet, 1, 0).astype(np.int8)[None].repeat(
        n_rhs, 0)
    bv = np.zeros((n_rhs, msh.num_facets, k))
    return dp, dr, fk, bv


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("n_rhs", [1, 2, 3, 5])
def test_elem_combine_matches_scatter_add(n_rhs, k):
    msh = unit_square(5)
    V = FunctionSpace(msh, "RT", k)
    dp, dr, fk, bv = _random_data(msh, k, n_rhs, 3)
    eng = EqlbEngine(V, build_patches(msh))
    dev, refd = eng._device_tables()

    dprT = jnp.concatenate(
        [jnp.moveaxis(jnp.asarray(dp), 1, -1),
         jnp.moveaxis(jnp.asarray(dr), 1, -1)[:, None]], axis=1)
    gdofs = {key: jnp.asarray(t["gdofs"]) for key, t in eng.tables.items()}

    @jax.jit
    def both(dprT, fk, bv, dev, refd, gdofs):
        flats = []
        x_ref = jnp.zeros((n_rhs, V.ndofs))
        for key in sorted(eng.buckets):
            sol_bl = solve_bucket_semiexplicit(eng, key, dprT, fk, bv,
                                               dev[key], refd)  # (r, nflux, P)
            flats.append(sol_bl.reshape(n_rhs, -1))
            # pad rows of gdofs point past ndofs: the scatter drops them
            x_ref = x_ref.at[:, gdofs[key]].add(jnp.moveaxis(sol_bl, -1, 1))
        return eng._combine_flat(jnp.concatenate(flats, axis=1), refd), x_ref

    x_elem, x_ref = both(dprT, jnp.asarray(fk), jnp.asarray(bv), dev, refd,
                         gdofs)
    scale = float(jnp.abs(x_ref).max())
    assert float(jnp.abs(x_elem - x_ref).max()) < 1e-13 * scale

    # and the whole fused program agrees (its load stage differs only in
    # gather layout for n_rhs > 1)
    x_eq = eng.equilibrate(dp, dr, fk, bv)
    assert float(jnp.abs(x_eq - x_ref).max()) < 1e-11 * scale


@pytest.mark.parametrize("k", [2, 3])
def test_f32_engine_matches_f64(k):
    """The f32 engine agrees with the f64 one at the tolerance chip_smoke.py
    states for its f32-vs-f64 check: max|x32 - x64| <= 1e-3 max|x64|."""
    msh = unit_square(6)
    V = FunctionSpace(msh, "RT", k)
    dp, dr, fk, bv = _random_data(msh, k, 2, 5)
    xs = {}
    for dt in (jnp.float32, jnp.float64):
        eng = EqlbEngine(V, build_patches(msh), dtype=dt)
        xs[dt] = np.asarray(eng.equilibrate(dp, dr, fk, bv,
                                            weak_symmetry=True))
        assert xs[dt].dtype == np.dtype(dt)
    x32, x64 = xs[jnp.float32].astype(np.float64), xs[jnp.float64]
    assert np.isfinite(x32).all()
    assert np.abs(x32 - x64).max() <= 1e-3 * np.abs(x64).max()


@pytest.mark.parametrize("value", ["pallas", "pallas_mixed", "lu"])
def test_removed_solver_values_raise(value):
    """The batched solves always run through XLA: assigning any other
    solver (the removed "pallas" / "pallas_mixed" kernels included) raises
    instead of falling back quietly."""
    msh = unit_square(2)
    eng = EqlbEngine(FunctionSpace(msh, "RT", 2), build_patches(msh))
    with pytest.raises(ValueError, match="removed"):
        eng.solver = value
    eng.solver = "xla"
    assert eng.solver == "xla"
