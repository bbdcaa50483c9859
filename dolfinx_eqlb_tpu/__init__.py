"""dolfinx_eqlb_tpu — flux equilibration as one JAX program, run on the GPU.

A from-scratch JAX/XLA re-design of the capabilities of
``brodbeck-m/dolfinx_eqlb`` (patch-wise flux and stress equilibration for
guaranteed a-posteriori error estimation, cf. reference README.md:7-14):

* cell-local L2 projection (reference ``cpp/dolfinx_eqlb/base/local_solver.hpp``)
* hierarchic Boffi-Brezzi-Fortin Raviart-Thomas elements
  (reference ``python/dolfinx_eqlb/elmtlib/e_raviart_thomas.py``)
* H(div) flux boundary conditions (reference ``base/BoundaryData.cpp``)
* flux equilibration via constrained minimisation (FluxEqlbEV,
  reference ``cpp/dolfinx_eqlb/ev``) and the semi-explicit strategy
  (FluxEqlbSE, reference ``cpp/dolfinx_eqlb/se``)
* weakly symmetric stress equilibration with Korn-constant estimation
* equilibrated error estimators + adaptive (Doerfler) refinement loops

Design: all mesh topology / patch extraction is integer precompute on the
host (NumPy); every floating-point stage — element tensors, patch assembly,
the per-patch constrained solves, scatter into the global H(div) vector,
and the estimator integrals — is a batched, jitted XLA program.  Vertex
patches are bucketed by (cell count, boundary flag) and each cell's element
tensor is permuted into a canonical patch layout on the host so that patch
assembly on device is *static* dense block placement (no dynamic scatter)
followed by one batched LU per bucket.  The programs compile through XLA
for an NVIDIA GPU in production and for the CPU in the test suite.
"""

import jax

# Equilibration requires f64 for the 1e-10-level invariant checks
# (BASELINE.md); benches may still run f32 by passing f32 arrays.
jax.config.update("jax_enable_x64", True)

__version__ = "0.1.0"

from . import elements, mesh, fem, eqlb, estimation, models  # noqa: E402,F401
