"""Demo: cell-local L2 projection (reference
``demo/projection/demo_local_projection.py``): project two non-polynomial
functions into DG2 and report the projection residuals."""

import os as _os
import sys as _sys

# self-locate: make `python demos/<demo>.py` work without PYTHONPATH
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)

from dolfinx_eqlb_tpu.mesh import unit_square
from dolfinx_eqlb_tpu.fem import (
    FunctionSpace,
    local_projection,
    expr_from_callable,
    cell_integrals_sq,
)

msh = unit_square(16)
V = FunctionSpace(msh, "DG", 2)

f1 = lambda x: np.sin(2 * np.pi * x[..., 0]) * np.sin(2 * np.pi * x[..., 1])
f2 = lambda x: np.exp(-10 * ((x[..., 0] - 0.5) ** 2 + (x[..., 1] - 0.5) ** 2))

u1, u2 = local_projection(V, [f1, f2], quadrature_degree=12)
for name, u, f in (("f1", u1, f1), ("f2", u2, f2)):
    err = expr_from_callable(f, msh) - u
    print(f"||{name} - P(f)||_L2 = {np.sqrt(float(cell_integrals_sq(err, 12).sum())):.3e}")
