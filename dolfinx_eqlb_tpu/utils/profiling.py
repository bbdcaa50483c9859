"""Profiling / tracing utilities (SURVEY.md section 5).

The reference has no built-in tracing — demos wrap solves in
``time.perf_counter`` (``demo_reconstruction.py:434-440``).  Here:

* ``sync``: wait for the device work producing some arrays
  (``jax.block_until_ready``); call it inside a ``timed`` block, because
  JAX dispatch returns before the device has finished.
* ``timed``: wall-clock context manager.
* ``trace``: ``jax.profiler`` trace context for TensorBoard/Perfetto dumps.
"""

from __future__ import annotations

import contextlib
import time

import jax

__all__ = ["timed", "trace", "sync"]


def sync(*arrays):
    """Wait for all device work producing ``arrays``; returns them."""
    jax.block_until_ready(arrays)
    return arrays[0] if len(arrays) == 1 else arrays


@contextlib.contextmanager
def timed(name: str, out=None):
    """Context manager: ``with timed("equilibrate") as t: ...``;
    ``t['s']`` holds the elapsed wall-clock after the block."""
    rec = {"name": name}
    t0 = time.perf_counter()
    try:
        yield rec
    finally:
        rec["s"] = time.perf_counter() - t0
        print(f"[{name}] {rec['s']:.4f} s", flush=True)


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace context (view with TensorBoard or Perfetto)."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
