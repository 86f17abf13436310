"""Shared example-model harness utilities (SURVEY.md C22/C23)."""

from __future__ import annotations

import json
import time

import jax

__all__ = ["timed_steps", "bench_line"]


def timed_steps(run_fn, *args, warmup_runs=1, timed_runs=1, **kwargs):
    """Time ``run_fn``: returns (last_result, seconds). Compile excluded via
    warmup runs; each run ends at ``jax.block_until_ready``."""
    result = None
    for _ in range(warmup_runs):
        result = jax.block_until_ready(run_fn(*args, **kwargs))
    t0 = time.perf_counter()
    for _ in range(timed_runs):
        result = jax.block_until_ready(run_fn(*args, **kwargs))
    dt = (time.perf_counter() - t0) / timed_runs
    return result, dt


def bench_line(metric, value, unit, vs_baseline=None, **extra):
    """The one-JSON-line contract for the bench driver."""
    rec = {"metric": metric, "value": float(value), "unit": unit,
           "vs_baseline": vs_baseline if vs_baseline is not None else 1.0}
    rec.update(extra)
    line = json.dumps(rec)
    print(line)
    return rec
