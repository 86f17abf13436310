"""Headline benchmark: the five BASELINE workloads through the harness
(benchmarks/harness.py), one fresh child process per workload.

The children run one after another and this parent never imports JAX, so
only one process holds the card at a time.  Every run measures afresh:
nothing is resumed from an earlier run.

Output contract: the caller reads the LAST stdout line as JSON, so

  * a compact headline line (≤ 500 bytes) is printed and flushed at
    startup (``"status": "starting"``) and again after every workload —
    the last stdout line parses at any kill instant, SIGKILL included;
  * a hard total deadline (``BENCH_DEADLINE_S``, default 1500 s) bounds the
    sweep: when it expires, the final emit runs with the records so far;
  * SIGTERM/SIGINT emit the current partial headline before exiting.

Final-line schema:

  {"metric": ..., "value": N, "unit": ..., "spread": N,
   "status": "starting" | "in-progress k/5" | "complete" | "partial"}

The full per-workload record dict goes on an EARLIER stdout line (the one
object with "workloads").  The headline metric is the flagship DLGM
ELBO-steps/s/chip.
"""

import json
import os
import signal
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from benchmarks.compile_cache import compile_cache_dir  # noqa: E402

# dlgm FIRST: it carries the headline metric, so a sweep cut short still
# records a non-zero headline
WORKLOADS = ("dlgm", "linreg", "hier_logistic", "matrix_fact", "gmm")

DEADLINE_S = float(os.environ.get("BENCH_DEADLINE_S", "1500"))
WORKLOAD_TIMEOUT_S = float(os.environ.get("BENCH_WORKLOAD_TIMEOUT_S", "1200"))

_T0 = time.time()


def remaining():
    """Seconds left on the hard sweep deadline (never negative)."""
    return max(0.0, DEADLINE_S - (time.time() - _T0))


# fields worth carrying into the aggregate line per record
KEEP = ("metric", "value", "unit", "spread", "reps", "min_ess", "max_rhat",
        "converged", "stages", "chains", "mfu", "hbm_util", "bound",
        "achieved_tflops", "platform", "device_kind")


def headline_record(done):
    """(records by model, the flagship ``dlgm`` record)."""
    by_model = {}
    for recs in done.values():
        for r in recs:
            by_model[r["model"]] = {k: r[k] for k in KEEP if k in r}
    return by_model, by_model.get("dlgm", {})


def compact_line(done, status, error=None):
    """The ≤500-byte JSON line the caller parses."""
    _, headline = headline_record(done)
    compact = {
        "metric": "dlgm_elbo_steps_per_s_per_chip",
        "value": float(headline.get("value", 0.0)),
        "unit": "steps/s/chip",
        "spread": headline.get("spread"),
        "status": status,
    }
    if error:
        compact["error"] = error[:120]
    line = json.dumps(compact)
    assert len(line) <= 500, f"headline line too long ({len(line)}B)"
    return line


def print_compact(done, status, error=None):
    print(compact_line(done, status, error), flush=True)


# --- SIGTERM/SIGINT: emit the current partial headline before dying ------
_CURRENT = {"done": {}}


def _term_handler(signum, frame):  # noqa: ARG001 — signal signature
    try:
        line = compact_line(_CURRENT["done"], "partial",
                            error=f"killed by signal {signum} mid-sweep")
        sys.stdout.write(line + "\n")
        sys.stdout.flush()
    finally:
        os._exit(1)


def run_workload(name):
    """One harness child for ``name``; its records, or [] on failure."""
    budget = min(WORKLOAD_TIMEOUT_S, remaining())
    env = dict(os.environ,
               JAX_COMPILATION_CACHE_DIR=compile_cache_dir())
    with tempfile.NamedTemporaryFile(suffix=".json", delete=False) as tf:
        tmp = tf.name
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "benchmarks.harness", "--model", name,
             "--out", tmp],
            capture_output=True, timeout=budget, text=True, cwd=HERE,
            env=env,
        )
        with open(tmp) as f:
            recs = json.load(f)
        if proc.returncode == 0 and recs:
            return recs
        print(f"bench: {name} failed: {proc.stderr[-300:]}",
              file=sys.stderr)
    except subprocess.TimeoutExpired:
        print(f"bench: {name} timed out after {budget:.0f}s",
              file=sys.stderr)
    except (OSError, ValueError) as e:
        print(f"bench: {name} left no records: {e}", file=sys.stderr)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return []


def emit(done, error=None, status=None):
    """Final emit: full per-workload dict on an EARLY line, compact
    headline-only JSON as the FINAL line.  A compact line is also printed
    BEFORE the full dict, so a kill between the two lines still leaves a
    parseable last line."""
    _, headline = headline_record(done)
    value = float(headline.get("value", 0.0))
    complete = all(done.get(name) for name in WORKLOADS)
    if status is None:
        status = "complete" if complete and not error else "partial"

    print_compact(done, status, error)
    full = {"workloads": headline_record(done)[0]}
    if error:
        full["error"] = error
    print(json.dumps(full), flush=True)   # early line: full records
    print_compact(done, status, error)    # FINAL line: compact, parseable
    return 0 if complete and value > 0 else 1


def main():
    signal.signal(signal.SIGTERM, _term_handler)
    signal.signal(signal.SIGINT, _term_handler)

    done = {}
    _CURRENT["done"] = done
    # startup line: the last stdout line is parseable from second zero
    print_compact(done, "starting")

    for i, name in enumerate(WORKLOADS):
        if remaining() < 30:
            return emit(done, error=(
                f"deadline {DEADLINE_S:.0f}s expired before {name}; "
                "partial records emitted"))
        recs = run_workload(name)
        if recs:
            done[name] = recs
        print_compact(done, f"in-progress {i + 1}/{len(WORKLOADS)}")
    return emit(done)


if __name__ == "__main__":
    sys.exit(main())
