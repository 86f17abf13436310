"""Fault-injection scenario for the harness ``--fault-inject step=K`` flag.

Blueprint: SURVEY.md §5 failure detection — "kills one host at step K in
multiprocess tests to verify a restart resumes from the last checkpoint to
the same posterior".  The scenario:

1. reference leg: 2 local jax.distributed processes run a chunked DP-SVI
   (checkpoint every ``chunk`` steps) to completion; record the replicated
   params fingerprint.
2. crash leg: same job, but process 1 hard-exits (``os._exit(17)``) when it
   reaches step K — after whatever checkpoints preceded K.
3. recovery leg: relaunch with the same process count from the last
   checkpoint; final fingerprint must equal the reference's.

Used by tests/test_multihost.py style machinery but callable standalone:

    python -m benchmarks.harness --fault-inject step=20
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent("""
    import os, sys
    pid, nproc, port, ckpt_dir, mode, fault_step, total, chunk = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        sys.argv[5], int(sys.argv[6]), int(sys.argv[7]), int(sys.argv[8]),
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(f"127.0.0.1:{port}", nproc, pid)
    import jax.numpy as jnp, numpy as np, optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import bayesic_tpu.dist as dist
    from bayesic_tpu.core import sample
    from bayesic_tpu.infer.svi import SVI, MeanFieldGuide
    from bayesic_tpu.parallel import make_mesh
    from bayesic_tpu.parallel.launcher import (
        host_shard, replicated_fingerprint, check_replicated_sync,
    )
    from bayesic_tpu.utils import checkpoint as ckpt

    rng = np.random.default_rng(0)
    n = 64
    x_global = rng.normal(0, 1, n).astype(np.float32)
    y_global = (1.2 * x_global - 0.4).astype(np.float32)

    mesh = make_mesh({"data": nproc})
    sh = NamedSharding(mesh, P("data"))
    x = jax.make_array_from_process_local_data(sh, host_shard(x_global))
    y = jax.make_array_from_process_local_data(sh, host_shard(y_global))

    def model(xa, ya):
        w = sample("w", dist.Normal(0.0, 2.0))
        b = sample("b", dist.Normal(0.0, 2.0))
        sample("obs", dist.Normal(w * xa + b, 0.5).to_event(1), obs=ya)

    svi = SVI(model, MeanFieldGuide, optax.adam(0.05), model_args=(x, y))
    key = jax.random.PRNGKey(0)
    path = os.path.join(ckpt_dir, "svi.npz")

    state = svi.init(key)
    start = 0
    if mode == "resume" and os.path.exists(path):
        state = ckpt.restore(path, state)
        start = int(state.step)
    for lo in range(start, total, chunk):
        steps = min(chunk, total - lo)
        res = svi.run(key, steps, model_args=(x, y), state=state)
        state = res.state
        ckpt.save_multihost(path, state)
        if mode == "crash" and pid == 1 and int(state.step) >= fault_step:
            os._exit(17)

    check_replicated_sync(state.params)
    fp = int(replicated_fingerprint(state.params))
    print(f"RESULT {pid} {fp} {int(state.step)}", flush=True)
""")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(worker_file, nproc, ckpt_dir, mode, fault_step, total, chunk):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = ""
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, worker_file, str(i), str(nproc), str(port),
             ckpt_dir, mode, str(fault_step), str(total), str(chunk)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        )
        for i in range(nproc)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        outs.append((p.returncode, out.decode(), err.decode()))
    return outs


def _fingerprints(outs, allow_codes=(0,)):
    res = {}
    for code, out, err in outs:
        if code not in allow_codes:
            raise RuntimeError(f"worker failed (rc={code}):\n{err[-2000:]}")
        for line in out.splitlines():
            if line.startswith("RESULT"):
                _, pid, fp, step = line.split()
                res[int(pid)] = (int(fp), int(step))
    return res


def run_fault_inject(fault_step=20, total=30, chunk=10, nproc=2):
    """Run the three-leg scenario; returns the JSON-able record."""
    with tempfile.TemporaryDirectory() as tmp:
        worker_file = os.path.join(tmp, "worker.py")
        with open(worker_file, "w") as f:
            f.write(_WORKER)

        ref_dir = os.path.join(tmp, "ref")
        os.makedirs(ref_dir)
        ref = _fingerprints(
            _launch(worker_file, nproc, ref_dir, "plain", fault_step,
                    total, chunk)
        )

        crash_dir = os.path.join(tmp, "crash")
        os.makedirs(crash_dir)
        outs = _launch(worker_file, nproc, crash_dir, "crash", fault_step,
                       total, chunk)
        codes = sorted(o[0] for o in outs)
        injected = 17 in codes

        rec_outs = _launch(worker_file, nproc, crash_dir, "resume",
                           fault_step, total, chunk)
        rec = _fingerprints(rec_outs)

        ok = (
            injected
            and len(rec) == nproc
            and len({fp for fp, _ in rec.values()}) == 1
            and rec[0][0] == ref[0][0]
        )
        record = {
            "model": "fault_inject",
            "metric": "recovered_fingerprint_matches",
            "value": float(ok),
            "unit": "bool",
            "fault_step": fault_step,
            "total_steps": total,
            "checkpoint_every": chunk,
            "n_processes": nproc,
            "injected": injected,
        }
        print(json.dumps(record), flush=True)
        if not ok:
            raise RuntimeError(f"fault-injection scenario failed: {record}")
        return [record]
