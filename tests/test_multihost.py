"""Multi-host-without-a-cluster tests (SURVEY.md §4.6): spawn N local
processes, each calling jax.distributed.initialize on CPU, run a tiny
DP-SVI, and assert all hosts agree on the replicated params (fingerprint
check) — plus checkpoint/resume across a simulated failure (§5)."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""
    import os, sys
    pid, nproc, port, ckpt_dir, mode = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        sys.argv[5],
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(f"127.0.0.1:{port}", nproc, pid)
    assert jax.process_count() == nproc
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
    if mode == "resume":
        state0 = svi.init(key)
        state0 = ckpt.restore(path, state0)
        res = svi.run(key, 30, model_args=(x, y), state=state0)
    else:
        res = svi.run(key, 30, model_args=(x, y))
        if mode == "save":      # first leg of the fault-injection pair
            ckpt.save_multihost(path, res.state)
            res = svi.run(key, 30, model_args=(x, y), state=res.state)
        elif mode == "crash":   # SURVEY.md §5 fault injection: one host
            ckpt.save_multihost(path, res.state)  # dies right after ckpt
            if pid == 1:
                os._exit(17)
            res = svi.run(key, 30, model_args=(x, y), state=res.state)

    check_replicated_sync(res.params)      # raises DesyncError on mismatch
    fp = int(replicated_fingerprint(res.params))
    print(f"RESULT {pid} {fp} {float(res.losses[-1]):.6f}", flush=True)
""")


INFER_BODY = textwrap.dedent("""
    import jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    import bayesic_tpu.dist as dist
    from bayesic_tpu.core import sample
    from bayesic_tpu.infer.mcmc import MCMC
    from bayesic_tpu.infer.smc import SMC
    from bayesic_tpu.parallel import make_mesh

    yv = jnp.asarray(np.linspace(-0.5, 1.5, 16).astype(np.float32))

    def model():
        mu = sample("mu", dist.Normal(0.0, 3.0))
        sample("obs", dist.Normal(mu, 1.0).expand((16,)).to_event(1), obs=yv)

    # ---- sharded-chain NUTS across all devices (1 per process when
    # distributed; SURVEY.md §4.6 / VERDICT r1 item 7) -----------------------
    n_dev = jax.device_count()
    mesh = make_mesh({"chain": n_dev})
    mcmc = MCMC(model=model, num_warmup=50, num_samples=50, num_chains=4,
                init_step_size=0.5,
                chain_sharding=NamedSharding(mesh, P("chain")))
    res = mcmc.run(jax.random.PRNGKey(0))
    q = res.unconstrained
    nuts_mean = float(jnp.mean(q))
    nuts_std = float(jnp.std(q))
    nuts_m3 = float(jnp.mean(q ** 3))

    # ---- sharded-particle SMC with at least one resampling stage ----------
    pmesh = make_mesh({"particle": n_dev})
    smc = SMC(model, num_particles=128, mutation_steps=2,
              hmc_leapfrog_steps=3, ess_target=0.9, resample_threshold=0.9,
              particle_sharding=NamedSharding(pmesh, P("particle")))
    sres = smc.run(jax.random.PRNGKey(1))
    smc_logz = float(sres.log_evidence)
    smc_mean = float(jnp.sum(jnp.exp(sres.log_weights)
                             * sres.unconstrained[:, 0]))
    stages = int(sres.num_stages)
    print(f"INFER {nuts_mean:.6f} {nuts_std:.6f} {nuts_m3:.6f} "
          f"{smc_logz:.6f} {smc_mean:.6f} {stages}", flush=True)
""")

WORKER_INFER = textwrap.dedent("""
    import os, sys
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(f"127.0.0.1:{port}", nproc, pid)
    assert jax.process_count() == nproc
""") + INFER_BODY

REF_INFER = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
""") + INFER_BODY


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(nproc, port, ckpt_dir, mode, worker_file):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # one device per process: drop the 8-virtual-device flag pytest sets
    env["XLA_FLAGS"] = ""
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, worker_file, str(i), str(nproc), str(port),
             ckpt_dir, mode],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        )
        for i in range(nproc)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        outs.append((p.returncode, out.decode(), err.decode()))
    return outs


def _results(outs, allow_codes=(0,)):
    res = {}
    for code, out, err in outs:
        assert code in allow_codes, f"worker failed:\n{err[-2000:]}"
        for line in out.splitlines():
            if line.startswith("RESULT"):
                _, pid, fp, loss = line.split()
                res[int(pid)] = (int(fp), float(loss))
    return res


@pytest.fixture
def worker_file(tmp_path):
    f = tmp_path / "worker.py"
    f.write_text(WORKER)
    return str(f)


def test_two_process_dp_svi_stays_in_sync(worker_file, tmp_path):
    outs = _launch(2, _free_port(), str(tmp_path), "plain", worker_file)
    res = _results(outs)
    assert len(res) == 2
    # replicated params byte-identical across hosts
    assert res[0][0] == res[1][0]
    # and losses identical
    assert res[0][1] == res[1][1]


def test_checkpoint_resume_matches_uninterrupted(worker_file, tmp_path):
    """Fault-injection analogue (SURVEY.md §5): run 30 steps + checkpoint +
    30 more in one job; then restart from the checkpoint in a fresh job and
    verify the final replicated params fingerprint matches."""
    port = _free_port()
    outs = _launch(2, port, str(tmp_path), "save", worker_file)
    ref = _results(outs)

    outs2 = _launch(2, _free_port(), str(tmp_path), "resume", worker_file)
    got = _results(outs2)

    assert ref[0][0] == got[0][0], "resume diverged from continuous run"
    assert abs(ref[0][1] - got[0][1]) < 1e-6


def _parse_infer(out):
    for line in out.splitlines():
        if line.startswith("INFER"):
            vals = line.split()[1:]
            return [float(v) for v in vals[:5]] + [int(vals[5])]
    raise AssertionError(f"no INFER line in output:\n{out[-2000:]}")


def test_two_process_nuts_and_smc_match_single_process(tmp_path):
    """SURVEY.md §4.6 / VERDICT r1 item 7: a sharded-chain NUTS run and a
    sharded-particle SMC run (with resampling stages) across 2 REAL
    jax.distributed processes must agree with the single-process run —
    randomness is keyed by logical index, never by device."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = ""
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")

    ref_file = tmp_path / "ref_infer.py"
    ref_file.write_text(REF_INFER)
    ref_proc = subprocess.run(
        [sys.executable, str(ref_file)], capture_output=True, text=True,
        env=env, timeout=300,
    )
    assert ref_proc.returncode == 0, ref_proc.stderr[-2000:]
    ref = _parse_infer(ref_proc.stdout)

    worker = tmp_path / "worker_infer.py"
    worker.write_text(WORKER_INFER)
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        outs.append((p.returncode, out.decode(), err.decode()))
    for code, _, err in outs:
        assert code == 0, f"worker failed:\n{err[-2000:]}"
    got0 = _parse_infer(outs[0][1])
    got1 = _parse_infer(outs[1][1])

    assert got0 == got1, "the two processes disagree with each other"
    assert got0[5] >= 2 and ref[5] >= 2, "SMC never resampled/tempered"
    assert got0[5] == ref[5], "stage count changed under sharding"
    np.testing.assert_allclose(got0[:5], ref[:5], rtol=5e-4, atol=5e-4)


def test_fault_injection_one_host_dies_then_restart(worker_file, tmp_path):
    """SURVEY.md §5 failure-detection story: a host dies mid-run (after the
    checkpoint); the job is restarted with the SAME process count from the
    checkpoint and must land exactly where an uninterrupted run would."""
    # reference: uninterrupted save-then-continue run
    outs_ref = _launch(2, _free_port(), str(tmp_path), "save", worker_file)
    ref = _results(outs_ref)

    # crashed run: host 1 exits hard right after the checkpoint barrier
    crash_dir = tmp_path / "crash"
    crash_dir.mkdir()
    outs_crash = _launch(2, _free_port(), str(crash_dir), "crash",
                         worker_file)
    codes = sorted(o[0] for o in outs_crash)
    assert 17 in codes, "injected failure did not occur"

    # recovery: fixed process count restart from the checkpoint
    outs_rec = _launch(2, _free_port(), str(crash_dir), "resume",
                       worker_file)
    rec = _results(outs_rec)
    assert rec[0][0] == rec[1][0]          # hosts agree after recovery
    assert rec[0][0] == ref[0][0]          # and match the uninterrupted run
