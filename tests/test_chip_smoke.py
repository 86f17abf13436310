"""chip_smoke.py on the CPU: it refuses to run without a GPU (and outside a
checkout), and each of its phases runs end to end at a tiny size — the
one-card phases here, the --four checks on 4 of the virtual devices."""

import importlib.util
import os
import shutil
import subprocess
import sys

import jax
import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(HERE, "chip_smoke.py")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(args, cwd, env_extra=None, path=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    if path is not None:
        env["PATH"] = path
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_ok_line(proc):
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("flags", [[], ["--four"]])
def test_refuses_without_gpu(tmp_path, flags):
    """No nvidia-smi answers: it says why, exits non-zero, no ok line."""
    proc = _run([SCRIPT, *flags], cwd=tmp_path, path=str(tmp_path))
    _no_ok_line(proc)
    assert "no GPU" in proc.stdout


def test_refuses_outside_a_checkout(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SCRIPT, alone)
    proc = _run([str(alone)], cwd=tmp_path)
    _no_ok_line(proc)
    assert "checkout" in proc.stdout


def test_refuses_when_jax_finds_only_the_cpu(tmp_path):
    """Even with a card answering nvidia-smi, a CPU-only JAX is refused:
    nothing falls back to the CPU."""
    fake = tmp_path / "nvidia-smi"
    fake.write_text("#!/bin/sh\necho 'NVIDIA H100 80GB HBM3, 700.00 W'\n")
    fake.chmod(0o755)
    proc = _run([SCRIPT, "--four"], cwd=tmp_path,
                path=f"{tmp_path}:{os.environ.get('PATH', '')}")
    _no_ok_line(proc)
    assert "H100" in proc.stdout and "not a GPU" in proc.stdout


def test_gate_failure_is_raised(smoke):
    smoke.check(True, "fine")
    with pytest.raises(smoke.GateFailure, match="boom"):
        smoke.check(False, "boom")


def test_failed_phase_is_reported_not_swallowed(smoke, capsys):
    def bad():
        smoke.check(False, "gate missed")

    assert smoke._run_phases([("Px", bad), ("Py", lambda: None)]) == ["Px"]
    out = capsys.readouterr().out
    assert "Px: FAILED" in out and "gate missed" in out and "Py: ok" in out


def test_phase_svi_tiny(smoke):
    out = smoke.phase_svi("cpu", num_data=512, data_dim=8, latent_dim=3,
                          hidden=16, batch_size=64, steps=200)
    assert out["loss_last"] < out["loss_first"]
    assert out["value_rel_highest"] <= smoke.P1_VALUE_TOL


def test_phase_nuts_tiny(smoke):
    out = smoke.phase_nuts("cpu", num_chains=8, rows=2, svi_steps=50,
                           num_warmup=100, num_samples=100)
    assert out["max_rhat"] <= smoke.P2_RHAT_MAX and out["min_ess"] > 0


def test_phase_gmm_tiny(smoke):
    out = smoke.phase_gmm("cpu", num_particles=256, num_data=200,
                          eval_reps=2, smc_rounds=1, interpret=True)
    assert out["kernel_worst_err"] <= smoke.P3_KERNEL_TOL
    for mode in ("xla", "hooks", "kernel"):
        assert len(out[f"smc_{mode}"]["walls_s"]) == 2
        assert abs(out[f"smc_{mode}"]["gap"]) < smoke.P3_GAP_MAX


@pytest.mark.parametrize("name,kw", [
    ("four_dp_svi", dict(num_data=1024, data_dim=16, latent_dim=4,
                         hidden=32, batch_per_device=32, steps=5)),
    ("four_chain_nuts", dict(num_chains=64, dim=8, num_warmup=100,
                             num_samples=100)),
    ("four_resample", dict(num_particles=4096, dim=4)),
    ("four_dense_mf", dict(num_users=64, num_items=64, num_factors=4,
                           num_ratings=2000)),
])
def test_four_checks_on_virtual_devices(smoke, name, kw):
    devices = jax.devices()[:4]
    assert len(devices) == 4
    assert getattr(smoke, name)(devices, **kw)
