"""CI smoke for the scaling-efficiency harness: the machinery that measures
DP-SVI scaling over several cards must run automatically, not only by
hand.  On the 8-device virtual CPU mesh the RATIO is meaningless (virtual
devices share host cores), so this asserts structure + finiteness only,
exactly as the records themselves are labeled ("program-validation, not a
throughput measurement")."""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_run_scaling_smoke(tmp_path):
    out = tmp_path / "scaling.json"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    proc = subprocess.run(
        [sys.executable, "-m", "benchmarks.harness", "--model", "scaling",
         "--smoke", "--cpu", "--out", str(out)],
        capture_output=True, text=True, timeout=1500, cwd=HERE, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    recs = json.loads(out.read_text())
    by_model = {r["model"]: r for r in recs}
    assert set(by_model) == {"dlgm_dp_scaling"}
    for r in by_model.values():
        assert r["metric"] == "scaling_efficiency"
        assert r["n_devices"] == 8
        for f in ("value", "rate_1dev", "rate_ndev"):
            v = float(r[f])
            assert v > 0.0 and v == v and v != float("inf"), (r["model"], f)
        # virtual-mesh records must carry the program-validation label
        assert "virtual CPU devices" in r.get("note", "")
