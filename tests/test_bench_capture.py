"""Capture-path resilience for bench.py: the last stdout line must always
parse — not after a giant record dict, and not after a kill mid-sweep.
These tests drive the emit logic without touching a device, and the kill
tests launch bench.py as a real subprocess and kill it mid-sweep, asserting
the LAST stdout line always json.loads."""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COMPACT_FIELDS = {"metric", "value", "unit", "spread", "status"}


@pytest.fixture()
def bench():
    spec = importlib.util.spec_from_file_location(
        "bench_under_test", os.path.join(HERE, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(capsys):
    """(full_record_dict, compact_dict_from_final_line, raw_final_line).

    emit() prints compact/full/compact; earlier progress lines may precede.
    The full line is the unique one carrying "workloads"."""
    lines = capsys.readouterr().out.strip().splitlines()
    full = next(json.loads(ln) for ln in lines if '"workloads"' in ln)
    return full, json.loads(lines[-1]), lines[-1]


def _rec(model, value):
    return {"model": model, "metric": "elbo_steps_per_s_per_chip",
            "value": value, "unit": "steps/s/chip", "spread": 0.03}


def test_emit_partial_keeps_records(bench, capsys):
    """A sweep cut short must still emit the measured records."""
    done = {"linreg": [_rec("linreg", 123.0)]}
    rc = bench.emit(done, error="deadline expired before gmm")
    full, compact, _ = _lines(capsys)
    assert rc == 1
    assert full["workloads"]["linreg"]["value"] == 123.0
    assert "error" in full and "error" in compact
    assert compact["value"] == 0.0
    assert compact["status"] == "partial"


def test_emit_final_line_is_compact_and_parseable(bench, capsys):
    """The caller parses the LAST line of a bounded stdout tail.  The
    final line must json.loads, stay ≤ 500 bytes even with every workload
    populated with rich records, and contain the headline fields; the
    per-workload dict must NOT be on it."""
    rich = dict(_rec("x", 1.0), mfu=0.455, hbm_util=0.9, bound="compute",
                reps=25, min_ess=1234.5, max_rhat=1.0008, converged=True,
                achieved_tflops=89.1, platform="gpu",
                device_kind="NVIDIA H100 80GB HBM3", stages=21, chains=1024)
    done = {name: [dict(rich, model=name), dict(rich, model=name + "_nuts")]
            for name in bench.WORKLOADS}
    rc = bench.emit(done)
    full, compact, raw_last = _lines(capsys)
    assert rc == 0
    assert len(raw_last) <= 500
    assert set(compact) == COMPACT_FIELDS
    assert compact["value"] == 1.0 and compact["status"] == "complete"
    assert "workloads" in full and len(full["workloads"]) == 10


def test_emit_final_line_compact_even_on_error(bench, capsys):
    long_err = "no GPU found: " + "x" * 400
    rc = bench.emit({}, error=long_err)
    _, compact, raw_last = _lines(capsys)
    assert rc == 1
    assert len(raw_last) <= 500 and compact["error"].startswith("no GPU")


def test_startup_line_parses_with_no_records(bench, capsys):
    """The line printed at second zero must already satisfy the contract."""
    line = bench.compact_line({}, "starting")
    compact = json.loads(line)
    assert len(line) <= 500
    assert compact["value"] == 0.0 and compact["status"] == "starting"


def test_main_runs_every_workload_afresh(bench, monkeypatch, capsys):
    """main() runs each workload once, in order, dlgm first, and resumes
    nothing; every stdout line parses."""
    ran = []

    def fake_run(name):
        ran.append(name)
        return [_rec(name, 7.0)]

    monkeypatch.setattr(bench, "run_workload", fake_run)
    rc = bench.main()
    out_lines = capsys.readouterr().out.strip().splitlines()
    parsed = [json.loads(ln) for ln in out_lines]
    assert ran == list(bench.WORKLOADS) and ran[0] == "dlgm"
    assert rc == 0 and parsed[-1]["value"] == 7.0
    assert parsed[-1]["status"] == "complete"
    assert len(out_lines[-1]) <= 500 and "workloads" not in parsed[-1]


def test_run_workload_passes_the_compile_cache(bench, monkeypatch,
                                               tmp_path):
    """Each harness child gets the cache directory of the one helper:
    $JAX_COMPILATION_CACHE_DIR when set."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    seen = {}

    def fake_subprocess_run(cmd, **kw):
        seen["env"] = kw["env"]
        out = cmd[cmd.index("--out") + 1]
        with open(out, "w") as f:
            json.dump([_rec("dlgm", 3.0)], f)
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(bench.subprocess, "run", fake_subprocess_run)
    assert bench.run_workload("dlgm") == [_rec("dlgm", 3.0)]
    assert seen["env"]["JAX_COMPILATION_CACHE_DIR"] == str(tmp_path / "c")


def test_main_deadline_expiry_emits_partial(bench, monkeypatch, capsys):
    """When the hard deadline expires mid-sweep, emit() must run with the
    partial records rather than keep working."""
    def one_then_expire(name):
        monkeypatch.setattr(bench, "DEADLINE_S", 0.0)
        return [_rec(name, 42.0)]

    monkeypatch.setattr(bench, "run_workload", one_then_expire)
    rc = bench.main()
    full, compact, raw_last = _lines(capsys)
    assert rc == 1
    assert "deadline" in compact["error"]
    assert full["workloads"]["dlgm"]["value"] == 42.0
    assert json.loads(raw_last)["status"] == "partial"


# --- real-subprocess kill tests (the r4 failure mode, end to end) --------

DRIVER = textwrap.dedent("""\
    import importlib.util, json, sys, time
    spec = importlib.util.spec_from_file_location("bench", {bench_path!r})
    bench = spec.loader.exec_module
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def slow_workload(name):
        time.sleep({sleep_s})
        return [{{"model": name, "metric": "elbo_steps_per_s_per_chip",
                  "value": 11.0, "unit": "steps/s/chip", "spread": 0.01}}]

    mod.run_workload = slow_workload
    sys.exit(mod.main())
""")


def _launch_stubbed(tmp_path, sleep_s):
    script = tmp_path / "driver.py"
    script.write_text(DRIVER.format(
        bench_path=os.path.join(HERE, "bench.py"),
        sleep_s=sleep_s,
    ))
    return subprocess.Popen(
        [sys.executable, str(script)], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True, cwd=HERE,
    )


def _read_until(proc, pred, deadline=30.0):
    """Read stdout lines until pred(line) or timeout; returns all lines."""
    lines = []
    t0 = time.time()
    while time.time() - t0 < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line.rstrip("\n"))
        if pred(lines[-1]):
            return lines
    raise AssertionError(f"pattern never seen; got {lines}")


@pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGINT])
def test_kill_mid_sweep_last_line_parses(tmp_path, sig):
    """A SIGTERM/SIGINT at any instant must leave a parseable last line
    with the records measured so far."""
    proc = _launch_stubbed(tmp_path, sleep_s=60.0)
    try:
        lines = _read_until(proc, lambda ln: "in-progress 1/" in ln)
        proc.send_signal(sig)
        rest, _ = proc.communicate(timeout=30)
        all_lines = lines + rest.strip().splitlines()
        last = json.loads(all_lines[-1])
        assert last["status"] == "partial"
        # dlgm runs FIRST precisely so a killed sweep still carries the
        # headline value
        assert last["value"] == 11.0
        assert "signal" in last["error"]
        assert len(all_lines[-1]) <= 500
        # every line emitted was parseable
        for ln in all_lines:
            json.loads(ln)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_sigkill_mid_sweep_last_line_parses(tmp_path):
    """Even SIGKILL (no handler possible) leaves a parseable last line,
    because a compact line is printed+flushed after every workload."""
    proc = _launch_stubbed(tmp_path, sleep_s=60.0)
    try:
        lines = _read_until(proc, lambda ln: "in-progress 1/" in ln)
        proc.kill()
        proc.wait(timeout=30)
        last = json.loads(lines[-1])
        assert last["status"].startswith("in-progress")
        assert len(lines[-1]) <= 500
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
