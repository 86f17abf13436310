"""__graft_entry__.py: ``entry()`` and ``dryrun_multichip(n)`` run with
plain-JAX MLPs and no kernels, on the 8 virtual CPU devices."""

import importlib.util
import os

import jax
import numpy as np
import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def graft():
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(HERE, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_elbo_is_finite(graft):
    fn, args = graft.entry()
    assert np.isfinite(float(jax.jit(fn)(*args)))


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip(graft, n, capsys):
    assert jax.device_count() >= n
    graft.dryrun_multichip(n)
    assert f"dryrun_multichip({n})" in capsys.readouterr().out
