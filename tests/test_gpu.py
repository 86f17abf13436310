"""Card-only tests: run with ``JAX_PLATFORMS=cuda pytest -m gpu``.

Each needs an NVIDIA GPU and skips elsewhere; the check is made inside the
``gpu`` fixture, never while this module is imported."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bayesic_tpu.dist as dist
from bayesic_tpu.core import sample
from bayesic_tpu.core.precision import exact
from bayesic_tpu.infer.mcmc import MCMC
from bayesic_tpu.ops import gmm_logprob

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda pytest -m gpu")
    return jax.devices()[0]


def _gmm_inputs(n, d, p, k, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    x = 3.0 * jax.random.normal(ks[0], (n, d))
    lw = jax.nn.log_softmax(jax.random.normal(ks[1], (p, k)), -1)
    mus = 2.0 * jax.random.normal(ks[2], (p, k, d))
    sig = jnp.exp(0.3 * jax.random.normal(ks[3], (p, k)))
    return x, lw, mus, sig


def _scaled(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / (1.0 + np.max(np.abs(ref)))


@pytest.mark.parametrize("n,d,p,k", [(2000, 2, 8192, 3), (777, 3, 1000, 5),
                                     (129, 8, 17, 1)])
def test_compiled_gmm_kernel_matches_reference(gpu, n, d, p, k):
    args = _gmm_inputs(n, d, p, k)
    assert gmm_logprob.use_kernel()
    got = jax.jit(gmm_logprob.gmm_loglik_grad)(*args)
    ref = jax.jit(exact(gmm_logprob._reference_value_and_grad))(*args)
    for g, r in zip(got, ref):
        assert _scaled(g, r) < 1e-5


def test_gmm_kernel_compiles_through_triton(gpu):
    """On the card the program holds the Triton kernel, not the
    reference and not the interpreter."""
    args = _gmm_inputs(300, 2, 64, 3)
    hlo = jax.jit(gmm_logprob.gmm_loglik_grad).lower(*args).as_text()
    assert "triton" in hlo.lower()
    jaxpr = str(jax.make_jaxpr(gmm_logprob.gmm_loglik)(*args))
    assert "pallas_call" in jaxpr


def test_pinned_potential_matches_float64(gpu):
    """The MCMC potential of a matmul-heavy model (Bayesian linear
    regression), computed on the card by the sampler's pinned init program,
    agrees with a float64 host evaluation to float32 accuracy: no TF32
    product enters the energy."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4096, 256)).astype(np.float32)
    y = rng.normal(size=4096).astype(np.float32)
    xd, yd = jnp.asarray(x), jnp.asarray(y)

    def model():
        w = sample("w", dist.Normal(0.0, 1.0).expand((256,)).to_event(1))
        sample("obs", dist.Normal(xd @ w, 1.0).to_event(1), obs=yd)

    q = rng.normal(size=256).astype(np.float32)
    m = MCMC(model=model, num_chains=1, init_params=q[None])
    state = jax.jit(m._init_states)(jax.random.PRNGKey(0), m.init_params)
    pe, g = state.pe[0], state.grad[0]

    x64, y64, q64 = (a.astype(np.float64) for a in (x, y, q))
    r = y64 - x64 @ q64
    half_log_2pi = 0.5 * np.log(2.0 * np.pi)
    pe_ref = (0.5 * q64 @ q64 + 0.5 * r @ r
              + (q64.size + r.size) * half_log_2pi)
    g_ref = q64 - x64.T @ r
    assert abs(float(pe) - pe_ref) <= 1e-5 * abs(pe_ref)
    assert (np.linalg.norm(np.asarray(g, np.float64) - g_ref)
            <= 1e-4 * np.linalg.norm(g_ref))
