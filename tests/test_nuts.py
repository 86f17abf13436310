"""NUTS/HMC golden-posterior tests (SURVEY.md §4.3): conjugate and published
posteriors within 2 MCSE (the BASELINE.json acceptance rule); adaptation and
integrator unit tests."""

import jax
import jax.numpy as jnp
import numpy as np

import bayesic_tpu.dist as dist
from bayesic_tpu.core import plate, sample
from bayesic_tpu.infer.mcmc import (
    MCMC,
    IntegratorState,
    da_init,
    da_update,
    make_leapfrog,
    make_nuts_kernel,
    welford_finalize,
    welford_init,
    welford_update,
)
from bayesic_tpu.utils import diagnostics as diag

KEY = jax.random.PRNGKey(0)


def test_leapfrog_energy_conservation():
    def pag(q):
        return jax.value_and_grad(lambda x: 0.5 * jnp.sum(x * x))(q)

    lf = make_leapfrog(pag)
    q = jnp.array([1.0, -0.5])
    p = jnp.array([0.3, 0.8])
    pe, grad = pag(q)
    s = IntegratorState(q, p, pe, grad)
    inv_mass = jnp.ones(2)
    h0 = s.pe + 0.5 * jnp.sum(p * p)
    for _ in range(100):
        s = lf(s, 0.01, inv_mass)
    h1 = s.pe + 0.5 * jnp.sum(s.p * s.p)
    assert abs(float(h1 - h0)) < 1e-4
    # reversibility: integrate back
    s_back = IntegratorState(s.q, -s.p, s.pe, s.grad)
    for _ in range(100):
        s_back = lf(s_back, 0.01, inv_mass)
    np.testing.assert_allclose(np.asarray(s_back.q), np.asarray(q), atol=1e-4)


def test_dual_averaging_targets_accept():
    da = da_init(jnp.asarray(1.0))
    # fake feedback: accept too high when eps small -> eps should grow
    for _ in range(100):
        accept = jnp.where(jnp.exp(da.log_step) < 0.5, 0.99, 0.2)
        da = da_update(da, accept, target=0.8)
    eps = float(jnp.exp(da.log_step_avg))
    assert 0.2 < eps < 1.5


def test_welford_matches_numpy():
    rng = np.random.default_rng(0)
    xs = rng.normal(2.0, 3.0, (500, 4)).astype(np.float32)
    wf = welford_init(4)
    for x in xs:
        wf = welford_update(wf, jnp.asarray(x))
    var = welford_finalize(wf, regularize=False)
    np.testing.assert_allclose(np.asarray(var), xs.var(0, ddof=1), rtol=1e-3)
    np.testing.assert_allclose(np.asarray(wf.mean), xs.mean(0), rtol=1e-3,
                               atol=1e-3)

    wfd = welford_init(4, dense=True)
    for x in xs:
        wfd = welford_update(wfd, jnp.asarray(x))
    cov = welford_finalize(wfd, regularize=False)
    np.testing.assert_allclose(np.asarray(cov), np.cov(xs.T), rtol=1e-2,
                               atol=1e-2)


def test_nuts_kernel_standard_normal_raw():
    """Raw kernel on N(0, I_3): chain mean/cov converge."""

    def pag(q):
        return jax.value_and_grad(lambda x: 0.5 * jnp.sum(x * x))(q)

    kernel = make_nuts_kernel(pag)
    q = jnp.zeros(3)
    pe, grad = pag(q)
    state = IntegratorState(q, jnp.zeros(3), pe, grad)
    inv_mass = jnp.ones(3)

    def step(st, i):
        key = jax.random.fold_in(KEY, i)
        st, info = kernel(key, st, jnp.asarray(0.5), inv_mass)
        return st, st.q

    _, qs = jax.lax.scan(step, state, jnp.arange(2000))
    qs = np.asarray(qs[500:])
    assert np.abs(qs.mean(0)).max() < 0.15
    np.testing.assert_allclose(qs.var(0), 1.0, rtol=0.2)


def test_mcmc_conjugate_normal_within_2mcse():
    """BASELINE.json acceptance rule: posterior moments within 2 MCSE of the
    analytic (conjugate) values."""
    rng = np.random.default_rng(3)
    n = 50
    y = jnp.asarray(rng.normal(1.5, 1.0, n).astype(np.float32))
    post_var = 1.0 / (1.0 / 100.0 + n)
    post_mean = post_var * float(y.sum())

    def model():
        mu = sample("mu", dist.Normal(0.0, 10.0))
        sample("obs", dist.Normal(mu, 1.0).expand((n,)).to_event(1), obs=y)

    mcmc = MCMC(model=model, num_warmup=500, num_samples=500, num_chains=4,
                init_step_size=0.5)
    res = mcmc.run(KEY)
    s = res.samples["mu"]
    assert s.shape == (4, 500)
    summ = diag.summary({"mu": s})["mu"]
    assert float(summ["rhat"]) < 1.02
    assert float(summ["ess"]) > 200
    mcse = float(summ["mcse"])
    assert abs(float(summ["mean"]) - post_mean) < 2.5 * mcse + 1e-3
    np.testing.assert_allclose(float(summ["std"]), np.sqrt(post_var),
                               rtol=0.15)
    # divergence-free on a Gaussian target
    assert int(res.extra["diverging"].sum()) == 0


def test_mcmc_dense_mass_correlated_gaussian():
    cov = np.array([[1.0, 0.95], [0.95, 1.0]], np.float32)
    prec = jnp.asarray(np.linalg.inv(cov))

    def pag(q):
        return jax.value_and_grad(lambda x: 0.5 * x @ prec @ x)(q)

    mcmc = MCMC(potential_and_grad=pag, example_q=jnp.zeros(2),
                num_warmup=600, num_samples=800, num_chains=4,
                dense_mass=True, init_step_size=0.2)
    res = mcmc.run(KEY)
    qs = np.asarray(res.unconstrained).reshape(-1, 2)
    np.testing.assert_allclose(qs.mean(0), 0.0, atol=0.12)
    np.testing.assert_allclose(np.cov(qs.T), cov, atol=0.25)
    # adapted inverse mass should reflect the covariance (dense)
    im = np.asarray(res.extra["inv_mass"])[0]
    assert im.shape == (2, 2)
    assert im[0, 1] > 0.3  # picked up the strong positive correlation


def test_eight_schools_noncentered():
    """configs[1]-style hierarchical model; posterior must match published
    long-run values (mu ~ 4.4, tau ~ 3.6) within generous MC error."""
    y = jnp.asarray([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
    sigma = jnp.asarray([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])

    def model():
        mu = sample("mu", dist.Normal(0.0, 5.0))
        tau = sample("tau", dist.HalfCauchy(5.0))
        theta_raw = sample("theta_raw",
                           dist.Normal(0.0, 1.0).expand((8,)).to_event(1))
        theta = mu + tau * theta_raw
        sample("obs", dist.Normal(theta, sigma).to_event(1), obs=y)

    mcmc = MCMC(model=model, num_warmup=700, num_samples=700, num_chains=4,
                target_accept=0.9, init_step_size=0.2)
    res = mcmc.run(jax.random.PRNGKey(7))
    mu_s = res.samples["mu"]
    tau_s = res.samples["tau"]
    summ = diag.summary({"mu": mu_s, "tau": tau_s})
    assert float(summ["mu"]["rhat"]) < 1.05
    assert float(summ["tau"]["rhat"]) < 1.1
    assert abs(float(summ["mu"]["mean"]) - 4.4) < 0.6
    assert abs(float(summ["tau"]["mean"]) - 3.6) < 1.0
    div_rate = float(res.extra["diverging"].mean())
    assert div_rate < 0.02


def test_hmc_kernel_runs():
    def model():
        sample("x", dist.Normal(0.0, 1.0).expand((3,)).to_event(1))

    mcmc = MCMC(model=model, kernel="hmc", num_warmup=300, num_samples=400,
                num_chains=2, hmc_num_steps=16, init_step_size=0.3)
    res = mcmc.run(KEY)
    x = np.asarray(res.samples["x"]).reshape(-1, 3)
    assert np.abs(x.mean(0)).max() < 0.2
    np.testing.assert_allclose(x.var(0), 1.0, rtol=0.25)


def test_shared_adapt_many_chains():
    """Pooled cross-chain adaptation (configs[4] regime): one step size +
    mass matrix fed by all chains; posterior still correct."""
    rng = np.random.default_rng(5)
    n = 30
    y = jnp.asarray(rng.normal(-0.5, 1.0, n).astype(np.float32))
    post_var = 1.0 / (1.0 / 25.0 + n)
    post_mean = post_var * float(y.sum())

    def model():
        mu = sample("mu", dist.Normal(0.0, 5.0))
        sample("obs", dist.Normal(mu, 1.0).expand((n,)).to_event(1), obs=y)

    mcmc = MCMC(model=model, num_warmup=300, num_samples=300, num_chains=16,
                shared_adapt=True, init_step_size=0.5)
    res = mcmc.run(jax.random.PRNGKey(2))
    # shared adaptation -> scalar step size and single mass vector
    assert res.extra["step_size"].ndim == 0
    assert res.extra["inv_mass"].shape == (1,)
    s = res.samples["mu"]
    summ = diag.summary({"mu": s})["mu"]
    assert float(summ["rhat"]) < 1.02
    assert abs(float(summ["mean"]) - post_mean) < 3 * float(summ["mcse"]) + 1e-3
    np.testing.assert_allclose(float(summ["std"]), np.sqrt(post_var),
                               rtol=0.15)


def test_thinning_inside_scan():
    def model():
        sample("x", dist.Normal(0.0, 1.0).expand((2,)).to_event(1))

    m = MCMC(model=model, num_warmup=100, num_samples=50, num_chains=2,
             thin=4, init_step_size=0.5)
    res = m.run(jax.random.PRNGKey(0))
    # num_samples counts COLLECTED draws
    assert res.samples["x"].shape == (2, 50, 2)
    # thinned draws decorrelate faster than unthinned
    x = res.samples["x"][:, :, 0]
    assert float(diag.ess(x)) > 40


def test_nuts_stationary_distribution_ks():
    """Distributional exactness: NUTS draws from a skewed target pass a KS
    test against the exact law (thinned to tame autocorrelation) — the
    strongest practical form of the BASELINE 'within MC error' criterion."""
    import scipy.stats as sps

    def model():
        sample("x", dist.Gamma(3.0, 2.0))

    res = MCMC(model=model, num_warmup=500, num_samples=4000, num_chains=4,
               init_step_size=0.5).run(jax.random.PRNGKey(0))
    xs = np.asarray(res.samples["x"]).ravel()
    ref = sps.gamma(a=3.0, scale=0.5)
    for q in (0.05, 0.25, 0.5, 0.75, 0.95):
        got, want = np.quantile(xs, q), ref.ppf(q)
        assert abs(got - want) / want < 0.08, (q, got, want)
    ks = sps.kstest(xs[::13], ref.cdf)
    assert ks.pvalue > 0.01, f"KS rejected: p={ks.pvalue}"


def test_run_segmented_matches_monolithic():
    """run_segmented (chunked XLA programs with host fences, the
    long-adaptation path) must reproduce run()
    exactly — both index schedule and PRNG stream by absolute step."""
    yv = jnp.asarray(np.linspace(-0.5, 1.5, 16).astype(np.float32))

    def model():
        mu = sample("mu", dist.Normal(0.0, 3.0))
        sample("obs", dist.Normal(mu, 1.0).expand((16,)).to_event(1), obs=yv)

    kw = dict(model=model, num_warmup=75, num_samples=50, num_chains=4,
              init_step_size=0.5)
    r1 = MCMC(**kw).run(KEY)
    # uneven chunks exercise the remainder-program path
    r2 = MCMC(**kw).run_segmented(KEY, warmup_chunk=30, sample_chunk=20)
    np.testing.assert_allclose(np.asarray(r1.unconstrained),
                               np.asarray(r2.unconstrained),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(r1.extra["step_size"]
                                     if np.ndim(r1.extra["step_size"]) == 0
                                     else r1.extra["step_size"][0]),
                               float(r2.extra["step_size"]
                                     if np.ndim(r2.extra["step_size"]) == 0
                                     else r2.extra["step_size"][0]),
                               rtol=1e-6)


def test_init_params_shape_validated():
    """ADVICE r3: a mis-shaped init_params must fail fast in __init__ with
    a message naming the expected (num_chains, dim) unconstrained layout,
    not deep inside the vmapped chain init."""
    import pytest

    from bayesic_tpu.infer.mcmc import MCMC

    def model():
        sample("mu", dist.Normal(0.0, 1.0))
        sample("tau", dist.HalfNormal(1.0))

    with pytest.raises(ValueError, match="UNCONSTRAINED"):
        MCMC(model=model, num_chains=4,
             init_params=jnp.zeros((3, 2)))     # wrong chain count
    with pytest.raises(ValueError, match=r"\(4, 2\)"):
        MCMC(model=model, num_chains=4,
             init_params=jnp.zeros((4, 5)))     # wrong dim
    MCMC(model=model, num_chains=4, init_params=jnp.zeros((4, 2)))
