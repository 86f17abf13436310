"""The precision pin (core/precision.py): every matrix product in a
sampler's programs — the MCMC (NUTS, HMC) init and steps with a model or a
user potential and a diagonal or dense mass, parallel tempering, discrete
Gibbs, elliptical slice and SMC — is traced at HIGHEST precision, so a GPU
never runs an energy in TF32.  SVI stays at XLA's default."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import bayesic_tpu.dist as dist
from bayesic_tpu.core import sample
from bayesic_tpu.core.precision import exact
from bayesic_tpu.infer.mcmc import (
    MCMC,
    DiscreteGibbs,
    EllipticalSlice,
    ParallelTempering,
)
from bayesic_tpu.infer.smc import SMC
from bayesic_tpu.infer.svi import SVI, MeanFieldGuide

_rng = np.random.default_rng(0)
X = jnp.asarray(_rng.normal(size=(20, 4)).astype(np.float32))
Y = jnp.asarray(_rng.normal(size=20).astype(np.float32))
HIGHEST = jax.lax.Precision.HIGHEST
KEY = jax.random.PRNGKey(0)


def linreg():
    w = sample("w", dist.Normal(0.0, 1.0).expand((4,)).to_event(1))
    sample("obs", dist.Normal(X @ w, 1.0).to_event(1), obs=Y)


def mixture():
    z = sample("z", dist.Bernoulli(0.3), infer={"enumerate": True})
    w = sample("w", dist.Normal(0.0, 1.0).expand((4,)).to_event(1))
    sample("obs", dist.Normal(X @ w + 2.0 * z, 1.0).to_event(1), obs=Y)


def dot_precisions(fn, *args):
    """The precision of every dot_general in ``fn``'s jaxpr, sub-jaxprs
    (jit, scan, while, custom rules) included."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                    if hasattr(sub, "jaxpr") and hasattr(sub, "consts"):
                        walk(sub.jaxpr)
                    elif hasattr(sub, "eqns"):
                        walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


def _all_highest(precisions):
    assert precisions, "no matrix product traced: the check saw nothing"
    for p in precisions:
        assert p is not None and tuple(np.atleast_1d(p)) in (
            (HIGHEST,), (HIGHEST, HIGHEST)), p


def _mcmc_precisions(m):
    """Every product traced by an MCMC instance's programs: the init, and
    a warmup and a sampling step from that init."""
    warm, samp = m._build_steps()
    carry = m._initial_carry(KEY)
    found = dot_precisions(m._initial_carry, KEY)
    found += dot_precisions(lambda c: warm(KEY, c, 0), carry)
    found += dot_precisions(
        lambda c: samp(KEY, (c.state, c.step_size, c.inv_mass), 0), carry)
    return found


def test_exact_sets_highest_and_restores_default():
    f = exact(lambda a: a.T @ a)
    _all_highest(dot_precisions(f, X))
    assert dot_precisions(lambda a: a.T @ a, X) == [None]


def test_mcmc_model_potential_is_pinned():
    _all_highest(_mcmc_precisions(MCMC(model=linreg, num_chains=2)))


def test_mcmc_user_potential_is_pinned():
    def pag(q):
        return jax.value_and_grad(lambda qq: 0.5 * jnp.sum((X @ qq) ** 2))(q)

    m = MCMC(potential_and_grad=pag, example_q=jnp.zeros(4), num_chains=2)
    _all_highest(_mcmc_precisions(m))


@pytest.mark.parametrize("kernel", ["nuts", "hmc"])
def test_mcmc_transition_is_pinned(kernel):
    """The whole transition is pinned, not only the potential: with a
    dense mass the kinetic energy, the velocity and the U-turn checks are
    matrix products of their own."""
    counts = {}
    for dense in (False, True):
        for shared in (False, True):
            m = MCMC(model=linreg, num_chains=2, kernel=kernel,
                     hmc_num_steps=3, max_depth=3, dense_mass=dense,
                     shared_adapt=shared)
            found = _mcmc_precisions(m)
            _all_highest(found)
            counts[dense, shared] = len(found)
    # the dense traces hold the metric's products: the check sees them
    assert counts[True, False] > counts[False, False]
    assert counts[True, True] > counts[False, True]


def test_parallel_tempering_is_pinned():
    pt = ParallelTempering(linreg, num_replicas=2, num_chains=2)
    state = pt._init_state(KEY)
    _all_highest(dot_precisions(pt._init_state, KEY))
    _all_highest(dot_precisions(
        lambda s: pt._transition_all(KEY, s, jnp.full((2,), 0.1),
                                     jnp.ones((2, pt.dim))), state))


def test_discrete_gibbs_is_pinned():
    g = DiscreteGibbs(mixture, num_chains=2, max_depth=3)
    carry = g._initial_carry(KEY)
    _all_highest(dot_precisions(g._initial_carry, KEY))
    _all_highest(dot_precisions(
        lambda c: jax.vmap(g._chain_step)(
            jax.random.split(KEY, 2), c.state, c.z, c.step_size,
            c.inv_mass), carry))


def test_elliptical_slice_is_pinned():
    ess = EllipticalSlice(linreg, num_samples=2, num_burnin=2, num_chains=2)
    ess.run(KEY)
    _all_highest(dot_precisions(ess._run_fn, KEY, jnp.zeros((2, ess.dim))))


def _smc_chunk_precisions(smc):
    init, chunk = smc._run_programs(False, 1)
    c0 = init(KEY)
    return (dot_precisions(init, KEY)
            + dot_precisions(lambda c: chunk(c, KEY), c0))


def test_smc_energies_are_pinned():
    smc = SMC(linreg, num_particles=8, mutation_steps=1,
              hmc_leapfrog_steps=2)
    _all_highest(_smc_chunk_precisions(smc))


def test_smc_hooked_likelihood_is_pinned():
    def ll(qs):
        return -0.5 * jnp.sum((qs @ X.T - Y) ** 2, -1)

    def ll_vg(qs):
        return jax.vmap(jax.value_and_grad(
            lambda q: -0.5 * jnp.sum((X @ q - Y) ** 2)))(qs)

    smc = SMC(linreg, num_particles=8, mutation_steps=1,
              hmc_leapfrog_steps=2, batched_loglik=ll,
              batched_loglik_grad=ll_vg)
    _all_highest(_smc_chunk_precisions(smc))


def test_svi_keeps_default_precision():
    """SVI's gradients only steer an optimizer: XLA's default (TF32 on a
    GPU) is kept."""
    svi = SVI(linreg, MeanFieldGuide, optax.adam(0.1))
    state = svi.init(KEY)
    precs = dot_precisions(lambda s: svi.step(s)[1], state)
    assert precs and all(p is None for p in precs)
