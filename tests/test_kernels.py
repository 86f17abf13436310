"""The gmm_loglik kernel (ops/gmm_logprob.py) against its plain-JAX
reference, with the kernel run in the Pallas interpreter on the CPU
(logic parity).  The compiled kernel is checked on the card by
tests/test_gpu.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesic_tpu.ops import gmm_logprob

# K x D grid the kernel unrolls statically
KD = [(k, d) for k in (1, 3, 5) for d in (1, 2, 3, 8)]


def _gmm_inputs(n=777, d=3, p=13, k=4, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    x = jax.random.normal(ks[0], (n, d))
    lw = jax.nn.log_softmax(jax.random.normal(ks[1], (p, k)), -1)
    mus = jax.random.normal(ks[2], (p, k, d)) * 2
    sig = jnp.exp(jax.random.normal(ks[3], (p, k)) * 0.3)
    return x, lw, mus, sig


def _ref_grads(x, lw, mus, sig):
    return jax.grad(
        lambda a, b, c: gmm_logprob.gmm_loglik_reference(x, a, b, c).sum(),
        argnums=(0, 1, 2),
    )(lw, mus, sig)


def _close(got, ref, tol=2e-5):
    """max|got - ref| <= tol * (1 + max|ref|): float32 sums of N terms."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_array_less(np.abs(got - ref),
                                 tol * (1.0 + np.abs(ref).max()))


# P and N that are not multiples of the particle block or the data step
_P, _N = 21, 150


@pytest.mark.parametrize("k,d", KD)
def test_kernel_value_matches_reference(k, d):
    x, lw, mus, sig = _gmm_inputs(n=_N, d=d, p=_P, k=k, seed=k + d)
    got = gmm_logprob.gmm_loglik(x, lw, mus, sig, True)
    _close(got, gmm_logprob.gmm_loglik_reference(x, lw, mus, sig))


@pytest.mark.parametrize("k,d", KD)
def test_kernel_grad_matches_reference(k, d):
    x, lw, mus, sig = _gmm_inputs(n=_N, d=d, p=_P, k=k, seed=10 + k + d)
    got = jax.grad(
        lambda a, b, c: gmm_logprob.gmm_loglik(x, a, b, c, True).sum(),
        argnums=(0, 1, 2))(lw, mus, sig)
    for g, r in zip(got, _ref_grads(x, lw, mus, sig)):
        _close(g, r)


@pytest.mark.parametrize("k,d", KD)
def test_kernel_value_and_grad_matches_reference(k, d):
    x, lw, mus, sig = _gmm_inputs(n=_N, d=d, p=_P, k=k, seed=20 + k + d)
    got = gmm_logprob.gmm_loglik_grad(x, lw, mus, sig, interpret=True)
    ref = (gmm_logprob.gmm_loglik_reference(x, lw, mus, sig),
           *_ref_grads(x, lw, mus, sig))
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("p,n", [(1, 1), (16, 128), (17, 129), (40, 300)])
def test_kernel_padding_and_masking(p, n):
    """Particle padding (sigma=1 rows sliced off) and the masked N tail,
    around and at exact block multiples."""
    x, lw, mus, sig = _gmm_inputs(n=n, d=2, p=p, k=3, seed=p + n)
    ll, dlw, dmu, dsg = gmm_logprob.gmm_loglik_grad(x, lw, mus, sig,
                                                    interpret=True)
    _close(ll, gmm_logprob.gmm_loglik_reference(x, lw, mus, sig))
    for g, r in zip((dlw, dmu, dsg), _ref_grads(x, lw, mus, sig)):
        _close(g, r)


def test_kernel_data_cotangent_is_nan():
    """The data gradient is not implemented: NaN, never silent zeros."""
    x, lw, mus, sig = _gmm_inputs(n=40, d=2, p=5, k=2)
    gx = jax.grad(lambda xx: gmm_logprob.gmm_loglik(xx, lw, mus, sig,
                                                     True).sum())(x)
    assert gx.shape == x.shape and bool(jnp.isnan(gx).all())
    gx_cpu = jax.grad(lambda xx: gmm_logprob.gmm_loglik(xx, lw, mus,
                                                         sig).sum())(x)
    assert bool(jnp.isnan(gx_cpu).all())


@pytest.mark.parametrize("backend,interpret,expected", [
    ("cpu", False, False),
    ("cpu", True, True),
    ("gpu", False, True),
])
def test_dispatch_rule(monkeypatch, backend, interpret, expected):
    monkeypatch.setattr(gmm_logprob.jax, "default_backend", lambda: backend)
    assert gmm_logprob.use_kernel(interpret) is expected


def test_dispatch_rejects_other_backends(monkeypatch):
    monkeypatch.setattr(gmm_logprob.jax, "default_backend", lambda: "metal")
    with pytest.raises(NotImplementedError, match="metal"):
        gmm_logprob.use_kernel()


def test_cpu_path_is_the_reference():
    """On the CPU no kernel is traced: the program is the reference."""
    x, lw, mus, sig = _gmm_inputs(n=50, d=2, p=4, k=3)
    jaxpr = str(jax.make_jaxpr(gmm_logprob.gmm_loglik)(x, lw, mus, sig))
    assert "pallas_call" not in jaxpr
    jaxpr_k = str(jax.make_jaxpr(
        lambda *a: gmm_logprob.gmm_loglik(*a, True))(x, lw, mus, sig))
    assert "pallas_call" in jaxpr_k


def test_gmm_loglik_fwd_parity():
    x, lw, mus, sig = _gmm_inputs()
    ref = gmm_logprob.gmm_loglik_reference(x, lw, mus, sig)
    got = gmm_logprob.gmm_loglik(x, lw, mus, sig, True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=2e-5)


def test_gmm_loglik_grad_parity():
    x, lw, mus, sig = _gmm_inputs(n=300, p=9)

    g_ref = _ref_grads(x, lw, mus, sig)
    g_got = jax.grad(
        lambda a, b, c: gmm_logprob.gmm_loglik(x, a, b, c, True).sum(),
        argnums=(0, 1, 2),
    )(lw, mus, sig)
    for r, g in zip(g_ref, g_got):
        scale = np.abs(np.asarray(r)).max() + 1.0
        np.testing.assert_allclose(
            np.asarray(g) / scale, np.asarray(r) / scale, atol=2e-5
        )


def test_gmm_loglik_odd_sizes():
    # non-multiple-of-block sizes exercise padding/masking
    x, lw, mus, sig = _gmm_inputs(n=513, d=1, p=1, k=2, seed=3)
    ref = gmm_logprob.gmm_loglik_reference(x, lw, mus, sig)
    got = gmm_logprob.gmm_loglik(x, lw, mus, sig, True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=2e-5)


def test_gmm_loglik_under_jit_and_value_grad():
    x, lw, mus, sig = _gmm_inputs(n=256, p=8)

    @jax.jit
    def f(a, b, c):
        return jnp.sum(gmm_logprob.gmm_loglik(x, a, b, c, True))

    v, g = jax.value_and_grad(f)(lw, mus, sig)
    v_ref = jnp.sum(gmm_logprob.gmm_loglik_reference(x, lw, mus, sig))
    np.testing.assert_allclose(float(v), float(v_ref), rtol=2e-5)
    assert jnp.isfinite(g).all()


def test_gmm_loglik_grad_fused_parity():
    """Fused value+gradient kernel vs jnp value_and_grad of the reference
    (one launch; float32 elementwise distances, no reduced-precision
    products, so the gradients hold float32 tolerance too)."""
    x, lw, mus, sig = _gmm_inputs(n=777, d=2, p=300, k=3)

    ll, dlw, dmus, dsig = gmm_logprob.gmm_loglik_grad(x, lw, mus, sig,
                                                      interpret=True)

    ll_ref = gmm_logprob.gmm_loglik_reference(x, lw, mus, sig)
    np.testing.assert_allclose(np.asarray(ll), np.asarray(ll_ref),
                               rtol=3e-5, atol=3e-5)
    for got, ref in zip((dlw, dmus, dsig), _ref_grads(x, lw, mus, sig)):
        _close(got, ref)


def test_smc_mutation_fused_path_matches_vjp():
    """SMC with batched_loglik_grad (the kernel path) must track the
    generic vjp mutation path: same model, same key, near-identical
    particles."""
    from bayesic_tpu.infer.smc import SMC
    from bayesic_tpu.models import gmm

    cfg = gmm.Config(num_data=200, num_particles=256, mutation_steps=2,
                     leapfrog_steps=3)
    x, _ = gmm.make_data(cfg)
    plain = gmm.make_smc(cfg, x, kernel=False)
    fused = gmm.make_smc(cfg, x, kernel=True, interpret=True)
    assert isinstance(plain, SMC) and fused._loglik_vg is not None
    key = jax.random.PRNGKey(3)
    # deterministic check: the fused potential+gradient equals the generic
    # vjp one on the same particle batch (trajectory-level equality is not
    # meaningful — a single f32 accept-flip diverges the chaotic paths)
    q0 = plain._init_particles(key)
    beta = jnp.asarray(0.6)

    def vjp_pe_and_grad(qs):
        pe, vjp = jax.vjp(
            lambda z: -(plain._logprior(z) + beta * plain._loglik(z)), qs
        )
        return pe, vjp(jnp.ones_like(pe))[0]

    def fused_pe_and_grad(qs):
        lp, glp = fused._logprior_vg(qs)
        ll, gll = fused._loglik_vg(qs)
        return -(lp + beta * ll), -(glp + beta * gll)

    pe1, g1 = jax.jit(vjp_pe_and_grad)(q0)
    pe2, g2 = jax.jit(fused_pe_and_grad)(q0)
    np.testing.assert_allclose(np.asarray(pe2), np.asarray(pe1),
                               rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(np.asarray(g2), np.asarray(g1),
                               rtol=2e-4, atol=2e-4)

    # statistical sanity: both full runs land on comparable evidence
    r1 = plain.run(key)
    r2 = fused.run(key)
    assert abs(float(r1.log_evidence) - float(r2.log_evidence)) < 15.0


def test_smc_with_batched_pallas_loglik():
    """End-to-end: GMM SMC with the kernel likelihood must match the
    vmap-of-replay likelihood (same seed => same tempering path).

    Pinned to the deterministic 'nudge' step adapter: the default
    dual-averaging adapter feeds acceptance statistics back into the step
    size continuously, so the last-ulp differences between the kernel and
    jnp likelihoods get amplified into genuinely different trajectories —
    the tight tolerances here are only meaningful when the two runs follow
    the SAME tempering path."""
    from bayesic_tpu.models import gmm

    cfg = gmm.Config(smoke=True)
    kw = {"smc_kwargs": {"step_adapt": "nudge"}}
    out_ref = gmm.run(cfg, kernel=False, **kw)
    out_pal = gmm.run(cfg, kernel=True, interpret=True, **kw)
    np.testing.assert_allclose(out_pal["log_evidence"],
                               out_ref["log_evidence"], rtol=1e-3, atol=0.2)
    assert out_pal["num_stages"] == out_ref["num_stages"]
    np.testing.assert_allclose(out_pal["pred_loglik"],
                               out_ref["pred_loglik"], rtol=1e-2)
