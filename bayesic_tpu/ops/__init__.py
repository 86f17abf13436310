"""Hand-written kernels, each beside its plain-JAX reference (SURVEY.md C14).

``gmm_logprob`` holds the one kernel: the GMM log-likelihood and its
gradient, a Pallas kernel compiled through Triton on a GPU.  On the CPU
the reference is the path; tests run the kernel in the Pallas interpreter.
"""

from .gmm_logprob import gmm_loglik, gmm_loglik_grad, gmm_loglik_reference

__all__ = ["gmm_loglik", "gmm_loglik_grad", "gmm_loglik_reference"]
