"""FastGT 15-genotype posterior — device batch implementation.

The numerical model follows src/genotypes.c:10-125: per marker, the
posterior over {X,A,B,AA,AB,BB,AAA..BBBB} is
prior(genotype; p0,p1,p2,pB) x NegBin(count_a; mu_a, size_a)
x NegBin(count_b; mu_b, size_b), with the five coverage levels
{error, lambda/2, lambda, 1.5 lambda, 2 lambda}.

One fused jnp program genotypes millions of markers per device dispatch
(lgamma + exp + log, all elementwise) and vmaps/shards over a device
mesh. The bit-exact host path, which is gmer_caller's output, lives in
models/fastgt_native.py; this float32 twin is reached only through
GT4_TPU_CALLER_IMPL=device (the log-space formulation keeps best-genotype
decisions stable — see tests/test_genotype_model.py for agreement checks
vs the exact path).
"""

from __future__ import annotations

import numpy as np

from genometester4_tpu.utils.lazyjax import jax, jnp, jit

N_GENOTYPES = 15

# (mu level for allele-A counts, for allele-B counts) per genotype;
# levels: 0=error 1=lambda/2 2=lambda 3=1.5*lambda 4=2*lambda
GT_MU = np.array([
    [0, 0],  # X
    [1, 0],  # A
    [0, 1],  # B
    [2, 0],  # AA
    [1, 1],  # AB
    [0, 2],  # BB
    [3, 0],  # AAA
    [2, 1],  # AAB
    [1, 2],  # BBA
    [0, 3],  # BBB
    [4, 0],  # AAAA
    [3, 1],  # AAAB
    [1, 3],  # BBBA
    [2, 2],  # AABB
    [0, 4],  # BBBB
], np.int32)

GENOTYPES = ["-", "A", "B", "AA", "AB", "BB", "AAA", "AAB", "BBA", "BBB",
             "AAAA", "AAAB", "BBBA", "AABB", "BBBB"]


def _log_dnbinom_mu(x, size, mu):
    """log NegBin(x; size, mu) with the mu/(size+mu) parameterization
    (src/binomial.c:219-244). Invalid (size<=0 or mu<=0) -> -inf."""
    p = mu / (size + mu)
    logpmf = (jax.scipy.special.gammaln(x + size)
              - jax.scipy.special.gammaln(size)
              - jax.scipy.special.gammaln(x + 1.0)
              + jnp.log(p) * x + jnp.log1p(-p) * size)
    ok = (size > 0) & (mu > 0)
    return jnp.where(ok, logpmf, -jnp.inf)


def _binom_pmf(k, n, p):
    # ensure_jax first: a bare `from jax.scipy...` as the process's
    # first jax touch would skip the compile-cache set-up
    import importlib

    from genometester4_tpu.utils.lazyjax import ensure_jax
    ensure_jax()
    gammaln = importlib.import_module("jax.scipy.special").gammaln
    return jnp.exp(gammaln(n + 1.0) - gammaln(k + 1.0)
                   - gammaln(n - k + 1.0)
                   + jnp.where(k > 0, jnp.log(p) * k, 0.0)
                   + jnp.where(n - k > 0, jnp.log1p(-p) * (n - k), 0.0))


@jit(static_argnames=())
def genotype_log_posteriors(count_a, count_b, pB, l_error, p0, p1, p2,
                            lam, size, size2):
    """Unnormalized log posterior for each marker x genotype.

    count_a/count_b: float arrays [N]; params: scalars.
    Returns log_post [N, 15].
    """
    pA = 1.0 - pB
    prior = jnp.stack([
        p0,
        pA * p1,
        pB * p1,
        pA * pA * p2,
        2 * pA * pB * p2,
        pB * pB * p2,
    ])
    p_extra = jnp.maximum(1.0 - p0 - p1 - p2, 0.0)
    pl1 = (-1.0 + jnp.sqrt(1.0 + 4.0 * p_extra)) / 2.0
    pl2 = pl1 * pl1
    tri = jnp.stack([_binom_pmf(3.0 - i, 3.0, pA) for i in range(4)])
    quad = jnp.stack([_binom_pmf(4.0 - i, 4.0, pA) for i in (0, 1, 3, 2, 4)])
    # order AAA, AAB, BBA, BBB then AAAA, AAAB, BBBA, AABB, BBBB
    prior = jnp.concatenate([
        prior,
        tri * pl1,
        quad * pl2,
    ])
    mus = jnp.stack([l_error, lam / 2, lam, lam * 1.5, lam * 2])
    sizes = size + size2 * mus
    la = _log_dnbinom_mu(count_a[:, None], sizes[None, :], mus[None, :])
    lb = _log_dnbinom_mu(count_b[:, None], sizes[None, :], mus[None, :])
    log_post = (la[:, GT_MU[:, 0]] + lb[:, GT_MU[:, 1]]
                + jnp.log(jnp.maximum(prior, 1e-300))[None, :])
    return log_post


@jit
def genotype_calls(count_a, count_b, pB, params):
    """Best genotype + normalized probability per marker.

    params: [error, p0, p1, p2, lambda, size, size2] (the gmer_caller
    v[] vector). Returns (best int32[N], prob float[N], post [N,15]).
    """
    f = jnp.float32
    lp = genotype_log_posteriors(
        count_a.astype(f), count_b.astype(f), pB,
        params[0], params[1], params[2], params[3], params[4], params[5],
        params[6])
    m = jnp.max(lp, axis=1, keepdims=True)
    w = jnp.exp(lp - m)
    post = w / jnp.sum(w, axis=1, keepdims=True)
    best = jnp.argmax(lp, axis=1).astype(jnp.int32)
    prob = jnp.take_along_axis(post, best[:, None], axis=1)[:, 0]
    return best, prob, post


@jit
def neg_log_likelihood(count_a, count_b, pB, params):
    """Training objective (sum over markers of -log marginal), the jnp
    twin of mlogL3 (src/gmer_caller.c:783-806)."""
    f = jnp.float32
    lp = genotype_log_posteriors(
        count_a.astype(f), count_b.astype(f), pB,
        params[0], params[1], params[2], params[3], params[4], params[5],
        params[6])
    m = jnp.max(lp, axis=1)
    marginal = m + jnp.log(jnp.sum(jnp.exp(lp - m[:, None]), axis=1))
    return -jnp.sum(marginal)


@jit
def _raw_posteriors(count_a, count_b, pB, params):
    """Raw (unnormalized) posteriors + row sums + argmax — the device
    twin of fgx_genotype_batch's per-marker output (a[i], sum, best),
    which print_genotypes needs because the reference compares the RAW
    a[best] against the probability cutoff (src/gmer_caller.c:448) and
    prints a[best]/sum."""
    f = jnp.float32
    lp = genotype_log_posteriors(
        count_a.astype(f), count_b.astype(f), pB,
        params[0], params[1], params[2], params[3], params[4], params[5],
        params[6])
    a = jnp.exp(lp)          # float32: underflows ~e^-87 where the
    sums = jnp.sum(a, axis=1)  # native float64 path goes to ~e^-708 —
    best = jnp.argmax(lp, axis=1).astype(jnp.uint32)  # documented tol
    return a, sums, best


def genotype_batch_device(counts: np.ndarray, pB: float,
                          params: np.ndarray, chunk: int = 1 << 20):
    """Drop-in twin of fastgt_native.genotype_batch on the accelerator:
    flat uint16 [a0,b0,a1,b1,...] -> (a[n,15], sum[n], best[n]).

    Routing: pipelines/gmercall.print_genotypes selects this only under
    GT4_TPU_CALLER_IMPL=device. float32 posteriors; best-call agreement vs the exact native path is
    pinned by tests/test_genotype_model.py::test_device_caller_*."""
    counts = np.asarray(counts).reshape(-1, 2)
    n = len(counts)
    a = np.empty((n, N_GENOTYPES), np.float64)
    sums = np.empty(n, np.float64)
    best = np.empty(n, np.uint32)
    p = jnp.asarray(np.asarray(params, np.float32))
    for s in range(0, n, chunk):
        ca = jnp.asarray(counts[s:s + chunk, 0].astype(np.float32))
        cb = jnp.asarray(counts[s:s + chunk, 1].astype(np.float32))
        aa, ss, bb = _raw_posteriors(ca, cb, float(pB), p)
        e = s + len(counts[s:s + chunk])
        a[s:e] = np.asarray(aa, np.float64)
        sums[s:e] = np.asarray(ss, np.float64)
        best[s:e] = np.asarray(bb)
    return a, sums, best


def genotype_calls_batch(counts: np.ndarray, pB: float,
                         params: np.ndarray, chunk: int = 1 << 20):
    """Host wrapper: flat uint16 [a0,b0,a1,b1,...] like the native path."""
    counts = np.asarray(counts).reshape(-1, 2)
    n = len(counts)
    best = np.empty(n, np.int32)
    prob = np.empty(n, np.float64)
    p = jnp.asarray(np.asarray(params, np.float32))
    for s in range(0, n, chunk):
        a = jnp.asarray(counts[s:s + chunk, 0].astype(np.float32))
        b = jnp.asarray(counts[s:s + chunk, 1].astype(np.float32))
        bb, pp, _ = genotype_calls(a, b, float(pB), p)
        best[s:s + len(counts[s:s + chunk])] = np.asarray(bb)
        prob[s:s + len(counts[s:s + chunk])] = np.asarray(pp)
    return best, prob
