"""Agreement tests: the jnp device genotype model vs the exact native path.

The jnp model (float32, log-space) is the device twin; it must make
the same best-genotype decisions as the bit-exact native library on all
but boundary-tied markers.
"""

import ctypes

import numpy as np

from genometester4_tpu.models import fastgt_native as native
from genometester4_tpu.models.genotype import (GT_MU, genotype_calls_batch,
                                               genotype_log_posteriors)


def test_gt_mu_table_matches_reference_model(rng):
    """Every (genotype, mu-level) pair must reproduce the reference's
    per-genotype negbin means (src/genotypes.c:50-125) — checked by
    comparing posteriors against the native exact implementation."""
    lib = native.get_lib()
    lib.fgx_genotype_probabilities.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_float, ctypes.c_uint,
        ctypes.c_uint] + [ctypes.c_double] * 7
    params = [0.05, 4.26e-05, 0.0149, 0.985, 31.2, 65.48, -0.679]
    pB = 0.37
    n = 300
    ca = rng.integers(0, 70, n)
    cb = rng.integers(0, 70, n)
    import jax.numpy as jnp
    lp = np.asarray(genotype_log_posteriors(
        jnp.asarray(ca, jnp.float32), jnp.asarray(cb, jnp.float32),
        pB, *params))
    for i in range(0, n, 17):
        a = (ctypes.c_double * 15)()
        lib.fgx_genotype_probabilities(a, pB, int(ca[i]), int(cb[i]),
                                       *params)
        exact = np.array(list(a))
        with np.errstate(divide="ignore"):
            exact_lp = np.log(exact)
        finite = np.isfinite(exact_lp) & np.isfinite(lp[i])
        # same ranking of genotypes (floating error aside)
        assert np.argmax(exact) == np.argmax(lp[i]) or np.isclose(
            np.sort(exact)[-1], np.sort(exact)[-2], rtol=1e-3)
        np.testing.assert_allclose(lp[i][finite], exact_lp[finite],
                                   rtol=2e-3, atol=2e-3)


def test_batch_calls_agree_with_native(rng):
    params = np.array([0.0547, 4.26e-05, 0.0149, 0.985, 28.7, 65.48,
                       -0.679], np.float32)
    pB = 0.29
    n = 5000
    counts = rng.integers(0, 90, 2 * n).astype(np.uint16)
    best_j, prob_j = genotype_calls_batch(counts, pB, params)
    a, sums, best_n = native.genotype_batch(counts, pB, params)
    agree = (best_j == best_n.astype(np.int32))
    # ties/boundaries may flip under float32: require near-total agreement
    assert agree.mean() > 0.995, agree.mean()
    pn = a[np.arange(n), best_n] / sums
    ok = np.isfinite(pn) & agree
    np.testing.assert_allclose(prob_j[ok], pn[ok], rtol=5e-2, atol=5e-3)


def test_device_caller_batch_twin_matches_native(rng):
    """genotype_batch_device (the device twin behind
    GT4_TPU_CALLER_IMPL=device) must agree with
    fgx_genotype_batch at the documented float32 tolerance: best calls
    near-totally identical, printed probabilities (%.2f of a/sum)
    within one rounding step."""
    from genometester4_tpu.models.genotype import genotype_batch_device
    params = np.array([0.0547, 4.26e-05, 0.0149, 0.985, 24.3, 65.48,
                       -0.679], np.float32)
    pB = 0.41
    n = 4000
    counts = rng.integers(0, 80, 2 * n).astype(np.uint16)
    ad, sd, bd = genotype_batch_device(counts, pB, params)
    an, sn, bn = native.genotype_batch(counts, pB, params)
    agree = bd == bn
    assert agree.mean() > 0.995, agree.mean()
    pd = ad[np.arange(n), bd] / np.where(sd == 0, 1, sd)
    pn = an[np.arange(n), bn] / np.where(sn == 0, 1, sn)
    ok = agree & np.isfinite(pd) & np.isfinite(pn) & (sd > 0) & (sn > 0)
    np.testing.assert_allclose(pd[ok], pn[ok], rtol=5e-2, atol=6e-3)


def test_device_caller_production_routing(rng, tmp_path, monkeypatch):
    """run_caller with GT4_TPU_CALLER_IMPL=device produces a decision-
    identical genotype table to the parity (native) path: the device
    twin is production-REACHABLE, not a unit-test artifact. Genotype
    and count columns must match exactly; the probability column within
    one %.2f step."""
    import io

    from genometester4_tpu.pipelines.gmercall import run_caller

    lines = ["#gmer_counter version 4.2.16 (stable)"]
    for i in range(600):
        a, b = int(rng.integers(0, 60)), int(rng.integers(0, 60))
        lines.append(f"1:{1000+i}:rs{i}:A/G\t2\t{a}\t{b}")
    data = ("\n".join(lines) + "\n").encode()

    outs = {}
    for impl in ("host", "device"):
        monkeypatch.setenv("GT4_TPU_CALLER_IMPL", impl)
        buf = io.StringIO()
        rc = run_caller(data, buf, nruns=1, max_training=400)
        assert rc == 0
        outs[impl] = buf.getvalue().splitlines()
    assert len(outs["host"]) == len(outs["device"])
    n_prob_off = 0
    for lh, ld in zip(outs["host"], outs["device"]):
        th, td = lh.split("\t"), ld.split("\t")
        assert th[0] == td[0]
        assert th[1] == td[1], (lh, ld)        # genotype decision
        assert th[3:] == td[3:]                # counts
        if th[2] != td[2]:                     # %.2f probability
            n_prob_off += 1
            assert abs(float(th[2]) - float(td[2])) <= 0.011, (lh, ld)
    assert n_prob_off <= len(outs["host"]) * 0.02
