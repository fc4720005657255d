"""The XLA device ops that every tool's device path runs, against the
native host engine and plain numpy references (CPU backend)."""

import numpy as np
import pytest

from genometester4_tpu.ops.encode import join_u64, split_u64


@pytest.mark.parametrize("canonical", [True, False],
                         ids=["canonical", "forward"])
@pytest.mark.parametrize("k", [1, 5, 16, 25, 31, 32])
def test_extract_kmers_matches_native(rng, k, canonical):
    """extract_kmers (the doubling window build) == the host engine's
    rolling extraction (fgx_extract_canonical / fgx_extract_forward),
    window for window, across invalid bases."""
    import jax.numpy as jnp

    from genometester4_tpu.models.fastgt_native import get_lib
    from genometester4_tpu.ops.kmers import extract_kmers

    n = 1 << 14
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    codes[rng.integers(0, n, size=n // 50)] = 255
    hi, lo, valid = (np.asarray(x) for x in extract_kmers(
        jnp.asarray(codes), k, canonical=canonical))
    lib = get_lib()
    fn = lib.fgx_extract_canonical if canonical else lib.fgx_extract_forward
    buf = np.empty(n, np.uint64)
    m = fn(codes, n, k, buf)
    assert m == int(valid.sum()) > 0
    np.testing.assert_array_equal(join_u64(hi[valid], lo[valid]), buf[:m])


def _words(rng, n, k, n_distinct):
    pool = rng.integers(0, 1 << min(2 * k, 63), size=n_distinct,
                        dtype=np.int64).astype(np.uint64)
    if k == 32:
        pool |= rng.integers(0, 2, size=n_distinct).astype(np.uint64) << \
            np.uint64(63)
    return pool[rng.integers(0, n_distinct, size=n)]


@pytest.mark.parametrize("unit_weights", [True, False],
                         ids=["unit", "weighted"])
@pytest.mark.parametrize("k", [12, 25, 32])
def test_count_unique_marks_match_numpy(rng, k, unit_weights):
    """count_unique(compact=False): words at run heads, per-run counts
    from consecutive tails, and n_unique all equal np.unique over the
    valid entries (the marked stream glistmaker's device path reads)."""
    import jax.numpy as jnp

    from genometester4_tpu.ops.sortcount import count_unique

    n = 1 << 13
    words = _words(rng, n, k, n // 4)
    valid = rng.random(n) < 0.9
    weights = (np.ones(n, np.uint32) if unit_weights
               else rng.integers(1, 1000, size=n).astype(np.uint32))
    hi, lo = split_u64(words)
    shi, slo, head, tail, tprefix, n_uniq = (
        None if x is None else np.asarray(x) for x in count_unique(
            jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(weights),
            jnp.asarray(valid), hi_bits=max(0, 2 * k - 32),
            unit_weights=unit_weights, compact=False))
    exp_w, inv = np.unique(words[valid], return_inverse=True)
    exp_c = np.bincount(inv, weights=weights[valid]).astype(np.uint64)
    assert int(n_uniq) == len(exp_w)
    np.testing.assert_array_equal(join_u64(shi[head], slo[head]), exp_w)
    tails = np.flatnonzero(tail)
    np.testing.assert_array_equal(np.flatnonzero(head),
                                  np.concatenate([[0], tails[:-1] + 1]))
    if unit_weights:
        assert tprefix is None
        counts = np.diff(tails + 1, prepend=0)
    else:
        counts = np.diff(tprefix[tails].astype(np.int64), prepend=0)
    np.testing.assert_array_equal(counts.astype(np.uint64), exp_c)


def _sorted_unique_source(rng, n, k=25):
    w = np.unique(_words(rng, n, k, 4 * n))[:n]
    c = rng.integers(1, 100, size=len(w)).astype(np.uint32)
    return w, c


def _numpy_merge(sources):
    aw = np.concatenate([w for w, _ in sources])
    ac = np.concatenate([c for _, c in sources]).astype(np.uint64)
    uw, inv = np.unique(aw, return_inverse=True)
    return uw, np.bincount(inv, weights=ac).astype(np.uint64)


@pytest.mark.parametrize("S", [1, 2, 3, 4, 8])
def test_merge_gathered_sources(rng, S):
    """The mesh merge stage (S==1 identity, S>1 compact + re-sort) over S
    sorted, deduplicated sources == numpy union with summed counts."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from genometester4_tpu.parallel.sharding import merge_gathered_sources

    cap = 512
    sources = [_sorted_unique_source(rng, int(rng.integers(1, cap)))
               for _ in range(S)]
    if S > 1:   # shared words across sources exercise the count sums
        shared = sources[0][0][: len(sources[0][0]) // 2]
        sources = [(np.unique(np.concatenate([w, shared]))[:cap], None)
                   for w, _ in sources]
        sources = [(w, rng.integers(1, 100, size=len(w)).astype(np.uint32))
                   for w, _ in sources]
    bh = np.zeros((S, cap), np.uint32)
    bl = np.zeros((S, cap), np.uint32)
    bc = np.zeros((S, cap), np.uint32)
    bn = np.zeros(S, np.int32)
    for s, (w, c) in enumerate(sources):
        h, lo = split_u64(w)
        bh[s, :len(w)], bl[s, :len(w)], bc[s, :len(w)] = h, lo, c
        bn[s] = len(w)
    merge_cap = cap if S == 1 else S * cap + cap
    fn = jax.jit(partial(merge_gathered_sources, S=S, cap=cap,
                         merge_cap=merge_cap, hi_bits=2 * 25 - 32))
    mhi, mlo, mcnt, n_uniq, ovf = (np.asarray(x) for x in fn(
        jnp.asarray(bh), jnp.asarray(bl), jnp.asarray(bc), jnp.asarray(bn)))
    exp_w, exp_c = _numpy_merge(sources)
    m = int(n_uniq)
    assert not bool(ovf)
    assert m == len(exp_w)
    np.testing.assert_array_equal(join_u64(mhi[:m], mlo[:m]), exp_w)
    np.testing.assert_array_equal(mcnt[:m].astype(np.uint64), exp_c)
    assert not mcnt[m:].any()


@pytest.mark.parametrize("n_buckets", [1, 4])
@pytest.mark.parametrize("n_shards", [1, 2, 5])
def test_merge_sorted_shards_matches_numpy(rng, n_shards, n_buckets):
    """merge_sorted_shards (glistmaker's device merge of per-chunk
    results) == numpy union with summed counts, buckets in ascending
    order, for one and several prefix buckets."""
    from genometester4_tpu.pipelines.listmaker import merge_sorted_shards

    shards = []
    for _ in range(n_shards):
        w = np.unique(rng.integers(0, 1 << 63, size=3000, dtype=np.int64)
                      .astype(np.uint64) << np.uint64(1))
        shards.append((w, rng.integers(1, 50, size=len(w)).astype(np.uint32)))
    if n_shards > 1:  # overlap: the same words in every shard
        common = shards[0][0][::7]
        shards = [(np.union1d(w, common), None) for w, _ in shards]
        shards = [(w, rng.integers(1, 50, size=len(w)).astype(np.uint32))
                  for w, _ in shards]
    total = sum(len(w) for w, _ in shards)
    target = total if n_buckets == 1 else total // 3
    out = list(merge_sorted_shards(shards, target_bucket=target,
                                   word_length=32))
    assert len(out) == n_buckets
    got_w = np.concatenate([w for w, _ in out])
    got_c = np.concatenate([c for _, c in out]).astype(np.uint64)
    exp_w, exp_c = _numpy_merge(shards)
    np.testing.assert_array_equal(got_w, exp_w)
    np.testing.assert_array_equal(got_c, exp_c)
