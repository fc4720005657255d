"""Batched dictionary lookup over sorted k-mer arrays — the device dict.

Replaces the reference's per-word binary search into the mmap'd list
(src/word-map.c:134-163) and its pointer-chasing trie (src/trie.c) with
a branchless vectorized binary search: every query walks the same
⌈log2 n⌉ steps, so the whole batch is a handful of gathers per step —
latency-hiding across thousands of queries instead of one at a time.
"""

from __future__ import annotations

import math
from genometester4_tpu.utils.lazyjax import jax, jnp, jit


@jit(static_argnames=("steps",))
def batched_lookup_pair(table_hi, table_lo, table_counts, n_words, qhi, qlo,
                        steps: int):
    """Lookup queries in a sorted (hi, lo) table.

    Parameters
    ----------
    table_* : uint32[N] — sorted word pairs + counts (padded; first
        ``n_words`` valid)
    n_words : int32 scalar — number of valid entries
    qhi, qlo : uint32[Q] — query word pairs
    steps : static ⌈log2(N)⌉+1

    Returns (found bool[Q], counts uint32[Q], index int32[Q]).
    """
    q = qhi.shape[0]
    lo_idx = jnp.zeros((q,), jnp.int32)
    hi_idx = jnp.full((q,), n_words, jnp.int32)

    def body(_, carry):
        lo_i, hi_i = carry
        mid = (lo_i + hi_i) >> 1
        mid_c = jnp.minimum(mid, jnp.maximum(n_words - 1, 0))
        mhi = table_hi[mid_c]
        mlo = table_lo[mid_c]
        less = (mhi < qhi) | ((mhi == qhi) & (mlo < qlo))
        new_lo = jnp.where(less & (lo_i < hi_i), mid + 1, lo_i)
        new_hi = jnp.where(less | (lo_i >= hi_i), hi_i, mid)
        return new_lo, new_hi

    lo_idx, hi_idx = jax.lax.fori_loop(0, steps, body, (lo_idx, hi_idx))
    idx = jnp.minimum(lo_idx, jnp.maximum(n_words - 1, 0))
    found = (lo_idx < n_words) & (table_hi[idx] == qhi) & (table_lo[idx] == qlo)
    counts = jnp.where(found, table_counts[idx], 0).astype(jnp.uint32)
    return found, counts, lo_idx


def lookup_steps(capacity: int) -> int:
    return max(1, math.ceil(math.log2(max(capacity, 2))) + 1)


@jit(static_argnames=("steps",))
def batched_bounds_pair(table_hi, table_lo, n_words, qhi, qlo, steps: int):
    """Lower and upper bound of each query in a sorted (hi, lo) table.

    Unlike ``batched_lookup_pair`` the table may contain DUPLICATES:
    returns (lower int32[Q], upper int32[Q]) with lower = first index
    >= q and upper = first index > q, so upper - lower is the number of
    occurrences. This turns occurrence counting over a sorted window
    stream into two searches — no dedupe pass needed (the role of the
    reference's trie-hit counting, src/gmer_counter.c:750-815).
    """
    q = qhi.shape[0]
    llo = jnp.zeros((q,), jnp.int32)
    lhi = jnp.full((q,), n_words, jnp.int32)
    ulo = jnp.zeros((q,), jnp.int32)
    uhi = jnp.full((q,), n_words, jnp.int32)

    def body(_, carry):
        llo_i, lhi_i, ulo_i, uhi_i = carry
        cap = jnp.maximum(n_words - 1, 0)
        # lower bound: strictly-less comparator
        mid = (llo_i + lhi_i) >> 1
        mid_c = jnp.minimum(mid, cap)
        mh, ml = table_hi[mid_c], table_lo[mid_c]
        less = (mh < qhi) | ((mh == qhi) & (ml < qlo))
        llo_n = jnp.where(less & (llo_i < lhi_i), mid + 1, llo_i)
        lhi_n = jnp.where(less | (llo_i >= lhi_i), lhi_i, mid)
        # upper bound: less-or-equal comparator
        mid = (ulo_i + uhi_i) >> 1
        mid_c = jnp.minimum(mid, cap)
        mh, ml = table_hi[mid_c], table_lo[mid_c]
        leq = (mh < qhi) | ((mh == qhi) & (ml <= qlo))
        ulo_n = jnp.where(leq & (ulo_i < uhi_i), mid + 1, ulo_i)
        uhi_n = jnp.where(leq | (ulo_i >= uhi_i), uhi_i, mid)
        return llo_n, lhi_n, ulo_n, uhi_n

    llo, lhi, ulo, uhi = jax.lax.fori_loop(0, steps, body,
                                           (llo, lhi, ulo, uhi))
    return llo, ulo
