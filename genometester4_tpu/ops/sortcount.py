"""Device sort + segmented count — the counting heart of the engine.

The reference counts k-mers by radix-sorting per-thread tables
(src/utils.c:101-198) and run-length scanning (src/word-table.c:233-258),
then k-way merging sorted tables/files (src/glistmaker.c:1081-1154,
src/set-operations.c:40-129). On the device both collapse into one
primitive:

    sort by (hi, lo) → mark run heads → per-run weight sums

Design rule carried from the accelerator this was first written for:
NO SCATTERS (its scatters serialized; sorts and gathers were fast). It
is not yet re-measured on the GPU, where the two-key comparator sort
is ~94% of glistmaker's chunk step (PERF.md; ROADMAP 1.4). So:

* run compaction is done with a second sort keyed on (is_not_head,
  position) instead of a scatter;
* per-run weight sums come from DIFFERENCES OF AN EXCLUSIVE PREFIX SUM
  gathered at run heads, instead of jax.ops.segment_sum (a scatter-add).
  uint32 prefix-sum wraparound is harmless: run sums fit u32 (reference
  count semantics wrap at u32 anyway), and differences of wrapped
  prefixes are exact mod 2^32.

Everything is static-shape: inputs are padded, outputs are padded, and
``n_unique`` travels as a scalar.
"""

from __future__ import annotations

from genometester4_tpu.utils.lazyjax import jax, jnp, jit


def _iota32(n):
    return jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).reshape(n)


def sort_compact(mask, *arrays):
    """Scatter-free stream compaction: entries where ``mask`` move to the
    front, preserving order. Returns (n_kept, compacted arrays...).
    Tail slots hold the (arbitrary) non-kept entries.

    The (keep, position) pair packs into ONE uint32 key (positions are
    int32 so bit 31 is free): a single-key sort instead of a two-key
    one."""
    n = mask.shape[0]
    key = jnp.where(mask, jnp.uint32(0), jnp.uint32(1 << 31)) \
        | _iota32(n).astype(jnp.uint32)
    out = jax.lax.sort((key,) + tuple(arrays), num_keys=1, is_stable=False)
    return (jnp.sum(mask.astype(jnp.int32)),) + out[1:]


@jit(static_argnames=("hi_bits", "unit_weights", "compact"))
def count_unique(hi, lo, weights, valid, hi_bits: int = 32,
                 unit_weights: bool = False, compact: bool = True):
    """Dedupe-and-sum over arbitrary (unsorted) word pairs.

    Parameters
    ----------
    hi, lo : uint32[N] — word pairs (need not be sorted)
    weights : uint32[N] — per-entry count contribution (1 for raw k-mers,
        existing counts when merging shards)
    valid : bool[N] — entries to include
    hi_bits : static — number of significant bits in ``hi`` (2k-32 for
        k-mers of length k). When <= 30 the invalid flag packs into the
        hi key, dropping the sort from 3 keys to 2 (and k <= 16
        collapses hi entirely).
    unit_weights : static — promise that every valid weight is 1 (raw
        k-mer extraction). Counts are then head-position differences:
        the big sort carries no weight payload and the prefix sum
        disappears.
    compact : static — when True, unique words are moved to the leading
        ``n_unique`` slots (costs a second full-length sort). When False
        both that sort AND all scans vanish: runs are described by pure
        element-wise head/tail marks; use it whenever the consumer can
        take a marked stream (e.g. host-side .list writing).

    Returns
    -------
    With ``compact=True``: (uhi, ulo, counts, n_unique) — sorted unique
    words in the first ``n_unique`` slots (ascending unsigned 64-bit
    order), their summed counts, and the scalar count of uniques; tail
    counts are zero.

    With ``compact=False``: (shi, slo, head, tail, tail_prefix, n_unique)
    — the full sorted stream plus bool masks marking the FIRST and LAST
    slot of each valid run. Valid runs tile the stream contiguously from
    slot 0, so with ``tails = nonzero(tail)``: words live at
    ``heads = concat([[0], tails[:-1] + 1])`` (== ``nonzero(head)``),
    and per-run counts are differences of ``tail_prefix`` (the inclusive
    weight prefix sum, meaningful at tail slots) at consecutive tails —
    u32-wrap-exact like the reference's counters. ``unit_weights``
    returns ``tail_prefix=None``: counts are then differences of the
    tail POSITIONS themselves (+1), no prefix array needed.
    """
    n = hi.shape[0]
    # invalid entries sort to the end via a leading flag bit/key, so no
    # word sentinel is needed (an all-ones word is a legal k=32 k-mer)
    if hi_bits <= 30:
        inv_flag = jnp.where(valid, jnp.uint32(0),
                             jnp.uint32(1 << max(hi_bits, 0)))
        packed = inv_flag | hi
        if unit_weights:
            packed, slo = jax.lax.sort((packed, lo), num_keys=2, is_stable=False)
            w = None
        else:
            packed, slo, w = jax.lax.sort((packed, lo, weights), num_keys=2,
                                             is_stable=False)
        svalid = (packed >> max(hi_bits, 0)) == 0
        shi = packed & jnp.uint32((1 << max(hi_bits, 0)) - 1) \
            if hi_bits > 0 else jnp.zeros_like(packed)
    else:
        inv = (~valid).astype(jnp.uint32)
        if unit_weights:
            inv, shi, slo = jax.lax.sort((inv, hi, lo), num_keys=3,
                                        is_stable=False)
            w = None
        else:
            inv, shi, slo, w = jax.lax.sort((inv, hi, lo, weights),
                                            num_keys=3, is_stable=False)
        svalid = inv == 0

    first = jnp.concatenate([jnp.ones((1,), jnp.bool_),
                             (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1])])
    head = first & svalid

    if unit_weights:
        # valid entries sort to the front, so the exclusive count prefix
        # of all-ones weights is just the position index
        total = jnp.sum(valid.astype(jnp.uint32))
        excl = _iota32(n).astype(jnp.uint32)
    else:
        w = jnp.where(svalid, w, 0)
        total = jnp.sum(w)
        excl = jnp.cumsum(w) - w  # exclusive prefix (u32 wrap is exact)
    if not compact:
        # no scans at all: a slot is a run TAIL iff the next slot starts
        # a new run (or it is the last valid slot) — pure element-wise
        # neighbour compares. Counts reconstruct from consecutive tail
        # positions / prefix values (see docstring).
        n_unique = jnp.sum(head.astype(jnp.int32))
        last_valid = _iota32(n) == (total.astype(jnp.int32) - 1)
        tail = (jnp.concatenate([first[1:], jnp.ones((1,), jnp.bool_)])
                | last_valid) & svalid
        if unit_weights:
            return shi, slo, head, tail, None, n_unique
        incl = excl + w  # inclusive weight prefix (u32 wrap is exact)
        return shi, slo, head, tail, incl, n_unique

    # head rows carry their segment's start prefix; everything else carries
    # the grand total so compacted-tail differences vanish
    e_head = jnp.where(head, excl, total)

    # single-key compaction with payloads: (head-flag, position) pack into
    # one uint32 key; the payloads ride the sort instead of a gather by
    # permutation.
    n_unique, uhi, ulo, ce = sort_compact(head, shi, slo, e_head)
    ce_next = jnp.concatenate([ce[1:], total[None]])
    counts = (ce_next - ce).astype(jnp.uint32)
    return uhi, ulo, counts, n_unique


@jit(static_argnames=("min_count", "max_count"))
def filter_counts(hi, lo, counts, n_unique, min_count: int = 1,
                  max_count: int | None = None):
    """Apply frequency cutoffs (glistmaker -c/--max) and recompact.

    Returns (hi, lo, counts, n_kept) with survivors in the leading slots.
    """
    n = hi.shape[0]
    in_range = _iota32(n) < n_unique
    keep = in_range & (counts >= jnp.uint32(min_count))
    if max_count is not None:
        keep &= counts <= jnp.uint32(max_count)
    n_kept, out_hi, out_lo, out_c = sort_compact(keep, hi, lo, counts)
    out_c = jnp.where(_iota32(n) < n_kept, out_c, 0)
    return out_hi, out_lo, out_c, n_kept
