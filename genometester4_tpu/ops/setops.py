"""Set operations over sorted k-mer lists — device kernels.

The reference walks two (or N) sorted lists with a cursor zipper
(src/glistcompare.c:843-905, :500-717) deciding per word via
``include_in_union/intersection/complement`` (src/glistcompare.c:433-489).

Device formulation: concatenate the (already sorted, already unique) lists
with a source tag, sort by word, and reduce each equal-word run into an
aligned table of per-source frequencies. All four set outputs (union /
intersection / diff1 / diff2) are then element-wise masks + compactions
over that aligned table — one sort feeds every requested output, like
the reference's single zipper pass feeding four files at once.

Like ops.sortcount, everything is scatter-free (a design rule from the
accelerator this was first written for, not yet re-measured on the GPU):
per-run reductions are differences of prefix sums gathered at run heads,
min/max reductions exploit a secondary sort key (within an equal-word
run, counts are sorted ascending, so min = first and max = last entry),
and compaction is a (flag, position)-keyed sort.

Frequency-rule semantics are copied exactly, including:
* 2-list union: excluded only if BOTH freqs are below cutoff;
* 2-list intersection: both freqs must reach cutoff; default rule MIN;
* difference: freq1 >= cutoff and freq2 < cutoff, default rule SUBTRACT;
* ``-du`` subtract quirk: keep only words with freq1 == freq2 >= cutoff
  (src/glistcompare.c:477-482);
* N-list union/intersect apply the cutoff to the COMBINED frequency
  (src/glistcompare.c:575,686) — different from the 2-list path;
* rule freq of 0 suppresses the word (``*freq != 0`` checks);
* u32 wraparound on ADD matches C unsigned arithmetic.
"""

from __future__ import annotations

from genometester4_tpu.utils.lazyjax import jax, jnp, jit

from genometester4_tpu.ops.sortcount import sort_compact, _iota32

RULE_DEFAULT = "default"
RULE_ADD = "add"
RULE_SUBTRACT = "subtract"
RULE_MIN = "min"
RULE_MAX = "max"
RULE_FIRST = "first"
RULE_SECOND = "second"
RULE_NUMBER = "number"


def _run_heads(shi, slo, svalid):
    first = jnp.concatenate([jnp.ones((1,), jnp.bool_),
                             (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1])])
    return first & svalid


def _head_prefix(head, values, total):
    """Per-run sums: exclusive prefix at run heads; non-heads carry the
    grand total so compacted-tail differences vanish."""
    excl = jnp.cumsum(values) - values
    return jnp.where(head, excl, total)


@jit
def pair_align(hi1, lo1, c1, valid1, hi2, lo2, c2, valid2):
    """Align two sorted unique lists into one unique word table.

    Returns (uhi, ulo, f1, f2, n_uniq): for every word present in either
    list, its count in list1 and list2 (0 when absent), sorted ascending.
    """
    hi = jnp.concatenate([hi1, hi2])
    lo = jnp.concatenate([lo1, lo2])
    c = jnp.concatenate([c1, c2])
    src = jnp.concatenate([jnp.zeros(hi1.shape, jnp.uint32),
                           jnp.ones(hi2.shape, jnp.uint32)])
    valid = jnp.concatenate([valid1, valid2])

    inv = (~valid).astype(jnp.uint32)
    inv, shi, slo, sc, ssrc = jax.lax.sort((inv, hi, lo, c, src), num_keys=3,
                                           is_stable=False)
    svalid = inv == 0
    head = _run_heads(shi, slo, svalid)

    w1 = jnp.where(svalid & (ssrc == 0), sc, 0)
    w2 = jnp.where(svalid & (ssrc == 1), sc, 0)
    t1, t2 = jnp.sum(w1), jnp.sum(w2)
    e1 = _head_prefix(head, w1, t1)
    e2 = _head_prefix(head, w2, t2)

    n_uniq, uhi, ulo, ce1, ce2 = sort_compact(head, shi, slo, e1, e2)
    f1 = (jnp.concatenate([ce1[1:], t1[None]]) - ce1).astype(jnp.uint32)
    f2 = (jnp.concatenate([ce2[1:], t2[None]]) - ce2).astype(jnp.uint32)
    return uhi, ulo, f1, f2, n_uniq


def _rule_freq(f1, f2, rule: str, count_override: int):
    """calculate_freq (src/glistcompare.c:433-455)."""
    if rule == RULE_ADD:
        return f1 + f2
    if rule == RULE_SUBTRACT:
        return jnp.where(f1 > f2, f1 - f2, 0)
    if rule == RULE_MIN:
        return jnp.minimum(f1, f2)
    if rule == RULE_MAX:
        return jnp.maximum(f1, f2)
    if rule == RULE_FIRST:
        return f1
    if rule == RULE_SECOND:
        return f2
    if rule == RULE_NUMBER:
        return jnp.full_like(f1, jnp.uint32(count_override))
    raise ValueError(f"invalid rule {rule}")


@jit(static_argnames=("op", "rule", "cutoff", "count_override",
                                   "subtract"))
def apply_pair_op(uhi, ulo, f1, f2, n_uniq, op: str, rule: str = RULE_DEFAULT,
                  cutoff: int = 1, count_override: int = 1,
                  subtract: bool = False):
    """One set-operation output from an aligned pair table.

    op ∈ {union, intrsec, diff1, diff2}. Returns (n, hi, lo, counts).
    """
    n = uhi.shape[0]
    in_range = _iota32(n) < n_uniq
    co = jnp.uint32(cutoff)
    ge1, ge2 = f1 >= co, f2 >= co
    present1, present2 = f1 > 0, f2 > 0

    if op == "union":
        r = RULE_ADD if rule == RULE_DEFAULT else rule
        freq = _rule_freq(f1, f2, r, count_override)
        inc = (ge1 | ge2) & (freq != 0)
    elif op == "intrsec":
        r = RULE_MIN if rule == RULE_DEFAULT else rule
        freq = _rule_freq(f1, f2, r, count_override)
        # zipper only evaluates intersection when the word is in BOTH lists
        inc = present1 & present2 & ge1 & ge2 & (freq != 0)
    elif op == "diff1":
        if subtract:
            freq = f1
            inc = present1 & present2 & (f1 == f2) & ge1
        else:
            r = RULE_SUBTRACT if rule == RULE_DEFAULT else rule
            freq = _rule_freq(f1, f2, r, count_override)
            inc = present1 & ge1 & ~ge2 & (freq != 0)
    elif op == "diff2":
        # ddiff swaps roles and never applies subtract (src/glistcompare.c:866)
        r = RULE_SUBTRACT if rule == RULE_DEFAULT else rule
        freq = _rule_freq(f2, f1, r, count_override)
        inc = present2 & ge2 & ~ge1 & (freq != 0)
    else:
        raise ValueError(f"unknown op {op}")

    inc &= in_range
    n_out, ohi, olo, oc = sort_compact(inc, uhi, ulo, freq)
    return n_out, ohi, olo, oc


@jit(static_argnames=("n_lists", "op", "rule", "cutoff",
                                   "count_override"))
def apply_multi_op(hi, lo, c, src, valid, n_lists: int, op: str,
                   rule: str = RULE_DEFAULT, cutoff: int = 1,
                   count_override: int = 1):
    """N-list union/intersection (src/glistcompare.c:500-717).

    Inputs are the concatenation of all N sorted lists with ``src`` tags.
    Cutoff applies to the combined frequency; intersection requires
    presence in all N lists.
    """
    n = hi.shape[0]
    inv = (~valid).astype(jnp.uint32)
    # counts as 4th sort key: within an equal-word run counts ascend, so
    # run-min = first entry and run-max = last entry — no segment scatter
    inv, shi, slo, sc = jax.lax.sort((inv, hi, lo, c), num_keys=4, is_stable=False)
    svalid = inv == 0
    head = _run_heads(shi, slo, svalid)

    w = jnp.where(svalid, sc, 0)
    total_w = jnp.sum(w)
    e_add = _head_prefix(head, w, total_w)
    ones = svalid.astype(jnp.uint32)
    total_n = jnp.sum(ones)
    e_cnt = _head_prefix(head, ones, total_n)
    pos = _iota32(n)
    # non-heads carry total_n so the LAST run's "next start" lands exactly
    # one past the final valid entry (valid entries occupy [0, total_n))
    start_pos = jnp.where(head, pos, total_n.astype(jnp.int32))

    n_uniq, uhi, ulo, ce_add, ce_cnt, cpos, cmin = sort_compact(
        head, shi, slo, e_add, e_cnt, start_pos, sc)
    f_add = (jnp.concatenate([ce_add[1:], total_w[None]]) - ce_add).astype(
        jnp.uint32)
    n_src = jnp.concatenate([ce_cnt[1:], total_n[None]]) - ce_cnt
    f_min = cmin  # first entry of the run (counts ascend within run)
    # last entry of the run = entry just before the next run's start
    next_pos = jnp.concatenate([cpos[1:], total_n.astype(jnp.int32)[None]])
    last_idx = jnp.clip(next_pos - 1, 0, n - 1)
    f_max = sc[last_idx]

    if op == "union":
        r = RULE_ADD if rule == RULE_DEFAULT else rule
    else:
        r = RULE_MIN if rule == RULE_DEFAULT else rule
    if r == RULE_ADD:
        freq = f_add
    elif r == RULE_MAX:
        freq = f_max
    elif r == RULE_MIN:
        freq = f_min
    elif r == RULE_NUMBER:
        freq = jnp.full_like(f_add, jnp.uint32(count_override))
    else:
        raise ValueError(f"rule {r} not valid for multi-list {op}")

    in_range = _iota32(n) < n_uniq
    inc = in_range & (freq >= jnp.uint32(cutoff))
    if op == "intrsec":
        inc &= n_src == jnp.uint32(n_lists)

    n_out, ohi, olo, oc = sort_compact(inc, uhi, ulo, freq.astype(jnp.uint32))
    return n_out, ohi, olo, oc
