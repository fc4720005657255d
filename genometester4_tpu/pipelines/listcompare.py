"""glistcompare equivalent: set operations over .list files.

Mirrors src/glistcompare.c's behaviors (see ops/setops.py for the rule
semantics). Large lists are processed in word-range buckets: both inputs
are partitioned at identical u64 boundaries (cheap host searchsorted on
the sorted mmap'd arrays), each bucket runs one device align+ops pass,
and outputs stream to ListWriters in ascending order — so results are
identical to a single full-size pass.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np

from genometester4_tpu.utils.lazyjax import jnp

from genometester4_tpu.formats.list_format import (GT4_LIST_CODE,
                                                    ListWriter, read_list)


def read_word_source(path):
    """Load a .list OR .index as (header-like, words, counts) — the
    reference's set operations accept either through the GT4WordSList
    interface, with index counts being location counts
    (src/glistcompare.c:250-286)."""
    import struct
    from types import SimpleNamespace
    with open(path, "rb") as f:
        code = struct.unpack("<I", f.read(4))[0]
    if code == GT4_LIST_CODE:
        return read_list(path)
    from genometester4_tpu.formats.index_format import (GT4_INDEX_CODE,
                                                        read_index_map)
    if code == GT4_INDEX_CODE:
        im = read_index_map(path)
        counts = im.counts
        hdr = SimpleNamespace(word_length=im.word_length,
                              n_words=len(im.words),
                              total_count=int(im.num_locations))
        return hdr, im.words, counts
    raise ValueError(
        f"Error: {path} is not a valid GenomeTester4 list/index file")
from genometester4_tpu.ops.encode import split_u64, join_u64
from genometester4_tpu.ops import setops
from genometester4_tpu.utils.rand48 import Rand48

RULES = {"default": setops.RULE_DEFAULT, "add": setops.RULE_ADD,
         "sum": setops.RULE_ADD, "subtract": setops.RULE_SUBTRACT,
         "min": setops.RULE_MIN, "max": setops.RULE_MAX,
         "first": setops.RULE_FIRST, "second": setops.RULE_SECOND,
         "number": setops.RULE_NUMBER}

DEFAULT_BUCKET = 1 << 25


def _pad(arr, cap, dtype):
    out = np.zeros(cap, dtype=dtype)
    out[: len(arr)] = arr
    return out


def _buckets(n_total, target):
    n = 1 << max(0, math.ceil(math.log2(max(1, n_total / target))))
    if n > 1:
        bounds = np.arange(1, n, dtype=np.uint64) * np.uint64(2 ** 64 // n)
    else:
        bounds = np.empty(0, np.uint64)
    return n, bounds


def _bucket_slices(words, bounds, b, n_buckets):
    a = 0 if b == 0 else np.searchsorted(words, bounds[b - 1])
    z = len(words) if b == n_buckets - 1 else np.searchsorted(words, bounds[b])
    return int(a), int(z)


# multi-list ops print a progress line at every PROGRESS_TICK output
# words when -D is on (src/glistcompare.c:586-588, src/set-operations.c:
# 111-113); module-level so tests can lower it below 100M
PROGRESS_TICK = 100_000_000


def _emit_progress_ticks(prev: int, new: int) -> None:
    """Print the reference's "Words written: NM" line for every
    PROGRESS_TICK boundary crossed in (prev, new]."""
    b = (prev // PROGRESS_TICK + 1) * PROGRESS_TICK
    while b <= new:
        sys.stderr.write("Words written: %uM\n" % (b // 1_000_000))
        b += PROGRESS_TICK


class _OpSink:
    """Accumulates one op's output: either a ListWriter or count-only."""

    def __init__(self, op, path, word_length, count_only, debug=0):
        self.op = op
        self.count_only = count_only
        self.n_words = 0
        self.total_count = 0
        self.debug = debug
        self.writer = None if count_only else ListWriter(path, word_length)

    def append(self, words, counts):
        prev = self.n_words
        self.n_words += len(words)
        self.total_count += int(np.asarray(counts, np.uint64).sum())
        if self.debug:
            _emit_progress_ticks(prev, self.n_words)
        if self.writer:
            self.writer.append(words, counts)

    def close(self):
        if self.writer:
            self.writer.close()


def _op_filename(out, wlen, op, nmm=0):
    if op == "union":
        return f"{out}_{wlen}_union.list"
    if op == "intrsec":
        return f"{out}_{wlen}_intrsec.list"
    if op == "diff1":
        return f"{out}_{wlen}_{nmm}_diff1.list"
    if op == "diff2":
        return f"{out}_{wlen}_{nmm}_diff2.list"
    raise ValueError(op)


# ---------------------------------------------------------------------------
# Host (numpy) twins of the device set-op kernels.
#
# The inputs are ALREADY SORTED, so on a CPU backend a stable merge +
# segment reductions beat the device formulation's re-sorts by an order
# of magnitude. Semantics mirror ops/setops.py exactly (same masks, same
# u32 wraparound); the differential suite runs both.
# ---------------------------------------------------------------------------


def _setops_impl() -> str:
    impl = os.environ.get("GT4_TPU_SETOPS_IMPL", "auto")
    if impl != "auto":
        return impl
    from genometester4_tpu.utils.backend import prefer_host
    return "host" if prefer_host() else "device"


def _host_pair_align(w1, c1, w2, c2):
    # native C merge of the two sorted streams (numpy formulations peak
    # at ~3x the reference's zipper cost: argsort + fancy indexing +
    # reduceats each re-stream the data; the C merge does one pass)
    from genometester4_tpu.models.fastgt_native import get_lib
    lib = get_lib()
    w1 = np.ascontiguousarray(w1, np.uint64)
    w2 = np.ascontiguousarray(w2, np.uint64)
    c1 = np.ascontiguousarray(c1, np.uint32)
    c2 = np.ascontiguousarray(c2, np.uint32)
    cap = len(w1) + len(w2)
    uw = np.empty(cap, np.uint64)
    f1 = np.empty(cap, np.uint32)
    f2 = np.empty(cap, np.uint32)
    m = lib.fgx_pair_align(w1, c1, len(w1), w2, c2, len(w2), uw, f1, f2)
    return uw[:m], f1[:m], f2[:m]


def _host_rule_freq(f1, f2, rule, count_override):
    if rule == setops.RULE_ADD:
        return f1 + f2
    if rule == setops.RULE_SUBTRACT:
        return np.where(f1 > f2, f1 - f2, 0).astype(np.uint32)
    if rule == setops.RULE_MIN:
        return np.minimum(f1, f2)
    if rule == setops.RULE_MAX:
        return np.maximum(f1, f2)
    if rule == setops.RULE_FIRST:
        return f1
    if rule == setops.RULE_SECOND:
        return f2
    if rule == setops.RULE_NUMBER:
        return np.full_like(f1, np.uint32(count_override))
    raise ValueError(f"invalid rule {rule}")


def _host_apply_pair_op(uw, f1, f2, op, rule, cutoff, count_override,
                        subtract):
    co = np.uint32(cutoff)
    ge1, ge2 = f1 >= co, f2 >= co
    present1, present2 = f1 > 0, f2 > 0
    if op == "union":
        r = setops.RULE_ADD if rule == setops.RULE_DEFAULT else rule
        freq = _host_rule_freq(f1, f2, r, count_override)
        inc = (ge1 | ge2) & (freq != 0)
    elif op == "intrsec":
        r = setops.RULE_MIN if rule == setops.RULE_DEFAULT else rule
        freq = _host_rule_freq(f1, f2, r, count_override)
        inc = present1 & present2 & ge1 & ge2 & (freq != 0)
    elif op == "diff1":
        if subtract:
            freq = f1
            inc = present1 & present2 & (f1 == f2) & ge1
        else:
            r = setops.RULE_SUBTRACT if rule == setops.RULE_DEFAULT else rule
            freq = _host_rule_freq(f1, f2, r, count_override)
            inc = present1 & ge1 & ~ge2 & (freq != 0)
    elif op == "diff2":
        r = setops.RULE_SUBTRACT if rule == setops.RULE_DEFAULT else rule
        freq = _host_rule_freq(f2, f1, r, count_override)
        inc = present2 & ge2 & ~ge1 & (freq != 0)
    else:
        raise ValueError(f"unknown op {op}")
    return uw[inc], freq[inc].astype(np.uint32)


def _host_apply_multi_op(w_cat, c_cat, s_cat, n_lists, op, rule, cutoff,
                         count_override):
    order = np.argsort(w_cat, kind="stable")
    sw = w_cat[order]
    sc = c_cat[order].astype(np.uint32)
    if len(sw) == 0:
        return np.empty(0, np.uint64), np.empty(0, np.uint32)
    head = np.concatenate([[True], sw[1:] != sw[:-1]])
    starts = np.flatnonzero(head)
    uw = sw[starts]
    f_add = np.add.reduceat(sc, starts)
    f_min = np.minimum.reduceat(sc, starts)
    f_max = np.maximum.reduceat(sc, starts)
    n_src = np.diff(np.concatenate([starts, [len(sw)]]))
    if op == "union":
        r = setops.RULE_ADD if rule == setops.RULE_DEFAULT else rule
    else:
        r = setops.RULE_MIN if rule == setops.RULE_DEFAULT else rule
    if r == setops.RULE_ADD:
        freq = f_add
    elif r == setops.RULE_MAX:
        freq = f_max
    elif r == setops.RULE_MIN:
        freq = f_min
    elif r == setops.RULE_NUMBER:
        freq = np.full_like(f_add, np.uint32(count_override))
    else:
        raise ValueError(f"rule {r} not valid for multi-list {op}")
    inc = freq >= np.uint32(cutoff)
    if op == "intrsec":
        inc &= n_src == n_lists
    return uw[inc], freq[inc].astype(np.uint32)


def compare_pair(list1: str, list2: str, ops: list[str], outputname: str = "out",
                 cutoff: int = 1, rule: str = "default", count_override: int = 1,
                 subtract: bool = False, count_only: bool = False,
                 bucket_target: int = DEFAULT_BUCKET):
    """Two-list compare producing any of union/intrsec/diff1/diff2.

    Returns {op: (n_words, total_count)}; writes files unless count_only.
    """
    h1, w1, c1 = read_word_source(list1)
    h2, w2, c2 = read_word_source(list2)
    wlen = h1.word_length
    # GT4_DIST_*: one host of a multi-process group — run the pair ops
    # SPMD over the global flat mesh; only process 0 writes files (a
    # distributed launch is an explicit placement choice, overriding
    # the local cost model, same as make_list)
    from genometester4_tpu.parallel.multihost import is_multiprocess
    multihost = is_multiprocess()
    is_writer = True
    if multihost:
        from genometester4_tpu.utils.lazyjax import ensure_jax
        is_writer = ensure_jax().process_index() == 0
    sinks = {op: _OpSink(op, _op_filename(outputname, wlen, op), wlen,
                         count_only or not is_writer) for op in ops}
    if multihost:
        from genometester4_tpu.parallel.multihost import (
            barrier, make_flat_global_mesh)
        from genometester4_tpu.parallel.sharding import sharded_pair_ops
        res = sharded_pair_ops(
            np.ascontiguousarray(w1, np.uint64),
            np.ascontiguousarray(c1, np.uint32),
            np.ascontiguousarray(w2, np.uint64),
            np.ascontiguousarray(c2, np.uint32),
            make_flat_global_mesh(), list(sinks), rule=RULES[rule],
            cutoff=cutoff, count_override=count_override,
            subtract=subtract)
        results = {}
        for op, sink in sinks.items():
            sink.append(*res[op])
            sink.close()
            results[op] = (sink.n_words, sink.total_count)
        barrier("gt4_compare_pair_multihost")
        return results

    if _setops_impl() == "host":
        import queue
        import threading

        from genometester4_tpu.formats.list_format import pack_records
        from genometester4_tpu.models.fastgt_native import get_lib
        from genometester4_tpu.utils.backend import disable_numpy_thp
        disable_numpy_thp()
        lib = get_lib()
        RINT = {setops.RULE_DEFAULT: 0, setops.RULE_ADD: 1,
                setops.RULE_SUBTRACT: 2, setops.RULE_MIN: 3,
                setops.RULE_MAX: 4, setops.RULE_FIRST: 5,
                setops.RULE_SECOND: 6, setops.RULE_NUMBER: 7}

        def rec_view(w, c):
            # .list mmaps expose 12-byte-strided record views: the raw
            # record buffer feeds C directly, no strided gather copy.
            # Other sources (indices) pack a temporary record stream.
            from genometester4_tpu.formats.list_format import \
                raw_record_view
            raw = raw_record_view(w)
            if raw is not None:
                return raw
            return pack_records(np.asarray(w, np.uint64),
                                np.asarray(c, np.uint32))

        r1 = rec_view(w1, c1)
        r2 = rec_view(w2, c2)

        n_threads = int(os.environ.get("OMP_NUM_THREADS",
                                       os.cpu_count() or 1))
        if n_threads > 1 and (h1.n_words + h2.n_words) > (1 << 20):
            # multi-core hosts: cut both inputs at identical word
            # boundaries (merge-path rank select) and run the zipper
            # OpenMP-parallel across buckets; bucket-order concatenation
            # is byte-identical to the sequential pass (the VERDICT's
            # order-preserving OpenMP discipline). Buffers are
            # output-sized per op — a RAM-for-cores trade the streaming
            # path below avoids on small machines.
            from genometester4_tpu.parallel.sharding import rank_bounds
            RINT = {setops.RULE_DEFAULT: 0, setops.RULE_ADD: 1,
                    setops.RULE_SUBTRACT: 2, setops.RULE_MIN: 3,
                    setops.RULE_MAX: 4, setops.RULE_FIRST: 5,
                    setops.RULE_SECOND: 6, setops.RULE_NUMBER: 7}
            nb = min(4 * n_threads, 64)
            bounds = rank_bounds([np.asarray(w1), np.asarray(w2)], nb)
            cuts1 = np.concatenate(
                [[0], np.searchsorted(w1, bounds),
                 [h1.n_words]]).astype(np.int64)
            cuts2 = np.concatenate(
                [[0], np.searchsorted(w2, bounds),
                 [h2.n_words]]).astype(np.int64)
            nb = len(cuts1) - 1
            cap = 12 * (h1.n_words + h2.n_words)
            bufs, ns, ss = {}, {}, {}
            for op in ("union", "intrsec", "diff1", "diff2"):
                if op in sinks:
                    bufs[op] = np.empty(max(cap, 12), np.uint8)
                    ns[op] = np.zeros(nb, np.int64)
                    ss[op] = np.zeros(nb, np.uint64)
                else:
                    bufs[op] = None
                    ns[op] = None
                    ss[op] = None
            lib.fgx_pair_ops_buckets(
                r1, r2, cuts1, cuts2, nb, RINT[RULES[rule]], cutoff,
                count_override, int(subtract),
                bufs["union"], ns["union"], ss["union"],
                bufs["intrsec"], ns["intrsec"], ss["intrsec"],
                bufs["diff1"], ns["diff1"], ss["diff1"],
                bufs["diff2"], ns["diff2"], ss["diff2"])
            offs = 12 * ((cuts1[:-1] - cuts1[0]) + (cuts2[:-1] - cuts2[0]))
            for op, sink in sinks.items():
                for b in range(nb):
                    m = int(ns[op][b])
                    if not m:
                        continue
                    o = int(offs[b])
                    if sink.writer:
                        sink.writer.append_records(
                            bufs[op][o: o + 12 * m], m, int(ss[op][b]))
                    sink.n_words += m
                    sink.total_count += int(ss[op][b])
                sink.close()
            return {op: (sink.n_words, sink.total_count)
                    for op, sink in sinks.items()}

        # Chunked resumable zipper (native fgx_pair_stream_*): output
        # records stream to the writers in CHUNK-record pieces through a
        # writer thread, so the file writes overlap the next chunk's
        # merge and no output-sized buffer is ever materialized
        # (the reference's one-pass-4-outputs structure,
        # src/glistcompare.c:843-905, with the write moved off-thread).
        CHUNK = 1 << 20
        ALL_OPS = ("union", "intrsec", "diff1", "diff2")
        active = [op in sinks for op in ALL_OPS]
        st = lib.fgx_pair_stream_start(
            r1, h1.n_words, r2, h2.n_words, RINT[RULES[rule]], cutoff,
            count_override, int(subtract), *[int(a) for a in active])
        if not st:
            raise MemoryError("pair stream allocation failed")
        dummy = np.empty(12, np.uint8)
        bufsets = []
        for _ in range(2):
            bufsets.append([np.empty(12 * CHUNK, np.uint8) if a else dummy
                            for a in active])
        n_out = np.zeros(4, np.int64)
        sums = np.zeros(4, np.uint64)
        q = queue.Queue()
        free = queue.Queue()
        for i in range(len(bufsets)):
            free.put(i)

        def pump():
            while True:
                item = q.get()
                if item is None:
                    return
                si, counts, csums = item
                for t, op in enumerate(ALL_OPS):
                    if active[t] and counts[t]:
                        sink = sinks[op]
                        m = int(counts[t])
                        if sink.writer:
                            sink.writer.append_records(
                                bufsets[si][t][: 12 * m], m, int(csums[t]))
                        sink.n_words += m
                        sink.total_count += int(csums[t])
                free.put(si)

        th = threading.Thread(target=pump, daemon=True)
        th.start()
        try:
            more = 1
            while more:
                si = free.get()
                bs = bufsets[si]
                more = lib.fgx_pair_stream_next(
                    st, bs[0], bs[1], bs[2], bs[3], CHUNK, n_out, sums)
                q.put((si, n_out.copy(), sums.copy()))
        finally:
            q.put(None)
            th.join()
            lib.fgx_pair_stream_free(st)
        for op, sink in sinks.items():
            sink.close()
        return {op: (sink.n_words, sink.total_count)
                for op, sink in sinks.items()}

    # device path, >1 visible device: the production route is the SPMD
    # mesh (parallel/sharding.py) — merge-path word-range buckets, one
    # aligned pair table per device feeding every requested op, output
    # concatenation globally sorted (same invariant as the mesh
    # glistmaker path). GT4_TPU_MESH=0 opts out.
    from genometester4_tpu.utils.lazyjax import ensure_jax
    if (len(ensure_jax().devices()) > 1
            and os.environ.get("GT4_TPU_MESH", "1") != "0"):
        from genometester4_tpu.parallel.sharding import (make_mesh,
                                                         sharded_pair_ops)
        res = sharded_pair_ops(
            np.ascontiguousarray(w1, np.uint64),
            np.ascontiguousarray(c1, np.uint32),
            np.ascontiguousarray(w2, np.uint64),
            np.ascontiguousarray(c2, np.uint32),
            make_mesh(), list(sinks), rule=RULES[rule], cutoff=cutoff,
            count_override=count_override, subtract=subtract)
        results = {}
        for op, sink in sinks.items():
            sink.append(*res[op])
            sink.close()
            results[op] = (sink.n_words, sink.total_count)
        return results

    n_buckets, bounds = _buckets(h1.n_words + h2.n_words, bucket_target)
    for b in range(n_buckets):
        a1, z1 = _bucket_slices(w1, bounds, b, n_buckets)
        a2, z2 = _bucket_slices(w2, bounds, b, n_buckets)
        m1, m2 = z1 - a1, z2 - a2
        if m1 + m2 == 0:
            continue
        cap = 1 << max(10, math.ceil(math.log2(max(m1, m2, 1))))
        hi1, lo1 = split_u64(_pad(w1[a1:z1], cap, np.uint64))
        hi2, lo2 = split_u64(_pad(w2[a2:z2], cap, np.uint64))
        v1 = np.arange(cap) < m1
        v2 = np.arange(cap) < m2
        aligned = setops.pair_align(
            jnp.asarray(hi1), jnp.asarray(lo1),
            jnp.asarray(_pad(c1[a1:z1], cap, np.uint32)), jnp.asarray(v1),
            jnp.asarray(hi2), jnp.asarray(lo2),
            jnp.asarray(_pad(c2[a2:z2], cap, np.uint32)), jnp.asarray(v2))
        for op, sink in sinks.items():
            n_out, ohi, olo, oc = setops.apply_pair_op(
                *aligned, op=op, rule=RULES[rule], cutoff=cutoff,
                count_override=count_override, subtract=subtract)
            m = int(n_out)
            if m:
                sink.append(join_u64(np.asarray(ohi[:m]), np.asarray(olo[:m])),
                            np.asarray(oc[:m], np.uint32))

    results = {}
    for op, sink in sinks.items():
        sink.close()
        results[op] = (sink.n_words, sink.total_count)
    return results


def compare_multi(paths: list[str], op: str, outputname: str = "out",
                  cutoff: int = 1, rule: str = "default",
                  count_override: int = 1, count_only: bool = False,
                  bucket_target: int = DEFAULT_BUCKET, debug: int = 0):
    """N-list union/intersection (N > 2)."""
    data = [read_word_source(p) for p in paths]
    wlen = data[0][0].word_length
    n_lists = len(data)
    # reference validates rules per op with its enum number in the
    # message and exit code 1 (src/glistcompare.c:518-523,617-623)
    _REF_RULE_NUM = {setops.RULE_DEFAULT: 0, setops.RULE_ADD: 1,
                     setops.RULE_SUBTRACT: 2, setops.RULE_MIN: 3,
                     setops.RULE_MAX: 4, setops.RULE_FIRST: 5,
                     setops.RULE_SECOND: 6, setops.RULE_NUMBER: 7}
    eff = RULES[rule] if rule in RULES else setops.RULE_NUMBER
    if op == "union" and eff not in (setops.RULE_DEFAULT, setops.RULE_ADD,
                                     setops.RULE_MAX, setops.RULE_NUMBER):
        sys.stderr.write(
            "union_multi: Invalid rule %d (only ADD, MAX and NUMBER "
            "allowed)\n" % _REF_RULE_NUM[eff])
        raise SystemExit(1)
    if op == "intrsec" and eff not in (setops.RULE_DEFAULT, setops.RULE_ADD,
                                       setops.RULE_MIN, setops.RULE_MAX,
                                       setops.RULE_NUMBER):
        sys.stderr.write(
            "intersect_multi: Invalid rule %d (only ADD, MIN, MAX and "
            "NUMBER allowed)\n" % _REF_RULE_NUM[eff])
        raise SystemExit(1)

    # multi-process group: SPMD N-list op over the global flat mesh,
    # process 0 writes (see compare_pair)
    from genometester4_tpu.parallel.multihost import is_multiprocess
    multihost = is_multiprocess()
    is_writer = True
    if multihost:
        from genometester4_tpu.utils.lazyjax import ensure_jax
        is_writer = ensure_jax().process_index() == 0
    sink = _OpSink(op, _op_filename(outputname, wlen, op), wlen,
                   count_only or not is_writer, debug=debug)
    if multihost:
        from genometester4_tpu.parallel.multihost import (
            barrier, make_flat_global_mesh)
        from genometester4_tpu.parallel.sharding import sharded_multi_op
        w, c = sharded_multi_op(
            [np.ascontiguousarray(d[1], np.uint64) for d in data],
            [np.ascontiguousarray(d[2], np.uint32) for d in data],
            make_flat_global_mesh(), op,
            rule=RULES.get(rule, setops.RULE_NUMBER), cutoff=cutoff,
            count_override=count_override)
        sink.append(w, c)
        sink.close()
        barrier("gt4_compare_multi_multihost")
        return {op: (sink.n_words, sink.total_count)}

    if _setops_impl() == "host":
        # streaming k-way merge over the raw record streams (native
        # fgx_multi_stream_*): no concatenation, no argsort — one pass,
        # chunked output (the former argsort formulation cost ~14x the
        # reference at 3x20M records)
        import ctypes

        from genometester4_tpu.formats.list_format import (pack_records,
                                                           raw_record_view)
        from genometester4_tpu.models.fastgt_native import get_lib
        from genometester4_tpu.utils.backend import disable_numpy_thp
        disable_numpy_thp()
        lib = get_lib()
        eff2 = RULES.get(rule, setops.RULE_NUMBER)
        if eff2 == setops.RULE_DEFAULT:
            eff2 = setops.RULE_ADD if op == "union" else setops.RULE_MIN
        RINT = {setops.RULE_ADD: 1, setops.RULE_MIN: 3,
                setops.RULE_MAX: 4, setops.RULE_NUMBER: 7}
        bufs_keepalive = []
        ptrs = (ctypes.c_void_p * n_lists)()
        lens = (ctypes.c_long * n_lists)()
        for i, (h, w, c) in enumerate(data):
            raw = raw_record_view(w)
            if raw is None:
                raw = pack_records(np.asarray(w, np.uint64),
                                   np.asarray(c, np.uint32))
            bufs_keepalive.append(raw)
            ptrs[i] = raw.ctypes.data
            lens[i] = len(w)
        st = lib.fgx_multi_stream_start(ptrs, lens, n_lists,
                                        int(op == "intrsec"), RINT[eff2],
                                        cutoff, count_override)
        if not st:
            raise MemoryError("multi stream allocation failed")
        # double-buffered writer thread: the file write overlaps the
        # next chunk's merge (same pattern as the pair path)
        import queue
        import threading
        CHUNK = 1 << 20
        bufs2 = [np.empty(12 * CHUNK, np.uint8) for _ in range(2)]
        n_out = ctypes.c_long(0)
        s_out = ctypes.c_ulonglong(0)
        q = queue.Queue()
        free_q = queue.Queue()
        for i in range(len(bufs2)):
            free_q.put(i)

        def pump():
            while True:
                item = q.get()
                if item is None:
                    return
                bi, m, t = item
                if sink.writer:
                    sink.writer.append_records(bufs2[bi][: 12 * m], m, t)
                prev = sink.n_words
                sink.n_words += m
                sink.total_count += t
                if debug:
                    _emit_progress_ticks(prev, sink.n_words)
                free_q.put(bi)

        th = threading.Thread(target=pump, daemon=True)
        th.start()
        try:
            more = 1
            while more:
                bi = free_q.get()
                more = lib.fgx_multi_stream_next(
                    st, bufs2[bi], CHUNK, ctypes.byref(n_out),
                    ctypes.byref(s_out))
                m = n_out.value
                if m:
                    q.put((bi, m, int(s_out.value)))
                else:
                    free_q.put(bi)
        finally:
            q.put(None)
            th.join()
            lib.fgx_multi_stream_free(st)
        sink.close()
        return {op: (sink.n_words, sink.total_count)}

    # device path, >1 visible device: SPMD mesh (see compare_pair)
    from genometester4_tpu.utils.lazyjax import ensure_jax
    if (len(ensure_jax().devices()) > 1
            and os.environ.get("GT4_TPU_MESH", "1") != "0"):
        from genometester4_tpu.parallel.sharding import (make_mesh,
                                                         sharded_multi_op)
        w, c = sharded_multi_op(
            [np.ascontiguousarray(w, np.uint64) for _, w, _ in data],
            [np.ascontiguousarray(c, np.uint32) for _, _, c in data],
            make_mesh(), op, rule=RULES.get(rule, setops.RULE_NUMBER),
            cutoff=cutoff, count_override=count_override)
        sink.append(w, c)
        sink.close()
        return {op: (sink.n_words, sink.total_count)}

    total = sum(h.n_words for h, _, _ in data)
    n_buckets, bounds = _buckets(total, bucket_target)
    for b in range(n_buckets):
        parts = []
        for si, (h, w, c) in enumerate(data):
            a, z = _bucket_slices(w, bounds, b, n_buckets)
            if z > a:
                parts.append((w[a:z], c[a:z], si))
        if not parts:
            # intersection of nothing in this range — nothing to write
            continue
        m_total = sum(len(p[0]) for p in parts)
        cap = 1 << max(10, math.ceil(math.log2(m_total)))
        w_cat = _pad(np.concatenate([p[0] for p in parts]), cap, np.uint64)
        c_cat = _pad(np.concatenate([p[1] for p in parts]), cap, np.uint32)
        s_cat = _pad(np.concatenate(
            [np.full(len(p[0]), p[2], np.uint32) for p in parts]), cap, np.uint32)
        valid = np.arange(cap) < m_total
        hi, lo = split_u64(w_cat)
        n_out, ohi, olo, oc = setops.apply_multi_op(
            jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(c_cat),
            jnp.asarray(s_cat), jnp.asarray(valid), n_lists=n_lists, op=op,
            rule=RULES.get(rule, setops.RULE_NUMBER), cutoff=cutoff,
            count_override=count_override)
        m = int(n_out)
        if m:
            sink.append(join_u64(np.asarray(ohi[:m]), np.asarray(olo[:m])),
                        np.asarray(oc[:m], np.uint32))
    sink.close()
    return {op: (sink.n_words, sink.total_count)}


def compare_pair_mm(list1: str, list2: str, ops: list[str],
                    outputname: str = "out", cutoff: int = 1, nmm: int = 1,
                    subtract: bool = False, count_only: bool = False,
                    chunk: int = 4096, debug: int = 0):
    """Mismatch-tolerant difference (src/glistcompare.c:957-1169).

    diff1 keeps words of list1 (passing the exact-match difference test)
    whose exactly-m neighborhoods, for every m in 1..nmm, stay below the
    cutoff in list2. Quirks replicated:
    * the candidate zipper computes cutoff flags from ORIGINAL freqs but
      the stored freq uses the subtract-modified freq2
      (src/glistcompare.c:1030-1047) including u32 wraparound;
    * subtract mode drops a candidate outright when any neighbor's count
      in list2 exceeds its count in list1 (search_query returns ~0,
      src/glistcompare.c:1140-1146);
    * ddiff never uses subtraction in its neighborhood pass (reference
      would dereference NULL; see fetch_relevant_words call :1105).
    """
    from genometester4_tpu.ops.mismatch import (exact_mismatch_masks,
                                                lookup_counts)
    from genometester4_tpu.ops.encode import canonical_u64

    h1, w1, c1 = read_word_source(list1)
    h2, w2, c2 = read_word_source(list2)
    k = h1.word_length
    w1 = np.asarray(w1)
    w2 = np.asarray(w2)

    if debug:
        # compare_wordmaps_mm's own header (src/glistcompare.c:1005-1008)
        sys.stderr.write("Table 1: %d entries\n" % len(w1))
        sys.stderr.write("Table 2: %d entries\n" % len(w2))

    all_w = np.union1d(w1, w2)
    f1 = lookup_counts(w1, np.asarray(c1), all_w).astype(np.uint32)
    f2 = lookup_counts(w2, np.asarray(c2), all_w).astype(np.uint32)
    p1, p2 = f1 > 0, f2 > 0
    ge1, ge2 = f1 >= np.uint32(cutoff), f2 >= np.uint32(cutoff)
    # subtract modifies freq2 in the equal-words branch before both checks
    f2e = np.where(p1 & p2 & subtract & (f1 <= f2), f2 - f1, f2)

    candidates = {}
    if "diff1" in ops:
        eq = p1 & p2 & ge1 & ~ge2
        only1 = p1 & ~p2 & ge1 & (not subtract)
        freqs = np.where(eq, f1 - f2e, f1).astype(np.uint32)  # u32 wrap ok
        mask = eq | only1
        candidates["diff1"] = (all_w[mask], freqs[mask], w2, c2, w1, c1,
                               subtract)
    if "diff2" in ops:
        eq = p1 & p2 & ge2 & ~ge1
        only2 = p2 & ~p1 & ge2
        freqs = np.where(eq, f2e - f1, f2).astype(np.uint32)
        mask = eq | only2
        candidates["diff2"] = (all_w[mask], freqs[mask], w1, c1, None, None,
                               False)

    def _present(words_sorted, queries):
        idx = np.searchsorted(words_sorted, queries)
        idx_c = np.minimum(idx, max(len(words_sorted) - 1, 0))
        if len(words_sorted) == 0:
            return np.zeros(len(queries), bool)
        return (idx < len(words_sorted)) & (words_sorted[idx_c] == queries)

    use_native = os.environ.get("GT4_MM_IMPL", "native") != "numpy"
    results = {}
    for op, (cw, cf, mw, mc, qw, qc, sub) in candidates.items():
        if debug and op == "diff1":
            # only find_diff announces itself (src/glistcompare.c:1058-1061)
            sys.stderr.write("Finding diff with mismatches (%d entries)\n"
                             % len(cw))
        if use_native:
            # per-candidate early exit (the running present-count is
            # monotone in non-subtract mode, and subtract mode bails on
            # the first over-present neighbor) — numpy must always
            # materialize the whole neighborhood (fgx_mm_filter;
            # GT4_MM_IMPL=numpy keeps the vectorized twin for the
            # differential tests)
            from genometester4_tpu.models.fastgt_native import get_lib
            lib = get_lib()
            alive8 = np.ones(len(cw), np.uint8)
            cwc = np.ascontiguousarray(cw, np.uint64)
            mwc = np.ascontiguousarray(mw, np.uint64)
            qwc = (np.ascontiguousarray(qw, np.uint64) if sub
                   else np.zeros(1, np.uint64))
            for m in range(1, nmm + 1):
                masks = np.ascontiguousarray(exact_mismatch_masks(k, m))
                lib.fgx_mm_filter(cwc, len(cwc), k, masks, len(masks),
                                  mwc, len(mwc), qwc,
                                  len(qwc) if sub else 0,
                                  cutoff, int(sub), alive8)
            alive = alive8.astype(bool)
            out_w, out_c = cw[alive], cf[alive]
            path = _op_filename(outputname, k, op, nmm)
            if not count_only:
                from genometester4_tpu.formats.list_format import write_list
                write_list(path, k, out_w, out_c)
            results[op] = (len(out_w), int(out_c.astype(np.uint64).sum()))
            continue
        alive = np.ones(len(cw), bool)
        for m in range(1, nmm + 1):
            masks = exact_mismatch_masks(k, m)
            idx_alive = np.flatnonzero(alive)
            for s in range(0, len(idx_alive), chunk):
                sel = idx_alive[s:s + chunk]
                neigh = canonical_u64(
                    cw[sel, None] ^ masks[None, :], k).reshape(-1)
                # gt4_word_dict_lookup returns the FOUND FLAG, not the
                # count (the count goes into inst->value, which
                # search_query never reads — src/word-dict.c:61-71,
                # src/glistcompare.c:1114-1127): the neighborhood sum is
                # the number of PRESENT neighbor words (fuzz finding)
                cur = _present(mw, neigh).astype(np.int64)
                if sub:
                    qf = _present(qw, neigh).astype(np.int64)
                    bad = (cur > qf).reshape(len(sel), -1).any(axis=1)
                    s_sum = ((cur - qf).reshape(len(sel), -1).sum(axis=1)
                             & 0xFFFFFFFF)
                    drop = bad | (s_sum >= cutoff)
                else:
                    s_sum = cur.reshape(len(sel), -1).sum(axis=1) & 0xFFFFFFFF
                    drop = s_sum >= cutoff
                alive[sel[drop]] = False
        out_w, out_c = cw[alive], cf[alive]
        path = _op_filename(outputname, k, op, nmm)
        if not count_only:
            from genometester4_tpu.formats.list_format import write_list
            write_list(path, k, out_w, out_c)
        results[op] = (len(out_w), int(out_c.astype(np.uint64).sum()))
    return results


def make_subset(list_path: str, method: str, size: int, outputname: str,
                seed: int):
    """Random subsetting (-ss): exact drand48 stream parity with the
    reference (src/glistcompare.c:719-787)."""
    h, words, counts = read_word_source(list_path)
    out_path = f"{outputname}_subset_{h.word_length}.list"
    METHODS = {"rand": 0, "rand_unique": 1, "rand_weighted_unique": 2}
    if method in METHODS:
        # native selection loop: glibc srand48/drand48 IS the
        # reference's PRNG, so the stream is bit-exact by construction
        # (src/glistcompare.c:719-787); the Python Rand48 twin below
        # remains the differential oracle for the stream itself.
        import ctypes

        from genometester4_tpu.formats.list_format import (ListWriter,
                                                           pack_records,
                                                           raw_record_view)
        from genometester4_tpu.models.fastgt_native import get_lib
        from genometester4_tpu.utils.backend import disable_numpy_thp
        disable_numpy_thp()   # multi-MB buffers below (CLAUDE.md)
        if method != "rand" and size > h.n_words:
            raise ValueError("subset size bigger than number of unique kmers")
        lib = get_lib()
        raw = raw_record_view(words)
        if raw is None:
            raw = pack_records(np.asarray(words, np.uint64),
                               np.asarray(counts, np.uint32))
            raw = np.ascontiguousarray(raw.view(np.uint8).reshape(-1))
        out_buf = np.empty(max(12, 12 * h.n_words), np.uint8)
        tot = ctypes.c_ulonglong(0)
        # in = the header's total (inst->sum_counts IS header->total for
        # a list source, src/glistcompare.c:735) — no counts-column scan
        m = lib.fgx_subset(raw, h.n_words, int(h.total_count),
                           METHODS[method], size, seed, out_buf,
                           ctypes.byref(tot))
        with ListWriter(out_path, h.word_length) as w:
            w.append_records(out_buf[: 12 * m], m, tot.value)
        return out_path
    rng = Rand48(seed)
    sel_words, sel_counts = [], []
    out = size
    if method == "rand":
        # one draw per count unit until `out` exhausted. Drawing a whole
        # word's values at once over-advances the PRNG only after `out`
        # hits 0, when the reference stops drawing too — harmless.
        inn = int(counts.sum(dtype=np.uint64))
        for wi in range(len(words)):
            if out <= 0:
                break
            c = int(counts[wi])
            vals = rng.drand_array(c)
            acc = 0
            for v in vals:
                if out <= 0:
                    break
                if v <= out / inn:
                    acc += 1
                    out -= 1
                inn -= 1
            if acc > 0:
                sel_words.append(int(words[wi]))
                sel_counts.append(acc)
    elif method == "rand_unique":
        if size > h.n_words:
            raise ValueError("subset size bigger than number of unique kmers")
        inn = h.n_words
        for wi in range(len(words)):
            if out <= 0:
                break
            if rng.drand() <= out / inn:
                sel_words.append(int(words[wi]))
                sel_counts.append(int(counts[wi]))
                out -= 1
            inn -= 1
    elif method == "rand_weighted_unique":
        if size > h.n_words:
            raise ValueError("subset size bigger than number of unique kmers")
        inn = int(counts.sum(dtype=np.uint64))
        for wi in range(len(words)):
            if out <= 0:
                break
            c = int(counts[wi])
            if rng.drand() <= c * out / inn:
                sel_words.append(int(words[wi]))
                sel_counts.append(c)
                out -= 1
            inn -= c
    else:
        raise ValueError(f"unknown subset method {method}")

    from genometester4_tpu.formats.list_format import write_list
    write_list(out_path, h.word_length, np.array(sel_words, np.uint64),
               np.array(sel_counts, np.uint32))
    return out_path
