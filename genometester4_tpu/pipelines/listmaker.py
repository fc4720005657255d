"""glistmaker equivalent: FASTA/FASTQ → sorted .list.

Reference pipeline (src/glistmaker.c:139-353, SURVEY.md §3.1): split files
into blocks → per-thread tables → radix sort → k-way merge of tmp lists.

Device pipeline:
  host parse (vectorized)          genometester4_tpu.io.fasta
  → fixed-size padded code chunks  (static shapes; one XLA compile)
  → device extract+canonicalize    ops.kmers.extract_kmers
  → device sort + segment count    ops.sortcount.count_unique
  → per-chunk sorted uniques back to host (u64)
  → prefix-partitioned device merges, streamed to the .list writer

The prefix partition step plays the role of the reference's tmp-file
k-way merge (src/set-operations.c:40-129): per-chunk results are already
sorted, so splitting every shard at the same word boundaries lets each
bucket merge independently and the concatenation of bucket outputs is
globally sorted — the same trick that makes multi-chip sharding produce
byte-identical lists (SURVEY.md §7).
"""

from __future__ import annotations

import math
import os
import sys
from dataclasses import dataclass

import numpy as np

from genometester4_tpu.utils.lazyjax import jax, jnp

from genometester4_tpu.formats.list_format import ListWriter, ListHeader
from genometester4_tpu.io.fasta import load_file
from genometester4_tpu.ops.encode import join_u64, split_u64
from genometester4_tpu.ops.kmers import extract_kmers
from genometester4_tpu.ops.sortcount import count_unique

# Default chunk: 2^25 bases (~33.5M windows) per device sort. Not yet
# tuned for H100 (ROADMAP 2.4).
DEFAULT_CHUNK_BASES = 1 << 25
# Target size of one merge bucket on device.
DEFAULT_MERGE_BUCKET = 1 << 25


def _make_chunk_fn(k: int, canonical: bool = True):
    """Fused extract→count for one padded chunk."""
    hi_bits = max(0, 2 * k - 32)

    @jax.jit
    def run(codes):
        hi, lo, valid = extract_kmers(codes, k, canonical=canonical)
        ones = jnp.ones(hi.shape, jnp.uint32)
        return count_unique(hi, lo, ones, valid, hi_bits=hi_bits,
                            unit_weights=True, compact=False)

    return run


def pad_pow2_chunk(chunk: np.ndarray, cap_limit: int) -> np.ndarray:
    """Pad a chunk with invalid bytes up to the next power of two.

    Keeps compiled-shape count at ~log2(cap_limit) instead of padding
    tiny inputs to the full chunk size (a 10 KB FASTA must not compile
    and sort a 16 Mi-element buffer).
    """
    cap = 1 << max(10, math.ceil(math.log2(max(len(chunk), 2))))
    cap = min(cap, cap_limit)
    if len(chunk) < cap:
        chunk = np.concatenate(
            [chunk, np.full(cap - len(chunk), 255, np.uint8)])
    return chunk


def count_chunks(codes: np.ndarray, k: int, chunk_bases: int = DEFAULT_CHUNK_BASES,
                 canonical: bool = True):
    """Yield per-chunk sorted unique (words u64, counts u32) numpy arrays.

    ``codes`` is the packed uint8 code array from the parser. Chunks
    overlap by k-1 bases so no window is lost at a seam; the final chunk
    is padded with 255 (invalid) bytes to the next power of two,
    preserving a small set of static shapes.
    """
    run = _make_chunk_fn(k, canonical)
    n = len(codes)
    step = chunk_bases - (k - 1)
    if n <= k - 1:
        return
    for start in range(0, max(n - (k - 1), 1), step):
        chunk = pad_pow2_chunk(codes[start:start + chunk_bases], chunk_bases)
        shi, slo, hmask, tmask, _, n_uniq = run(jnp.asarray(chunk))
        if int(n_uniq) == 0:
            continue
        # compact=False marked stream: words at run heads, counts from
        # consecutive tail positions (runs tile the valid prefix)
        hmask = np.asarray(hmask)
        tails = np.flatnonzero(np.asarray(tmask))
        counts = np.diff(tails + 1, prepend=0).astype(np.uint32)
        yield (join_u64(np.asarray(shi)[hmask], np.asarray(slo)[hmask]),
               counts)


def _pad_pow2(x: np.ndarray, size: int, fill=0):
    out = np.full(size, fill, dtype=x.dtype)
    out[: len(x)] = x
    return out


@dataclass
class _MergeKernelCache:
    fns: dict = None

    def get(self, capacity: int, hi_bits: int = 32):
        if self.fns is None:
            self.fns = {}
        key = (capacity, hi_bits)
        if key not in self.fns:
            @jax.jit
            def merge(hi, lo, counts, valid):
                return count_unique(hi, lo, counts, valid, hi_bits=hi_bits,
                                    compact=False)
            self.fns[key] = merge
        return self.fns[key]


_merge_cache = _MergeKernelCache()


def merge_sorted_shards(shards, target_bucket: int = DEFAULT_MERGE_BUCKET,
                        word_length: int | None = None):
    """Merge sorted (words, counts) shards into one global sorted stream.

    Splits the u64 key space into equal prefix buckets sized so each
    bucket's total input fits on device, merges each bucket with the
    sort+segment-sum kernel, and yields sorted (words, counts) buckets in
    ascending order. Yielded buckets concatenate into the global sorted
    unique list.
    """
    shards = [s for s in shards if len(s[0])]
    if not shards:
        return
    total = sum(len(w) for w, _ in shards)
    n_buckets = 1 << max(0, math.ceil(math.log2(max(1, total / target_bucket))))
    # bucket b owns words in [b, b+1) * 2^64 / n_buckets
    if n_buckets > 1:
        bounds = (np.arange(1, n_buckets, dtype=np.uint64)
                  * np.uint64(2 ** 64 // n_buckets))
    else:
        bounds = np.empty(0, dtype=np.uint64)
    # partition every shard at identical word boundaries
    splits = [np.searchsorted(w, bounds) for w, _ in shards]
    for b in range(n_buckets):
        parts_w, parts_c = [], []
        for (w, c), sp in zip(shards, splits):
            a = 0 if b == 0 else sp[b - 1]
            z = len(w) if b == n_buckets - 1 else sp[b]
            if z > a:
                parts_w.append(w[a:z])
                parts_c.append(c[a:z])
        if not parts_w:
            continue
        cat_w = np.concatenate(parts_w)
        cat_c = np.concatenate(parts_c)
        if len(parts_w) == 1:
            # single source: already sorted and unique
            yield cat_w, cat_c
            continue
        cap = 1 << max(10, math.ceil(math.log2(len(cat_w))))
        hi, lo = split_u64(_pad_pow2(cat_w, cap))
        counts = _pad_pow2(cat_c, cap)
        valid = np.zeros(cap, bool)
        valid[: len(cat_w)] = True
        hb = 32 if word_length is None else max(0, 2 * word_length - 32)
        merge = _merge_cache.get(cap, hb)
        shi, slo, hmask, tmask, incl, n_uniq = merge(
            jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(counts),
            jnp.asarray(valid))
        hmask = np.asarray(hmask)
        tails = np.flatnonzero(np.asarray(tmask))
        tp = np.asarray(incl)[tails]
        ucounts = np.diff(tp, prepend=np.uint32(0)).astype(np.uint32)
        yield (join_u64(np.asarray(shi)[hmask], np.asarray(slo)[hmask]),
               ucounts)


def _make_index_chunk_fn(k: int):
    """Extract (canonical word, window position, direction) for every
    valid window, compacted to the front (scatter-free)."""
    from genometester4_tpu.ops.encode import canonical_pair
    from genometester4_tpu.ops.sortcount import sort_compact

    @jax.jit
    def run(codes):
        fhi, flo, valid = extract_kmers(codes, k, canonical=False)
        chi, clo = canonical_pair(fhi, flo, k)
        is_rc = ~((chi == fhi) & (clo == flo))
        n = chi.shape[0]
        pos = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).reshape(n)
        return sort_compact(valid, chi, clo, pos, is_rc.astype(jnp.uint8))

    return run


def make_index(input_files, word_length: int, output_path: str,
               min_count: int = 1, max_count: int = 0xFFFFFFFF,
               chunk_bases: int = DEFAULT_CHUNK_BASES,
               slab_bytes: int = 1 << 28):
    """glistmaker --index: FASTA/FASTQ -> .index location file
    (reference writer: src/glistmaker.c:366-782).

    Location semantics (src/glistmaker.c:1052-1068): pos counts printable
    sequence characters (seq_npos), subseq is the record index within the
    file, dir means the canonical word is the reverse complement.

    Ingestion is O(slab): raw bytes never reside whole-file
    (iter_slabs_indexed streams codes with per-slab record/position
    segment maps — the role of the reference's 100 MB block registry,
    src/sequence-block.c:148-206). The location table itself is O(total
    windows), as in the reference.
    """
    from genometester4_tpu.formats.index_format import (IndexFile,
                                                        get_bitsize,
                                                        write_index_file)
    from genometester4_tpu.io.fasta import iter_slabs_indexed

    k = word_length
    impl = _count_impl()
    if impl == "host":
        # host-native extraction (one rolling C pass per slab, no
        # chunk seams) — the same placement rule as make_list: on the
        # CPU backend the XLA chunk path loses to the native pass
        from genometester4_tpu.models.fastgt_native import get_lib
        from genometester4_tpu.utils.backend import disable_numpy_thp
        disable_numpy_thp()
        _lib = get_lib()
        run = None
    else:
        _lib = None
        run = _make_index_chunk_fn(k)
    files_meta = []
    per_file = []  # (words, rec, lpos, dirs)
    max_lpos = 0
    max_subseq = 0
    for file_idx, path in enumerate(input_files):
        span_parts = []
        len_parts = []       # FASTQ per-record char lengths
        is_fastq = False
        w_l, r_l, p_l, d_l = [], [], [], []
        stream_size = 0
        n_rec = 0
        for codes, meta in iter_slabs_indexed(path, k, slab_bytes):
            if codes is None:
                stream_size = meta.stream_size
                n_rec = meta.n_records
                break
            span_parts.append(meta.name_spans)
            if meta.rec_lengths is not None:
                is_fastq = True
                len_parts.append(meta.rec_lengths)
            n = len(codes)
            if n < k:
                continue
            if _lib is not None:
                cap = max(n - k + 1, 1)
                wbuf = np.empty(cap, np.uint64)
                pbuf = np.empty(cap, np.int64)
                dbuf = np.empty(cap, np.uint8)
                m = _lib.fgx_extract_canonical_posdir(
                    np.ascontiguousarray(codes, np.uint8), n, k,
                    wbuf, pbuf, dbuf)
                if not m:
                    continue
                # buffers are per-slab allocations: slice views suffice
                # (the later concatenate is the one copy)
                w_l.append(wbuf[:m])
                spos = pbuf[:m]
                seg = np.searchsorted(meta.seg_starts, spos,
                                      side="right") - 1
                r_l.append(meta.seg_rec[seg])
                p_l.append(spos - meta.seg_starts[seg]
                           + meta.seg_lpos0[seg])
                d_l.append(dbuf[:m])
                continue
            step = chunk_bases - (k - 1)
            for start in range(0, max(n - (k - 1), 1), step):
                chunk = pad_pow2_chunk(codes[start:start + chunk_bases],
                                       chunk_bases)
                n_v, hi, lo, pos, dirs = run(jnp.asarray(chunk))
                m = int(n_v)
                if not m:
                    continue
                w_l.append(join_u64(np.asarray(hi[:m]), np.asarray(lo[:m])))
                spos = np.asarray(pos[:m]).astype(np.int64) + start
                seg = np.searchsorted(meta.seg_starts, spos,
                                      side="right") - 1
                r_l.append(meta.seg_rec[seg])
                p_l.append(spos - meta.seg_starts[seg]
                           + meta.seg_lpos0[seg])
                d_l.append(np.asarray(dirs[:m]))

        # byte-level subsequence registry (src/glistmaker.c:1030-1050):
        # name_pos/name_len from the record header, seq span in BYTES up
        # to the next record start (FASTA) or the sequence line (FASTQ)
        ns = (np.concatenate(span_parts) if span_parts
              else np.zeros((0, 2), np.int64))
        subseqs = np.zeros((n_rec, 4), np.int64)
        subseqs[:, 0] = ns[:, 0]
        subseqs[:, 1] = ns[:, 1] - ns[:, 0]
        seq_pos = ns[:, 1] + 1
        subseqs[:, 2] = seq_pos
        if not is_fastq:
            nxt = np.concatenate([ns[1:, 0] - 1, [stream_size]])
            subseqs[:, 3] = nxt - seq_pos
        else:
            subseqs[:, 3] = (np.concatenate(len_parts) if len_parts
                             else np.zeros(0, np.int64))
        # registry file size is the ON-DISK size (the reference stats
        # the file, so a .gz records its compressed size) while all
        # subseq offsets/spans are decompressed-stream coordinates
        disk_size = (os.path.getsize(path) if path != "-"
                     else stream_size)
        files_meta.append(IndexFile(path.encode(), disk_size, subseqs))
        if n_rec:
            max_subseq = max(max_subseq, n_rec - 1)
        if not w_l:
            per_file.append(None)
            continue
        words = np.concatenate(w_l)
        rec = np.concatenate(r_l)
        lpos = np.concatenate(p_l)
        dirs = np.concatenate(d_l)
        if len(lpos):
            max_lpos = max(max_lpos, int(lpos.max()))
        per_file.append((words, rec, lpos, dirs))

    if not any(pf is not None and len(pf[0]) for pf in per_file):
        # zero words anywhere: the reference writes a header-only index
        # (write_index_header, src/glistmaker.c:343-346,577-630)
        import struct
        tmp = f"{output_path}.tmp"
        with open(tmp, "wb") as f:
            f.write(b"I4TG")
            f.write(struct.pack("<II", 4, 2))
            f.write(struct.pack("<I", k))
            f.write(struct.pack("<QQ", 0, 0))
            f.write(struct.pack("<IIII", 1, 1, 1, 0))
            f.write(struct.pack("<QQQ", 72, 72, 72))
        os.replace(tmp, output_path)
        return

    n_file_bits = get_bitsize(len(input_files) - 1)
    n_subseq_bits = get_bitsize(max_subseq)
    n_pos_bits = get_bitsize(max_lpos)

    words_parts, code_parts = [], []
    for file_idx, pf in enumerate(per_file):
        if pf is None:
            continue
        words, rec, lpos, dirs = pf
        code = ((np.uint64(file_idx)
                 << np.uint64(n_subseq_bits + n_pos_bits + 1))
                | (rec.astype(np.uint64) << np.uint64(n_pos_bits + 1))
                | (lpos.astype(np.uint64) << np.uint64(1))
                | dirs.astype(np.uint64))
        words_parts.append(words)
        code_parts.append(code)
    if words_parts:
        aw = np.ascontiguousarray(np.concatenate(words_parts))
        ac = np.ascontiguousarray(np.concatenate(code_parts))
        # lexicographic (word, code) needs only ONE stable sort by
        # word: location codes pack (file, record, position, dir) in
        # stream-enumeration order, so they are strictly ascending in
        # the concatenated input already — a stable LSD pair sort by
        # word keeps them ascending within each word run (the former
        # two-sort formulation paid a second full pass set; both are
        # ~6x numpy.lexsort at 10M windows)
        from genometester4_tpu.models.fastgt_native import get_lib
        if get_lib().fgx_sort_pair_u64(aw, ac, len(aw), 2 * k):
            raise MemoryError("pair sort scratch allocation failed")
        # one C pass over the runs emits the interleaved k-mer block
        # directly (cutoff-bug semantics preserved: offsets accumulate
        # over kept words only, every location written — format doc)
        import ctypes

        from genometester4_tpu.models.fastgt_native import get_lib
        recs = np.empty(2 * len(aw), np.uint64)
        nloc = ctypes.c_ulonglong(0)
        m = get_lib().fgx_index_kmer_records(
            aw, len(aw), min_count, max_count, recs, ctypes.byref(nloc))
        kmer_recs = recs[: 2 * m]
        num_locations = int(nloc.value)
        locations = ac
    else:
        kmer_recs = np.empty(0, np.uint64)
        num_locations = 0
        locations = np.empty(0, np.uint64)

    write_index_file(output_path, k, files_meta, None, None,
                     num_locations, locations, n_file_bits, n_subseq_bits,
                     n_pos_bits, kmer_recs=kmer_recs)


def _count_impl() -> str:
    """Compute placement for the counting pipeline: host-native on the
    CPU backend, device otherwise (utils.backend.prefer_host).
    ``GT4_TPU_COUNT_IMPL=host|device`` pins either twin."""
    impl = os.environ.get("GT4_TPU_COUNT_IMPL", "auto")
    if impl != "auto":
        return impl
    from genometester4_tpu.utils.backend import prefer_host
    return "host" if prefer_host() else "device"


def _make_list_host(input_files, word_length: int, output_path: str,
                    min_count: int, max_count: int, canonical: bool,
                    debug: int, spill_bytes: int,
                    slab_bytes: int) -> ListHeader:
    """Host-native glistmaker: slab streaming → C rolling extraction →
    one LSD radix sort → run-length record emit (native/listkernel.c).

    Replaces the reference's per-thread-table + k-way-merge architecture
    (src/glistmaker.c:894-968, 1081-1154) with extract-all + sort-once;
    beyond spill_bytes of extracted words, sorted record shards spill to
    tmp .list files and a streaming k-way record merge produces the
    final list (cutoffs applied only at the last stage, matching the
    reference's final-merge cutoff semantics src/word-table.c:300-358).
    """
    import ctypes
    import sys
    import tempfile
    import time

    from genometester4_tpu.io.fasta import iter_code_slabs
    from genometester4_tpu.models.fastgt_native import get_lib
    from genometester4_tpu.utils.backend import disable_numpy_thp

    disable_numpy_thp()
    lib = get_lib()
    k = word_length
    extract = (lib.fgx_extract_canonical if canonical
               else lib.fgx_extract_forward)
    tmpdir = os.environ.get("GT4_TPU_TMPDIR") or None

    word_parts = []
    acc_words = 0
    tmp_files = []
    t_parse = t_count = 0.0
    n_words_in = 0
    EMIT_CHUNK = 1 << 20   # records per emitted chunk (12 MB buffer)

    def take_words():
        nonlocal word_parts, acc_words
        if len(word_parts) == 1:
            words = word_parts[0]
        else:
            words = (np.concatenate(word_parts) if word_parts
                     else np.empty(0, np.uint64))
        word_parts = []
        acc_words = 0
        return np.ascontiguousarray(words, np.uint64)

    def stream_emit(writer, words, min_c, max_c):
        """MSD-bucketed sort with chunked run emission: sorted records
        stream straight into the writer, never materializing the full
        record array (native fgx_sce_*). A writer thread overlaps the
        file write with the next chunk's bucket sorts (ctypes releases
        the GIL inside fgx_sce_next, write(2) releases it too)."""
        import queue
        import threading

        h = lib.fgx_sce_start(words, len(words), 2 * k)
        if not h:
            raise MemoryError("native sort allocation failed")
        bufs = [np.empty(12 * EMIT_CHUNK, np.uint8) for _ in range(2)]
        tot = ctypes.c_ulonglong(0)
        q = queue.Queue()
        free = queue.Queue()
        for i in range(len(bufs)):
            free.put(i)

        def pump():
            while True:
                item = q.get()
                if item is None:
                    return
                bi, m, t = item
                writer.append_records(bufs[bi][: 12 * m], m, t)
                free.put(bi)

        th = threading.Thread(target=pump, daemon=True)
        th.start()
        try:
            while True:
                bi = free.get()      # blocks until a buffer is writable
                m = lib.fgx_sce_next(h, min_c, max_c, bufs[bi], EMIT_CHUNK,
                                     ctypes.byref(tot))
                if m <= 0:
                    break
                q.put((bi, m, tot.value))
        finally:
            q.put(None)
            th.join()
            lib.fgx_sce_free(h)

    def spill():
        nonlocal t_count
        t0 = time.time()
        words = take_words()
        fd, tmp = tempfile.mkstemp(suffix=".list", dir=tmpdir)
        os.close(fd)
        with ListWriter(tmp, k) as w:
            stream_emit(w, words, 1, 0xFFFFFFFF)
        tmp_files.append(tmp)
        t_count += time.time() - t0

    for path in input_files:
        slabs = iter_code_slabs(path, k, slab_bytes)
        while True:
            t0 = time.time()
            item = next(slabs, None)
            t_parse += time.time() - t0
            if item is None:
                break
            codes, meta = item
            t0 = time.time()
            buf = np.empty(max(1, len(codes)), np.uint64)
            m = extract(np.ascontiguousarray(codes), len(codes), k, buf)
            if m:
                word_parts.append(buf[:m])
                acc_words += m
            t_count += time.time() - t0
            n_words_in += max(0, meta.total_bases - (word_length - 1)
                              * meta.n_records)
            if acc_words * 8 > spill_bytes:
                spill()

    t_w0 = time.time()
    if not tmp_files:
        words = take_words()
        with ListWriter(output_path, k) as w:
            stream_emit(w, words, min_count, max_count)
    else:
        if acc_words:
            spill()
        t_w0 = time.time()
        from genometester4_tpu.formats.list_format import read_list
        maps = [read_list(t, mmap=True) for t in tmp_files]
        shard_bufs = []
        lens = (ctypes.c_long * len(maps))()
        ptrs = (ctypes.c_void_p * len(maps))()
        cap = 0
        for i, (hdr, ws, cs) in enumerate(maps):
            # raw mmap record bytes start at the header's list_start
            raw = np.memmap(tmp_files[i], np.uint8, mode="r")[hdr.list_start:]
            shard_bufs.append(raw)
            ptrs[i] = raw.ctypes.data
            lens[i] = hdr.n_words
            cap += hdr.n_words
        out = np.empty(12 * max(1, cap), np.uint8)
        tot = ctypes.c_ulonglong(0)
        m = lib.fgx_merge_rec_shards(ptrs, lens, len(maps), min_count,
                                     max_count, out, ctypes.byref(tot))
        with ListWriter(output_path, k) as w:
            w.append_records(out[: 12 * m], m, tot.value)
    t_write = time.time() - t_w0

    hdr = ListHeader(word_length, w.n_words, w.total_count)
    if debug:
        _print_phase_debug(hdr, n_words_in, t_parse, t_count, t_write)
    for tmp in tmp_files:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    return hdr


def _print_phase_debug(hdr, n_words_in, t_parse, t_count, t_write):
    """-D phase accounting, format-matched to the reference's token
    accumulators (src/glistmaker.c:355-359, :1150) with this pipeline's
    honest stage mapping: Read = slab parse/extract, Sort = the count
    kernel, Write tmp = merge + final write."""
    sys.stderr.write("Words %d, unique %d\n"
                     % (hdr.total_count, hdr.n_words))
    for phase, nw, dt in (("Read", n_words_in, t_parse),
                          ("Sort", n_words_in, t_count),
                          ("Write tmp", hdr.n_words, t_write)):
        rate = int(nw / dt) & 0xFFFFFFFF if dt > 0 else 0
        sys.stderr.write("%s %d words at %.2f (%d words/s)\n"
                         % (phase, nw, dt, rate))


def make_list(input_files, word_length: int, output_path: str,
              min_count: int = 1, max_count: int = 0xFFFFFFFF,
              chunk_bases: int = DEFAULT_CHUNK_BASES,
              canonical: bool = True, debug: int = 0,
              spill_bytes: int | None = None,
              slab_bytes: int = 1 << 28) -> ListHeader:
    """Full glistmaker run: files → .list at ``output_path``.

    ``debug`` > 0 prints per-phase throughput counters to stderr like the
    reference's -D accounting (src/glistmaker.c:355-359), with phases
    renamed to this pipeline's stages (parse / device count / merge+write).

    ``spill_bytes`` (default 6 GiB, env GT4_SPILL_BYTES): in-RAM word
    budget before sorted shards spill to durable tmp .list files — the
    memory-budget analogue of the reference's tmp-file collation
    (src/glistmaker.c:788-835); spill shards double as crash-resumable
    checkpoints.
    """
    if spill_bytes is None:
        import os as _os
        spill_bytes = int(_os.environ.get("GT4_SPILL_BYTES", 6 << 30))
    # GT4_DIST_* configured: this process is one host of a multi-process
    # group — count over the global mesh (parallel/multihost.py); only
    # process 0 writes the (byte-identical) output. Overrides the local
    # cost model: a distributed launch is an explicit placement choice.
    multihost = False
    if canonical:
        from genometester4_tpu.parallel.multihost import is_multiprocess
        multihost = is_multiprocess()
    if not multihost and _count_impl() == "host":
        return _make_list_host(input_files, word_length, output_path,
                               min_count, max_count, canonical, debug,
                               spill_bytes, slab_bytes)
    import os
    import sys
    import tempfile
    import time
    t_parse = t_count = 0.0
    n_words_in = 0
    shards = []
    ram_bytes = 0
    tmp_files = []

    def spill(shards):
        # RAM shards -> tmp .list files, reloaded as mmaps: the merge
        # then streams pages on demand, the device-path analogue of the
        # reference's tmp-list collation (src/glistmaker.c:788-835)
        nonlocal ram_bytes
        from genometester4_tpu.formats.list_format import (read_list,
                                                           write_list)
        out = []
        for w, c in shards:
            if isinstance(w, np.memmap) or len(w) == 0:
                out.append((w, c))
                continue
            fd, tmp = tempfile.mkstemp(suffix=".list", dir=tmpdir)
            os.close(fd)
            write_list(tmp, word_length, w, c)
            tmp_files.append(tmp)
            _, mw, mc = read_list(tmp, mmap=True)
            out.append((mw, mc))
        ram_bytes = 0
        return out

    from genometester4_tpu.io.fasta import iter_code_slabs

    # With more than one visible device, the production count path IS
    # the ("dp", "kp") mesh (parallel/sharding.py): per-slab SPMD
    # extract+count with all_to_all prefix routing, yielding already
    # globally sorted per-slab results. Shard-by-most-significant-bits
    # keeps the final merge and the .list bytes identical to the
    # 1-device path at any mesh shape. GT4_TPU_MESH=0 opts out.
    from genometester4_tpu.utils.lazyjax import ensure_jax
    jax = ensure_jax()
    if debug:
        sys.stderr.write("Count placement: device (%s, %d devices)\n"
                         % (jax.default_backend(), len(jax.devices())))
    mesh = None
    is_writer = True
    if multihost:
        # global (dp=process, kp=local-devices) mesh; every process
        # participates in the collectives, only process 0 accumulates
        # shards and writes (results are dp-replicated by construction)
        from genometester4_tpu.parallel.multihost import make_global_mesh
        mesh = make_global_mesh()
        is_writer = jax.process_index() == 0
    elif (canonical and len(jax.devices()) > 1
            and os.environ.get("GT4_TPU_MESH", "1") != "0"):
        from genometester4_tpu.parallel.sharding import (
            count_kmers_sharded, make_mesh)
        mesh = make_mesh()

    # duplication-adaptive slack carried ACROSS slabs (the step builder
    # is memoized, so slab N+1 reuses slab N's compiled program AND its
    # adapted cap_factor — without this every slab restarted at the
    # worst-case buffers and recompiled)
    mesh_adapt_state: dict = {}

    def slab_shards(codes):
        if multihost:
            from genometester4_tpu.parallel.multihost import \
                iter_count_kmers_multihost
            yield from iter_count_kmers_multihost(
                codes, word_length, mesh, adapt_state=mesh_adapt_state)
            return
        if mesh is not None:
            w, c = count_kmers_sharded(codes, word_length, mesh,
                                       adapt_state=mesh_adapt_state)
            if len(w):
                yield w, c
            return
        yield from count_chunks(codes, word_length, chunk_bases,
                                canonical=canonical)

    tmpdir = os.environ.get("GT4_TPU_TMPDIR") or None
    for path in input_files:
        # streaming slab ingestion: peak RAM is O(slab_bytes), not
        # O(file) — the role of the reference's 100 MB mmap blocks
        # (src/listmaker-queue.c:116-161)
        t0 = time.time()
        slabs = iter_code_slabs(path, word_length, slab_bytes)
        t_parse += time.time() - t0
        while True:
            t0 = time.time()
            item = next(slabs, None)
            t_parse += time.time() - t0
            if item is None:
                break
            codes, meta = item
            t0 = time.time()
            for w, c in slab_shards(codes):
                if not is_writer:
                    continue  # non-writer processes only participate
                shards.append((w, c))
                ram_bytes += w.nbytes + c.nbytes
                if ram_bytes > spill_bytes:
                    shards = spill(shards)
            t_count += time.time() - t0
            n_words_in += max(0, meta.total_bases - (word_length - 1)
                              * meta.n_records)
    t_merge0 = time.time()
    if is_writer:
        with ListWriter(output_path, word_length) as w:
            for words, counts in merge_sorted_shards(
                    shards, word_length=word_length):
                if min_count > 1 or max_count != 0xFFFFFFFF:
                    keep = counts >= np.uint32(min_count)
                    if max_count != 0xFFFFFFFF:
                        keep &= counts <= np.uint32(max_count)
                    words, counts = words[keep], counts[keep]
                w.append(words, counts)
        hdr = ListHeader(word_length, w.n_words, w.total_count)
        if debug:
            t_merge = time.time() - t_merge0
            _print_phase_debug(hdr, n_words_in, t_parse, t_count, t_merge)
    else:
        hdr = None
    for tmp in tmp_files:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    if multihost:
        # no process returns before the output file is published
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices("gt4_make_list_multihost")
    return hdr
