"""glistquery equivalent: lookups, dumps, and list statistics.

Output is line-for-line identical to the reference (src/glistquery.c),
including its quirks:

* absent words print "<canonical-word>\\t0" only when min_freq is 0
  (src/glistquery.c:560-566);
* the printed word is always the CANONICAL form of the query;
* ``-l`` without mismatches prints counts from the QUERY list, not the
  searched list (src/glistquery.c:702-717 passes the query cursor's
  count to the print callback);
* mismatch neighborhoods are canonicalized per generated word without
  dedup, so counts can double-count palindromic twins
  (src/word-dict.c:74-106);
* ``--all`` prints matches in the generator's DFS order.

Bulk paths (-s FASTA, -l with mismatches, -f with many words) batch
canonicalization + lookup on device via ops.lookup; single queries stay
on host.
"""

from __future__ import annotations

import math
import sys

import numpy as np

from genometester4_tpu.utils.lazyjax import jnp

from genometester4_tpu.formats.list_format import (ListFileError, read_list,
                                                   read_list_header)
from genometester4_tpu.ops.encode import (canonical_u64, split_u64,
                                          string_to_word, words_to_strings,
                                          word_to_string)
from genometester4_tpu.ops.lookup import batched_lookup_pair, lookup_steps
from genometester4_tpu.ops.mismatch import preorder_masks


class ListQuery:
    """A loaded .list with host and device lookup paths."""

    # set on .index sources (GT4IndexMap equivalent)
    index_map = None
    print_locations = False

    def __init__(self, path: str):
        self.path = path
        # gt4_word_map_new compatibility checks (src/word-map.c:179-215):
        # wrong major version and the file-size check, whose required
        # size is computed with word_bytes/count_bytes from the header —
        # a truncated 4.4 header reads those as 0 from the mmap zero
        # page, so the u64 product wraps and the check passes.
        import os as _os
        hdr = read_list_header(path)
        if hdr.version_major != 4:
            sys.stderr.write(
                "gt4_word_map_new: incompatible major version "
                f"{hdr.version_major} (required 4)\n")
            raise ListFileError(path)
        required = (hdr.list_start + hdr.n_words
                    * (hdr.word_bytes + hdr.count_bytes)) & 0xFFFFFFFFFFFFFFFF
        csize = _os.path.getsize(path)
        if csize < required:
            sys.stderr.write(
                f"gt4_word_map_new: file size too small ({csize}, "
                f"should be at least {required})\n")
            raise ListFileError(path)
        self.header = hdr
        self.k = hdr.word_length
        # record load is lazy: STATS reads only the header, and the
        # reference succeeds there even when n_words is zero-page
        # garbage too large to ever materialize (src/glistquery.c:818-827)
        self._recs = None
        self._dev = None

    def _load_records(self):
        if self._recs is None:
            _, words, counts = read_list(self.path)
            self._recs = (words, counts)
        return self._recs

    @property
    def words(self) -> np.ndarray:
        return self._load_records()[0]

    @property
    def counts(self) -> np.ndarray:
        return self._load_records()[1]

    # -- host path ---------------------------------------------------------
    _host_tab = None

    def _host_table(self):
        # numpy's searchsorted falls off its fast path on the strided
        # mmap record view (measured 2.2 s vs 0.3 s for 2M queries into
        # 20M words); bulk lookups amortize one contiguous copy
        if self._host_tab is None:
            self._host_tab = (np.ascontiguousarray(self.words),
                              np.ascontiguousarray(self.counts))
        return self._host_tab

    def lookup_host(self, queries: np.ndarray) -> np.ndarray:
        n = len(self.words)
        if n == 0:
            return np.zeros(len(queries), np.uint32)
        if len(queries) >= 4096:
            from genometester4_tpu.formats.list_format import \
                raw_record_view
            raw = raw_record_view(self.words)
            if raw is not None:
                from genometester4_tpu.models.fastgt_native import \
                    get_lib
                q64 = np.asarray(queries, np.uint64)
                if len(q64) and bool((q64[1:] >= q64[:-1]).all()):
                    # already-sorted queries (-l: the query side IS a
                    # sorted .list): one linear zipper over both sorted
                    # streams, the reference's own shape
                    # (src/glistquery.c:702-717)
                    qs = np.ascontiguousarray(q64)
                    out = np.empty(len(qs), np.uint32)
                    get_lib().fgx_lookup_records_zipper(
                        raw, n, qs, len(qs), out)
                    return out
                # native pipelined search over the raw record stream:
                # 64 interleaved misses in flight, no 600 MB contiguous
                # copy of the word column (the former amortized-copy
                # formulation spent 2.5 s on the copy alone at 50M
                # records; round-3 find). Sorted probes add locality.
                order = np.argsort(queries, kind="stable")
                qs = np.ascontiguousarray(queries[order], np.uint64)
                out_sorted = np.empty(len(qs), np.uint32)
                get_lib().fgx_lookup_records_batched(
                    raw, n, qs, len(qs), out_sorted)
                out = np.empty_like(out_sorted)
                out[order] = out_sorted
                return out
            words, counts = self._host_table()
            # random-order probes cache-miss ~log2(n) lines each; sorted
            # probes walk the table with locality (measured 2.3 s ->
            # ~0.4 s at 2M queries x 20M words). Sort, search, unsort.
            order = np.argsort(queries, kind="stable")
            idx_sorted = np.searchsorted(words, queries[order])
            idx = np.empty_like(idx_sorted)
            idx[order] = idx_sorted
        else:
            words, counts = self.words, self.counts
            idx = np.searchsorted(words, queries)
        idx_c = np.minimum(idx, n - 1)
        hit = words[idx_c] == queries
        return np.where(hit, counts[idx_c], 0).astype(np.uint32)

    # -- device path -------------------------------------------------------
    def _device_table(self):
        if self._dev is None:
            n = len(self.words)
            cap = 1 << max(10, math.ceil(math.log2(max(n, 2))))
            w = np.zeros(cap, np.uint64)
            w[:n] = self.words
            c = np.zeros(cap, np.uint32)
            c[:n] = self.counts
            hi, lo = split_u64(w)
            self._dev = (jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(c),
                         np.int32(n), lookup_steps(cap))
        return self._dev

    def lookup_device(self, queries: np.ndarray, chunk: int = 1 << 22):
        """Bulk lookup on device; returns uint32 counts."""
        thi, tlo, tc, n, steps = self._device_table()
        out = np.empty(len(queries), np.uint32)
        for s in range(0, len(queries), chunk):
            q = queries[s:s + chunk]
            qhi, qlo = split_u64(q)
            _, counts, _ = batched_lookup_pair(
                thi, tlo, tc, n, jnp.asarray(qhi), jnp.asarray(qlo), steps=steps)
            out[s:s + len(q)] = np.asarray(counts)
        return out

    def lookup(self, queries: np.ndarray) -> np.ndarray:
        if len(queries) >= 4096:
            # placement rule (utils.backend.prefer_host); small batches
            # stay on the host, where a dispatch would cost more
            from genometester4_tpu.utils.backend import prefer_host
            if not prefer_host():
                return self.lookup_device(queries)
        return self.lookup_host(queries)


class IndexQuery(ListQuery):
    """A loaded .index behaving as a word source (count = n locations),
    the GT4IndexMap interface stack (src/index-map.c:140-208)."""

    def __init__(self, path: str):
        from genometester4_tpu.formats.index_format import (
            IndexVersionError, read_index_map)
        self.path = path
        try:
            self.index_map = read_index_map(path)
        except IndexVersionError as e:
            # gt4_index_map_new prints its own diagnostic before
            # returning NULL (src/index-map.c:330-334); the caller then
            # prints the corrupted line
            sys.stderr.write("gt4_index_map_new: incompatible major "
                             f"version {e.version_major} (required 4)\n")
            raise ListFileError(path) from e
        except Exception as e:
            # gt4_index_map_new returns NULL on malformed indices
            # (src/index-map.c:322-347); the caller prints the
            # corrupted line
            raise ListFileError(path) from e
        self.k = self.index_map.word_length
        self.header = None
        self._dev = None
        self._counts = None

    # lazy: blob-level consumers (--locations dump) never deinterleave
    # the k-mer records or difference the offsets
    @property
    def words(self) -> np.ndarray:
        return self.index_map.words

    @property
    def counts(self) -> np.ndarray:
        if self._counts is None:
            self._counts = self.index_map.counts
        return self._counts

    @property
    def total_count(self) -> int:
        return int(self.index_map.num_locations)


def _word_index(lst, word: int) -> int:
    idx = int(np.searchsorted(lst.words, np.uint64(word)))
    if idx < len(lst.words) and lst.words[idx] == np.uint64(word):
        return idx
    return -1


def _location_lines(im, word_idx: int, reverse: int, out: list):
    """print_index_info (src/glistquery.c:469-478): one line per
    location, dir xor'ed with the query's reverse flag."""
    codes = im.word_locations(word_idx)
    fil, seq, pos, dirs = im.decode_locations(codes)
    for j in range(len(codes)):
        d = int(bool(dirs[j]) != bool(reverse))
        out.append("%u\t%u\t%llu\t%u\n".replace("%llu", "%d").replace(
            "%u", "%d") % (int(fil[j]), int(seq[j]), int(pos[j]), d))


def print_files(im):
    """glistquery --files (src/glistquery.c:439-449)."""
    out = []
    for i, fi in enumerate(im.files):
        out.append("%d\t%s\t%d\t%d\n" % (i, fi.name.decode("latin1"),
                                         fi.size, len(fi.subseqs)))
    _emit(out)


def print_sequences(im):
    """glistquery --sequences (src/glistquery.c:451-467): the name bytes
    are read from the SOURCE file at name_pos."""
    out = []
    for i, fi in enumerate(im.files):
        try:
            with open(fi.name.decode("latin1"), "rb") as f:
                src = f.read()
        except OSError:
            src = b""
        for j, (np_, nl, sp, sl) in enumerate(fi.subseqs):
            name = src[np_:np_ + min(nl, 1023)].decode("latin1")
            out.append("%d\t%d\t%s\t%d\t%d\t%d\n" % (i, j, name, np_, sp, sl))
    _emit(out)


def _emit(lines):
    sys.stdout.write("".join(lines))


def _emit_records(words: np.ndarray, counts: np.ndarray, k: int,
                  chunk: int = 1 << 20):
    """Bulk "KMER\\tCOUNT\\n" emission through the native formatter."""
    from genometester4_tpu.formats.list_format import pack_records
    from genometester4_tpu.models.fastgt_native import get_lib
    lib = get_lib()
    buf = np.empty(chunk * (k + 12), np.uint8)
    ob = getattr(sys.stdout, "buffer", None)
    if ob is not None:
        sys.stdout.flush()
    n = len(words)
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        recs = pack_records(
            np.ascontiguousarray(words[s:s + m], np.uint64),
            np.ascontiguousarray(counts[s:s + m], np.uint32))
        recs = np.ascontiguousarray(recs.view(np.uint8).reshape(-1))
        nb = lib.fgx_dump_records(recs, m, k, buf)
        if ob is not None:
            ob.write(memoryview(buf)[:nb])
        else:
            sys.stdout.write(buf[:nb].tobytes().decode("latin1"))
    if ob is not None:
        ob.flush()


def mm_lookup_sum(lst: ListQuery, word: int, nmm: int, pm3: int):
    """gt4_word_dict_lookup_mm for one canonical word: (total, found_words,
    found_counts) with per-generated-word canonicalization, no dedup."""
    masks = preorder_masks(lst.k, nmm, pm3)
    neigh = canonical_u64(np.uint64(word) ^ masks, lst.k)
    counts = lst.lookup_host(neigh)
    hit = counts > 0
    total = int(counts.astype(np.uint64).sum()) & 0xFFFFFFFF
    return total, neigh[hit], counts[hit]


def search_one_word(lst: ListQuery, word: int, nmm: int, pm3: int,
                    min_freq: int, max_freq: int, print_all: bool,
                    out: list, reverse: int = 0):
    """src/glistquery.c:543-567 semantics for one query word.

    ``reverse`` is the caller's qd->reverse state: the reference SETS it
    when a query canonicalizes to its reverse complement but never
    clears it, so it is STICKY across the words of a -f/-s/-l stream
    (src/glistquery.c:517-523). Returns the updated state."""
    cword = int(canonical_u64(np.array([word], np.uint64), lst.k)[0])
    if cword != word:
        reverse = 1
    word = cword
    ws = word_to_string(word, lst.k)
    with_locs = lst.index_map is not None and lst.print_locations
    if with_locs or print_all:
        # callback path (src/glistquery.c:552-556): every found word is
        # printed, min/max filter skipped; locations follow for indexes
        if nmm == 0:
            neigh = np.array([word], np.uint64)
        else:
            masks = preorder_masks(lst.k, nmm, pm3)
            neigh = canonical_u64(np.uint64(word) ^ masks, lst.k)
        counts = lst.lookup_host(neigh)
        hit = counts > 0
        for w, c in zip(neigh[hit], counts[hit]):
            if with_locs:
                out.append(f"{word_to_string(int(w), lst.k)}\t{c}\t{reverse}\n")
                _location_lines(lst.index_map, _word_index(lst, int(w)),
                                reverse, out)
            else:
                out.append(f"{word_to_string(int(w), lst.k)}\t{c}\n")
        if not hit.any() and not min_freq:
            out.append(f"{ws}\t0\n")
        return reverse
    if nmm == 0:
        cnt = int(lst.lookup_host(np.array([word], np.uint64))[0])
        if cnt:
            if min_freq <= cnt <= max_freq:
                out.append(f"{ws}\t{cnt}\n")
        elif not min_freq:
            out.append(f"{ws}\t0\n")
        return reverse
    total, fw, fc = mm_lookup_sum(lst, word, nmm, pm3)
    if total:
        if min_freq <= total <= max_freq:
            out.append(f"{ws}\t{total}\n")
    elif not min_freq:
        out.append(f"{ws}\t0\n")
    return reverse


def query_words_bulk(lst: ListQuery, words: np.ndarray, min_freq: int,
                     max_freq: int) -> None:
    """Vectorized no-mismatch path shared by -s / -f bulk queries:
    canonical lookup + native record formatting (the per-word Python
    loop cost ~1 ms/query at scale)."""
    cwords = canonical_u64(words, lst.k)
    counts = lst.lookup(cwords).astype(np.uint32)
    inc = np.where(counts > 0,
                   (counts >= np.uint32(min_freq))
                   & (counts <= np.uint32(max_freq)),
                   min_freq == 0)
    _emit_records(cwords[inc], counts[inc], lst.k)


def search_fasta(lst: ListQuery, path: str, nmm: int, pm3: int, min_freq: int,
                 max_freq: int, print_all: bool):
    from genometester4_tpu.io.fasta import load_file
    from genometester4_tpu.ops.kmers import extract_kmers
    from genometester4_tpu.ops.encode import join_u64

    import os as _os
    if path != "-" and not _os.path.isfile(path):
        # the reference's stream constructor opens lazily; the reader
        # fails in read(2). A missing path also fails fclose's az
        # assertion; a directory opened fine, so only the read error
        # prints (src/glistquery.c:688-696 + sequence-source.c:97)
        sys.stderr.write(
            f"fasta_reader_read_nwords: Reader {path} read error (-1) "
            "at 0\n")
        if not _os.path.isdir(path):
            sys.stderr.write("File sequence-source.c line 97 (?): "
                             "Assertion inst->open failed\n")
        return 255
    parsed = load_file(path)
    codes = parsed.codes
    if len(codes) < lst.k:
        return 0
    # extraction without canonicalization: search_one_word canonicalizes.
    # Host-native rolling extraction (the jnp window build on the CPU
    # backend cost ~2 s at 2 Mbp).
    try:
        import ctypes as _ct

        from genometester4_tpu.models.fastgt_native import get_lib
        lib = get_lib()
        buf = np.empty(max(1, len(codes)), np.uint64)
        m = lib.fgx_extract_forward(np.ascontiguousarray(codes),
                                    len(codes), lst.k, buf)
        words = buf[:m]
    except (OSError, ImportError):
        hi, lo, valid = extract_kmers(jnp.asarray(codes), lst.k,
                                      canonical=False)
        words = join_u64(np.asarray(hi), np.asarray(lo))[np.asarray(valid)]
    with_locs = lst.index_map is not None and lst.print_locations
    if nmm == 0 and not print_all and not with_locs:
        query_words_bulk(lst, words, min_freq, max_freq)
    else:
        out = []
        rev = 0
        for w in words:
            rev = search_one_word(lst, int(w), nmm, pm3, min_freq,
                                  max_freq, print_all, out, rev)
        _emit(out)
    return 0


def search_query_file(lst: ListQuery, path: str, nmm: int, pm3: int,
                      min_freq: int, max_freq: int, print_all: bool,
                      use_3p: bool, use_5p: bool):
    """-f: byte-level tokenizer parity (src/glistquery.c:619-640): collect
    up to 255 chars until newline, then skip bytes < 'A'."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        # src/glistquery.c:614-618 (note the trailing period)
        sys.stderr.write("search_n_query_strings: Cannot open file "
                         f"{path}.\n")
        return 1
    if (nmm == 0 and not print_all
            and not (lst.index_map is not None and lst.print_locations)):
        # clean-file fast path: exact-k ACGT tokens, one per line — the
        # common shape — batches through the vectorized lookup (the
        # per-token loop below costs ~1 ms/query). Any deviation falls
        # through to the byte-exact tokenizer.
        lines = data.split(b"\n")
        while lines and lines[-1] == b"":
            lines.pop()
        if lines and all(len(t) == lst.k for t in lines):
            cat = np.frombuffer(b"".join(lines), np.uint8)
            from genometester4_tpu.ops.encode import NUCL_CODES
            codes = NUCL_CODES[cat]
            if not (codes > 3).any():
                shifts = np.arange(2 * (lst.k - 1), -1, -2, dtype=np.uint64)
                mat = codes.reshape(len(lines), lst.k).astype(np.uint64)
                words = (mat << shifts[None, :]).sum(axis=1,
                                                     dtype=np.uint64)
                query_words_bulk(lst, words, min_freq, max_freq)
                return 0
    out: list[str] = []
    rev = 0
    i, n = 0, len(data)
    while i < n:
        j = i
        tok = []
        while j < n and len(tok) < 255 and data[j] != 0x0A:
            tok.append(data[j])
            j += 1
        while j < n and data[j] != 0x0A:
            j += 1
        while j < n and data[j] < ord("A"):
            j += 1
        i = j
        s = bytes(tok).decode("latin1")
        word = _string_query_to_word(lst.k, s, use_3p, use_5p,
                                     "search_n_query_strings")
        if word is None:
            _emit(out)
            return 1
        rev = search_one_word(lst, word, nmm, pm3, min_freq, max_freq,
                              print_all, out, rev)
    _emit(out)
    return 0


def _string_query_to_word(k: int, s: str, use_3p: bool, use_5p: bool,
                          fn_name: str):
    if len(s) != k:
        if len(s) < k:
            sys.stderr.write(f"{fn_name}: Word too short ({k} < {len(s)})\n")
            return None
        if use_3p:
            return string_to_word(s[len(s) - k:], strict=False)
        if use_5p:
            return string_to_word(s[:k], strict=False)
        sys.stderr.write(f"{fn_name}: Wrong query length ({k} != {len(s)}) "
                         "- use --3p or --5p\n")
        return None
    return string_to_word(s, strict=False)


def search_one_query_string(lst: ListQuery, query: str, nmm: int, pm3: int,
                            min_freq: int, max_freq: int, print_all: bool,
                            use_3p: bool, use_5p: bool):
    word = _string_query_to_word(lst.k, query, use_3p, use_5p,
                                 "search_one_query_string")
    if word is None:
        return 1
    out: list[str] = []
    search_one_word(lst, word, nmm, pm3, min_freq, max_freq, print_all, out)
    _emit(out)
    return 0


def search_list(lst: ListQuery, query_path: str, nmm: int, pm3: int,
                min_freq: int, max_freq: int, print_all: bool):
    qh, qw, qc = read_list(query_path)
    if qh.word_length != lst.k:
        return 4  # GT_INCOMPATIBLE_WORDLENGTH_ERROR (src/common.h)
    if nmm == 0:
        # zipper prints the QUERY list's counts for words found in the
        # searched list (reference behavior, src/glistquery.c:702-717);
        # formatting goes through the native record formatter
        qw = np.asarray(qw)
        counts = lst.lookup(qw)
        hit = counts > 0
        if lst.index_map is not None and lst.print_locations:
            # index + --locations: cb_print's three-column form with
            # qd->reverse (never set on this path, so 0) and the word's
            # location lines; no min/max filter applies
            # (src/glistquery.c:529-538,712)
            out: list[str] = []
            for w, c in zip(qw[hit], np.asarray(qc)[hit]):
                out.append(f"{word_to_string(int(w), lst.k)}\t{c}\t0\n")
                _location_lines(lst.index_map, _word_index(lst, int(w)),
                                0, out)
            _emit(out)
        else:
            _emit_records(qw[hit], np.asarray(qc)[hit], lst.k)
    else:
        out: list[str] = []
        rev = 0
        for w in np.asarray(qw):
            rev = search_one_word(lst, int(w), nmm, pm3, min_freq,
                                  max_freq, print_all, out, rev)
        _emit(out)
    return 0


def search_lists_multi(query_path: str, lists: list[ListQuery]):
    """Query-list × N-lists table (src/glistquery.c:776-812)."""
    qh, qw, _ = read_list(query_path)
    qw = np.asarray(qw)
    counts = np.stack([lst.lookup(qw) for lst in lists], axis=1)
    any_hit = (counts > 0).any(axis=1)
    strs = words_to_strings(qw[any_hit], lists[0].k)
    sub = counts[any_hit]
    out = []
    for r, s in enumerate(strs):
        line = [s]
        for i in range(len(lists)):
            if sub[r, i]:
                line.append(f"\t{i}:{sub[r, i]}")
        line.append("\n")
        out.append("".join(line))
    _emit(out)
    return 0


def print_full_map(lst: ListQuery, chunk: int = 1 << 20):
    if lst.index_map is not None and lst.print_locations:
        # src/glistquery.c:495-510: per word also dump its locations —
        # the native formatter runs straight off the mmapped .index
        # blobs (interleaved k-mer records + raw u64 location codes,
        # field decode folded into the C loop; the per-word Python loop
        # was minutes at ~2M words, the numpy pre-decode ~100 ms)
        from genometester4_tpu.models.fastgt_native import get_lib
        lib = get_lib()
        im = lst.index_map
        recs = im.kmer_recs
        if recs is None or not recs.flags.c_contiguous:
            recs = np.empty(2 * len(im.words), np.uint64)
            recs[0::2] = im.words
            recs[1::2] = im.loc_start
        locs = np.asarray(im.locations)
        if not locs.flags.c_contiguous:
            locs = np.ascontiguousarray(locs)
        n = len(recs) // 2
        total_locs = int(im.num_locations)
        fb, sb, pb = im.n_file_bits, im.n_subseq_bits, im.n_pos_bits
        ob = getattr(sys.stdout, "buffer", None)
        if ob is not None:
            sys.stdout.flush()
        CH = 1 << 18
        for s0 in range(0, n, CH):
            m = min(CH, n - s0)
            a = int(recs[2 * s0 + 1])
            z = int(recs[2 * (s0 + m) + 1]) if s0 + m < n else total_locs
            buf = np.empty(m * (lst.k + 14) + max(z - a, 0) * 80 + 64,
                           np.uint8)
            nb = lib.fgx_dump_index_locations_raw(
                recs[2 * s0:], m, z, lst.k, locs, fb, sb, pb, buf)
            if ob is not None:
                ob.write(memoryview(buf)[:nb])
            else:
                sys.stdout.write(buf[:nb].tobytes().decode("latin1"))
        if ob is not None:
            ob.flush()
        return
    from genometester4_tpu.formats.list_format import (pack_records,
                                                       raw_record_view)
    raw = raw_record_view(lst.words)
    if raw is None:
        raw = pack_records(np.ascontiguousarray(lst.words, np.uint64),
                           np.ascontiguousarray(lst.counts, np.uint32))
        raw = np.ascontiguousarray(raw.view(np.uint8).reshape(-1))
    import ctypes as _ct

    from genometester4_tpu.models.fastgt_native import get_lib
    lib = get_lib()
    n = len(lst.words)
    buf = np.empty(chunk * (lst.k + 12), np.uint8)
    ob = getattr(sys.stdout, "buffer", None)
    if ob is not None:
        sys.stdout.flush()
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        nb = lib.fgx_dump_records(raw[12 * s:], m, lst.k, buf)
        if ob is not None:
            ob.write(memoryview(buf)[:nb])
        else:  # captured stdout (tests): text fallback
            sys.stdout.write(buf[:nb].tobytes().decode("latin1"))
    if ob is not None:
        ob.flush()


def dump_lists(lists: list[ListQuery], is_union: bool, header_names=None):
    """Multi-list dump: per word present in any (or all for is_union=0?
    — gt4_union prints every word with per-list counts; gt4_is_union
    walks words of the FIRST list only, src/set-operations.c:131-228)."""
    k = lists[0].k
    if header_names:
        sys.stdout.write("KMER" + "".join(f"\t{n}" for n in header_names) + "\n")
    if is_union:
        base = np.asarray(lists[0].words)
        cols = [np.asarray(lists[0].counts)] + [
            lst.lookup(base) for lst in lists[1:]]
        words = base
    else:
        words = np.asarray(lists[0].words)
        for lst in lists[1:]:
            words = np.union1d(words, np.asarray(lst.words))
        cols = [lst.lookup(words) for lst in lists]
    strs = words_to_strings(words, k)
    mat = np.stack(cols, axis=1)
    # bug-compat: gt4_union's cursor loop (src/set-operations.c:160-178)
    # reuses an exhausted source's stale last word for one extra round,
    # emitting a duplicate line with all-zero counts right after that
    # word's true line — except for the source(s) exhausting last.
    dup_words = set()
    if not is_union and len(lists) > 1:
        lasts = [int(lst.words[-1]) for lst in lists if len(lst.words)]
        if lasts:
            final = max(lasts)
            dup_words = {w for w in lasts if w != final}
    zero_row = "".join("\t0" for _ in lists)
    out = []
    for r, s in enumerate(strs):
        out.append(s + "".join(f"\t{c}" for c in mat[r]) + "\n")
        if int(words[r]) in dup_words:
            out.append(s + zero_row + "\n")
    _emit(out)


def _stats_header_lines(lst: ListQuery) -> str:
    if lst.index_map is not None:
        return (f"Index {lst.path}: built with glistmaker version "
                f"{lst.index_map.version_major}."
                f"{lst.index_map.version_minor}\n"
                f"Wordlength\t{lst.k}\nNUnique\t{len(lst.words)}\n"
                f"NTotal\t{lst.index_map.num_locations}\n")
    h = lst.header
    return (f"List {lst.path}: built with glistmaker version "
            f"{h.version_major}.{h.version_minor}\n"
            f"Wordlength\t{h.word_length}\nNUnique\t{h.n_words}\n"
            f"NTotal\t{h.total_count}\n")


def get_statistics(lst: ListQuery):
    sys.stdout.write(_stats_header_lines(lst))


def print_median(lst: ListQuery, debug: int = 0):
    """Exact replica of the reference's iterative median search
    (src/glistquery.c:814-892) with vectorized count passes."""
    counts = np.asarray(lst.counts)
    n = len(counts)
    h = lst.header
    if debug:
        sys.stderr.write("Finding min/max...")
    gmin = int(counts.min()) if n else 0xFFFFFFFF
    gmax = int(counts.max()) if n else 0
    if debug:
        sys.stderr.write("done (%u %u)\n".replace("%u", "%d")
                         % (gmin, gmax))
    mn, mx = gmin, gmax
    med = (mn + mx) // 2
    while mx > mn:
        above = int((counts > med).sum())
        below = int((counts < med).sum())
        equal = n - above - below
        if debug:
            sys.stderr.write("Trying median %d - equal %d, below %d, "
                             "above %d\n" % (med, equal, below, above))
        if mx == mn + 1:
            if above > below + equal:
                med = mx
            break
        if above > below:
            if above - below < equal:
                break
            mn = med
        elif below > above:
            if below - above < equal:
                break
            mx = med
        else:
            break
        med = (mn + mx) // 2
    sys.stdout.write(_stats_header_lines(lst))
    if lst.index_map is not None:
        total, nuniq = lst.index_map.num_locations, len(lst.words)
    else:
        total, nuniq = h.total_count, h.n_words
    if nuniq:
        avg_s = "%.2f" % (total / nuniq)
    else:
        # C prints 0.0/0 as "-nan" on x86 (the division sets the NaN
        # sign bit); Python would print "nan" (src/glistquery.c:868)
        avg_s = "-nan"
    sys.stdout.write(f"Min {gmin} Max {gmax} Median {med} Average {avg_s}\n")


def print_distro(lst: ListQuery, max_count: int):
    counts = np.asarray(lst.counts)
    d = np.bincount(np.minimum(counts, max_count + 1),
                    minlength=max_count + 2)[1:max_count + 1]
    _emit(f"{i + 1}\t{d[i]}\n" for i in range(max_count))


def print_gc(lst: ListQuery):
    # a base is G or C iff its two bits differ: (w ^ (w >> 1)) has a 1
    # at the even position of every GC base — one popcount per word.
    # Over mmap'd lists the native one-pass record kernel avoids the
    # strided gather copy entirely (fgx_gc_rec).
    from genometester4_tpu.formats.list_format import raw_record_view
    raw = raw_record_view(lst.words)
    if raw is not None:
        import ctypes

        from genometester4_tpu.models.fastgt_native import get_lib
        lib = get_lib()
        gt = ctypes.c_ulonglong(0)
        ct = ctypes.c_ulonglong(0)
        lib.fgx_gc_rec(raw, len(lst.words), ctypes.byref(gt),
                       ctypes.byref(ct))
        total, csum = int(gt.value), int(ct.value)
    else:
        words = np.ascontiguousarray(np.asarray(lst.words))
        counts = np.asarray(lst.counts).astype(np.uint64)
        x = ((words ^ (words >> np.uint64(1)))
             & np.uint64(0x5555555555555555))
        gc_bases = np.bitwise_count(x).astype(np.uint64)
        total = int((gc_bases * counts).sum())
        csum = int(counts.sum())
    denom = csum * lst.k
    if not denom:
        # x86 0.0/0.0 sets the NaN sign bit; C %g prints "-nan"
        # (same quirk as the stats Average line, src/glistquery.c:868)
        sys.stdout.write("GC\t-nan\n")
        return
    sys.stdout.write("GC\t%g\n" % (total / denom))
