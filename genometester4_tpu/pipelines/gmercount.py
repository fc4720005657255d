"""gmer_counter equivalent: count DB k-mers in sequencing reads.

Reference pipeline (src/gmer_counter.c:625-872, SURVEY.md §3.4): FASTA
reader emits canonical words into 10 Mi-word tables; worker threads walk
the trie per word and bump the flat count table.

Device pipeline:

  host parse (vectorized)        io.fasta
  -> device extract+canonicalize ops.kmers.extract_kmers
  -> device batched binary search into the sorted DB word array
     (replaces the trie walk)    ops.lookup.batched_lookup_pair
  -> device dedupe-and-sum of hit CODES (sort + segmented reduction,
     no scatters)                ops.sortcount.count_unique
  -> tiny (code, count) pairs back to host; decoded and accumulated
     into the flat per-slot count table.

Count semantics match the reference: per-occurrence increments clamp at
65535 (16-bit) or 2^32-1 (src/gmer_counter.c:790-795) — with pure
increments that equals min(total, limit), so totals accumulate in u64
and clamp at the end.  A code that decodes outside the node/kmer tables
makes the reference print a "DB inconsistency" error and abandon the
REST OF THAT 10 Mi-WORD BLOCK (break, src/gmer_counter.c:779-788);
we reproduce the message and the abandon-rest-of-chunk behavior, but our
chunk boundary differs from the reference's, so outputs only match
bit-for-bit on databases without duplicate/garbage codes (any sane DB).
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass, field
from functools import partial

import numpy as np

from genometester4_tpu.utils.lazyjax import jax, jnp

from genometester4_tpu.formats.gmerdb import GmerDB
from genometester4_tpu.io.fasta import load_file
from genometester4_tpu.ops.encode import split_u64
from genometester4_tpu.ops.kmers import extract_kmers
from genometester4_tpu.ops.lookup import batched_lookup_pair, lookup_steps
from genometester4_tpu.ops.sortcount import count_unique
from genometester4_tpu.pipelines.listmaker import pad_pow2_chunk

# 2^25-base chunks amortize dispatch; not yet tuned for H100 (ROADMAP 2.4)
DEFAULT_CHUNK_BASES = 1 << 25


@dataclass
class CountStats:
    """--stats accumulators (src/gmer_counter.c:69-80,292-302)."""
    n_seq: int = 0          # nucleotides + Ns
    n_nucl: int = 0         # valid ACGTU
    n_gc: int = 0           # C/G among valid
    n_kmers_total: int = 0  # canonical words emitted
    n_kmers: int = 0        # words that hit the DB
    n_kmer_gc: int = 0      # G+C bases inside hit words


@dataclass
class CountResult:
    counts: np.ndarray                      # u64[n_kmers] unclamped totals
    stats: CountStats = field(default_factory=CountStats)

    def clamped(self, count_bits: int) -> np.ndarray:
        limit = np.uint64(65535 if count_bits == 16 else 0xFFFFFFFF)
        return np.minimum(self.counts, limit)


def _make_count_fn(k: int, chunk_cap: int):
    """One fused device program: extract -> canonical -> dedupe-count ->
    INVERTED join -> per-DB-slot accumulation.

    The join direction matters: looking every window up in the DB does
    O(windows x log DB) gathers. Instead the chunk's windows are sorted
    and the DB's words binary-search the chunk's sorted stream:
    O(DB x log windows) gathers, typically thousands of times fewer. Counts accumulate on device as
    (lo, carry) uint32 pairs — exact u64 without the x64 flag — and are
    read back once per file.
    """
    steps = lookup_steps(chunk_cap)
    hi_bits = max(0, 2 * k - 32)

    @partial(jax.jit, donate_argnums=(0, 1))
    def run(acc_lo, acc_hi, codes, dbhi, dblo):
        from genometester4_tpu.ops.lookup import batched_bounds_pair
        hi, lo, valid = extract_kmers(codes, k, canonical=True)
        total = jnp.sum(valid.astype(jnp.int32))
        # occurrence counting without a dedupe pass: sort the raw window
        # stream (invalid flagged past the end) and take each DB word's
        # upper - lower bound. Saves the run-marks work entirely; the
        # second search reuses the same gather pattern.
        if hi_bits <= 30:
            packed = jnp.where(valid, jnp.uint32(0),
                               jnp.uint32(1 << hi_bits)) | hi
            shi, slo = jax.lax.sort((packed, lo), num_keys=2,
                                    is_stable=False)
        else:
            inv = (~valid).astype(jnp.uint32)
            _, shi, slo = jax.lax.sort((inv, hi, lo), num_keys=3,
                                       is_stable=False)
        lo_b, up_b = batched_bounds_pair(shi, slo, total, dbhi, dblo,
                                         steps=steps)
        add = (up_b - lo_b).astype(jnp.uint32)
        new_lo = acc_lo + add
        acc_hi = acc_hi + (new_lo < add).astype(jnp.uint32)
        return (new_lo, acc_hi, total, jnp.sum(add, dtype=jnp.uint32))

    return run


def _make_count_fn_mesh(k: int, chunk_cap: int, mesh):
    """Multi-device twin of _make_count_fn: chunks shard over a flat
    ("dp",) mesh, the DB tables and accumulators replicate, and one
    psum over dp merges per-chunk bound differences — the FastGT
    analogue of the mesh glistmaker/glistcompare paths. The count
    vector is tiny next to the window stream, so the only collective
    is cheap."""
    from genometester4_tpu.parallel.sharding import P

    steps = lookup_steps(chunk_cap)
    hi_bits = max(0, 2 * k - 32)

    def per_device(acc_lo, acc_hi, codes_block, dbhi, dblo):
        from genometester4_tpu.ops.lookup import batched_bounds_pair
        codes = codes_block.reshape(-1)
        hi, lo, valid = extract_kmers(codes, k, canonical=True)
        total = jnp.sum(valid.astype(jnp.int32))
        if hi_bits <= 30:
            packed = jnp.where(valid, jnp.uint32(0),
                               jnp.uint32(1 << hi_bits)) | hi
            shi, slo = jax.lax.sort((packed, lo), num_keys=2,
                                    is_stable=False)
        else:
            inv = (~valid).astype(jnp.uint32)
            _, shi, slo = jax.lax.sort((inv, hi, lo), num_keys=3,
                                       is_stable=False)
        lo_b, up_b = batched_bounds_pair(shi, slo, total, dbhi, dblo,
                                         steps=steps)
        add = jax.lax.psum((up_b - lo_b).astype(jnp.uint32), "dp")
        total = jax.lax.psum(total, "dp")
        new_lo = acc_lo + add
        acc_hi = acc_hi + (new_lo < add).astype(jnp.uint32)
        return (new_lo, acc_hi, total, jnp.sum(add, dtype=jnp.uint32))

    return jax.jit(
        jax.shard_map(per_device, mesh=mesh,
                      in_specs=(P(), P(), P("dp", None), P(), P()),
                      out_specs=(P(), P(), P(), P()),
                      # the binary-search carries mix dp-varying window
                      # tables with replicated query bounds; outputs are
                      # made replicated by the psums
                      check_vma=False),
        donate_argnums=(0, 1))


def _make_index_fn(k: int, steps: int):
    """Index-mode device program: like the count path but compacting
    per-hit (code, window position, direction) triples in stream order
    (scatter-free compaction via ops.sortcount.sort_compact)."""
    from genometester4_tpu.ops.encode import canonical_pair
    from genometester4_tpu.ops.sortcount import sort_compact

    @jax.jit
    def run(codes, thi, tlo, tcode, n_words):
        fhi, flo, valid = extract_kmers(codes, k, canonical=False)
        chi, clo = canonical_pair(fhi, flo, k)
        # dir = canonical word != forward word (src/gmer_counter.c:911)
        is_rc = ~((chi == fhi) & (clo == flo))
        found, code, _ = batched_lookup_pair(thi, tlo, tcode, n_words,
                                             chi, clo, steps=steps)
        hit = found & valid
        n = code.shape[0]
        pos = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).reshape(n)
        n_hit, hcode, hpos, hdir = sort_compact(hit, code, pos,
                                                is_rc.astype(jnp.uint8))
        return (n_hit, hcode, hpos, hdir,
                jnp.sum(valid.astype(jnp.int32)))

    return run


class DBCounter:
    """Accumulates DB k-mer counts across files/chunks on device.

    With ``build_index=True`` every hit's (code, record, position,
    direction) is also collected — the data for --compile_index
    (src/gmer_counter.c:523-623).
    """

    def __init__(self, db: GmerDB, chunk_bases: int = DEFAULT_CHUNK_BASES,
                 collect_stats: bool = False, build_index: bool = False):
        self.db = db
        self.chunk_bases = chunk_bases
        self.collect_stats = collect_stats
        self.build_index = build_index
        # per-hit arrays in stream order, one entry per add_file
        self.hits: list[dict] = []
        self.result = CountResult(np.zeros(db.n_kmers, np.uint64))
        n = len(db.sorted_words)
        self._finalized = False
        # unique DB word -> flat slot via the reference's code decode
        # (garbage summed codes of duplicate k-mers decode out of range
        # and are dropped with the reference's stderr message)
        node, kmer, ok = db.decode(db.sorted_codes)
        self._slot_ok = ok
        self._slot_of_unique = np.zeros(n, np.int64)
        self._slot_of_unique[ok] = db.flat_slot(node[ok], kmer[ok])
        self._run_cache: dict = {}
        # placement (utils.backend.prefer_host): with no accelerator the
        # native host kernels (extract + radix sort + searchsorted
        # bounds) beat the jnp pipeline on the XLA CPU backend several-
        # fold; on an accelerator the device path runs.
        # GT4_TPU_COUNT_IMPL=host|device pins either twin.
        import os

        from genometester4_tpu.utils.backend import prefer_host

        impl = os.environ.get("GT4_TPU_COUNT_IMPL", "auto")
        # GT4_DIST_*: one host of a multi-process group — count mode
        # runs the same SPMD program over the GLOBAL flat mesh (chunks
        # shard over every host's devices, one psum of the tiny per-DB-
        # word count vector is the only cross-host collective). An
        # explicit distributed launch overrides the local cost model,
        # same as make_list. Index mode stays per-process (its per-hit
        # position stream is inherently chunk-ordered; writers publish
        # atomically, so concurrent identical runs are benign).
        self._multiproc = False
        if not build_index:
            from genometester4_tpu.parallel.multihost import \
                is_multiprocess
            if is_multiprocess():
                self._multiproc = True
                impl = "device"
        if impl == "auto":
            impl = "host" if prefer_host() else "device"
        self._count_impl = impl
        self._mesh = None
        if impl == "host":
            self._host_acc = np.zeros(n, np.uint64)
        elif self._multiproc:
            from genometester4_tpu.parallel.multihost import (
                make_flat_global_mesh, put_replicated)
            self._mesh = make_flat_global_mesh("dp")
            dbhi, dblo = split_u64(db.sorted_words)
            self._dbhi = put_replicated(np.ascontiguousarray(dbhi),
                                        self._mesh)
            self._dblo = put_replicated(np.ascontiguousarray(dblo),
                                        self._mesh)
            self._acc_lo = put_replicated(np.zeros(n, np.uint32),
                                          self._mesh)
            self._acc_hi = put_replicated(np.zeros(n, np.uint32),
                                          self._mesh)
        else:
            # device-resident DB tables + u64-as-two-u32 accumulators,
            # uploaded only on the device path (the upload itself
            # initializes jax)
            dbhi, dblo = split_u64(db.sorted_words)
            self._dbhi = jnp.asarray(dbhi)
            self._dblo = jnp.asarray(dblo)
            self._acc_lo = jnp.zeros(n, jnp.uint32)
            self._acc_hi = jnp.zeros(n, jnp.uint32)
            # >1 device: chunks shard over the flat mesh, counts psum
            # (GT4_TPU_MESH=0 opts out; index mode stays single-device —
            # its per-hit position stream is inherently chunk-ordered)
            if (not build_index and len(jax.devices()) > 1
                    and os.environ.get("GT4_TPU_MESH", "1") != "0"):
                from genometester4_tpu.parallel.sharding import Mesh
                self._mesh = Mesh(np.array(jax.devices()), ("dp",))
        # index mode: per-window DB lookup. Host placement runs the
        # rolling native kernel (fgx_index_hits, binary search into the
        # L2-resident sorted DB); the device path uploads padded tables.
        if build_index:
            if self._count_impl == "host":
                self._hw = np.ascontiguousarray(db.sorted_words, np.uint64)
                self._hc = np.ascontiguousarray(db.sorted_codes, np.uint32)
                self._hit_bufs = None
            else:
                cap = 1 << max(10, math.ceil(math.log2(max(n, 2))))
                w = np.zeros(cap, np.uint64)
                w[:n] = db.sorted_words
                c = np.zeros(cap, np.uint32)
                c[:n] = db.sorted_codes
                hi, lo = split_u64(w)
                self._thi = jnp.asarray(hi)
                self._tlo = jnp.asarray(lo)
                self._tcode = jnp.asarray(c)
                self._n = np.int32(n)
                self._run_idx = _make_index_fn(db.wordsize,
                                               lookup_steps(cap))
        # per-slot GC counts for --stats. Bug-compat: the reference
        # re-reads the UNSHIFTED word every loop iteration
        # (src/gmer_counter.c:798-803 redeclares `word` inside the loop),
        # so its "GC count" is wordsize x (last base is G or C).
        if collect_stats:
            w = db.kmer_words
            self._slot_gc = (np.uint64(db.wordsize)
                             * ((w ^ (w >> np.uint64(1))) & np.uint64(1)))

    def _idx_lookup(self, chunk_codes: np.ndarray):
        """One chunk's (hcode, hpos, hdir, n_valid) as numpy, host or
        device per placement. Host positions are already chunk-local
        window starts, identical to the device program's iota."""
        if self._count_impl == "host":
            import ctypes

            from genometester4_tpu.models.fastgt_native import get_lib
            codes = np.ascontiguousarray(chunk_codes, np.uint8)
            n = len(codes)
            cap = max(n - self.db.wordsize + 1, 1)
            bufs = self._hit_bufs
            if bufs is None or len(bufs[0]) < cap:
                bufs = (np.empty(cap, np.uint32), np.empty(cap, np.int64),
                        np.empty(cap, np.uint8))
                self._hit_bufs = bufs
            hcode, hpos, hdir = bufs
            nv = ctypes.c_longlong(0)
            # past ~4M DB words the table is DRAM-resident and the
            # software-pipelined batched search wins (~1.4x at 30M,
            # identical hit stream); below, the plain rolling loop
            # (native/listkernel.c fgx_index_hits_batched comment)
            lib = get_lib()
            fn = (lib.fgx_index_hits_batched
                  if len(self._hw) >= (1 << 22) else lib.fgx_index_hits)
            m = fn(
                codes, ctypes.c_long(n), ctypes.c_int(self.db.wordsize),
                self._hw, self._hc, ctypes.c_long(len(self._hw)),
                hcode, hpos, hdir, ctypes.byref(nv))
            return (hcode[:m].copy(), hpos[:m].copy(), hdir[:m].copy(),
                    int(nv.value))
        chunk = pad_pow2_chunk(chunk_codes, self.chunk_bases)
        n_hit, hcode, hpos, hdir, n_valid = self._run_idx(
            jnp.asarray(chunk), self._thi, self._tlo, self._tcode, self._n)
        m = int(n_hit)
        return (np.asarray(hcode[:m]), np.asarray(hpos[:m]).astype(np.int64),
                np.asarray(hdir[:m]), int(n_valid))

    def add_file(self, path: str, slab_bytes: int = 1 << 28):
        if self.build_index:
            # FASTQ (the KATK read format) streams: records never span
            # slabs and SlabMeta carries absolute name offsets. FASTA
            # records CAN span slabs; iter_slabs_indexed carries the
            # record/position segment maps across seams, so that path
            # streams too (O(slab) raw bytes).
            if self._sniff_fastq(path):
                self._add_file_indexed_stream(path, slab_bytes)
            else:
                self._add_file_indexed_stream_fasta(path, slab_bytes)
            return
        # count mode streams: peak RAM O(slab), matching the reference's
        # block-at-a-time read pipeline (src/gmer_counter.c:713-748)
        from genometester4_tpu.io.fasta import iter_code_slabs
        for codes, meta in iter_code_slabs(path, self.db.wordsize,
                                           slab_bytes):
            if self.collect_stats:
                st = self.result.stats
                fresh = codes[meta.prefix_len:]
                new_nucl = int((fresh < 4).sum())
                st.n_nucl += new_nucl
                st.n_gc += int(((fresh == 1) | (fresh == 2)).sum())
                st.n_seq += new_nucl + meta.count_n  # nucleotides + Ns
            self._add_codes(codes)

    @staticmethod
    def _sniff_fastq(path: str) -> bool:
        import zlib
        with open(path, "rb") as f:
            head = f.read(4096)
        if head[:2] == b"\x1f\x8b":
            head = zlib.decompressobj(wbits=31).decompress(head, 256)
        head = head.lstrip(b" \t\r\n")
        return head[:1] == b"@"

    def _add_file_indexed_stream(self, path: str, slab_bytes: int):
        """Index-mode FASTQ ingestion in bounded memory: one hits table
        per file assembled from per-slab pieces (same semantics as
        _add_codes_indexed; positions are record-local, name offsets
        absolute via SlabMeta)."""
        from genometester4_tpu.io.fasta import iter_code_slabs

        k = self.db.wordsize
        file_idx = len(self.hits)
        rec_base = 0
        rec_l, lpos_l, code_l, dir_l, npos_l = [], [], [], [], []
        for codes, meta in iter_code_slabs(path, k, slab_bytes):
            if self.collect_stats:
                st = self.result.stats
                fresh = codes[meta.prefix_len:]
                new_nucl = int((fresh < 4).sum())
                st.n_nucl += new_nucl
                st.n_gc += int(((fresh == 1) | (fresh == 2)).sum())
                st.n_seq += new_nucl + meta.count_n
            n = len(codes)
            if n >= k:
                gpos_l, c_l, d_l = [], [], []
                step = self.chunk_bases - (k - 1)
                for start in range(0, max(n - (k - 1), 1), step):
                    hcode, hpos, hdir, n_valid = self._idx_lookup(
                        codes[start:start + self.chunk_bases])
                    c_l.append(hcode)
                    gpos_l.append(hpos + start)
                    d_l.append(hdir)
                    if self.collect_stats:
                        self.result.stats.n_kmers_total += n_valid
                if c_l:
                    gpos = np.concatenate(gpos_l)
                    rec = np.searchsorted(meta.rec_starts, gpos,
                                          side="right") - 1
                    rec_l.append(rec + rec_base)
                    lpos_l.append(gpos - meta.rec_starts[rec])
                    code_l.append(np.concatenate(c_l))
                    dir_l.append(np.concatenate(d_l))
                    npos_l.append(meta.name_pos[rec])
            rec_base += meta.n_records

        code_a = (np.concatenate(code_l) if code_l
                  else np.empty(0, np.uint32))
        rec = (np.concatenate(rec_l) if rec_l else np.empty(0, np.int64))
        kmer_pos = ((np.concatenate(lpos_l) if lpos_l
                     else np.empty(0, np.int64)) & 0x3FFFF)
        dirs = (np.concatenate(dir_l) if dir_l else np.empty(0, np.uint8))
        name_pos = (np.concatenate(npos_l) if npos_l
                    else np.empty(0, np.int64))
        node, kmer, ok = self.db.decode(code_a)
        if not ok.all():
            sys.stderr.write("DB inconsistency: invalid code in index mode\n")
            rec, kmer_pos, dirs = rec[ok], kmer_pos[ok], dirs[ok]
            name_pos = name_pos[ok]
            node, kmer = node[ok], kmer[ok]
        slots = self.db.flat_slot(node, kmer)
        np.add.at(self.result.counts, slots, 1)
        if self.collect_stats:
            st = self.result.stats
            st.n_kmers += len(slots)
            st.n_kmer_gc += int(self._slot_gc[slots].sum())
        self.hits.append(dict(file_idx=file_idx, slot=slots,
                              subseq=rec.astype(np.int64),
                              kmer_pos=kmer_pos.astype(np.int64),
                              name_pos=name_pos,
                              dir=dirs.astype(np.uint64)))

    def _add_file_indexed_stream_fasta(self, path: str, slab_bytes: int):
        """Index-mode FASTA ingestion in bounded memory: per-slab
        record/position maps from iter_slabs_indexed replace the former
        whole-file parse (same hit table, same stats quirks as
        _add_codes_indexed — n_seq is SET to n_nucl + this file's N
        count, reproducing the whole-file path's behavior)."""
        from genometester4_tpu.io.fasta import iter_slabs_indexed

        k = self.db.wordsize
        file_idx = len(self.hits)
        name_starts_l = []
        rec_l, lpos_l, code_l, dir_l = [], [], [], []
        file_count_n = 0
        for codes, meta in iter_slabs_indexed(path, k, slab_bytes):
            if codes is None:
                break
            name_starts_l.append(meta.name_spans[:, 0])
            file_count_n += meta.count_n
            if self.collect_stats:
                st = self.result.stats
                fresh = codes[meta.prefix_len:]
                st.n_nucl += int((fresh < 4).sum())
                st.n_gc += int(((fresh == 1) | (fresh == 2)).sum())
            n = len(codes)
            if n < k:
                continue
            step = self.chunk_bases - (k - 1)
            for start in range(0, max(n - (k - 1), 1), step):
                hcode, hpos, hdir, n_valid = self._idx_lookup(
                    codes[start:start + self.chunk_bases])
                m = len(hcode)
                if self.collect_stats:
                    self.result.stats.n_kmers_total += n_valid
                if not m:
                    continue
                spos = hpos + start
                seg = np.searchsorted(meta.seg_starts, spos,
                                      side="right") - 1
                rec_l.append(meta.seg_rec[seg])
                lpos_l.append(spos - meta.seg_starts[seg]
                              + meta.seg_lpos0[seg])
                code_l.append(np.asarray(hcode[:m]))
                dir_l.append(np.asarray(hdir[:m]))
        if self.collect_stats:
            st = self.result.stats
            st.n_seq = st.n_nucl + file_count_n
        name_starts = (np.concatenate(name_starts_l) if name_starts_l
                       else np.zeros(0, np.int64))
        code_a = (np.concatenate(code_l) if code_l
                  else np.empty(0, np.uint32))
        rec = (np.concatenate(rec_l) if rec_l else np.empty(0, np.int64))
        kmer_pos = ((np.concatenate(lpos_l) if lpos_l
                     else np.empty(0, np.int64)) & 0x3FFFF)
        dirs = (np.concatenate(dir_l) if dir_l else np.empty(0, np.uint8))
        node, kmer, ok = self.db.decode(code_a)
        if not ok.all():
            sys.stderr.write("DB inconsistency: invalid code in index mode\n")
            rec, kmer_pos, dirs = rec[ok], kmer_pos[ok], dirs[ok]
            node, kmer = node[ok], kmer[ok]
        slots = self.db.flat_slot(node, kmer)
        np.add.at(self.result.counts, slots, 1)
        if self.collect_stats:
            st = self.result.stats
            st.n_kmers += len(slots)
            st.n_kmer_gc += int(self._slot_gc[slots].sum())
        self.hits.append(dict(file_idx=file_idx, slot=slots,
                              subseq=rec.astype(np.int64),
                              kmer_pos=kmer_pos.astype(np.int64),
                              name_pos=(name_starts[rec] if len(rec)
                                        else np.empty(0, np.int64)),
                              dir=dirs.astype(np.uint64)))

    def _add_codes_indexed(self, parsed):
        """Index-mode ingestion: collect per-hit location data.

        kmer_pos counts printable sequence characters (our code array
        keeps one slot per printable char, N included, so the window
        offset within the record IS the reference's seq_npos-based
        position, src/fasta.c:252-266,908-911); the Read bitfield
        truncates it to 18 bits (src/database.h:56-60). name_pos is the
        absolute byte offset of the record name (src/fasta.c:141,188).
        """
        codes = parsed.codes
        k = self.db.wordsize
        n = len(codes)
        file_idx = len(self.hits)
        rec_starts = parsed.rec_starts
        name_pos_abs = (parsed._name_spans[:, 0].astype(np.int64)
                        if parsed._name_spans is not None
                        else np.zeros(len(rec_starts), np.int64))
        gpos_l, code_l, dir_l = [], [], []
        if n >= k:
            step = self.chunk_bases - (k - 1)
            for start in range(0, max(n - (k - 1), 1), step):
                hcode, hpos, hdir, n_valid = self._idx_lookup(
                    codes[start:start + self.chunk_bases])
                code_l.append(hcode)
                gpos_l.append(hpos + start)
                dir_l.append(hdir)
                if self.collect_stats:
                    self.result.stats.n_kmers_total += n_valid
        code_a = (np.concatenate(code_l) if code_l
                  else np.empty(0, np.uint32))
        gpos = (np.concatenate(gpos_l) if gpos_l
                else np.empty(0, np.int64))
        dirs = (np.concatenate(dir_l) if dir_l
                else np.empty(0, np.uint8))
        rec = np.searchsorted(rec_starts, gpos, side="right") - 1
        kmer_pos = (gpos - rec_starts[rec]) & 0x3FFFF
        node, kmer, ok = self.db.decode(code_a)
        if not ok.all():
            sys.stderr.write("DB inconsistency: invalid code in index mode\n")
            rec, kmer_pos, dirs = rec[ok], kmer_pos[ok], dirs[ok]
            node, kmer = node[ok], kmer[ok]
        slots = self.db.flat_slot(node, kmer)
        np.add.at(self.result.counts, slots, 1)
        if self.collect_stats:
            st = self.result.stats
            st.n_kmers += len(slots)
            st.n_kmer_gc += int(self._slot_gc[slots].sum())
        self.hits.append(dict(file_idx=file_idx, slot=slots,
                              subseq=rec.astype(np.int64),
                              kmer_pos=kmer_pos.astype(np.int64),
                              name_pos=name_pos_abs[rec],
                              dir=dirs.astype(np.uint64)))

    def _add_codes(self, codes: np.ndarray):
        k = self.db.wordsize
        n = len(codes)
        if n < k:
            return
        if self._count_impl == "host":
            import ctypes

            from genometester4_tpu.models.fastgt_native import get_lib
            from genometester4_tpu.utils.backend import disable_numpy_thp
            disable_numpy_thp()
            lib = get_lib()
            buf = np.empty(n, np.uint64)
            m = lib.fgx_extract_canonical(np.ascontiguousarray(codes), n,
                                          k, buf)
            if self.collect_stats:
                self.result.stats.n_kmers_total += int(m)
            if not m:
                return
            words = np.ascontiguousarray(buf[:m])
            if lib.fgx_sort_u64(words, m, 2 * k) != 0:
                raise MemoryError("sort scratch allocation failed")
            # both sides sorted: one streaming dual-pointer merge pass
            # (fgx_sorted_occurrences) replaces 2x ndb independent
            # bisections — 4.2 s -> ~0.2 s at 30M DB words (round 3)
            lib.fgx_sorted_occurrences(
                words, m, np.ascontiguousarray(self.db.sorted_words),
                len(self.db.sorted_words), self._host_acc)
            return
        step = self.chunk_bases - (k - 1)
        starts = list(range(0, max(n - (k - 1), 1), step))
        if self._mesh is not None:
            n_dev = self._mesh.devices.size
            for gi in range(0, len(starts), n_dev):
                batch = starts[gi:gi + n_dev]
                # one static cap per dispatch: the longest chunk rounded
                # up (same pow2 policy as pad_pow2_chunk)
                longest = max(min(n - s, self.chunk_bases) for s in batch)
                cap = min(self.chunk_bases,
                          1 << max(10, math.ceil(math.log2(max(longest,
                                                               2)))))
                blocks = np.full((n_dev, cap), 255, np.uint8)
                for bi, s in enumerate(batch):
                    c = codes[s:s + cap]
                    blocks[bi, : len(c)] = c
                run = self._run_cache.get(("mesh", cap))
                if run is None:
                    run = _make_count_fn_mesh(k, cap, self._mesh)
                    self._run_cache[("mesh", cap)] = run
                if self._multiproc:
                    from genometester4_tpu.parallel.multihost import \
                        put_axis0_sharded
                    blocks = put_axis0_sharded(blocks, self._mesh, "dp")
                self._acc_lo, self._acc_hi, n_valid, _ = run(
                    self._acc_lo, self._acc_hi, blocks,
                    self._dbhi, self._dblo)
                if self.collect_stats:
                    self.result.stats.n_kmers_total += int(n_valid)
            return
        for start in starts:
            chunk = pad_pow2_chunk(codes[start:start + self.chunk_bases],
                                   self.chunk_bases)
            cap = len(chunk)
            run = self._run_cache.get(cap)
            if run is None:
                run = _make_count_fn(k, cap)
                self._run_cache[cap] = run
            self._acc_lo, self._acc_hi, n_valid, _n_hits = run(
                self._acc_lo, self._acc_hi, jnp.asarray(chunk),
                self._dbhi, self._dblo)
            if self.collect_stats:
                self.result.stats.n_kmers_total += int(n_valid)

    def finalize(self):
        """Pull device accumulators and fold into per-slot totals."""
        if self._finalized:
            return
        self._finalized = True
        if self.build_index:
            return
        if self._count_impl == "host":
            totals = self._host_acc
        else:
            lo = np.asarray(self._acc_lo).astype(np.uint64)
            hi = np.asarray(self._acc_hi).astype(np.uint64)
            totals = (hi << np.uint64(32)) | lo
        ok = self._slot_ok
        if not ok.all() and totals[~ok].any():
            sys.stderr.write(
                "DB inconsistency: Node index is bigger than the "
                "number of nodes\n")
        np.add.at(self.result.counts, self._slot_of_unique[ok], totals[ok])
        if self.collect_stats:
            st = self.result.stats
            st.n_kmers += int(totals[ok].sum())
            st.n_kmer_gc += int(
                (self._slot_gc[self._slot_of_unique[ok]] * totals[ok]).sum())


def _index_nbits(maxval: int) -> int:
    """src/gmer_counter.c:587-603: nbits=1; while (max > 1) {nbits++;
    max/=2;}"""
    nbits = 1
    while maxval > 1:
        nbits += 1
        maxval //= 2
    return nbits


def build_read_index(db: GmerDB, counter: DBCounter, file_names: list[str]):
    """Assemble the KATK read index from collected hits
    (src/gmer_counter.c:523-623).

    Per-k-mer read lists come out in REVERSE encounter order because the
    reference prepends to singly-linked ReadLists
    (src/gmer_counter.c:805-810), and FILES are encountered in reverse
    argv order because equal-priority tasks push onto the queue head
    (src/queue.c:158-160) — so within a k-mer: file_idx ascending,
    stream position descending. Byte-identity versus the reference holds
    for --num_threads 1 (multi-threaded runs interleave blocks
    nondeterministically).
    """
    from genometester4_tpu.formats.read_index import ReadIndex

    slot = np.concatenate([h["slot"] for h in counter.hits]) \
        if counter.hits else np.empty(0, np.int64)
    n = len(slot)
    gidx = np.concatenate(
        [np.arange(len(h["slot"]), dtype=np.int64) for h in counter.hits]) \
        if counter.hits else np.empty(0, np.int64)
    file_idx = np.concatenate(
        [np.full(len(h["slot"]), h["file_idx"], np.uint64)
         for h in counter.hits]) if counter.hits else np.empty(0, np.uint64)
    subseq = np.concatenate([h["subseq"] for h in counter.hits]) \
        if counter.hits else np.empty(0, np.int64)
    kmer_pos = np.concatenate([h["kmer_pos"] for h in counter.hits]) \
        if counter.hits else np.empty(0, np.int64)
    name_pos = np.concatenate([h["name_pos"] for h in counter.hits]) \
        if counter.hits else np.empty(0, np.int64)
    dirs = np.concatenate([h["dir"] for h in counter.hits]) \
        if counter.hits else np.empty(0, np.uint64)

    nbits_file = _index_nbits(len(file_names) - 1 if file_names else 0)
    nbits_npos = _index_nbits(int(name_pos.max(initial=0)))
    nbits_kmer = _index_nbits(int(kmer_pos.max(initial=0)))

    # group by kmer slot; within a slot: file ascending, position
    # descending (see docstring)
    order = np.lexsort((-gidx, file_idx, slot))
    reads = ((dirs[order] << np.uint64(nbits_file + nbits_npos + nbits_kmer))
             | (file_idx[order] << np.uint64(nbits_npos + nbits_kmer))
             | (name_pos[order].astype(np.uint64) << np.uint64(nbits_kmer))
             | kmer_pos[order].astype(np.uint64))
    per_slot = np.bincount(slot, minlength=db.n_kmers).astype(np.uint64)
    read_blocks = np.zeros(db.n_kmers, np.uint64)
    if db.n_kmers:
        read_blocks[1:] = np.cumsum(per_slot)[:-1]
    ri = ReadIndex(nbits_file, nbits_npos, nbits_kmer,
                   [f.encode() for f in file_names], read_blocks, reads)
    # bookkeeping for the verbose per-kmer (src/subseq/pos) dump
    ri._print_info = (slot, file_idx, subseq, kmer_pos, gidx)  # type: ignore
    return ri


def write_index_db(db: GmerDB, counter: DBCounter, file_names: list[str],
                   path: str, debug: int = 0):
    """gmer_counter --compile_index: GMDB (no counts) + read index.

    ``debug`` reproduces the reference's -D phase chatter and timing
    lines (src/gmer_counter.c:523-623) with this pipeline's timings.
    """
    import time

    from genometester4_tpu.formats.read_index import pack_read_index
    from genometester4_tpu.formats.gmerdb_binary import write_binary_db
    t0 = time.time()
    if debug:
        sys.stderr.write("Calculate bitsizes\n")
    ri = build_read_index(db, counter, file_names)
    if debug:
        sys.stderr.write("Bitsize time: %.1fs\n" % (time.time() - t0))
        t0 = time.time()
        mnp = max((int(h["name_pos"].max(initial=0)) for h in counter.hits),
                  default=0)
        mkp = max((int(h["kmer_pos"].max(initial=0)) for h in counter.hits),
                  default=0)
        sys.stderr.write("Num files %u Max name pos %llu Max sequence pos"
                         " %u\n".replace("%u", "%d").replace("%llu", "%d")
                         % (len(file_names), mnp, mkp))
        sys.stderr.write("NBits file %d npos %d kmer %d\n"
                         % (ri.nbits_file, ri.nbits_npos, ri.nbits_kmer))
        sys.stderr.write("Writing index database to %s\n" % path)
    blob, physical, buggy_bs = pack_read_index(ri.nbits_file, ri.nbits_npos,
                                               ri.nbits_kmer, ri.files,
                                               ri.read_blocks, ri.reads)
    with open(path, "wb") as f:
        # gmer_counter's write_reads returns a read COUNT where bytes are
        # expected, so the recorded blocksize is too small — reproduced
        write_binary_db(db, f, index_blob=blob, index_physical=physical,
                        index_blocksize=buggy_bs)
    if debug:
        sys.stderr.write("Done\n")
        sys.stderr.write("Writing time (reads): %.1fs\n"
                         % (time.time() - t0))
    return ri


def pair_median(db: GmerDB, counts_clamped: np.ndarray) -> int:
    """--double_median: median of per-node k-mer PAIR sums, found by the
    reference's iterative bisection (src/gmer_counter.c:946-1013).

    Pairs step 2 through each node's flat slots; an odd node reads one
    slot past its end in the reference (flat table overrun) — we read the
    next node's first count, which is what the overrun hits in the flat
    layout, and 0 at the very end of the table. The reference's `total`
    counts only nkmers/2 FLOOR pairs while the scans count the overrun
    pair too, so `equal = total - above - below` can wrap as a C
    unsigned — every arithmetic step below keeps u32 wrap semantics
    (fuzz finding: odd-nkmers nodes diverged under signed math).
    """
    M = 0xFFFFFFFF
    flat = np.concatenate([counts_clamped.astype(np.int64), [0]])
    sums = []
    total = 0
    for i in range(db.n_nodes):
        nk = int(db.node_nkmers[i])
        k0 = int(db.node_kmers_start[i])
        total = (total + nk // 2) & M
        for j in range(0, nk, 2):
            sums.append(int(flat[k0 + j] + flat[k0 + j + 1]))
    s = np.asarray(sums, np.int64)
    mx = int(s.max(initial=0))
    mn = int(s.min(initial=0xFFFFFFFF))
    med = (mn + mx) // 2
    while mx > mn:
        above = int((s > med).sum())
        below = int((s < med).sum())
        equal = (total - above - below) & M
        if mx == mn + 1:
            if above > ((below + equal) & M):
                med = mx
            break
        if above > below:
            if ((above - below) & M) < equal:
                break
            mn = med
        elif below > above:
            if ((below - above) & M) < equal:
                break
            mx = med
        else:
            break
        med = (mn + mx) // 2
    return med


def format_counts(db: GmerDB, counts: np.ndarray, show_total: bool,
                  show_unique: bool, show_kmers: bool, distro: int,
                  header: bool, out, read_index=None) -> None:
    """Per-node output lines (src/gmer_counter.c:625-711).

    Bug-compat: the reference's --unique tests ``kmers_16[idx]`` even in
    32-bit mode (src/gmer_counter.c:655-659), aliasing 16-bit reads onto
    the u32 count array — slot j reads the low/high half of count j//2.
    We reproduce that deterministic aliasing.
    """
    if header:
        cols = ["NODE", "N_KMERS"]
        if show_total:
            cols.append("TOTAL")
        if show_unique:
            cols.append("UNIQUE")
        if show_kmers:
            cols.append("KMERS")
        if distro:
            cols.append("DISTRIBUTION")
        out.write("\t".join(cols) + "\n")
    starts = db.node_kmers_start.astype(np.int64)
    nks = db.node_nkmers.astype(np.int64)
    counts = counts.astype(np.uint64)
    if show_unique and db.count_bits == 32:
        aliased16 = counts.astype(np.uint32).view(np.uint16)
    if (not show_total and not show_unique and show_kmers and not distro
            and read_index is None):
        # default output shape: one native pass formats every line
        # (the Python str() loop cost ~0.5 s at 100k nodes)
        import ctypes

        from genometester4_tpu.models.fastgt_native import get_lib
        n = db.n_nodes
        name_off = np.empty(n, np.int64)
        name_len = np.empty(n, np.int32)
        blob_parts = []
        off = 0
        for i, nm in enumerate(db.names):
            name_off[i] = off
            name_len[i] = len(nm)
            off += len(nm)
        blob = b"".join(bytes(nm) for nm in db.names)
        cap = off + int(nks.sum()) * 22 + n * 26
        buf = np.empty(cap, np.uint8)
        counts_c = np.ascontiguousarray(counts, np.uint64)
        m = get_lib().fgx_format_node_counts(
            np.frombuffer(blob, np.uint8),
            name_off.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            name_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            np.ascontiguousarray(starts).ctypes.data_as(
                ctypes.POINTER(ctypes.c_longlong)),
            np.ascontiguousarray(nks).ctypes.data_as(
                ctypes.POINTER(ctypes.c_longlong)),
            counts_c, ctypes.c_long(n), buf)
        out.write(buf[:m].tobytes().decode("latin1"))
        return

    idx_info = None
    if read_index is not None and hasattr(read_index, "_print_info"):
        slot, file_idx, subseq, kmer_pos, gidx = read_index._print_info
        order = np.lexsort((-gidx, file_idx, slot))
        idx_info = (slot[order], file_idx[order], subseq[order],
                    kmer_pos[order],
                    np.searchsorted(slot[order], np.arange(db.n_kmers + 1)))
    lines = []
    for i in range(db.n_nodes):
        c = counts[starts[i]:starts[i] + nks[i]]
        parts = [db.names[i].decode("latin1"), str(int(nks[i]))]
        if show_total:
            parts.append(str(int(c.sum())))
        if show_unique:
            if db.count_bits == 32:
                u = aliased16[starts[i]:starts[i] + nks[i]]
                parts.append(str(int((u != 0).sum())))
            else:
                parts.append(str(int((c != 0).sum())))
        if show_kmers:
            parts.extend(str(int(v)) for v in c)
        if distro:
            sc = np.sort(c)
            hist = np.bincount(np.minimum(sc, distro + 1).astype(np.int64),
                               minlength=distro + 2)
            parts.extend(str(int(hist[v])) for v in range(distro + 1))
        line = "\t".join(parts)
        if idx_info is not None:
            _, fi, ss, kp, bounds = idx_info
            segs = []
            for j in range(int(nks[i])):
                s0, s1 = bounds[starts[i] + j], bounds[starts[i] + j + 1]
                for r in range(s0, s1):
                    segs.append(" (%u/%u/%u)" % (fi[r], ss[r], kp[r]))
            line += "".join(segs)
        lines.append(line)
        if len(lines) >= 4096:
            out.write("\n".join(lines) + "\n")
            lines = []
    if lines:
        out.write("\n".join(lines) + "\n")
