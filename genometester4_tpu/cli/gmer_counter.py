"""gmer_counter CLI — flag-compatible with the reference
(src/gmer_counter.c:100-270).

Usage: gmer_counter ARGUMENTS SEQUENCES...
"""

from __future__ import annotations

import os
import sys

# The counts-file header announces the FORMAT version; downstream
# gmer_caller output is diffed byte-for-byte against the reference, so we
# emit the reference format version string (src/gmer_counter.c:395).
REF_VERSION = "4.2.16 (stable)"

VERSION_LINE = 'gmer_counter version 4.2.16 (stable)\n'
HELP = 'gmer_counter version 4.2.16 (stable)\nUsage:\n  gmer_counter ARGUMENTS SEQUENCES...\nArguments:\n    -v | --version   - Print version information and exit\n    -db DATABASE     - SNP/KMER database file\n    -dbb DBBINARY    - binary database file\n    -w FILENAME      - write binary database to file\n    -32              - use 32-bit integeres for counts (default 16-bit)\n    --max_kmers NUM  - maximum number of kmers per node\n    --silent         - do not print kmer counts (default for index and binary database compilation)\n    --verbose        - print kmer counts (default for counting)\n    --header         - print header row\n    --total          - print the total number of kmers per node\n    --unique         - print the number of nonzero kmers per node\n    --kmers          - print individual kmer counts (default if no other output)\n    --compile_index FILENAME - Add read index to database and write it to file\n    --distribution NUM  - print kmer distribution (up to given number)\n    --num_threads    - number of worker threads (default 24)\n    --prefetch       - prefetch memory mapped files (faster on high-memory systems)\n    --recover        - recover from FastA/FastQ errors (useful for corrupted streams)\n    --stats          - print some statistics about sequence and kmers\n    -D               - increase debug level\n    -DDB             - increase database debug level\n'


def _dump_db(path: str, db) -> None:
    """--dump_index: debug dump of a binary DB + read index
    (gt4_db_dump, src/database.c:543-572)."""
    import struct
    with open(path, "rb") as f:
        hdr = f.read(48)
    major, minor = struct.unpack_from("<HH", hdr, 4)
    version = (major << 16) | minor
    _, node_bits, kmer_bits, count_bits = struct.unpack_from(
        "<IIII", hdr, 8)
    if version < 4:
        count_bits = 16  # load-time adjustment, mirrored by our parser
    n_nodes, n_kmers, names_size = struct.unpack_from("<QQQ", hdr, 24)
    out = sys.stdout
    out.write("Database layout\n")
    out.write("  Wordsize: %u\n".replace("%u", "%d") % db.wordsize)
    out.write("  Node bits: %d\n" % node_bits)
    out.write("  KMer bits: %d\n" % kmer_bits)
    out.write("  Count bits: %d\n" % count_bits)
    out.write("  Nodes: %d\n" % n_nodes)
    out.write("  Kmers: %d\n" % n_kmers)
    out.write("  Names size: %d\n" % names_size)
    out.write("  Compatibility: %s\n" % ("yes" if version < 4 else "no"))
    idx = getattr(db, "index", None)
    for i in range(db.n_nodes):
        name = db.names[i].decode("latin1")
        ks = int(db.node_kmers_start[i])
        nk = int(db.node_nkmers[i])
        out.write("Node %d %s kmers %d nkmers %d\n" % (i, name, ks, nk))
        if idx is None:
            continue
        for j in range(nk):
            codes = idx.kmer_reads(ks + j)
            kmer_pos, name_pos, file_idx, dirs = idx.decode_reads(codes)
            for k in range(len(codes)):
                out.write("  %d %d %d %d %d\n" % (
                    j, int(file_idx[k]), int(name_pos[k]),
                    int(kmer_pos[k]), int(dirs[k])))


def _eof_reader_lines(path: str) -> None:
    """The reader's -D end-of-sequence chrome (src/fasta.c:116,273):
    a FASTQ ending in a newline prints the line TWICE at size-1 (the
    quality branch fires, then the outer EOF branch re-fires at the
    same cpos); everything else — FASTA, or a FASTQ with no trailing
    newline — prints once at the full decompressed size."""
    size = None
    last = b""
    first = b""
    try:
        with open(path, "rb") as f:
            head = f.read(2)
        if head == b"\x1f\x8b":
            import zlib
            d = zlib.decompressobj(wbits=31)
            size = 0
            with open(path, "rb") as f:
                while True:
                    raw = f.read(1 << 20)
                    if not raw:
                        break
                    out = d.decompress(raw)
                    if out:
                        size += len(out)
                        if not first:
                            first = out[:1]
                        last = out[-1:]
        else:
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                first = f.read(1)
                if size:
                    f.seek(-1, 2)
                    last = f.read(1)
    except OSError:
        return
    is_fq = first == b"@"
    if is_fq and last == b"\n":
        line = ("fasta_reader_read_nwords: Reader %s end of sequence "
                "at %d\n" % (path, size - 1))
        sys.stderr.write(line * 2)
    else:
        sys.stderr.write("fasta_reader_read_nwords: Reader %s end of "
                         "sequence at %d\n" % (path, size))


def _main_impl(argv=None) -> int:
    from genometester4_tpu.cli._cstrtol import strtol as _strtol

    argv = list(sys.argv[1:] if argv is None else argv)
    db_name = dbb = wdb = index_name = None
    max_kmers_per_node = 1000000000
    silent = verbose = big = dm = dump_index = 0
    header = total = unique = kmers = distro = 0
    stats = 0
    debug = 0
    seqnames: list[str] = []
    i = 0
    try:
        while i < len(argv):
            a = argv[i]
            if a in ("-v", "--version"):
                sys.stdout.write(VERSION_LINE)
                return 0
            elif a in ("-h", "--help"):
                sys.stdout.write(HELP)
                return 0
            elif a == "-db":
                i += 1
                db_name = argv[i]
            elif a == "-dbb":
                i += 1
                dbb = argv[i]
            elif a == "-w":
                i += 1
                wdb = argv[i]
            elif a == "--max_kmers":
                i += 1
                max_kmers_per_node = _strtol(argv[i])[0]
            elif a == "--silent":
                silent = 1
            elif a == "--verbose":
                verbose = 1
            elif a == "--header":
                header = 1
            elif a == "--total":
                total = 1
            elif a == "--unique":
                unique = 1
            elif a == "--kmers":
                kmers = 1
            elif a == "-32":
                big = 1
            elif a == "--double_median":
                dm = 1
            elif a == "--compile_index":
                i += 1
                index_name = argv[i]
            elif a == "--distribution":
                i += 1
                distro = _strtol(argv[i])[0]
            elif a == "--num_threads":
                i += 1
                if i >= len(argv):
                    sys.stderr.write(HELP)
                    return 1
            elif a == "--prefetch":
                pass
            elif a == "--recover":
                pass
            elif a == "--export_reads":
                pass  # parsed but its action block is empty upstream
                # (src/gmer_counter.c:217-218,430-431)
            elif a == "--count_trie_allocations":
                pass  # trie allocation counter (debug-only upstream)
            elif a == "--dump_index":
                dump_index = 1
            elif a in ("--stats", "-stat"):
                stats = 1
            elif a == "-D":
                debug += 1
            elif a == "-DDB":
                debug += 1
            else:
                if len(seqnames) >= 1024:
                    sys.stderr.write(
                        "Maximum number of input sequence files is 1024\n")
                    return 1
                seqnames.append(a)
            i += 1
    except (IndexError, ValueError):
        sys.stderr.write(HELP)
        return 1

    # C pointer truthiness: -w '' sets a non-NULL empty string, so the
    # checks here must test is-set, not Python truthiness
    # (src/gmer_counter.c:259-273)
    if not seqnames and wdb is None:
        sys.stderr.write("Nothing to do!\n" + HELP)
        return 1
    if db_name is not None and dbb is not None:
        sys.stderr.write("Both text and binary database specifed\n" + HELP)
        return 1
    if dbb is not None and wdb is not None:
        sys.stderr.write("Binary database read and written\n" + HELP)
        return 1
    if index_name and not verbose:
        silent = 1
    if not total and not unique and not distro:
        kmers = 1
    if distro > 65536:
        distro = 65536

    from genometester4_tpu.formats.gmerdb import load_text_db
    from genometester4_tpu.pipelines.gmercount import (
        DBCounter, format_counts, pair_median, write_index_db)

    # -D phase timing chatter, format-matched to the reference
    # (src/gmer_counter.c:284-446) with this pipeline's timings
    import time
    start_time = last_time = time.time()

    from genometester4_tpu.utils.gt4mmap import gt4_mmap_fail

    db = None
    if db_name is not None:
        mf = gt4_mmap_fail(db_name)
        if mf is not None:
            sys.stderr.write(mf)
            sys.stderr.write(f"Cannot mmap database file {db_name}\n")
            return 1
        if debug:
            sys.stderr.write(f"Loading text database {db_name}\n")
        db = load_text_db(db_name, max_kmers_per_node, 32 if big else 16)
        if db is None:
            # the reference prints the (NULL) -dbb pointer here, which
            # glibc renders as "(null)" (src/gmer_counter.c:305)
            sys.stderr.write("Cannot read text database (null)\n")
            return 1
        if debug:
            sys.stderr.write("Loading time (text): %.1fs\n"
                             % (time.time() - last_time))
        last_time = time.time()
    if dbb is not None:
        from genometester4_tpu.formats.gmerdb_binary import load_binary_db
        # debug line precedes the mmap in the binary branch (the text
        # branch is the other way around; src/gmer_counter.c:292-320)
        if debug:
            sys.stderr.write(f"Loading binary database {dbb}\n")
        mf = gt4_mmap_fail(dbb)
        if mf is not None:
            sys.stderr.write(mf)
            sys.stderr.write(f"Cannot mmap {dbb}\n")
            return 1
        db = load_binary_db(dbb)
        if db is None:
            sys.stderr.write(f"Cannot read binary database {dbb}\n")
            return 1
        if dump_index:
            _dump_db(dbb, db)
            return 0
        if debug:
            sys.stderr.write("Loading time (binary): %.1fs\n"
                             % (time.time() - last_time))
        last_time = time.time()
    if wdb is not None:
        from genometester4_tpu.formats.gmerdb_binary import write_binary_db
        if debug:
            sys.stderr.write(f"Writing binary database to {wdb}\n")
        # the reference fopen()s before touching the (possibly NULL)
        # db pointer (src/gmer_counter.c:350-358)
        try:
            f = open(wdb, "wb")
        except OSError:
            sys.stderr.write(f"Cannot open {wdb} for writing\n")
            return 1
        if db is None:
            # reference: write_db_to_file (NULL, ...) segfaults — not
            # an oracle; fail cleanly instead
            f.close()
            sys.stderr.write("Nothing to do!\n" + HELP)
            return 1
        with f:
            write_binary_db(db, f)
        if debug:
            sys.stderr.write("Done\n")
            sys.stderr.write("Writing time (database): %.1fs\n"
                             % (time.time() - last_time))
        last_time = time.time()

    if db is None:
        # counting sequences without any database segfaults upstream
        # (NULL db in read_file) — fail cleanly instead
        sys.stderr.write("Nothing to do!\n" + HELP)
        return 1

    if seqnames:
        counter = DBCounter(db, collect_stats=bool(stats),
                            build_index=bool(index_name))
        for path in seqnames:
            if path != "-" and not os.path.isfile(path):
                # the reference's reader fails inside read(2) and the
                # queue layer echoes the u32-wrapped -1
                # (src/fasta.c read loop + src/gmer_counter.c read_file)
                sys.stderr.write(
                    f"fasta_reader_read_nwords: Reader {path} read error "
                    "(-1) at 0\n"
                    f"read_file: Fasta reader {path} returned 4294967295\n")
                return 1
            counter.add_file(path)
            if debug and path != "-":
                _eof_reader_lines(path)
        counter.finalize()
        counts = counter.result.clamped(db.count_bits)
        if debug:
            sys.stderr.write("Reading time: %.1fs\n"
                             % (time.time() - last_time))
        last_time = time.time()

        read_index = None
        if index_name:
            read_index = write_index_db(db, counter, seqnames, index_name,
                                        debug=debug)
            if debug:
                sys.stderr.write("Index writing time: %.1fs\n"
                                 % (time.time() - last_time))
            last_time = time.time()

        if not silent:
            out = sys.stdout
            out.write(f"#gmer_counter version {REF_VERSION}\n")
            if db_name is not None:
                out.write(f"#TextDatabase\t{db_name}\n")
            if dbb is not None:
                out.write(f"#BinaryDatabase\t{dbb}\n")
            if dm:
                out.write(f"#PairMedian\t{pair_median(db, counts)}\n")
            if stats:
                st = counter.result.stats
                out.write(f"#LENGTH\t{st.n_seq}\n")
                out.write(f"#LENGTH_ACGT\t{st.n_nucl}\n")
                out.write("#GC\t%.3f\n" % (st.n_gc / st.n_nucl
                                           if st.n_nucl else float("nan")))
                out.write(f"#TOTAL_KMERS\t{st.n_kmers_total}\n")
                out.write(f"#LIST_KMERS\t{st.n_kmers}\n")
                denom = st.n_kmers * db.wordsize
                out.write("#LIST_KMER_GC\t%.3f\n" % (st.n_kmer_gc / denom
                                                     if denom else float("nan")))
            format_counts(db, counts, bool(total), bool(unique), bool(kmers),
                          distro, bool(header), out, read_index=read_index)
    if debug:
        sys.stderr.write("Total time: %.1fs\n" % (time.time() - start_time))
    return 0


def main(argv=None) -> int:
    import os
    import sys as _sys
    args = list(_sys.argv[1:] if argv is None else argv)
    # GT4_DIST_*: join the process group BEFORE anything initializes the
    # XLA backend; counting then shards chunks over the global mesh
    # (pipelines/gmercount.DBCounter) and only process 0 prints counts.
    # Env-gated inline like glistmaker's (multihost import costs numpy).
    if os.environ.get("GT4_DIST_COORD") \
            and int(os.environ.get("GT4_DIST_NPROCS", "1")) > 1:
        from genometester4_tpu.parallel.multihost import init_from_env
        if init_from_env():
            from genometester4_tpu.utils.lazyjax import ensure_jax
            if ensure_jax().process_index() != 0:
                _sys.stdout = open(os.devnull, "w")
    return _main_impl(args)


if __name__ == "__main__":
    raise SystemExit(main())
