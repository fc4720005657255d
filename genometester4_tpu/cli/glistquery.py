"""glistquery CLI — flag-compatible with the reference
(src/glistquery.c:124-260).
"""

from __future__ import annotations

import sys

from genometester4_tpu import __version__

VERSION_LINE = 'glistquery version 4.2.16 (stable)\n'
HELP = "glistquery version 4.2.16 (stable)\nUsage: glistquery INPUT_LIST [OPTIONS]\nOptions:\n    -v, --version             - print version information and exit\n    -h, --help                - print this usage screen and exit\n    -stat, --stats            - print statistics of the list file and exit\n    --median                  - print min/max/median/average and exit\n    --distribution MAX        - print distribution up to MAX\n    --gc                      - print average GC content of all words\n    -q, --query               - single query word\n    -f, --queryfile           - list of query words in a file\n    -s, --seqfile             - FastA/FastQ file\n    -l, --listfile            - list file made by glistmaker\n    -mm, --mismatch NUMBER    - specify number of mismatches (0-16; default 0)\n    -p, --perfectmatch NUMBER - specify number of 3' perfect matches (0-32; default 0)\n    -min, --minfreq NUMBER    - minimum frequency of the printed words (default 0)\n    -max, --maxfreq NUMBER    - maximum frequency of the printed words (default MAX_UINT)\n    --files                   - Print indexed files\n    --sequences               - Print indexed subsequences\n    --bloom                   - use bloom filter to speed up lookups\n    --all                     - in case of mismatches prints all found words\n    --locations               - in case of index print all word locations\n    --3p                      - if query is longer than word use 3' end\n    --5p                      - if query is longer than word use 5' end\n    -D                        - increase debug level\n"


def _main_impl(argv=None) -> int:
    from genometester4_tpu.cli._cstrtol import i32 as _i32
    from genometester4_tpu.cli._cstrtol import strtol as _strtol
    from genometester4_tpu.cli._cstrtol import strtol_u32 as _strtol_u32

    argv = list(sys.argv[1:] if argv is None else argv)
    lists: list[str] = []
    querystring = queryfilename = seqfilename = querylistfilename = None
    nmm = pm3 = 0
    printall = False
    print_header = False
    minfreq, maxfreq = 0, 0xFFFFFFFF
    distro = 0
    command = "query"
    is_union = False
    locations = False
    use_3p = use_5p = False
    debug = 0

    def _optarg(i):
        if i + 1 >= len(argv) or argv[i + 1].startswith("-"):
            return None
        return argv[i + 1]

    i = 0
    try:
        while i < len(argv):
            a = argv[i]
            if a in ("-v", "--version"):
                sys.stdout.write(VERSION_LINE)
                return 0
            elif a in ("-h", "--help", "-?"):
                sys.stderr.write(HELP)
                return 0
            elif a in ("-s", "--seqfile"):
                v = _optarg(i)
                if v is None:
                    sys.stderr.write("Warning: No sequence file name specified!\n")
                else:
                    seqfilename = v
                i += 1
            elif a in ("-l", "--listfile"):
                v = _optarg(i)
                if v is None:
                    sys.stderr.write("Warning: No query list file name specified!\n")
                else:
                    querylistfilename = v
                i += 1
            elif a in ("-f", "--queryfile"):
                v = _optarg(i)
                if v is None:
                    sys.stderr.write("Warning: No query file name specified!\n")
                else:
                    queryfilename = v
                i += 1
            elif a in ("-q", "--query"):
                v = _optarg(i)
                if v is None:
                    sys.stderr.write("Warning: No query specified!\n")
                else:
                    querystring = v
                i += 1
            elif a in ("-p", "--perfectmatch"):
                i += 1
                # unsigned int pm3: the (pm3 < 0) check is dead and the
                # u32 truncation wraps first (src/glistquery.c:114,170)
                pm3, ok = _strtol_u32(argv[i])
                if not ok or pm3 > 32:
                    sys.stderr.write(HELP)
                    return 1
            elif a in ("-mm", "--mismatch"):
                i += 1
                nmm, ok = _strtol_u32(argv[i])
                if not ok or nmm > 16:
                    sys.stderr.write(HELP)
                    return 1
            elif a in ("-min", "--minfreq"):
                if i + 1 >= len(argv):
                    sys.stderr.write("Warning: No minimum frequency "
                                     "specified! Using the default value: "
                                     "%d.\n" % _i32(minfreq))
                    i += 1
                    continue
                minfreq, ok = _strtol(argv[i + 1])
                if not ok:
                    sys.stderr.write("Error: Invalid minimum frequency: "
                                     f"{argv[i + 1]}! Must be a positive "
                                     "integer.\n" + HELP)
                    return 1
                i += 1
            elif a in ("-max", "--maxfreq"):
                if i + 1 >= len(argv):
                    # %d of the UINT_MAX default prints -1
                    sys.stderr.write("Warning: No maximum frequency "
                                     "specified! Using the default value: "
                                     "%d.\n" % _i32(maxfreq))
                    i += 1
                    continue
                maxfreq, ok = _strtol(argv[i + 1])
                if not ok:
                    sys.stderr.write("Error: Invalid maximum frequency: "
                                     f"{argv[i + 1]}! Must be a positive "
                                     "integer.\n" + HELP)
                    return 1
                i += 1
            elif a == "-D":
                debug += 1
            elif a in ("--all", "-all"):
                printall = True
            elif a in ("--stats", "--stat", "-stat"):
                command = "stats"
            elif a in ("--median", "-median"):
                command = "median"
            elif a in ("--distribution", "-distribution"):
                i += 1
                # no *end validation here, unlike -p/-mm/-min/-max
                # (src/glistquery.c:223-224)
                distro = _strtol(argv[i])[0]
                command = "distro"
            elif a in ("-gc", "--gc"):
                command = "gc"
            elif a == "--files":
                command = "files"
            elif a == "--sequences":
                command = "sequences"
            elif a == "--locations":
                locations = True
            elif a == "--3p":
                use_3p = True
            elif a == "--5p":
                use_5p = True
            elif a == "--header":
                print_header = True
            elif a in ("--bloom", "--is_union", "--disable_scouts"):
                is_union = is_union or a == "--is_union"
            elif not a.startswith("-"):
                lists.append(a)
            else:
                sys.stderr.write(f"Error: Unknown argument: {a}!\n" + HELP)
                return 1
            i += 1
    except (IndexError, ValueError):
        sys.stderr.write(HELP)
        return 1

    if not lists:
        sys.stderr.write("No list/index files specified!\n" + HELP)
        return 1

    if command in ("stats", "median", "distro", "gc") and not debug:
        # numpy-free stat paths: header read + at most one native pass
        # (skipped under -D so the generic loop prints its load chrome)
        # (the numpy import alone costs ~240 ms under the -S
        # launchers). Returns None -> generic pipeline (error chrome,
        # index counts, odd headers).
        from genometester4_tpu.pipelines.list_stats_fast import \
            try_fast_stats
        rc = try_fast_stats(command, lists, distro)
        if rc is not None:
            return rc

    from genometester4_tpu.pipelines import listquery as lq
    from genometester4_tpu.formats.list_format import GT4_LIST_CODE
    from genometester4_tpu.formats.index_format import GT4_INDEX_CODE

    maps = []
    wlen = 0
    invalid = False
    has_lists = False
    for p in lists:
        try:
            with open(p, "rb") as f:
                import struct
                head4 = f.read(4)
                # <4 bytes: the reference's fread fails and leaves the
                # code variable uninitialized (src/glistquery.c:285) —
                # in practice never the magic, so the invalid branch
                code = (struct.unpack("<I", head4)[0]
                        if len(head4) == 4 else 0)
        except OSError:
            sys.stderr.write(f"Cannot open list {p}\n")
            return 1
        if code in (GT4_LIST_CODE, GT4_INDEX_CODE):
            try:
                if code == GT4_LIST_CODE:
                    m = lq.ListQuery(p)
                    if debug:
                        sys.stderr.write(f"List {p} loaded\n")
                    has_lists = True
                else:
                    m = lq.IndexQuery(p)
                    m.print_locations = locations
            except (lq.ListFileError, MemoryError, OverflowError):
                # constructor returned NULL (diagnostic already on
                # stderr); src/glistquery.c:302-304
                sys.stderr.write(f"Error: {p} is invalid or corrupted\n")
                invalid = True
                continue
        else:
            sys.stderr.write(f"Error: {p} is not a valid GenomeTester4 "
                             "list/index file\n")
            # maps[i] stays NULL, so the reference ALSO prints the
            # corrupted line for a bad-magic file (src/glistquery.c:299-304)
            sys.stderr.write(f"Error: {p} is invalid or corrupted\n")
            invalid = True
            continue
        if not wlen:
            wlen = m.k
        elif m.k != wlen:
            sys.stderr.write(f"Error: {p} has different word length {m.k} "
                             f"(first list had {wlen})\n")
            invalid = True
        maps.append(m)
    # the query list stream is opened BEFORE the invalid exit
    # (src/glistquery.c:318-337), so its constructor chrome shows even
    # when the searched lists already failed
    if querylistfilename is not None:
        qerr = None
        qk = None
        try:
            with open(querylistfilename, "rb") as f:
                qhead = f.read(48)
        except OSError:
            qerr = ("gt4_word_list_stream_new: could not open file "
                    f"{querylistfilename}\n")
        else:
            if len(qhead) < 48:
                qerr = ("gt4_word_list_stream_new: could not read list "
                        "header\n")
            else:
                import struct
                qcode, qmaj = struct.unpack_from("<II", qhead, 0)
                qk = struct.unpack_from("<I", qhead, 12)[0]
                if qcode != GT4_LIST_CODE:
                    qerr = ("gt4_word_list_stream_new: invalid file tag "
                            f"({qcode:x}, should be {GT4_LIST_CODE:x})\n")
                elif qmaj != 4:
                    qerr = ("gt4_word_list_stream_new: incompatible major "
                            f"version {qmaj} (required 4)\n")
        if qerr is not None:
            sys.stderr.write(qerr)
            sys.stderr.write(f"Error: {querylistfilename} is invalid or "
                             "corrupted\n")
            invalid = True
        elif qk != wlen:
            sys.stderr.write(f"Error: {querylistfilename} has different "
                             f"word length {qk} (first list had {wlen})\n")
            invalid = True
    if invalid:
        return 1

    if command == "stats":
        for m in maps:
            lq.get_statistics(m)
        return 0
    if command == "median":
        for m in maps:
            lq.print_median(m, debug=debug)
        return 0
    if command == "distro":
        for m in maps:
            lq.print_distro(m, distro + 1)
        return 0
    if command == "gc":
        for m in maps:
            lq.print_gc(m)
        return 0
    if command in ("files", "sequences"):
        if has_lists or len(maps) > 1:
            sys.stderr.write(
                f"Error: {command.capitalize()} can only be queried "
                "from single index\n")
            return 1
        if command == "files":
            lq.print_files(maps[0].index_map)
        else:
            lq.print_sequences(maps[0].index_map)
        return 0

    if not (seqfilename or querylistfilename or queryfilename or querystring):
        if len(maps) > 1:
            lq.dump_lists(maps, is_union,
                          lists if print_header else None)
        else:
            lq.print_full_map(maps[0])
        return 0

    if querylistfilename and len(maps) > 1:
        if nmm or pm3:
            sys.stderr.write("Error: Searching multiple lists is incompatible "
                             "with mismatches\n")
            return 1
        return lq.search_lists_multi(querylistfilename, maps)

    if len(maps) > 1:
        sys.stderr.write("Error: Query is incompatible with multiple "
                         "lists/indices\n")
        return 1
    if nmm + pm3 > wlen:
        sys.stderr.write(f"Error: Number of mismatches ({nmm}) and 3' perfect "
                         f"match ({pm3}) are longer than word length {wlen}\n")
        return 1

    if querystring:
        return lq.search_one_query_string(maps[0], querystring, nmm, pm3,
                                          minfreq, maxfreq, printall, use_3p,
                                          use_5p)
    if queryfilename:
        return lq.search_query_file(maps[0], queryfilename, nmm, pm3, minfreq,
                                    maxfreq, printall, use_3p, use_5p)
    if seqfilename:
        return lq.search_fasta(maps[0], seqfilename, nmm, pm3, minfreq,
                               maxfreq, printall)
    if querylistfilename:
        return lq.search_list(maps[0], querylistfilename, nmm, pm3, minfreq,
                              maxfreq, printall)
    return 0


def main(argv=None) -> int:
    try:
        return _main_impl(argv)
    except Exception as e:
        # lazy record loads can hit the corrupt-file path after
        # construction; the reference segfaults on such files
        # (12-byte record macros walk unmapped garbage,
        # src/word-map.h:110), so any clean exit is acceptable —
        # match the corrupted-line chrome
        from genometester4_tpu.formats.list_format import ListFileError
        if not isinstance(e, ListFileError):
            raise
        sys.stderr.write(f"Error: {e.args[0]} is invalid or corrupted\n")
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
