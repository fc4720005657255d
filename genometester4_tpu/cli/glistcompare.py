"""glistcompare CLI — argv-, chrome- and sequencing-compatible with the
reference (src/glistcompare.c:84-430).

Every warning/error string, stream choice (help → stdout, errors →
stderr), exit code and op-sequencing quirk below is mirrored from the
reference main(); each block cites the line it reproduces.  Where the
reference runs into undefined behaviour (segfaults on unopenable
files, stack-garbage reads), we print the same stderr prefix it
produces up to the crash point and exit 1 — COVERAGE.md "Known gaps"
documents the divergence.
"""

from __future__ import annotations

import os
import sys
import time

from genometester4_tpu import __version__
from genometester4_tpu.cli._cstrtol import strtol, strtol_u32, strtoll_u64, i32

VERSION_LINE = 'glistcompare version 4.2.16 (stable)\n'
HELP = 'glistcompare version 4.2.16 (stable)\nUsage: glistcompare INPUTLIST1 [INPUTLIST2...] METHOD [OPTIONS]\nOptions:\n    -v, --version            - print version information and exit\n    -h, --help               - print this usage screen and exit\n    -u, --union              - union of input lists\n    -i, --intersection       - intersection of input lists\n    -d, --difference         - difference of input lists\n    -dd, --double_difference - double difference of input lists\n    -du, --diff_union        - subtract first list from the second and finds difference\n    -mm, --mismatch   NUMBER - specify number of mismatches (default 0, can be used with -diff and -ddiff)\n    -c, --cutoff NUMBER      - specify frequency cut-off (default 1)\n    -o, --outputname STRING  - specify output name (default "out")\n    -r, --rule STRING        - specify rule how final frequencies are calculated (default, add, subtract, min, max, first, second, 1, 2)\n                               NOTE: rules min, subtract, first and second can only be used with finding the intersection.\n    -ss, --subset METHOD SIZE - make subset with given method (rand, rand_unique, rand_weighted_unique)\n    --seed INTEGER           - Set seed of random number generator (default uses start time)\n    --count_only             - output count of k-mers instead of k-mers themself\n    --disable_scouts         - disable list read-ahead in background thread\n    --stream                 - read input as stream (do not memory map files)\n    -D                       - increase debug level\n'

MAX_FILES = 1024  # src/glistcompare.c:77

# enum Rules, src/glistcompare.c:45-54
(R_DEFAULT, R_ADD, R_SUBTRACT, R_MIN, R_MAX, R_FIRST, R_SECOND,
 R_NUMBER) = range(8)
_RULE_NAMES = {R_DEFAULT: "default", R_ADD: "add", R_SUBTRACT: "subtract",
               R_MIN: "min", R_MAX: "max", R_FIRST: "first",
               R_SECOND: "second", R_NUMBER: "number"}

_MAGIC_LIST = b"C4TG"   # GT4_LIST_CODE little-endian on disk
_MAGIC_INDEX = b"I4TG"  # GT4_INDEX_CODE


class _HelpExit(Exception):
    """print_help(exitvalue): usage screen to STDOUT, then exit
    (src/glistcompare.c:1171-1196)."""

    def __init__(self, code):
        self.code = code


def _help(code):
    raise _HelpExit(code)


def _probe_source(fn, prev_magic, stream_flag):
    """Mirror the reference's open/validate loop for one file
    (src/glistcompare.c:250-286 + word-map.c:165-217).

    Returns ``(wlen, n_words, magic)`` on success; on failure returns
    ``(None, None, magic)`` after printing exactly the stderr lines the
    reference produces.  ``prev_magic`` emulates the reused stack slot
    ``uint32_t code`` whose old bytes survive a short fread
    (src/glistcompare.c:255-262: fread of 4 bytes into an
    uninitialized-between-iterations automatic variable).
    """
    try:
        fh = open(fn, "rb")
    except OSError:
        # reference: prints this, then fread(NULL) segfaults
        # (src/glistcompare.c:256-262). We exit cleanly instead.
        sys.stderr.write(f"Error: Cannot open {fn}\n")
        raise SystemExit(1)
    head = fh.read(4)
    fh.close()
    magic = head + prev_magic[len(head):4]  # glibc fread keeps old tail bytes
    size = os.path.getsize(fn)

    def _u(buf, off, n):
        return int.from_bytes(buf[off:off + n], "little")

    bad = False
    if magic == _MAGIC_LIST and stream_flag:
        # gt4_word_list_stream_new validation (src/word-list-stream.c:
        # 128-166): full 48-byte header read, major version accepted
        # when <= 4, NO record-region size check.
        with open(fn, "rb") as f:
            hdr = f.read(48)
        if len(hdr) < 48:
            sys.stderr.write("gt4_word_list_stream_new: "
                             "could not read list header\n")
            bad = True
        elif _u(hdr, 4, 4) > 4:
            sys.stderr.write("gt4_word_list_stream_new: incompatible major "
                             f"version {_u(hdr, 4, 4)} (required 4)\n")
            bad = True
        else:
            return _u(hdr, 12, 4), _u(hdr, 16, 8), magic
    elif magic == _MAGIC_LIST:
        # gt4_word_map_new validation (src/word-map.c:165-217); mmap of
        # the file zero-fills reads past EOF inside the last page.
        with open(fn, "rb") as f:
            hdr = f.read(48)
        hdr = hdr + b"\0" * (48 - len(hdr))
        if size == 0:
            sys.stderr.write(f"gt4_word_map_new: could not mmap file {fn}\n")
            bad = True
        elif _u(hdr, 4, 4) != 4:
            sys.stderr.write("gt4_word_map_new: incompatible major version "
                             f"{_u(hdr, 4, 4)} (required 4)\n")
            bad = True
        else:
            vmin = _u(hdr, 8, 4)
            wlen = _u(hdr, 12, 4)
            n_words = _u(hdr, 16, 8)
            if vmin == 0:
                start, wb, cb = 40, 8, 4  # sizeof(_GT4ListHeader_4_0)
            elif vmin <= 2:
                start, wb, cb = _u(hdr, 32, 8), 8, 4
            else:
                start, wb, cb = _u(hdr, 32, 8), _u(hdr, 40, 4), _u(hdr, 44, 4)
            need = start + n_words * (wb + cb)
            if size < need:
                sys.stderr.write("gt4_word_map_new: file size too small "
                                 f"({size}, should be at least {need})\n")
                bad = True
            else:
                return wlen, n_words, magic
    elif magic == _MAGIC_INDEX:
        # gt4_index_map_new does NOT size-check (src/index-map.c:315-374)
        with open(fn, "rb") as f:
            hdr = f.read(48)
        hdr = hdr + b"\0" * (48 - len(hdr))
        if size == 0:
            sys.stderr.write(f"gt4_index_map_new: could not mmap file {fn}\n")
            bad = True
        elif _u(hdr, 4, 4) != 4:
            sys.stderr.write("gt4_index_map_new: incompatible major version "
                             f"{_u(hdr, 4, 4)} (required 4)\n")
            bad = True
        else:
            return _u(hdr, 12, 4), _u(hdr, 16, 8), magic
    else:
        sys.stderr.write(f"Error: File {fn} has unknown format\n")
    # az_object_get_interface on the NULL/garbage object: az asserts
    # (non-fatally) then the caller reports corruption
    # (src/glistcompare.c:271-279, az/object.c:115)
    sys.stderr.write("File az/object.c line 115 (?): "
                     "Assertion obj != NULL failed\n")
    sys.stderr.write(f"Error: File {fn} is invalid or corrupted\n")
    return None, None, magic


def _main_impl(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        _help(1)  # src/glistcompare.c:103-105

    files: list[str] = []
    cutoff, nmm = 1, 0          # unsigned int
    find_union = find_intrsec = find_diff = find_ddiff = False
    subtraction = countonly = print_operation = False
    rule = R_DEFAULT
    count_override = 1
    outputname = "out"
    find_subset = False
    subset_method = "rand"
    subset_size = 0
    seed = -1
    stream = False
    debug = 0

    n = len(argv)
    i = 0
    while i < n:
        a = argv[i]
        if not a.startswith("-"):
            if len(files) >= MAX_FILES:
                sys.stderr.write(f"Too many file arguments (max {MAX_FILES})\n")
                _help(1)
            files.append(a)
        elif a in ("-v", "--version"):
            sys.stdout.write(VERSION_LINE)
            return 0
        elif a in ("-h", "--help", "-?"):
            _help(0)
        elif a in ("-o", "--outputname"):
            # a following flag-like token is consumed AND skipped
            # (src/glistcompare.c:122-128: arg_idx += 1 in the warning
            # branch too — `-o -u` swallows the -u)
            if i + 1 >= n or argv[i + 1].startswith("-"):
                sys.stderr.write("Warning: No output name specified!\n")
                i += 1
            else:
                outputname = argv[i + 1]
                i += 1
        elif a in ("-c", "--cutoff"):
            if i + 1 >= n:
                sys.stderr.write("Warning: No frequency cut-off specified! "
                                 f"Using the default value: {i32(cutoff)}.\n")
            else:
                v, ok = strtol_u32(argv[i + 1])
                if not ok:
                    sys.stderr.write(f"Error: Invalid frequency cut-off: "
                                     f"{argv[i + 1]}! Must be an integer.\n")
                    _help(1)
                cutoff = v
                i += 1
        elif a in ("-mm", "--mismatch"):
            if i + 1 >= n:
                # no trailing newline in the reference (glistcompare.c:143)
                sys.stderr.write("Warning: No number of mismatches specified!")
            else:
                v, ok = strtol_u32(argv[i + 1])
                if not ok:
                    sys.stderr.write(f"Error: Invalid number of mismatches: "
                                     f"{argv[i + 1]}! Must be an integer.\n")
                    _help(1)
                nmm = v
                i += 1
        elif a in ("-u", "--union"):
            find_union = True
        elif a in ("-i", "--intersection"):
            find_intrsec = True
        elif a in ("-d", "--difference"):
            find_diff = True
        elif a in ("-dd", "--double_difference"):
            find_ddiff = True
        elif a in ("-du", "--diff_union"):
            find_diff = True
            subtraction = True
        elif a == "--count_only":
            countonly = True
        elif a in ("-r", "--rule"):
            i += 1
            if i >= n:
                _help(1)
            r = argv[i]
            if r[:1] in "123456789":
                rule = R_NUMBER
                # strtol with no end-check (src/glistcompare.c:170-172)
                count_override = strtol(r)[0] & 0xFFFFFFFF
            elif r == "default":
                rule = R_DEFAULT
            elif r in ("add", "sum"):
                rule = R_ADD
            elif r == "subtract":
                rule = R_SUBTRACT
            elif r == "min":
                rule = R_MIN
            elif r == "max":
                rule = R_MAX
            elif r == "first":
                rule = R_FIRST
            elif r == "second":
                rule = R_SECOND
            # unknown strings silently keep the previous rule
        elif a in ("-ss", "--subset"):
            find_subset = True
            i += 1
            if i >= n:
                _help(1)
            if argv[i] in ("rand", "rand_unique", "rand_weighted_unique"):
                subset_method = argv[i]
            else:
                _help(1)
            i += 1
            if i >= n:
                _help(1)
            v, ok = strtoll_u64(argv[i])
            if not ok:
                sys.stderr.write(f"Error: Invalid subset size: {argv[i]}! "
                                 "Must be an integer.\n")
                _help(1)
            subset_size = v
        elif a == "--seed":
            i += 1
            if i >= n:
                _help(1)
            seed = strtol(argv[i])[0]  # strtoll, NO end-check
        elif a == "--print_operation":
            print_operation = True
        elif a == "--disable_scouts":
            pass  # scouts obviated: batched reads need no mmap prefetcher
        elif a == "--stream":
            stream = True
        elif a == "-D":
            debug += 1
        else:
            sys.stderr.write(f"Unknown argument: {a}!\n")
            _help(1)
        i += 1

    if debug:
        sys.stderr.write(f"Rule: {rule}\n")
        sys.stderr.write(f"Num files: {len(files)}\n")

    if seed == -1:
        seed = int(time.time()) & 0xFFFFFFFF  # (unsigned int) time(NULL)

    # Subset/mismatches force mapping (src/glistcompare.c:244-247)
    if nmm or find_subset:
        if stream:
            sys.stderr.write("Warning: Subset and mismatches are incompatible "
                             "with streaming, using mapping\n")
        stream = False

    # Open/validate every input up front (src/glistcompare.c:250-289)
    wlen = 0
    err = False
    n_words_of: list[int] = []
    prev_magic = b"\xde\xad\xbe\xef"  # stack garbage stand-in: first-file
    have_prev = False                 # short reads can't fake a real magic
    for fn in files:
        fwlen, fnw, prev_magic = _probe_source(fn, prev_magic, stream)
        if fwlen is None:
            err = True
            if not have_prev:
                # reference dereferences the uninitialized interface
                # pointer here and segfaults (glistcompare.c:280-286);
                # clean exit with the same stderr prefix
                return 1
            n_words_of.append(0)
            continue  # stale inst: word-length check vacuously passes
        have_prev = True
        n_words_of.append(fnw)
        if not wlen:
            wlen = fwlen
        elif fwlen != wlen:
            sys.stderr.write(f"Error: File {fn} has different word length "
                             f"({fwlen} != {wlen})\n")
            err = True
    if err:
        sys.stderr.write("Stopping...\n")
        return 1

    # Subset (src/glistcompare.c:291-315)
    if find_subset:
        if len(files) != 1:
            sys.stderr.write("Error: Subsetting multiple files is not supported\n")
            return 1
        if (subset_method in ("rand_unique", "rand_weighted_unique")
                and subset_size > n_words_of[0]):
            sys.stderr.write(f"Error: Unique subset size ({subset_size}) is "
                             "bigger than number of unique kmers "
                             f"({n_words_of[0]})\n")
            return 1
        # numpy-free fast path (plain .list inputs): the native pass
        # starts before any numpy import (pipelines/subset_fast.py)
        from genometester4_tpu.pipelines.subset_fast import try_fast_subset
        if try_fast_subset(files[0], subset_method, subset_size,
                           outputname, seed) is not None:
            return 0
        from genometester4_tpu.pipelines import listcompare as lc
        lc.make_subset(files[0], subset_method, subset_size, outputname,
                       seed)
        return 0

    # numpy (~0.25 s under the bin/ -S launchers) stays unimported until
    # a path that needs it runs: the multi-op fast path and all error/
    # chrome exits below are numpy-free
    class _LazyLC:
        def __getattr__(self, name):
            from genometester4_tpu.pipelines import listcompare
            return getattr(listcompare, name)
    lc = _LazyLC()

    if len(files) < 2:
        sys.stderr.write("Error: At least 2 list/index files are needed\n")
        return 1

    if len(files) > 2:
        if not (find_union or find_intrsec) or find_diff or find_ddiff:
            sys.stderr.write("Error: Algorithm incompatible with multiple files!\n")
            _help(1)
        if nmm:
            sys.stderr.write("Error: Multiple files are not compatible with mismatches!\n")
            _help(1)

    if find_ddiff:
        find_diff = True

    # Parameter cross-checks (src/glistcompare.c:336-351)
    if not find_diff and nmm:
        sys.stderr.write("Warning: Number of mismatches are not used!\n")
    if not find_diff and subtraction:
        sys.stderr.write("Warning: Subtraction is not used!\n")
    if len(outputname) > 200:
        sys.stderr.write("Error: Output name exceeds the 200 character limit.\n")
        return 1
    if not find_intrsec and rule in (R_MIN, R_FIRST, R_SECOND):
        sys.stderr.write("Error: Rules min, fist and second can only be used "
                         "with finding the intersection.\n")
        return 1
    if (not find_intrsec and not find_diff) and rule == R_SUBTRACT:
        sys.stderr.write("Error: Rule subtract can only be used with "
                         "intersection and difference.\n")
        return 1

    if print_operation:  # src/glistcompare.c:354-359
        ops_str = (("U" if find_union else "") + ("I" if find_intrsec else "")
                   + ("D" if find_diff else "") + ("X" if find_ddiff else ""))
        sys.stdout.write(f"Operation\t{ops_str}\trule\t{rule}\nFiles\t"
                         f"{len(files)}\n")
        for idx, fn in enumerate(files):
            sys.stdout.write(f"{idx}\t{fn}\n")

    rule_name = _RULE_NAMES[rule]

    if nmm:
        # mismatch path ignores union/intersection AND the rule
        # (src/glistcompare.c:362-363, compare_wordmaps_mm never reads it)
        ops = (["diff1"] if find_diff else []) + (["diff2"] if find_ddiff else [])
        if debug:
            _print_mm_debug(files, n_words_of)
        res = lc.compare_pair_mm(files[0], files[1], ops, outputname, cutoff,
                                 nmm, subtraction, countonly, debug=debug)
        if countonly:
            for op in ops:
                nu, t = res[op]
                sys.stdout.write(f"NUnique\t{nu}\nNTotal\t{t}\n")
        return 0

    if len(files) == 2:
        ops = ((["union"] if find_union else [])
               + (["intrsec"] if find_intrsec else [])
               + (["diff1"] if find_diff else [])
               + (["diff2"] if find_ddiff else []))
        if debug:
            sys.stderr.write(f"compare_wordmaps: methods {int(find_union)}/"
                             f"{int(find_intrsec)}/{int(find_diff)}/"
                             f"{int(find_ddiff)}\n")
            sys.stderr.write(f"compare_wordmaps: List 1: {n_words_of[0]} entries\n")
            # ';' typo preserved from src/glistcompare.c:810
            sys.stderr.write(f"compare_wordmaps; List 2: {n_words_of[1]} entries\n")
        # no methods selected → the zipper writes nothing, exit 0
        # (src/glistcompare.c:365 with all find_* == 0)
        if ops:
            res = lc.compare_pair(files[0], files[1], ops, outputname, cutoff,
                                  rule_name, count_override, subtraction,
                                  countonly)
            if countonly:
                for op in ops:
                    nu, t = res[op]
                    sys.stdout.write(f"NUnique\t{nu}\nNTotal\t{t}\n")
            elif debug:
                # only the diff outputs announce their atomic publish
                # (src/glistcompare.c:936-950)
                from genometester4_tpu.pipelines.listcompare import \
                    _op_filename
                wlen = lc.read_word_source(files[0])[0].word_length
                for op in ops:
                    if op in ("diff1", "diff2"):
                        name = _op_filename(outputname, wlen, op, 0)
                        sys.stderr.write(f"Renaming {name}.tmp to {name}\n")
        return 0

    # Multi-file: union then intersection, each with its own rule
    # validation; v holds only the LAST op's status
    # (src/glistcompare.c:367-423: v is overwritten per op)
    v = 0
    if find_union:
        if rule not in (R_DEFAULT, R_ADD, R_MAX, R_NUMBER):
            sys.stderr.write(f"union_multi: Invalid rule {rule} "
                             "(only ADD, MAX and NUMBER allowed)\n")
            v = 1
            if countonly or debug:
                # header is never initialized on this path; the stack
                # page is zero (src/glistcompare.c:368,394 — stable UB)
                sys.stdout.write("NUnique\t0\nNTotal\t0\n")
        else:
            import time as _time
            _t0 = _time.time()
            # numpy-free fast path for plain .list inputs (the merge is
            # the same native kernel; pipelines/setops_stream.py)
            from genometester4_tpu.pipelines.setops_stream import \
                try_fast_multi
            res = try_fast_multi(files, "union", outputname, cutoff,
                                 rule_name, count_override, countonly,
                                 debug)
            if res is None:
                res = lc.compare_multi(files, "union", outputname, cutoff,
                                       rule_name, count_override,
                                       countonly, debug=debug)
            v = 0
            nu, t = res["union"]
            if debug:
                # format-matched throughput line with THIS pipeline's
                # timing (src/glistcompare.c:599)
                _dt = max(_time.time() - _t0, 1e-9)
                _inp = sum(n_words_of)
                sys.stderr.write(
                    "Combined %u maps: input %llu (%.3f Mwords/s) output "
                    "%llu (%.3f Mwords/s)\n".replace("%u", "%d")
                    .replace("%llu", "%d")
                    % (len(files), _inp, _inp / (1000000 * _dt),
                       nu, nu / (1000000 * _dt)))
            if countonly or debug:
                sys.stdout.write(f"NUnique\t{nu}\nNTotal\t{t}\n")
    if find_intrsec:
        if rule not in (R_DEFAULT, R_ADD, R_MIN, R_MAX, R_NUMBER):
            sys.stderr.write(f"intersect_multi: Invalid rule {rule} "
                             "(only ADD, MIN, MAX and NUMBER allowed)\n")
            v = 1
            if countonly or debug:
                sys.stdout.write("NUnique\t0\nNTotal\t0\n")
        else:
            import time as _time
            _t0 = _time.time()
            from genometester4_tpu.pipelines.setops_stream import \
                try_fast_multi
            res = try_fast_multi(files, "intrsec", outputname, cutoff,
                                 rule_name, count_override, countonly,
                                 debug)
            if res is None:
                res = lc.compare_multi(files, "intrsec", outputname,
                                       cutoff, rule_name, count_override,
                                       countonly, debug=debug)
            v = 0
            nu, t = res["intrsec"]
            if debug:
                # src/glistcompare.c:713
                _dt = max(_time.time() - _t0, 1e-9)
                _inp = sum(n_words_of)
                sys.stderr.write(
                    "Combined %u maps: input %llu (%.3f Mwords/s) output "
                    "%llu (%.3f Mwords/s)\n".replace("%u", "%d")
                    .replace("%llu", "%d")
                    % (len(files), _inp, _inp / (1000000 * _dt),
                       nu, nu / (1000000 * _dt)))
            if countonly or debug:
                sys.stdout.write(f"NUnique\t{nu}\nNTotal\t{t}\n")
    # print_error_message(1) prints nothing (src/common.c:28-31)
    return 1 if v else 0


def _print_mm_debug(files, n_words_of):
    sys.stderr.write(f"compare_wordmaps: List 1: {n_words_of[0]} entries\n")
    sys.stderr.write(f"compare_wordmaps; List 2: {n_words_of[1]} entries\n")


def main(argv=None) -> int:
    import os

    # GT4_DIST_*: join the process group BEFORE anything initializes the
    # XLA backend; set ops then run SPMD over the global mesh and only
    # process 0 writes files / prints counts (pipelines/listcompare.py).
    # Env-gated inline like glistmaker's: importing multihost just to
    # check the variables costs the numpy import on single-host runs.
    if os.environ.get("GT4_DIST_COORD") \
            and int(os.environ.get("GT4_DIST_NPROCS", "1")) > 1:
        from genometester4_tpu.parallel.multihost import init_from_env
        if init_from_env():
            from genometester4_tpu.utils.lazyjax import ensure_jax
            if ensure_jax().process_index() != 0:
                sys.stdout = open(os.devnull, "w")

    try:
        return _main_impl(argv)
    except _HelpExit as e:
        sys.stdout.write(HELP)
        return e.code


if __name__ == "__main__":
    raise SystemExit(main())
