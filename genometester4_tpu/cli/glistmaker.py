"""glistmaker CLI — flag-compatible with the reference
(src/glistmaker.c:158-228; defaults src/glistmaker.c:49-52,106-108).

Usage: glistmaker <INPUTFILES> [OPTIONS]
"""

from __future__ import annotations

import re
import sys

from genometester4_tpu import __version__

_STRTOL_RE = re.compile(r"\s*[+-]?[0-9]+")


def _strtol_u32(s: str):
    """glibc ``strtol(arg, &end, 10)`` twin, truncated to C unsigned int.

    Returns ``(value_u32, end_ok)`` where ``end_ok`` mirrors the only
    check the reference makes, ``*end == 0`` (src/glistmaker.c:170-213):
    trailing junk fails, an EMPTY string "converts" to 0 with end still
    at the terminator (accepted), whitespace-only does not."""
    m = _STRTOL_RE.match(s)
    if m is None:
        return 0, s == ""
    if m.end() != len(s):
        return 0, False
    v = int(m.group())
    v = min(max(v, -2**63), 2**63 - 1)  # strtol clamps to long range
    return v & 0xFFFFFFFF, True


def _i32(u: int) -> int:
    """Value a C ``%d`` prints for an unsigned-int variable."""
    return u - 0x100000000 if u >= 0x80000000 else u

VERSION_LINE = 'glistmaker version 4.2.16 (stable)\n'
HELP = 'glistmaker version 4.2.16 (stable)\nUsage: glistmaker <INPUTFILES> [OPTIONS]\nOptions:\n    -v, --version           - print version information and exit\n    -h, --help              - print this usage screen and exit\n    -w, --wordlength NUMBER - specify index wordsize (1-32)\n    -o, --outputname STRING - specify output name (default "out")\n    --index                 - create index instead of list\n    --num_threads           - number of threads (default 8)\n    --max_tables            - maximum number of temporary tables (default 4096)\n    --table_size            - maximum size of the temporary table (default 1048576)\n    --tmpdir                - directory for temporary files (may need an order of magnitude more space than the size of the final list)\n    --stream                - read files as streams instead of memory-mapping (slower but uses less virtual memory)\n    --index                 - creates indexed list (larger and slower)\n    -D                      - increase debug level\n'


def _main_impl(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    inputs: list[str] = []
    wordlength = 0
    cutoff = 1
    maxfreq = 0xFFFFFFFF
    outputname = "out"
    create_index = False
    debug = 0
    # C variables mirrored for the -D header block
    # (src/glistmaker.c:47-52,148-150): defaults 8 / 4096 / 1 Mi
    nthreads_c = 8
    ntables_c = 32 * 128
    tablesize_c = 1024 * 1024
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
            elif a in ("-o", "--outputname"):
                i += 1
                outputname = argv[i]
            elif a in ("-w", "--wordlength"):
                i += 1
                wordlength, ok = _strtol_u32(argv[i])
                if not ok:
                    sys.stderr.write(f"Error: Invalid word-length: {argv[i]}!"
                                     " Must be an integer.\n" + HELP)
                    return 1
            elif a in ("-c", "--cutoff", "--min"):
                i += 1
                cutoff, ok = _strtol_u32(argv[i])
                if not ok:
                    sys.stderr.write("Error: Invalid frequency cut-off: "
                                     f"{argv[i]}! Must be an integer.\n" + HELP)
                    return 1
            elif a == "--max":
                i += 1
                maxfreq, ok = _strtol_u32(argv[i])
                if not ok:
                    sys.stderr.write("Error: Invalid frequency cut-off: "
                                     f"{argv[i]}! Must be an integer.\n" + HELP)
                    return 1
            elif a == "--num_threads":
                i += 1  # value ignored: scheduling is XLA's/our host lib's job
                nthreads_c, ok = _strtol_u32(argv[i])
                if not ok:
                    sys.stderr.write(f"Error: Invalid num-threads: {argv[i]}!"
                                     " Must be an integer.\n" + HELP)
                    return 1
            elif a == "--max_tables":
                i += 1
                ntables_c, ok = _strtol_u32(argv[i])
                if not ok:
                    sys.stderr.write(f"Error: Invalid max_tables: {argv[i]}!"
                                     " Must be an integer.\n" + HELP)
                    return 1
            elif a == "--table_size":
                i += 1
                tablesize_c, ok = _strtol_u32(argv[i])
                if not ok:
                    sys.stderr.write(f"Error: Invalid table-size: {argv[i]}!"
                                     " Must be an integer.\n" + HELP)
                    return 1
                # bug-compat: the reference advances PAST the value a
                # second time, silently swallowing the next argument
                # (src/glistmaker.c:204-211 has a stray `i += 1` inside
                # the branch on top of the loop increment)
                i += 1
            elif a == "--tmpdir":
                i += 1
                _ = argv[i]  # value accepted; missing value → usage screen
            elif a == "--index":
                create_index = True
            elif a == "--stream":
                pass
            elif a == "-D":
                debug += 1
            elif a.startswith("-") and len(a) > 1:
                sys.stderr.write(HELP)
                return 1
            else:
                inputs.append(a)
            i += 1
    except IndexError:
        # flag at end of argv with its value missing: print_help(1)
        sys.stderr.write(HELP)
        return 1

    if not inputs:
        sys.stderr.write("Error: No FastA/FastQ file specified!\n" + HELP)
        return 1
    if not 1 <= wordlength <= 32:   # wordlength is unsigned (C semantics)
        sys.stderr.write(f"Error: Invalid word-length {_i32(wordlength)} "
                         "(must be 1 - 32)!\n" + HELP)
        return 1
    if cutoff < 1:                  # unsigned: only 0 trips this
        sys.stderr.write(f"Error: Invalid frequency cut-off: {_i32(cutoff)}! "
                         "Must be positive.\n" + HELP)
        return 1
    if maxfreq < cutoff:            # unsigned comparison, %u-%u print
        sys.stderr.write(f"Error: Invalid frequency range: "
                         f"{cutoff}-{maxfreq}!\n" + HELP)
        return 1
    if len(outputname) > 200:
        # reference: no trailing newline, no usage screen
        sys.stderr.write("Error: Output name exceeds the 200 character "
                         "limit.")
        return 1

    import os

    from genometester4_tpu.pipelines.listmaker import make_list

    total_size = 0
    for p in inputs:
        if p == "-":
            continue
        try:
            total_size += os.stat(p).st_size
        except OSError:
            sys.stderr.write(f"main: No such file (cannot stat): {p}\n")
            return 1
    if debug:
        # header block with the C clamps applied
        # (src/glistmaker.c:230,253,265-270)
        if ntables_c > 256:
            ntables_c = 256
        if nthreads_c > 256:
            nthreads_c = 256
        if total_size < 100000:
            nthreads_c = 1
        sys.stderr.write("Total file size %d\n" % total_size)
        sys.stderr.write("Num threads is %d\n" % nthreads_c)
        sys.stderr.write("Num tables is %d\n" % ntables_c)
        sys.stderr.write("Table size is %d\n" % tablesize_c)

    if create_index:
        from genometester4_tpu.pipelines.listmaker import make_index
        out_path = f"{outputname}_{wordlength}.index"
        make_index(inputs, wordlength, out_path, min_count=cutoff,
                   max_count=maxfreq)
        return 0

    # bug-compat: the reference parses and validates -c/--max but never
    # applies them to .list output — gt4_write_union is called with a
    # hardcoded cutoff of 1 (src/glistmaker.c:333,814); min/max only
    # reach the --index writer (src/glistmaker.c:486)
    out_path = f"{outputname}_{wordlength}.list"
    make_list(inputs, wordlength, out_path, debug=debug)
    return 0


def main(argv=None) -> int:
    import os

    # GT4_DIST_*: join the process group BEFORE anything can initialize
    # the XLA backend (jax.distributed.initialize requires it); the
    # group's mesh then overrides the local placement rule
    # (parallel/multihost.py). Env-gated inline: importing multihost
    # just to check the variables costs the numpy import (~0.3 s) on
    # every single-host run.
    if os.environ.get("GT4_DIST_COORD") \
            and int(os.environ.get("GT4_DIST_NPROCS", "1")) > 1:
        from genometester4_tpu.parallel.multihost import init_from_env
        init_from_env()

    return _main_impl(argv)


if __name__ == "__main__":
    raise SystemExit(main())
