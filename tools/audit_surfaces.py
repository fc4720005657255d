"""Tool-vs-tool scale audit: every CLI surface, interleaved timed runs,
byte-compared outputs. Reproduces the tool-vs-tool measured table on the
current container (wall times shift per container — re-measure before
quoting ratios, CLAUDE.md).

Usage:  python tools/audit_surfaces.py [--quick]

Needs the reference binaries in .ref_build/ (see CLAUDE.md). Writes
fixtures under /tmp/audit_gt4 (reused across runs). Each surface prints
one line:  SURFACE  ref_best  ours_best  ratio  BYTE-IDENTICAL|DIFFER.
This is the harness that caught the round-3 regressions (glistmaker
--index 0.32x, glistquery -f 0.5x, -ss numpy imports) — run it each
round.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, ".ref_build", "src")
BIN = os.path.join(REPO, "bin")
FIX = "/tmp/audit_gt4"
QUICK = "--quick" in sys.argv


def sh(cmd, **kw):
    return subprocess.run(cmd, capture_output=True, **kw)


def timed(cmd, n=2):
    best = 1e18
    r = None
    for _ in range(n):
        t0 = time.time()
        r = sh(cmd)
        best = min(best, time.time() - t0)
        if r.returncode != 0:
            raise SystemExit(f"FAILED rc={r.returncode}: {cmd}\n"
                             f"{r.stderr.decode()[:500]}")
    return best, r


def row(name, ref_cmd, our_cmd, outputs):
    # ALTERNATE single runs: consecutive same-tool runs bias the
    # successor with the predecessor's dirty-page writeback (a round-3
    # --index measurement flipped sign from this)
    tr = to = 1e18
    for _ in range(2):
        t, _r = timed(ref_cmd, n=1)
        tr = min(tr, t)
        t, _r = timed(our_cmd, n=1)
        to = min(to, t)
    same = True
    for a, b in outputs:
        if open(a, "rb").read() != open(b, "rb").read():
            same = False
    print(f"{name:44s} ref {tr:7.2f}s  ours {to:7.2f}s  "
          f"{tr / to:5.2f}x  {'BYTE-IDENTICAL' if same else 'DIFFER'}")
    if not same:
        raise SystemExit(f"{name}: outputs differ")


def ensure_fixtures():
    os.makedirs(FIX, exist_ok=True)
    fa = f"{FIX}/seq.fa"
    if not os.path.exists(fa):
        import numpy as np
        rng = np.random.default_rng(42)
        L = 10_000_000 if QUICK else 50_000_000
        bases = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=L)
        with open(fa, "wb") as f:
            f.write(b">chr1 synthetic\n")
            for i in range(0, L, 80):
                f.write(bases[i:i + 80].tobytes() + b"\n")
    fq = f"{FIX}/reads.fq"
    if not os.path.exists(fq):
        import numpy as np
        rng = np.random.default_rng(11)
        n = 50_000 if QUICK else 150_000
        with open(fq, "wb") as f:
            for i in range(n):
                seq = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                 size=100).tobytes()
                f.write(b"@r%d\n" % i + seq + b"\n+\nIIII\n"
                        .replace(b"IIII", b"I" * 100))
    if not os.path.exists(fq + ".gz"):
        sh(["gzip", "-kf", fq])
    return fa, fq


def main():
    fa, fq = ensure_fixtures()
    # lists first (inputs for later surfaces)
    row("glistmaker 25-mers -> .list",
        [f"{REF}/glistmaker", fa, "-w", "25", "-o", f"{FIX}/ref"],
        [f"{BIN}/glistmaker", fa, "-w", "25", "-o", f"{FIX}/our"],
        [(f"{FIX}/ref_25.list", f"{FIX}/our_25.list")])
    row("glistmaker gz FASTQ",
        [f"{REF}/glistmaker", fq + ".gz", "-w", "25", "-o", f"{FIX}/refq"],
        [f"{BIN}/glistmaker", fq + ".gz", "-w", "25", "-o", f"{FIX}/ourq"],
        [(f"{FIX}/refq_25.list", f"{FIX}/ourq_25.list")])
    row("glistmaker --index",
        [f"{REF}/glistmaker", fa, "-w", "25", "-o", f"{FIX}/refi",
         "--index"],
        [f"{BIN}/glistmaker", fa, "-w", "25", "-o", f"{FIX}/ouri",
         "--index"],
        [(f"{FIX}/refi_25.index", f"{FIX}/ouri_25.index")])
    L1, L2 = f"{FIX}/ref_25.list", f"{FIX}/refq_25.list"
    row("glistcompare -u -i",
        [f"{REF}/glistcompare", L1, L2, "-u", "-i", "-o", f"{FIX}/refc"],
        [f"{BIN}/glistcompare", L1, L2, "-u", "-i", "-o", f"{FIX}/ourc"],
        [(f"{FIX}/refc_25_union.list", f"{FIX}/ourc_25_union.list"),
         (f"{FIX}/refc_25_intrsec.list", f"{FIX}/ourc_25_intrsec.list")])
    # 4-way union+intersection (numpy-free k-way merge fast path)
    quarters = []
    for qi in range(4):
        qp = f"{FIX}/q{qi}"
        if not os.path.exists(f"{qp}_25.list"):
            sh([f"{BIN}/glistcompare", L1, "-ss", "rand_unique", "400000",
                "--seed", str(qi), "-o", qp])
            os.rename(f"{qp}_subset_25.list", f"{qp}_25.list")
        quarters.append(f"{qp}_25.list")
    row("glistcompare 4-list -u",
        [f"{REF}/glistcompare"] + quarters + ["-u", "-o", f"{FIX}/refm"],
        [f"{BIN}/glistcompare"] + quarters + ["-u", "-o", f"{FIX}/ourm"],
        [(f"{FIX}/refm_25_union.list", f"{FIX}/ourm_25_union.list")])
    row("glistcompare 4-list -i",
        [f"{REF}/glistcompare"] + quarters + ["-i", "-o", f"{FIX}/refn"],
        [f"{BIN}/glistcompare"] + quarters + ["-i", "-o", f"{FIX}/ourn"],
        [(f"{FIX}/refn_25_intrsec.list", f"{FIX}/ourn_25_intrsec.list")])
    row("glistcompare -ss rand_unique",
        [f"{REF}/glistcompare", L1, "-ss", "rand_unique", "100000",
         "--seed", "7", "-o", f"{FIX}/refs"],
        [f"{BIN}/glistcompare", L1, "-ss", "rand_unique", "100000",
         "--seed", "7", "-o", f"{FIX}/ours"],
        [(f"{FIX}/refs_subset_25.list", f"{FIX}/ours_subset_25.list")])
    for flag, name in (("--median", "median"), ("--gc", "gc"),
                       ("--distribution", "distro")):
        args = [flag] + (["200"] if flag == "--distribution" else [])
        tr, rr = timed([f"{REF}/glistquery", L1] + args)
        to, ro = timed([f"{BIN}/glistquery", L1] + args)
        same = rr.stdout == ro.stdout
        print(f"{'glistquery ' + name:44s} ref {tr:7.2f}s  ours "
              f"{to:7.2f}s  {tr / to:5.2f}x  "
              f"{'BYTE-IDENTICAL' if same else 'DIFFER'}")
        if not same:
            raise SystemExit(f"{name}: stdout differs")
    row("glistquery -l (sorted zipper)",
        [f"{REF}/glistquery", L1, "-l", L2],
        [f"{BIN}/glistquery", L1, "-l", L2],
        [])
    # -f: word queries from the other list's dump (first 500k words)
    qf = f"{FIX}/queries.txt"
    if not os.path.exists(qf):
        r = sh([f"{BIN}/glistquery", L2])
        words = [ln.split(b"\t")[0] for ln in
                 r.stdout.splitlines()[:500000]]
        import random
        random.seed(1)
        random.shuffle(words)
        open(qf, "wb").write(b"\n".join(words) + b"\n")
    tr, rr = timed([f"{REF}/glistquery", L1, "-f", qf])
    to, ro = timed([f"{BIN}/glistquery", L1, "-f", qf])
    print(f"{'glistquery -f 500k shuffled':44s} ref {tr:7.2f}s  ours "
          f"{to:7.2f}s  {tr / to:5.2f}x  "
          f"{'BYTE-IDENTICAL' if rr.stdout == ro.stdout else 'DIFFER'}")
    if rr.stdout != ro.stdout:
        raise SystemExit("-f stdout differs")
    # --- no-write twins (round-3 VERDICT weak #5): separate the compute
    # ratio from the shared IO ceiling on the writeback-bound rows -----
    def row_nowrite(name, ref_cmd, our_cmd, check_stdout=False):
        if check_stdout:
            rr = sh(ref_cmd)
            ro = sh(our_cmd)
            if rr.stdout != ro.stdout:
                raise SystemExit(f"{name}: stdout differs")
        devnull = open(os.devnull, "wb")
        tr = to = 1e18
        for _ in range(2):
            t0 = time.time()
            r = subprocess.run(ref_cmd, stdout=devnull,
                               stderr=subprocess.DEVNULL)
            tr = min(tr, time.time() - t0)
            assert r.returncode == 0, (name, "ref")
            t0 = time.time()
            r = subprocess.run(our_cmd, stdout=devnull,
                               stderr=subprocess.DEVNULL)
            to = min(to, time.time() - t0)
            assert r.returncode == 0, (name, "ours")
        print(f"{name:44s} ref {tr:7.2f}s  ours {to:7.2f}s  "
              f"{tr / to:5.2f}x  (no-write twin)")

    row_nowrite("glistcompare 4-list -u --count_only",
                [f"{REF}/glistcompare"] + quarters
                + ["-u", "--count_only", "-o", f"{FIX}/nul"],
                [f"{BIN}/glistcompare"] + quarters
                + ["-u", "--count_only", "-o", f"{FIX}/nul"],
                check_stdout=True)
    row_nowrite("glistquery full dump -> /dev/null",
                [f"{REF}/glistquery", L1],
                [f"{BIN}/glistquery", L1])
    # -mm neighborhood difference on the 400k-record quarters (the
    # full 45M-record lists would take the reference minutes); the
    # native early-exit filter (fgx_mm_filter, round 5) is the surface
    row("glistcompare -d -mm 1 (400k quarters)",
        [f"{REF}/glistcompare", quarters[0], quarters[1], "-d", "-mm",
         "1", "-o", f"{FIX}/refmm"],
        [f"{BIN}/glistcompare", quarters[0], quarters[1], "-d", "-mm",
         "1", "-o", f"{FIX}/ourmm"],
        [(f"{FIX}/refmm_25_1_diff1.list", f"{FIX}/ourmm_25_1_diff1.list")])
    # the --index row above is writeback-bound at 1 GB+ outputs: print
    # the container's raw page-cache write ceiling for the same byte
    # volume (1 MB chunks + sync, the pattern both writers use) so the
    # tool walls can be read against the floor they share
    idx_bytes = os.path.getsize(f"{FIX}/refi_25.index")
    buf = b"\0" * (1 << 20)
    t0 = time.time()
    with open(f"{FIX}/ceiling.tmp", "wb") as f:
        for _ in range(idx_bytes // len(buf) + 1):
            f.write(buf)
    os.sync()
    t_ceil = time.time() - t0
    os.unlink(f"{FIX}/ceiling.tmp")
    print(f"{'raw write ceiling (.index bytes + sync)':44s} "
          f"{idx_bytes / 1e6:7.0f}MB  {t_ceil:7.2f}s  "
          f"{idx_bytes / t_ceil / 1e6:6.0f} MB/s")
    print("audit complete")
    print("NOTE: sub-1x rows with ref < ~0.7s are the CPython launcher "
          "floor (~0.06-0.2s)\nagainst near-zero reference jobs; they "
          "amortize at production sizes.")


if __name__ == "__main__":
    main()
