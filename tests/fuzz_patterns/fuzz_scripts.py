"""Fuzz the Perl-script twins: random inputs -> perl script vs our
Python twin, byte-compare stdout (and final .list files for the
MakeUnion/MakeIntersection drivers).

Domain: gmer_caller-/KATK-shaped tables (the scripts' actual inputs).
Arbitrary malformed lines are NOT an oracle domain — Perl's scalar
coercion of garbage ("3abc" -> 3 with a warning) has no contract the
reference toolchain can produce, so the generator stays in-grammar
while randomizing every value, ordering, and optional field the
producers can emit (conventions: tests/fuzz_patterns/README.md).

Run: python tests/fuzz_patterns/fuzz_scripts.py SEED [N_TRIALS]
"""

from __future__ import annotations

import io
import os
import random
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

SCRIPTS = "/root/reference/scripts"
REF_BIN = os.path.join(REPO, ".ref_build", "src")

rnd = random.Random(int(sys.argv[1]) if len(sys.argv) > 1 else 0)
N_TRIALS = int(sys.argv[2]) if len(sys.argv) > 2 else 10
PERL = shutil.which("perl")


def run_cli(fn, args, capture="stdout"):
    buf = io.StringIO()
    old = getattr(sys, capture)
    setattr(sys, capture, buf)
    try:
        rc = fn(args)
    finally:
        setattr(sys, capture, old)
    return rc, buf.getvalue()


def trial_generate_vcf(t):
    from genometester4_tpu.cli.generate_vcf import main
    lines = []
    sex_val = rnd.choice(["M", "F", "m", "X", ""])
    sex_at = rnd.randrange(-1, 4)
    chroms = [str(c) for c in range(1, 23)] + ["X", "Y", "MT"]
    for i in range(rnd.randrange(0, 14)):
        if i == sex_at:
            lines.append("#Sex\t%s" % sex_val)
        if rnd.random() < 0.15:
            lines.append("#comment %d" % rnd.randrange(1000))
        chrom = rnd.choice(chroms)
        pos = rnd.randrange(1, 10 ** 8)
        rid = rnd.choice(["rs%d" % rnd.randrange(10 ** 6),
                          "var_%d" % i, "."])
        ref, alt = rnd.sample("ACGT", 2)
        gt = rnd.choice(["AA", "AB", "BB", "A", "B", "NC", "BA", "0"])
        prob = "%.2f" % rnd.random()
        rc_, ac = rnd.randrange(0, 99), rnd.randrange(0, 99)
        lines.append("%s:%d:%s:%s/%s\t%s\t%s\t%d\t%d"
                     % (chrom, pos, rid, ref, alt, gt, prob, rc_, ac))
    if sex_at >= len(lines):
        lines.append("#Sex\t%s" % sex_val)
    with tempfile.TemporaryDirectory() as d:
        calls = os.path.join(d, "calls.txt")
        with open(calls, "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
        ref = subprocess.run(
            [PERL, os.path.join(SCRIPTS, "generate_vcf.pl"), calls],
            capture_output=True, text=True)
        rc, out = run_cli(main, [calls])
        if rc != 0 or out != ref.stdout:
            return "generate_vcf diverges (trial %d, %d lines)" % (
                t, len(lines))


def trial_katk2vcf(t):
    from genometester4_tpu.cli.katk2vcf import main
    B = "ACGT"
    with tempfile.TemporaryDirectory() as d:
        chrdir = os.path.join(d, "chr")
        os.mkdir(chrdir)
        chrom_names = rnd.sample(["1", "2", "X"], rnd.randrange(1, 3))
        seqs = {}
        for cn in chrom_names:
            seq = "".join(rnd.choice(B) for _ in range(
                rnd.randrange(600, 2500)))
            seqs[cn] = seq
            with open(os.path.join(chrdir, cn + ".fa"), "w") as f:
                f.write(">%s\n" % cn)
                for i in range(0, len(seq), 60):
                    f.write(seq[i:i + 60] + "\n")
        lines = ["#KATK version: 4.2.16",
                 "CHR\tPOS\tSUB\tREF\tCOV\tCALL\tCLASS\tP\tPMUT"]
        for cn in chrom_names:
            seq = seqs[cn]
            poss = sorted(rnd.sample(range(100, len(seq) - 100),
                                     rnd.randrange(1, 9)))
            for pos in poss:
                base = seq[pos - 1]
                alt = rnd.choice([b for b in B if b != base])
                kind = rnd.choice(["NC", "S", "I", "D", "HOM"])
                cov = rnd.randrange(5, 60)
                p = "%.2f" % (0.5 + rnd.random() / 2)
                pmut = "%.2f" % (0.4 + rnd.random() / 2)
                if kind == "NC":
                    lines.append("%s\t%d\t0\t%s\t%d\tNC\t0\t%s\t%s"
                                 % (cn, pos, base, cov, p, pmut))
                elif kind == "S":
                    lines.append("%s\t%d\t0\t%s\t%d\t%s%s\tS\t%s\t%s"
                                 % (cn, pos, base, cov, base, alt, p,
                                    pmut))
                elif kind == "I":
                    for sub in range(1, rnd.randrange(2, 4)):
                        lines.append("%s\t%d\t%d\t-\t%d\t-%s\tI\t%s\t%s"
                                     % (cn, pos, sub, cov,
                                        rnd.choice(B), p, pmut))
                elif kind == "D":
                    lines.append("%s\t%d\t0\t%s\t%d\t%s-\tD\t%s\t%s"
                                 % (cn, pos, base, cov, base, p, pmut))
                else:
                    lines.append("%s\t%d\t0\t%s\t%d\t%s%s\t0\t%s\t%s"
                                 % (cn, pos, base, cov, base, base, p,
                                    pmut))
        calls = os.path.join(d, "calls.txt")
        with open(calls, "w") as f:
            f.write("\n".join(lines) + "\n")
        src = open(os.path.join(SCRIPTS, "katk2vcf.pl")).read()
        src = src.replace(
            'my $chr_dir = "/storage9/db/human_GRCh38/data/chr/";',
            'my $chr_dir = "%s/";' % chrdir)
        patched = os.path.join(d, "katk2vcf_local.pl")
        open(patched, "w").write(src)
        ref = subprocess.run([PERL, patched, calls],
                             capture_output=True, text=True)
        rc, out = run_cli(main, ["--chr_dir", chrdir, calls])
        if rc != 0 or out != ref.stdout:
            return "katk2vcf diverges (trial %d, %d lines)" % (
                t, len(lines) - 2)


def trial_make_union(t):
    from genometester4_tpu.cli.make_union import main_union
    from genometester4_tpu.cli.make_union import main_intersection
    B = "ACGT"
    which = rnd.choice(["union", "intersection"])
    n = rnd.randrange(2, 6)
    with tempfile.TemporaryDirectory() as d:
        ref_dir = os.path.join(d, "ref")
        ours_dir = os.path.join(d, "ours")
        os.mkdir(ref_dir)
        os.mkdir(ours_dir)
        names = []
        for i in range(n):
            seq = "".join(rnd.choice(B) for _ in range(
                rnd.randrange(300, 1500)))
            fa = os.path.join(ref_dir, "l%d.fa" % i)
            open(fa, "w").write(">s\n%s\n" % seq)
            r = subprocess.run(
                [os.path.join(REF_BIN, "glistmaker"), fa, "-w", "10",
                 "-o", os.path.join(ref_dir, "l%d" % i)],
                capture_output=True)
            if r.returncode != 0:
                return None  # reference failed to build input: skip
            shutil.copy(os.path.join(ref_dir, "l%d_10.list" % i),
                        os.path.join(ours_dir, "l%d_10.list" % i))
            names.append("l%d_10.list" % i)
        shutil.copy(os.path.join(REF_BIN, "glistcompare"),
                    os.path.join(ref_dir, "glistcompare"))
        script = ("MakeUnion.pl" if which == "union"
                  else "MakeIntersection.pl")
        subprocess.run([PERL, os.path.join(SCRIPTS, script)] + names,
                       cwd=ref_dir, capture_output=True)
        fn = main_union if which == "union" else main_intersection
        old = os.getcwd()
        os.chdir(ours_dir)
        try:
            rc, _ = run_cli(fn, names, capture="stderr")
        finally:
            os.chdir(old)
        if rc != 0:
            return "make_%s rc=%d (trial %d)" % (which, rc, t)
        out_name = ("union_10_union.list" if which == "union"
                    else "intrsec_10_intrsec.list")
        refp = os.path.join(ref_dir, out_name)
        oursp = os.path.join(ours_dir, out_name)
        if not os.path.exists(refp):
            return None  # perl driver produced nothing: skip
        if not os.path.exists(oursp):
            return "make_%s missing output (trial %d)" % (which, t)
        if open(refp, "rb").read() != open(oursp, "rb").read():
            return "make_%s final list diverges (trial %d, n=%d)" % (
                which, t, n)


def run_cli_both(fn, args):
    """Capture stdout AND stderr of a twin stage."""
    so, se = io.StringIO(), io.StringIO()
    old_o, old_e = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = so, se
    try:
        rc = fn(args)
    finally:
        sys.stdout, sys.stderr = old_o, old_e
    return rc, so.getvalue(), se.getvalue()


def trial_repeats(t):
    """The whole 5-stage repeats pipeline vs the Perl scripts, each
    stage's stdout+stderr byte-compared; later stages consume the
    PERL outputs so a stage-1 divergence can't mask stage-2."""
    from genometester4_tpu.cli.repeats import STAGES
    B = "ACGT"
    with tempfile.TemporaryDirectory() as d:
        # genome with planted repeats so find_regions has material
        motif = "".join(rnd.choice(B) for _ in range(
            rnd.randrange(40, 200)))
        parts = []
        for _ in range(rnd.randrange(3, 9)):
            parts.append("".join(rnd.choice(B) for _ in range(
                rnd.randrange(100, 800))))
            if rnd.random() < 0.75:
                parts.append(motif)
        seq = "".join(parts)
        fa = os.path.join(d, "g.fa")
        open(fa, "w").write(">g%d extra tokens\n%s\n" % (t, seq))
        counts = {}
        for i in range(len(seq) - 16):
            w = seq[i:i + 16]
            counts[w] = counts.get(w, 0) + 1
        table = os.path.join(d, "over.txt")
        with open(table, "w") as f:
            for w, c in counts.items():
                if c >= 2 or rnd.random() < 0.001:
                    f.write("%s\t%d\n" % (w, c))
        min_len = str(rnd.randrange(20, 120))
        min_avg = rnd.choice(["1", "1.5", "2", "2.0"])
        args = [table, fa, min_len, min_avg]
        if rnd.random() < 0.4:
            args.append(str(rnd.randrange(200, 3000)))
        ref = subprocess.run(
            [PERL, os.path.join(SCRIPTS, "repeats", "find_regions.pl")]
            + args, capture_output=True, text=True)
        rc, out, err = run_cli_both(STAGES["find_regions"], args)
        if rc != 0 or out != ref.stdout or err != ref.stderr:
            return "repeats find_regions diverges (trial %d)" % t

        regions = os.path.join(d, "regions.fa")
        open(regions, "w").write(ref.stdout)
        rids, rlens = [], {}
        for ln in ref.stdout.splitlines():
            if ln.startswith(">"):
                rid = ln[1:].split()[0]
                rids.append(rid)
            elif rids:
                rlens[rids[-1]] = len(ln)
        blast = os.path.join(d, "blast.txt")
        with open(blast, "w") as f:
            if rids:
                for _ in range(rnd.randrange(0, 4 * len(rids) + 4)):
                    a, b = rnd.choice(rids), rnd.choice(rids)
                    la, lb = rlens[a], rlens[b]
                    if rnd.random() < 0.7:
                        lb = max(1, int(la * (0.9 + 0.2 * rnd.random())))
                    ident = "%.1f" % (80 + 20 * rnd.random())
                    alen = max(1, int(la * (0.85 + 0.3 * rnd.random())))
                    f.write("%s\t%d\t%s\t%d\t%s\t%d\n"
                            % (a, la, b, lb, ident, alen))

        ref2 = subprocess.run(
            [PERL, os.path.join(SCRIPTS, "repeats", "collate_repeats.pl"),
             blast, regions], capture_output=True, text=True)
        rc, out, err = run_cli_both(STAGES["collate_repeats"],
                                    [blast, regions])
        if rc != 0 or out != ref2.stdout or err != ref2.stderr:
            return "repeats collate diverges (trial %d)" % t

        groups = os.path.join(d, "groups.txt")
        open(groups, "w").write(ref2.stdout)
        mn = str(rnd.randrange(0, 4))
        ref3 = subprocess.run(
            [PERL, os.path.join(SCRIPTS, "repeats",
                                "_filter_collated.pl"), groups, mn],
            capture_output=True, text=True)
        rc, out, err = run_cli_both(STAGES["filter_collated"],
                                    [groups, mn])
        if rc != 0 or out != ref3.stdout:
            return "repeats filter_collated diverges (trial %d)" % t

        ref4 = subprocess.run(
            [PERL, os.path.join(SCRIPTS, "repeats", "_unique.pl"),
             regions, blast], capture_output=True, text=True)
        rc, out, err = run_cli_both(STAGES["unique"], [regions, blast])
        if rc != 0 or out != ref4.stdout:
            return "repeats unique diverges (trial %d)" % t

        chrom_blast = os.path.join(d, "chroms.txt")
        chroms = ["chr1", "chr2", "chrX"]
        tgt = rnd.choice(chroms)
        with open(chrom_blast, "w") as f:
            for rid in rids:
                for _ in range(rnd.randrange(0, 4)):
                    f.write("%s\t%s\textra\tcols\n"
                            % (rid, rnd.choice(chroms)))
            if rnd.random() < 0.3:
                f.write("lonely_token\n")
        ref5 = subprocess.run(
            [PERL, os.path.join(SCRIPTS, "repeats", "_filter_final.pl"),
             regions, chrom_blast, tgt], capture_output=True, text=True)
        rc, out, err = run_cli_both(STAGES["filter_final"],
                                    [regions, chrom_blast, tgt])
        if rc != 0 or out != ref5.stdout:
            return "repeats filter_final diverges (trial %d)" % t


def main():
    if PERL is None:
        print("perl not available; skipping", file=sys.stderr)
        return 0
    fails = 0
    for t in range(N_TRIALS):
        for fn in (trial_generate_vcf, trial_katk2vcf, trial_repeats):
            msg = fn(t)
            if msg:
                print("FAIL: " + msg, file=sys.stderr)
                fails += 1
        if t < 2 and os.path.exists(os.path.join(REF_BIN, "glistmaker")):
            msg = trial_make_union(t)
            if msg:
                print("FAIL: " + msg, file=sys.stderr)
                fails += 1
    print("seed %s: fails %d" % (sys.argv[1] if len(sys.argv) > 1
                                 else 0, fails))
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
