"""Differential tests: our gassembler vs the compiled reference binary.

Scenario: synthetic diploid sample with SNVs and indels on chr 1/2/X,
reads indexed through gmer_counter --compile_index, overlapping call
regions. Reference runs single-threaded (its multi-threaded output is
schedule-dependent). Everything — SW alignment, grouping, logistic call
models, rand-driven coverage sampling, auto sex (including the 0/0 NaN
male default), ordered block output — must be byte-identical.
"""

import io
import os
import sys

import numpy as np
import pytest

from tests.conftest import run_reference

B = "ACGT"


def _rc(s):
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


@pytest.fixture(scope="module")


def katk_fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("katk")
    rng = np.random.default_rng(77)
    L = 600
    genome = {c: "".join(B[i] for i in rng.integers(0, 4, L))
              for c in ("1", "2", "X")}
    hap = {}
    g = genome["1"]
    hap[("1", 0)] = g
    hap[("1", 1)] = (g[:100] + ("G" if g[100] != "G" else "T")
                     + g[101:300] + g[302:])  # het SNV + het 2bp deletion
    g = genome["2"]
    g2 = g[:150] + ("C" if g[150] != "C" else "A") + g[151:]  # hom SNV
    hap[("2", 0)] = g2
    hap[("2", 1)] = g2[:400] + "TT" + g2[400:]  # het insertion
    g = genome["X"]
    hap[("X", 0)] = g[:200] + ("T" if g[200] != "T" else "G") + g[201:]
    hap[("X", 1)] = hap[("X", 0)]
    reads = []
    for (chrom, h), seq in hap.items():
        for i in range(120):
            start = int(rng.integers(0, len(seq) - 100 + 1))
            r = list(seq[start:start + 100])
            for _ in range(rng.poisson(0.4)):
                p = int(rng.integers(len(r)))
                r[p] = B[int(rng.integers(4))]
            r = "".join(r)
            if rng.random() < 0.5:
                r = _rc(r)
            reads.append(r)
    with open(tmp / "reads.fq", "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@rd{i}\n{r}\n+\n{'J' * len(r)}\n")
    dblines, regions = [], []
    for chrom in ("1", "2", "X"):
        g = genome[chrom]
        for rs in range(0, L - 150 + 1, 100):
            re_ = rs + 150
            kms = [g[p:p + 25] for p in range(rs + 5, re_ - 30, 35)]
            for km in kms:
                dblines.append(f"{chrom}_{rs}_{len(dblines)}\t1\t{km}")
            regions.append(f"{chrom}\t{1000 + rs}\t{1000 + re_}\t"
                           f"{g[rs:re_]}\t" + "\t".join(kms))
    (tmp / "db.txt").write_text("\n".join(dblines) + "\n")
    (tmp / "regions.txt").write_text("\n".join(regions) + "\n")
    r = run_reference(["gmer_counter", "-db", "db.txt", "--compile_index",
                       "db.idx", "--num_threads", "1", "reads.fq"], cwd=tmp)
    assert r.returncode == 0, r.stderr
    return tmp


def run_ours(args):
    from genometester4_tpu.cli.gassembler import main
    old = sys.stdout
    sys.stdout = io.StringIO()
    try:
        try:
            rc = main(args)
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 0
        out = sys.stdout.getvalue()
    finally:
        sys.stdout = old
    return rc, out


@pytest.mark.parametrize("flags", [
    ["--coverage", "40", "--sex", "female"],
    ["--coverage", "40", "--sex", "male"],
    ["--coverage", "median", "--sex", "auto"],
    ["--coverage", "40", "--sex", "female", "--output", "all", "--counts"],
    ["--coverage", "40", "--sex", "female", "--output", "best", "--extra"],
    ["--coverage", "40", "--sex", "male", "--exome"],
    ["--coverage", "ignore", "--sex", "female"],
    ["--coverage", "40", "--sex", "female", "--alternatives"],
    ["--coverage", "40", "--sex", "female", "--min_group_size", "2",
     "--min_p", "0.5"],
])


def test_gassembler_byte_identical(katk_fixture, flags):
    tmp = katk_fixture
    args = ["--dbi", "db.idx", "--region_file", "regions.txt",
            "--num_threads", "1"] + flags
    ref = run_reference(["gassembler"] + args, cwd=tmp, timeout=600)
    assert ref.returncode == 0, ref.stderr
    import os
    old = os.getcwd()
    os.chdir(tmp)
    try:
        rc, out = run_ours(args)
    finally:
        os.chdir(old)
    assert rc == 0
    assert out == ref.stdout.decode()


def test_sw_traceback_vs_reference_scores(rng):
    """Self-consistency: batched wavefront SW equals a direct per-pair
    numpy DP (row order) on random sequence pairs."""
    from genometester4_tpu.ops.swalign import (sw_matrices_batch,
                                               sw_traceback)

    def sw_rowmajor(a, b):
        n, m = len(a), len(b)
        NEG = -1000
        sc = np.zeros((n + 1, m + 1), np.int32)
        lg = np.full((n + 1, m + 1), NEG, np.int32)
        lgl = np.zeros((n + 1, m + 1), np.int32)
        tg = np.full((n + 1, m + 1), NEG, np.int32)
        tgl = np.zeros((n + 1, m + 1), np.int32)
        sx = np.zeros((n + 1, m + 1), np.int32)
        sy = np.zeros((n + 1, m + 1), np.int32)
        for i in range(1, n + 1):
            for j in range(1, m + 1):
                sub = 0 if (a[i - 1] >= 4 or b[j - 1] >= 4) else (
                    2 if a[i - 1] == b[j - 1] else -3)
                cell = 0
                cx = cy = 0
                if sc[i - 1, j - 1] + sub > 0:
                    cell = sc[i - 1, j - 1] + sub
                    cx = cy = -1
                ls, ll = cell - 4, 0
                if lg[i, j - 1] - 2 > ls:
                    ls, ll = lg[i, j - 1] - 2, lgl[i, j - 1] + 1
                if ls >= cell:
                    cell, cx, cy = ls, -np.int8(ll), 0
                ts, tl = cell - 4, 0
                if tg[i - 1, j] - 2 > ts:
                    ts, tl = tg[i - 1, j] - 2, tgl[i - 1, j] + 1
                if ts >= cell:
                    cell, cx, cy = ts, 0, -np.int8(tl)
                sc[i, j] = cell
                lg[i, j], lgl[i, j] = ls, ll
                tg[i, j], tgl[i, j] = ts, tl
                sx[i, j], sy[i, j] = cx, cy
        return sc, sx, sy

    for trial in range(10):
        n = int(rng.integers(20, 120))
        m = int(rng.integers(20, 120))
        a = rng.integers(0, 4, n).astype(np.int8)
        b = a.copy()[:m] if m <= n else np.concatenate(
            [a, rng.integers(0, 4, m - n).astype(np.int8)])
        # mutate b a bit
        for _ in range(int(rng.integers(0, 6))):
            p = int(rng.integers(len(b)))
            b[p] = int(rng.integers(4))
        score_b, sx_b, sy_b = sw_matrices_batch(a, b[None, :])
        score_r, sx_r, sy_r = sw_rowmajor(a, b)
        np.testing.assert_array_equal(score_b[0], score_r.astype(np.int16))
        np.testing.assert_array_equal(sx_b[0], sx_r.astype(np.int8))
        np.testing.assert_array_equal(sy_b[0], sy_r.astype(np.int8))
        sw_traceback(score_b[0], sx_b[0], sy_b[0], m)


def test_snvs_and_fp_files(katk_fixture):
    """--snvs marks known SNVs (excluded from group divergence), --fp
    forces NC at listed positions — byte-identical."""
    tmp = katk_fixture
    region1 = (tmp / "regions.txt").read_text().splitlines()[0].split("\t")
    ref_seq = region1[3]
    ref_base = ref_seq[100]
    alt = "G" if ref_base != "G" else "T"
    (tmp / "snvs.txt").write_text(f"1:1101:rs1:{ref_base}/{alt}\tAB\n")
    (tmp / "fps.txt").write_text("1:1120\n")
    args = ["--dbi", "db.idx", "--region_file", "regions.txt",
            "--num_threads", "1", "--coverage", "40", "--sex", "female",
            "--snvs", "snvs.txt", "--fp", "fps.txt"]
    ref = run_reference(["gassembler"] + args, cwd=tmp, timeout=600)
    assert ref.returncode == 0, ref.stderr
    import os
    old = os.getcwd()
    os.chdir(tmp)
    try:
        rc, out = run_ours(args)
    finally:
        os.chdir(old)
    assert rc == 0
    assert out == ref.stdout.decode()


@pytest.mark.parametrize("mode", ["pos", "region"])


def test_single_region_modes(katk_fixture, mode):
    """--pos CHR:POS and --region CHR START END SEQ single-region paths
    (print via the recursive assembler) — byte-identical."""
    tmp = katk_fixture
    line = (tmp / "regions.txt").read_text().splitlines()[0].split("\t")
    if mode == "pos":
        args = ["--dbi", "db.idx", "--region_file", "regions.txt",
                "--num_threads", "1", "--coverage", "40", "--sex",
                "female", "--pos", "1:1100"]
    else:
        args = ["--dbi", "db.idx", "--num_threads", "1", "--coverage",
                "40", "--sex", "female", "--region", "1", "1000", "1150",
                line[3]] + line[4:]
    ref = run_reference(["gassembler"] + args, cwd=tmp, timeout=600)
    assert ref.returncode == 0, ref.stderr
    import os
    old = os.getcwd()
    os.chdir(tmp)
    try:
        rc, out = run_ours(args)
    finally:
        os.chdir(old)
    assert rc == 0
    assert out == ref.stdout.decode()


@pytest.fixture(scope="module")


def dense_katk_fixture(tmp_path_factory):
    """One chromosome, enough reads that every region exceeds the
    200-unique-read cap — exercises the rand() subsampling stream that
    parallel workers must fast-forward to exactly."""
    tmp = tmp_path_factory.mktemp("katk_dense")
    rng = np.random.default_rng(99)
    L = 500
    g = "".join(B[i] for i in rng.integers(0, 4, L))
    hap1 = g
    hap2 = g[:120] + ("A" if g[120] != "A" else "C") + g[121:]
    reads = []
    for seq in (hap1, hap2):
        for _ in range(300):
            start = int(rng.integers(0, len(seq) - 100 + 1))
            r = seq[start:start + 100]
            if rng.random() < 0.5:
                r = _rc(r)
            reads.append(r)
    with open(tmp / "reads.fq", "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@rd{i}\n{r}\n+\n{'J' * len(r)}\n")
    dblines, regions = [], []
    for rs in range(0, L - 150 + 1, 100):
        re_ = rs + 150
        # step 30 shares no positions across 100-spaced regions, so no
        # k-mer string repeats in the DB (duplicate names break the trie)
        kms = [g[p:p + 25] for p in range(rs + 5, re_ - 30, 30)]
        for km in kms:
            dblines.append(f"1_{rs}_{len(dblines)}\t1\t{km}")
        regions.append(f"1\t{1000 + rs}\t{1000 + re_}\t{g[rs:re_]}\t"
                       + "\t".join(kms))
    (tmp / "db.txt").write_text("\n".join(dblines) + "\n")
    (tmp / "regions.txt").write_text("\n".join(regions) + "\n")
    r = run_reference(["gmer_counter", "-db", "db.txt", "--compile_index",
                       "db.idx", "--num_threads", "1", "reads.fq"], cwd=tmp)
    assert r.returncode == 0, r.stderr
    return tmp


@pytest.mark.parametrize("threads", [2, 5])


def test_parallel_regions_byte_identical(dense_katk_fixture, threads):
    """--num_threads N output == reference --num_threads 1 output, with
    every region consuming 200 rand() draws (subsampling active): the
    precomputed stream offsets must land each worker exactly where the
    sequential run would be. (The reference's own multi-threaded output
    is schedule-dependent; ours is deterministic.)"""
    import os
    tmp = dense_katk_fixture
    args = ["--dbi", "db.idx", "--region_file", "regions.txt",
            "--coverage", "40", "--sex", "female"]
    ref = run_reference(["gassembler"] + args + ["--num_threads", "1"],
                        cwd=tmp, timeout=600)
    assert ref.returncode == 0, ref.stderr
    old = os.getcwd()
    os.chdir(tmp)
    try:
        rc, out = run_ours(args + ["--num_threads", str(threads)])
    finally:
        os.chdir(old)
    assert rc == 0
    assert out == ref.stdout.decode()


def test_dense_fixture_triggers_subsampling(dense_katk_fixture):
    from genometester4_tpu.pipelines.gassemble import (
        region_rand_consumption, MAX_READS_PER_REGION, MAX_READS_PER_KMER)
    from genometester4_tpu.formats.gmerdb_binary import load_binary_db
    tmp = dense_katk_fixture
    db = load_binary_db(str(tmp / "db.idx"), lazy=True)
    lines = (tmp / "regions.txt").read_text().splitlines()
    cons = [region_rand_consumption(db, ln.split("\t")[4:],
                                    MAX_READS_PER_KMER) for ln in lines]
    assert any(c == MAX_READS_PER_REGION for c in cons), \
        "fixture must exercise the subsample stream"

def test_debug_level1_stderr_parity(katk_fixture):
    """-D level-1 stderr chrome is byte-identical: Loading reads
    database/done, Sample min/max + median (glibc-rand sampled),
    Loading read sequences, Determine sex + Klass lines, per-region
    Block lines (src/gassembler.c:947-961,1240-1245,2476-2769). The
    -DD per-read diagnostic firehose is deliberately not emulated
    (COVERAGE.md)."""
    import subprocess
    tmp = katk_fixture
    args = ["--dbi", "db.idx", "--region_file", "regions.txt",
            "--num_threads", "1", "--coverage", "median",
            "--sex", "auto", "-D"]
    ref = run_reference(["gassembler"] + args, cwd=tmp, timeout=600)
    ours = subprocess.run(
        [sys.executable, "-m", "genometester4_tpu.cli.gassembler"] + args,
        cwd=tmp, capture_output=True, timeout=600,
        env={**os.environ, "PYTHONPATH": os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))})
    assert ours.returncode == ref.returncode
    assert ours.stdout == ref.stdout
    err = b"\n".join(l for l in ours.stderr.splitlines()
                     if b"xla_bridge" not in l) + b"\n"
    assert err == ref.stderr


def test_gapped_alignment_native_matches_numpy_twin():
    """The C gapped-alignment walk (fgx_gapped_alignment) and its numpy
    oracle agree on random alignments (twins keep differential tests —
    CLAUDE.md)."""
    from genometester4_tpu.pipelines import gassemble as ga
    rng = np.random.default_rng(11)
    p = ga.Params()
    n = 80
    ref_codes = rng.integers(0, 4, n).astype(np.int8)
    reads = []
    for i in range(40):
        s = int(rng.integers(0, n - 40))
        ln = int(rng.integers(30, 41))
        codes = ref_codes[s:s + ln].copy()
        for _ in range(int(rng.integers(0, 3))):     # mutations
            codes[rng.integers(0, len(codes))] = rng.integers(0, 4)
        if rng.random() < 0.3:                       # small indel
            cut = int(rng.integers(5, len(codes) - 5))
            codes = np.concatenate([codes[:cut], codes[cut + 1:]])
        seq = "".join("ACGT"[c] for c in codes)
        reads.append(ga.GASMRead(b"r%d" % i, seq.encode(),
                                 codes.astype(np.int8), 1))
    a_reads, a = ga.align_reads(ref_codes, reads, p)
    assert len(a_reads) > 5, "fixture should align"
    got = ga.create_gapped_alignment(ref_codes, 500, a_reads, a, p)
    exp = ga.create_gapped_alignment_numpy(ref_codes, 500, a_reads, a, p)
    assert got[0] == exp[0]
    np.testing.assert_array_equal(got[1][:got[0]], exp[1][:exp[0]])
    np.testing.assert_array_equal(got[2][:got[0]], exp[2][:exp[0]])
    np.testing.assert_array_equal(got[3][:, :got[0]], exp[3][:, :exp[0]])


def test_debug_groups_stderr_parity(katk_fixture):
    """-DG level-1 stderr is byte-identical: the merge trace (updated
    tag + old mask halves), Num remaining groups, divergent-position /
    Known SNV / Potential DeNovo lines, both Group dumps, Read groups,
    and the discard messages including the literal backslash-n quirk of
    the min-coverage line (src/gassembler.c:1404-1580,1619-1623)."""
    import subprocess
    tmp = katk_fixture
    region1 = (tmp / "regions.txt").read_text().splitlines()[0].split("\t")
    ref_base = region1[3][100]
    alt = "G" if ref_base != "G" else "T"
    (tmp / "snvs_dg.txt").write_text(f"1:1101:rs1:{ref_base}/{alt}\tAB\n")
    args = ["--dbi", "db.idx", "--region_file", "regions.txt",
            "--num_threads", "1", "--coverage", "40", "--sex", "female",
            "--snvs", "snvs_dg.txt", "-DG"]
    ref = run_reference(["gassembler"] + args, cwd=tmp, timeout=600)
    ours = subprocess.run(
        [sys.executable, "-m", "genometester4_tpu.cli.gassembler"] + args,
        cwd=tmp, capture_output=True, timeout=600,
        env={**os.environ, "PYTHONPATH": os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))})
    assert ours.returncode == ref.returncode
    assert ours.stdout == ref.stdout
    err = b"\n".join(l for l in ours.stderr.splitlines()
                     if b"xla_bridge" not in l) + b"\n"
    assert err == ref.stderr


def test_region_file_unterminated_last_line(katk_fixture):
    """Fuzz regression: split_line has no csize bound on its outer
    loop, so an unterminated final region line reads the mmap zero
    page into ~1024 empty trailing tokens; the empty k-mers make the
    reference print "No such kmer: " and exit 0 with no calls
    (src/utils.c:234-248 + src/gassembler.c:2575-2580)."""
    tmp = katk_fixture
    line1 = (tmp / "regions.txt").read_text().splitlines()[0]
    (tmp / "nonl.txt").write_text(line1)   # no trailing newline
    args = ["--dbi", "db.idx", "--region_file", "nonl.txt",
            "--num_threads", "1", "--coverage", "40", "--sex", "female"]
    ref = run_reference(["gassembler"] + args, cwd=tmp, timeout=600)
    if ref.returncode < 0:
        # the 1028-token zero-page walk crossed into an unmapped page
        # (depends on csize mod 4096) and the reference SIGSEGVed —
        # not an oracle for this file size
        pytest.skip("reference segfaulted on this size")
    import os
    old = os.getcwd()
    os.chdir(tmp)
    try:
        rc, out = run_ours(args)
    finally:
        os.chdir(old)
    assert rc == ref.returncode
    assert out == ref.stdout.decode()


def test_debug_level2_stderr_parity(katk_fixture):
    """-D -D per-read/per-kmer diagnostic firehose is byte-identical:
    the Arguments virtual command line, Kmer/Node/Num reads/Adding read
    traces, Got/usable counts, per-read fetch dumps, the
    Aligning-reads progress + per-read divergence/filter traces, the
    initial group tag/mask hex dumps, and Divergent position /
    Known SNV / Potential DeNovo lines
    (src/gassembler.c:1862-1868,2575-2615,2662,1223-1251,1928-1962,
    1356-1361,1285-1294)."""
    import subprocess
    tmp = katk_fixture
    region1 = (tmp / "regions.txt").read_text().splitlines()[0].split("\t")
    ref_base = region1[3][100]
    alt = "G" if ref_base != "G" else "T"
    (tmp / "snvs_dd.txt").write_text(f"1:1101:rs1:{ref_base}/{alt}\tAB\n")
    args = ["--dbi", "db.idx", "--region_file", "regions.txt",
            "--num_threads", "1", "--coverage", "40", "--sex", "female",
            "--snvs", "snvs_dd.txt", "-D", "-D"]
    ref = run_reference(["gassembler"] + args, cwd=tmp, timeout=600)
    ours = subprocess.run(
        [sys.executable, "-m", "genometester4_tpu.cli.gassembler"] + args,
        cwd=tmp, capture_output=True, timeout=600,
        env={**os.environ, "PYTHONPATH": os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))})
    assert ours.returncode == ref.returncode
    assert ours.stdout == ref.stdout
    err = b"\n".join(l for l in ours.stderr.splitlines()
                     if b"xla_bridge" not in l) + b"\n"
    assert err == ref.stderr


def test_debug_groups_level2_stderr_parity(katk_fixture):
    """-DG -DG adds per-group consensus strings and member read names
    to both Group dumps (src/gassembler.c:1521-1526,1623-1630) —
    byte-identical."""
    import subprocess
    tmp = katk_fixture
    args = ["--dbi", "db.idx", "--region_file", "regions.txt",
            "--num_threads", "1", "--coverage", "40", "--sex", "female",
            "-DG", "-DG"]
    ref = run_reference(["gassembler"] + args, cwd=tmp, timeout=600)
    ours = subprocess.run(
        [sys.executable, "-m", "genometester4_tpu.cli.gassembler"] + args,
        cwd=tmp, capture_output=True, timeout=600,
        env={**os.environ, "PYTHONPATH": os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))})
    assert ours.returncode == ref.returncode
    assert ours.stdout == ref.stdout
    err = b"\n".join(l for l in ours.stderr.splitlines()
                     if b"xla_bridge" not in l) + b"\n"
    assert err == ref.stderr


def test_debug_level3_stderr_parity(katk_fixture):
    """-D -D -D byte-identical: adds print_db_reads index dumps, the
    'Already registered' dedup trace, FP: echo lines, and the per-read
    >i/na + print_alignment blocks (src/gassembler.c:2581,2612,2428,
    1930-1935). The reference's own in-fill SW matrix/traceback dumps
    (src/gassembler.c:2275,2314) are DEAD CODE — smith_waterman_seq's
    debug parameter is hardwired 0 at the align call
    (src/gassembler.c:1925) — so nothing prints from them upstream or
    here."""
    import subprocess
    tmp = katk_fixture
    region1 = (tmp / "regions.txt").read_text().splitlines()[0].split("\t")
    ref_base = region1[3][100]
    alt = "G" if ref_base != "G" else "T"
    (tmp / "snvs_d3.txt").write_text(f"1:1101:rs1:{ref_base}/{alt}\tAB\n")
    (tmp / "fp_d3.txt").write_text("1:1120\nX:7\n")
    args = ["--dbi", "db.idx", "--region_file", "regions.txt",
            "--num_threads", "1", "--coverage", "40", "--sex", "female",
            "--snvs", "snvs_d3.txt", "--fp", "fp_d3.txt",
            "-D", "-D", "-D"]
    ref = run_reference(["gassembler"] + args, cwd=tmp, timeout=600)
    ours = subprocess.run(
        [sys.executable, "-m", "genometester4_tpu.cli.gassembler"] + args,
        cwd=tmp, capture_output=True, timeout=600,
        env={**os.environ, "PYTHONPATH": os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))})
    assert ours.returncode == ref.returncode
    assert ours.stdout == ref.stdout
    err = b"\n".join(l for l in ours.stderr.splitlines()
                     if b"xla_bridge" not in l) + b"\n"
    assert err == ref.stderr
