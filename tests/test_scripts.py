"""Differential tests for the post-processing script equivalents:
generate_vcf / katk2vcf (vs the reference Perl scripts, which are
available in this environment) and MakeUnion/MakeIntersection (staging
trees + final lists vs the Perl drivers shelling out to the reference
glistcompare)."""

import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from tests.conftest import REF_BIN, run_reference

SCRIPTS = REF_BIN.parent.parent.parent / "reference" / "scripts"
import pathlib
SCRIPTS = pathlib.Path("/root/reference/scripts")

perl = shutil.which("perl")


def run_cli(fn, args, capture="stdout"):
    buf = io.StringIO()
    old = getattr(sys, capture)
    setattr(sys, capture, buf)
    try:
        rc = fn(args)
    finally:
        setattr(sys, capture, old)
    return rc, buf.getvalue()


@pytest.mark.skipif(perl is None, reason="perl not available")
def test_generate_vcf_identical(tmp_path):
    calls = tmp_path / "calls.txt"
    calls.write_text(
        "#gmer_counter version 4.2.16 (stable)\n#Sex\tM\n"
        "1:12345:rs111:A/G\tAB\t0.99\t10\t12\n"
        "2:777:rs222:C/T\tAA\t1.00\t20\t0\n"
        "X:5555:rs333:G/C\tB\t0.98\t1\t15\n"
        "Y:123:rs444:T/A\tA\t0.97\t9\t0\n")
    ref = subprocess.run([perl, str(SCRIPTS / "generate_vcf.pl"),
                          str(calls)], capture_output=True, text=True)
    from genometester4_tpu.cli.generate_vcf import main
    rc, out = run_cli(main, [str(calls)])
    assert rc == 0
    assert out == ref.stdout


@pytest.mark.skipif(perl is None, reason="perl not available")
def test_katk2vcf_identical(tmp_path, rng):
    B = "ACGT"
    seq = "".join(B[i] for i in rng.integers(0, 4, 2000))
    chrdir = tmp_path / "chrdir"
    chrdir.mkdir()
    (chrdir / "1.fa").write_text(
        ">1\n" + "\n".join(seq[i:i + 60]
                           for i in range(0, len(seq), 60)) + "\n")
    alt = "G" if seq[149] != "G" else "T"
    lines = ["#KATK version: 4.2.16",
             "CHR\tPOS\tSUB\tREF\tCOV\tCALL\tCLASS\tP\tPMUT",
             f"1\t100\t0\t{seq[99]}\t30\tNC\t0\t0.5\t0.4",
             f"1\t150\t0\t{seq[149]}\t30\t{seq[149]}{alt}\tS\t0.99\t0.97",
             "1\t200\t1\t-\t28\t-A\tI\t0.98\t0.9",
             "1\t200\t2\t-\t28\t-A\tI\t0.98\t0.9",
             f"1\t300\t0\t{seq[299]}\t30\t{seq[299]}-\tD\t0.97\t0.9",
             f"1\t400\t0\t{seq[399]}\t25\t{seq[399]}{seq[399]}\t0\t0.99"
             "\t0.99"]
    calls = tmp_path / "katk_calls.txt"
    calls.write_text("\n".join(lines) + "\n")
    patched = tmp_path / "katk2vcf_local.pl"
    src = (SCRIPTS / "katk2vcf.pl").read_text()
    src = src.replace('my $chr_dir = "/storage9/db/human_GRCh38/data/chr/";',
                      f'my $chr_dir = "{chrdir}/";')
    patched.write_text(src)
    ref = subprocess.run([perl, str(patched), str(calls)],
                         capture_output=True, text=True)
    from genometester4_tpu.cli.katk2vcf import main
    rc, out = run_cli(main, ["--chr_dir", str(chrdir), str(calls)])
    assert rc == 0
    assert out == ref.stdout


@pytest.mark.skipif(perl is None, reason="perl not available")
def test_katk2vcf_cross_chromosome_flush_quirk(tmp_path, rng):
    """fuzz_scripts finding (round 4): a pending indel flushed at a
    chromosome switch is re-attributed to the NEW line's chromosome
    ($voti = $tmp0[0], scripts/katk2vcf.pl:63-65,82-84) while the
    left-shift scan indexes the OLD chromosome's sequence — and the
    deletion r=0 identity match fires unconditionally, so the
    reattribution happens even with no shift. Byte-parity requires
    reproducing it."""
    B = "ACGT"
    chrdir = tmp_path / "chrdir"
    chrdir.mkdir()
    seqs = {}
    for cn in ("1", "2"):
        seq = "".join(B[i] for i in rng.integers(0, 4, 1500))
        seqs[cn] = seq
        (chrdir / f"{cn}.fa").write_text(
            ">%s\n" % cn + "\n".join(seq[i:i + 60]
                                     for i in range(0, len(seq), 60))
            + "\n")
    # chrom-2 deletion left pending across the switch: the negative
    # position delta suppresses the flush, the chrom-1 S line clobbers
    # the shared $mutat_* state to single chars, and the next gap
    # flushes the deletion with the every-r empty-string match — the
    # variant re-emerges 50 bp left, on chromosome 1, with bases from
    # chromosome 2 (scripts/katk2vcf.pl:45-89)
    def alt(b):
        return "G" if b != "G" else "T"
    lines = ["#KATK version: 4.2.16",
             "CHR\tPOS\tSUB\tREF\tCOV\tCALL\tCLASS\tP\tPMUT",
             f"2\t600\t0\t{seqs['2'][599]}\t30\t{seqs['2'][599]}-\tD"
             "\t0.9\t0.9",
             f"1\t300\t0\t{seqs['1'][299]}\t30"
             f"\t{seqs['1'][299]}{alt(seqs['1'][299])}\tS\t0.9\t0.9",
             f"1\t500\t0\t{seqs['1'][499]}\t30"
             f"\t{seqs['1'][499]}{alt(seqs['1'][499])}\tS\t0.9\t0.9"]
    calls = tmp_path / "calls.txt"
    calls.write_text("\n".join(lines) + "\n")
    patched = tmp_path / "katk2vcf_local.pl"
    src = (SCRIPTS / "katk2vcf.pl").read_text()
    src = src.replace('my $chr_dir = "/storage9/db/human_GRCh38/data/chr/";',
                      f'my $chr_dir = "{chrdir}/";')
    patched.write_text(src)
    ref = subprocess.run([perl, str(patched), str(calls)],
                         capture_output=True, text=True)
    from genometester4_tpu.cli.katk2vcf import main
    rc, out = run_cli(main, ["--chr_dir", str(chrdir), str(calls)])
    assert rc == 0
    assert out == ref.stdout
    # the quirk line: the pending 2:600 deletion prints under
    # chromosome 1 at position 550 (slid 50 left by the final r=49
    # empty-string match)
    body = [l for l in out.splitlines() if not l.startswith("#")]
    assert any(l.startswith("1\t550\t") and "\tD\t" in l for l in body)


@pytest.mark.skipif(perl is None, reason="perl not available")
def test_katk2vcf_degenerate_position_tokens(tmp_path, rng):
    """Round-5 advisor finding (medium): a non-numeric position token
    (e.g. "12x") opening an I/D run crashed flush_indel's strict
    int() while Perl numifies it ($lahti[1]-1, scripts/katk2vcf.pl:47).
    Also covers the same numification family in the output loop
    (pl:196) where a position-0 key wraps substr to the LAST
    chromosome base via Perl's negative offset."""
    B = "ACGT"
    seq = "".join(B[i] for i in rng.integers(0, 4, 200))
    chrdir = tmp_path / "chrdir"
    chrdir.mkdir()
    (chrdir / "1.fa").write_text(
        ">1\n" + "\n".join(seq[i:i + 60]
                           for i in range(0, len(seq), 60)) + "\n")

    def alt(b):
        return "G" if b != "G" else "T"
    lines = ["#KATK version: 4.2.16",
             "CHR\tPOS\tSUB\tREF\tCOV\tCALL\tCLASS\tP\tPMUT",
             # I run opened at the degenerate position "12x" (numifies
             # to 12); the gap to pos 30 triggers flush_indel on it
             "1\t12x\t0\t-\t28\t-A\tI\t0.98\t0.9",
             "1\t12x\t0\t-\t28\t-A\tI\t0.98\t0.9",
             f"1\t30\t0\t{seq[29]}\t30\t{seq[29]}{alt(seq[29])}\tS"
             "\t0.9\t0.9",
             # S at numified position 0: the VCF loop's nuc becomes
             # the LAST chromosome base (substr negative wrap)
             f"1\t0junk\t0\t{seq[199]}\t30"
             f"\t{seq[199]}{alt(seq[199])}\tS\t0.9\t0.9",
             # sacrificial last call (the Perl loop drops the final one)
             f"1\t80\t0\t{seq[79]}\t30\t{seq[79]}{alt(seq[79])}\tS"
             "\t0.9\t0.9"]
    calls = tmp_path / "calls.txt"
    calls.write_text("\n".join(lines) + "\n")
    patched = tmp_path / "katk2vcf_local.pl"
    src = (SCRIPTS / "katk2vcf.pl").read_text()
    src = src.replace('my $chr_dir = "/storage9/db/human_GRCh38/data/chr/";',
                      f'my $chr_dir = "{chrdir}/";')
    patched.write_text(src)
    ref = subprocess.run([perl, str(patched), str(calls)],
                         capture_output=True, text=True)
    from genometester4_tpu.cli.katk2vcf import main
    rc, out = run_cli(main, ["--chr_dir", str(chrdir), str(calls)])
    assert rc == 0
    assert out == ref.stdout


@pytest.mark.skipif(perl is None, reason="perl not available")
def test_katk2vcf_d_scan_stale_ajut_retention(tmp_path, rng):
    """Round-5 advisor finding: in the Perl D-branch every
    per-iteration $ajut_1 assignment is guarded by length($mutat_1)>1
    (scripts/katk2vcf.pl:75-76), so when a match truncates mutat_1 to
    one char (substr clamped by a negative offset near the chromosome
    start), Perl RETAINS the previous matching $ajut_1 and re-fires
    the match at every later r. A pending heterozygous deletion at
    position 1 (p0=0) hits exactly that: the r=0 identity match
    rewrites mutat_1 = substr(seq,-1,2) = one char, and the stale
    ajut then slides the variant to position -49."""
    B = "ACGT"
    seq = "".join(B[i] for i in rng.integers(0, 4, 100))
    chrdir = tmp_path / "chrdir"
    chrdir.mkdir()
    (chrdir / "1.fa").write_text(
        ">1\n" + "\n".join(seq[i:i + 60]
                           for i in range(0, len(seq), 60)) + "\n")

    def alt(b):
        return "G" if b != "G" else "T"
    lines = ["#KATK version: 4.2.16",
             "CHR\tPOS\tSUB\tREF\tCOV\tCALL\tCLASS\tP\tPMUT",
             f"1\t1\t0\t{seq[0]}\t30\t{seq[0]}-\tD\t0.9\t0.9",
             f"1\t60\t0\t{seq[59]}\t30\t{seq[59]}{alt(seq[59])}\tS"
             "\t0.9\t0.9",
             f"1\t80\t0\t{seq[79]}\t30\t{seq[79]}{alt(seq[79])}\tS"
             "\t0.9\t0.9"]
    calls = tmp_path / "calls.txt"
    calls.write_text("\n".join(lines) + "\n")
    patched = tmp_path / "katk2vcf_local.pl"
    src = (SCRIPTS / "katk2vcf.pl").read_text()
    src = src.replace('my $chr_dir = "/storage9/db/human_GRCh38/data/chr/";',
                      f'my $chr_dir = "{chrdir}/";')
    patched.write_text(src)
    ref = subprocess.run([perl, str(patched), str(calls)],
                         capture_output=True, text=True)
    from genometester4_tpu.cli.katk2vcf import main
    rc, out = run_cli(main, ["--chr_dir", str(chrdir), str(calls)])
    assert rc == 0
    assert out == ref.stdout
    # the retention quirk: the deletion lands at position -49
    body = [l for l in out.splitlines() if not l.startswith("#")]
    assert any(l.startswith("1\t-49\t") for l in body)


def test_make_union_intersection_tree(tmp_path, rng):
    from tests.conftest import has_reference
    if not has_reference():
        pytest.skip("reference not built")
    B = "ACGT"
    ref_dir = tmp_path / "mu_ref"
    ours_dir = tmp_path / "mu_ours"
    ref_dir.mkdir()
    ours_dir.mkdir()
    names = []
    for i in range(5):
        seq = "".join(B[j] for j in rng.integers(0, 4, 800))
        fa = ref_dir / f"l{i}.fa"
        fa.write_text(f">s\n{seq}\n")
        r = run_reference(["glistmaker", str(fa), "-w", "10", "-o",
                           str(ref_dir / f"l{i}")])
        assert r.returncode == 0
        shutil.copy(ref_dir / f"l{i}_10.list", ours_dir / f"l{i}_10.list")
        names.append(f"l{i}_10.list")
    if perl:
        shutil.copy(REF_BIN / "glistcompare", ref_dir / "glistcompare")
        subprocess.run([perl, str(SCRIPTS / "MakeUnion.pl")] + names,
                       cwd=ref_dir, capture_output=True)
    from genometester4_tpu.cli.make_union import main_union
    old = os.getcwd()
    os.chdir(ours_dir)
    try:
        rc, _ = run_cli(main_union, names, capture="stderr")
    finally:
        os.chdir(old)
    assert rc == 0
    assert (ours_dir / "union_10_union.list").exists()
    if perl and (ref_dir / "union_10_union.list").exists():
        assert (ours_dir / "union_10_union.list").read_bytes() == (
            ref_dir / "union_10_union.list").read_bytes()
