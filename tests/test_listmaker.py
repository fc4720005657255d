"""Differential tests: our glistmaker vs the compiled reference binary.

The reference has no test suite (SURVEY.md §4); the verification oracle
is byte-identical .list output versus the reference binaries.
"""

import subprocess

import os
from pathlib import Path

import numpy as np
import pytest

from tests.conftest import run_reference, random_fasta, random_fastq
from genometester4_tpu.formats.list_format import read_list
from genometester4_tpu.pipelines.listmaker import make_list
from genometester4_tpu.cli import glistmaker as cli_glistmaker


def _run_both(tmp_path, fasta_text, k, cutoff=1, n_files=1, texts=None,
              chunk_bases=None):
    texts = texts or [fasta_text]
    paths = []
    for i, t in enumerate(texts):
        p = tmp_path / f"in{i}.fa"
        p.write_text(t)
        paths.append(str(p))

    r = run_reference(["glistmaker"] + paths + ["-w", str(k), "-c", str(cutoff),
                                                "-o", str(tmp_path / "ref")])
    assert r.returncode == 0, r.stderr
    ref_file = tmp_path / f"ref_{k}.list"

    kwargs = {}
    if chunk_bases:
        kwargs["chunk_bases"] = chunk_bases
    # CLI semantics: the reference IGNORES -c for .list output
    # (gt4_write_union hardcoded cutoff, src/glistmaker.c:333)
    make_list(paths, k, str(tmp_path / f"ours_{k}.list"), **kwargs)
    return ref_file, tmp_path / f"ours_{k}.list"


def _assert_identical(ref_file, ours_file):
    ref_bytes = ref_file.read_bytes()
    ours_bytes = ours_file.read_bytes()
    if ref_bytes != ours_bytes:
        h1, w1, c1 = read_list(ref_file)
        h2, w2, c2 = read_list(ours_file)
        assert h1.n_words == h2.n_words, (h1, h2)
        np.testing.assert_array_equal(np.asarray(w1), np.asarray(w2))
        np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
        raise AssertionError("records equal but raw bytes differ (header?)")


@pytest.mark.parametrize("k", [4, 11, 16, 17, 25, 32])
def test_byte_identical_small_fasta(tmp_path, rng, k):
    text = random_fasta(rng, n_records=5, min_len=200, max_len=2000, n_prob=0.01)
    ref_file, ours_file = _run_both(tmp_path, text, k)
    _assert_identical(ref_file, ours_file)


def test_byte_identical_with_cutoff(tmp_path, rng):
    """-c is parsed but IGNORED by the reference's .list path (fuzz
    finding): inputs full of count-1 words must survive -c 3."""
    text = random_fasta(rng, n_records=3, min_len=400, max_len=900)
    ref_file, ours_file = _run_both(tmp_path, text, 16, cutoff=3)
    h, w, c = read_list(ref_file)
    assert (np.asarray(c) == 1).any()  # cutoff visibly not applied
    _assert_identical(ref_file, ours_file)


def test_byte_identical_multi_file(tmp_path, rng):
    texts = [random_fasta(rng, 3, 500, 1500) for _ in range(3)]
    ref_file, ours_file = _run_both(tmp_path, None, 16, texts=texts)
    _assert_identical(ref_file, ours_file)


def test_byte_identical_fastq(tmp_path, rng):
    text = random_fastq(rng, n_records=200, read_len=100, n_prob=0.02)
    p = tmp_path / "in.fq"
    p.write_text(text)
    r = run_reference(["glistmaker", str(p), "-w", "25", "-o", str(tmp_path / "ref")])
    assert r.returncode == 0, r.stderr
    make_list([str(p)], 25, str(tmp_path / "ours_25.list"))
    _assert_identical(tmp_path / "ref_25.list", tmp_path / "ours_25.list")


def test_chunked_matches_unchunked(tmp_path, rng):
    """Multiple device chunks must merge to the same result as one."""
    text = random_fasta(rng, n_records=4, min_len=3000, max_len=8000)
    ref_file, ours_file = _run_both(tmp_path, text, 16, chunk_bases=4096)
    _assert_identical(ref_file, ours_file)


def test_cli_entry(tmp_path, rng, monkeypatch):
    text = random_fasta(rng, 2, 300, 600)
    p = tmp_path / "in.fa"
    p.write_text(text)
    monkeypatch.chdir(tmp_path)
    assert cli_glistmaker.main([str(p), "-w", "12", "-o", "cli"]) == 0
    r = run_reference(["glistmaker", str(p), "-w", "12", "-o", str(tmp_path / "ref")])
    assert r.returncode == 0
    _assert_identical(tmp_path / "ref_12.list", tmp_path / "cli_12.list")


def test_gz_input(tmp_path, rng):
    import gzip
    text = random_fasta(rng, 2, 500, 1000)
    p = tmp_path / "in.fa.gz"
    p.write_bytes(gzip.compress(text.encode()))
    plain = tmp_path / "in.fa"
    plain.write_text(text)
    r = run_reference(["glistmaker", str(p), "-w", "14", "-o", str(tmp_path / "ref")])
    assert r.returncode == 0, r.stderr
    make_list([str(p)], 14, str(tmp_path / "ours_14.list"))
    _assert_identical(tmp_path / "ref_14.list", tmp_path / "ours_14.list")


def test_spill_to_disk_byte_identical(tmp_path, rng):
    """Tiny spill threshold forces the tmp-file shard path; output must
    stay byte-identical to both the in-RAM path and the reference."""
    text = random_fasta(rng, n_records=3, min_len=30000, max_len=40000,
                        n_prob=0.005)
    fa = tmp_path / "in.fa"
    fa.write_text(text)
    r = run_reference(["glistmaker", str(fa), "-w", "16", "-o",
                       str(tmp_path / "ref")])
    assert r.returncode == 0
    make_list([str(fa)], 16, str(tmp_path / "spill.list"),
              spill_bytes=1 << 14, chunk_bases=1 << 14)
    assert (tmp_path / "spill.list").read_bytes() == (
        tmp_path / "ref_16.list").read_bytes()


def test_spill_bytes_env_knob(tmp_path, rng, monkeypatch):
    """GT4_SPILL_BYTES (round-5 knob: the memory budget the CLI path
    can set without an API call) must force the same durable
    spill-shard path and identical bytes — exercised through the CLI
    entry like a production run."""
    text = random_fasta(rng, n_records=2, min_len=25000, max_len=30000)
    fa = tmp_path / "in.fa"
    fa.write_text(text)
    r = run_reference(["glistmaker", str(fa), "-w", "16", "-o",
                       str(tmp_path / "ref")])
    assert r.returncode == 0
    monkeypatch.setenv("GT4_SPILL_BYTES", str(1 << 14))
    from genometester4_tpu.cli.glistmaker import main
    assert main([str(fa), "-w", "16", "-o", str(tmp_path / "env")]) == 0
    assert (tmp_path / "env_16.list").read_bytes() == (
        tmp_path / "ref_16.list").read_bytes()


def test_streaming_slabs_window_invariant(tmp_path, rng):
    """Counting via tiny slabs == counting the whole file: slab cuts land
    mid-record, mid-line, and at record boundaries, and the k-1 overlap
    carry must lose no window and count none twice. Also checks slab
    metadata totals match the whole-file parse."""
    from genometester4_tpu.io.fasta import iter_code_slabs, load_file
    text = random_fasta(rng, n_records=7, min_len=50, max_len=900,
                        n_prob=0.02)
    p = tmp_path / "s.fa"
    p.write_text(text)
    whole = load_file(str(p))
    k = 9
    for slab_bytes in (64, 257, 1024):
        metas = [m for _, m in iter_code_slabs(str(p), k, slab_bytes)]
        assert sum(m.n_records for m in metas) == whole.n_records
        assert sum(m.total_bases for m in metas) == whole.total_bases
        assert sum(m.count_n for m in metas) == whole.count_n
    out_a = tmp_path / "a.list"
    out_b = tmp_path / "b.list"
    make_list([str(p)], k, str(out_a))
    make_list([str(p)], k, str(out_b), slab_bytes=113)
    assert out_a.read_bytes() == out_b.read_bytes()


@pytest.mark.parametrize("slab_bytes", [97, 1000, 1 << 14])
def test_streaming_byte_identical_vs_reference(tmp_path, rng, slab_bytes):
    text = random_fasta(rng, n_records=6, min_len=100, max_len=2500,
                        n_prob=0.01)
    p = tmp_path / "in.fa"
    p.write_text(text)
    k = 16
    r = run_reference(["glistmaker", str(p), "-w", str(k),
                       "-o", str(tmp_path / "ref")])
    assert r.returncode == 0, r.stderr
    make_list([str(p)], k, str(tmp_path / "ours.list"), slab_bytes=slab_bytes)
    assert (tmp_path / "ours.list").read_bytes() == (
        tmp_path / f"ref_{k}.list").read_bytes()


def test_streaming_fastq_and_gz(tmp_path, rng):
    import gzip as _gz
    text = random_fastq(rng, n_records=300, read_len=75, n_prob=0.02)
    p = tmp_path / "in.fq"
    p.write_text(text)
    pgz = tmp_path / "in.fq.gz"
    pgz.write_bytes(_gz.compress(text.encode()))
    k = 12
    r = run_reference(["glistmaker", str(p), "-w", str(k),
                       "-o", str(tmp_path / "ref")])
    assert r.returncode == 0, r.stderr
    make_list([str(p)], k, str(tmp_path / "a.list"), slab_bytes=501)
    make_list([str(pgz)], k, str(tmp_path / "b.list"), slab_bytes=501)
    ref = (tmp_path / f"ref_{k}.list").read_bytes()
    assert (tmp_path / "a.list").read_bytes() == ref
    assert (tmp_path / "b.list").read_bytes() == ref


def test_streaming_single_line_fasta(tmp_path, rng):
    """One-line records larger than the slab (no newline in a slab)."""
    bases = "".join(rng.choice(list("ACGT"), size=5000))
    text = f">one\n{bases}\n>two\n{bases[:3000]}\n"
    p = tmp_path / "in.fa"
    p.write_text(text)
    k = 14
    r = run_reference(["glistmaker", str(p), "-w", str(k),
                       "-o", str(tmp_path / "ref")])
    assert r.returncode == 0, r.stderr
    make_list([str(p)], k, str(tmp_path / "ours.list"), slab_bytes=777)
    assert (tmp_path / "ours.list").read_bytes() == (
        tmp_path / f"ref_{k}.list").read_bytes()


def test_streaming_crlf_single_line_records(tmp_path, rng):
    """Fuzz regression: a CRLF file whose records are single giant lines
    — a tiny slab can end exactly on the '\r' of a CRLF split across
    slabs, which must not be consumed as a sequence byte."""
    bases = "".join(rng.choice(list("ACGTN"), size=3000))
    text = (">a\r\n" + bases + "\r\n>b desc\r\n" + bases[:1777] + "\r\n")
    p = tmp_path / "in.fa"
    p.write_bytes(text.encode())
    for k in (2, 25):
        r = run_reference(["glistmaker", str(p), "-w", str(k),
                           "-o", str(tmp_path / "ref")])
        assert r.returncode == 0, r.stderr
        for slab in (37, 101):
            make_list([str(p)], k, str(tmp_path / "t.list"),
                      slab_bytes=slab, chunk_bases=1 << 12)
            assert (tmp_path / "t.list").read_bytes() == (
                tmp_path / f"ref_{k}.list").read_bytes()


def test_omp_threads_byte_identical(tmp_path, rng):
    """The MSD-bucket presort parallelizes across OpenMP threads; output
    bytes must be identical at any OMP_NUM_THREADS (parallelism only
    moves WHEN a bucket is sorted, never the emission order)."""
    import subprocess
    import sys as _sys

    text = random_fasta(rng, 3, 30000, 50000, n_prob=0.01)
    fa = tmp_path / "in.fa"
    fa.write_text(text)
    outs = []
    for nt in ("1", "4"):
        out = tmp_path / f"o{nt}.list"
        code = (
            "import jax, sys; jax.config.update('jax_platforms','cpu')\n"
            "from genometester4_tpu.pipelines.listmaker import make_list\n"
            f"make_list([{str(fa)!r}], 16, {str(out)!r})\n")
        env = dict(__import__('os').environ, OMP_NUM_THREADS=nt)
        r = subprocess.run([_sys.executable, "-c", code], env=env,
                           capture_output=True)
        assert r.returncode == 0, r.stderr
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]


def test_fastq_crlf_empty_fields_byte_identical(tmp_path):
    """fuzz_ingest finding (round 4, seed 404): a CRLF FASTQ record with
    an EMPTY sequence (and quality) line — "@name\\r\\n\\r\\n+\\r\\n\\r\\n" —
    desynced the native slab parser's 4-line group cadence: it stripped
    CR before its line-emptiness test, so "\\r\\n" fields vanished and
    every later line shifted roles (sequences became qualities, zero
    records emitted). parse_fastq's _line_index counts a line iff it
    has >=1 RAW byte before the newline; the native pass now mirrors
    that exactly."""
    import subprocess

    from tests.conftest import has_reference, run_reference
    if not has_reference():
        import pytest
        pytest.skip("reference not built")
    fq = tmp_path / "in.fa"   # extension lies on purpose (content sniff)
    seq = "ACGTGGTACGTTACGGATTTACGGTACGGGTACCGTAAACCGGTTACGATCGGTA" * 40
    fq.write_bytes(
        b"@empty first record\r\n\r\n+plus line with text\r\n\r\n"
        + b"@rec1\r\n" + seq.encode() + b"\r\n+\r\n"
        + b"I" * len(seq) + b"\r\n"
        + b"@rec2\r\n" + seq[5:].encode() + b"\r\n+\r\n"
        + b"J" * (len(seq) - 5) + b"\r\n")
    r = run_reference(["glistmaker", str(fq), "-w", "31",
                       "-o", str(tmp_path / "ref")])
    assert r.returncode == 0, r.stderr
    launcher = str(Path(__file__).resolve().parent.parent / "bin"
                   / "glistmaker")
    r = subprocess.run([launcher, str(fq), "-w", "31", "-o",
                        str(tmp_path / "ours")],
                       env=dict(os.environ, GT4_TPU_COUNT_IMPL="host"),
                       capture_output=True)
    assert r.returncode == 0, r.stderr
    ours = (tmp_path / "ours_31.list").read_bytes()
    ref = (tmp_path / "ref_31.list").read_bytes()
    assert ours == ref
    assert len(ref) > 48  # records actually produced


def test_fastq_lf_empty_record_byte_identical(tmp_path):
    """fuzz_ingest finding (round 4, seed 517): a bare-LF FASTQ record
    with zero-length sequence and quality lines ("@n\\n\\n+\\n\\n") is a
    complete 4-line record to the reference's line-driven state machine
    (src/fasta.c:190-293) — and it registers the empty record in the
    .index subsequence registry. parse_fastq's old line index dropped
    zero-length lines, shifting the group cadence (sequences became
    qualities). Checks .list and .index bytes."""
    import subprocess

    from tests.conftest import has_reference, run_reference
    if not has_reference():
        import pytest
        pytest.skip("reference not built")
    fq = tmp_path / "in.fq"
    seq = "ACGTGGTACGTTACGGATTTACGGTACGGGTACCGTAAACCGGTTACGATCGGTA" * 30
    fq.write_bytes(
        b"@rec0\n" + seq.encode() + b"\n+\n" + b"I" * len(seq) + b"\n"
        + b"@empty\n\n+\n\n"
        + b"@rec2\n" + seq[3:].encode() + b"\n+\n"
        + b"J" * (len(seq) - 3) + b"\n")
    launcher = str(Path(__file__).resolve().parent.parent / "bin"
                   / "glistmaker")
    for extra, ext in (([], "list"), (["--index"], "index")):
        r = run_reference(["glistmaker", str(fq), "-w", "25",
                           "-o", str(tmp_path / "ref")] + extra)
        assert r.returncode == 0, r.stderr
        r = subprocess.run([launcher, str(fq), "-w", "25", "-o",
                            str(tmp_path / "ours")] + extra,
                           env=dict(os.environ, GT4_TPU_COUNT_IMPL="host"),
                           capture_output=True)
        assert r.returncode == 0, r.stderr
        assert (tmp_path / f"ours_25.{ext}").read_bytes() == \
               (tmp_path / f"ref_25.{ext}").read_bytes(), ext
