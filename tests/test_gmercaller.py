"""Differential tests: our gmer_caller vs the compiled reference binary.

The training path depends on glibc rand() (srand(1)), float32 simplex
arithmetic, and libm transcendentals — the native exact library
reproduces all three, so even trained outputs must be byte-identical.
"""

import io
import sys

import numpy as np
import pytest

from tests.conftest import run_reference


def synth_counts(rng, n_a=4000, n_x=300, n_y=120, male=True, mean=30):
    """Synthetic gmer_counter output: diploid autosomes, haploid X/Y for
    males, diploid X (and noise-level Y) for females."""
    lines = []

    def nb(m, n):
        return rng.poisson(rng.gamma(10, np.maximum(m, 1e-3) / 10, n))

    for i in range(n_a):
        gt = rng.choice([0, 1, 2], p=[0.7, 0.25, 0.05])
        a = int(nb(mean if gt == 0 else (mean / 2 if gt == 1 else 0.5), 1)[0])
        b = int(nb(0.5 if gt == 0 else (mean / 2 if gt == 1 else mean), 1)[0])
        lines.append(f"{rng.integers(1, 23)}_m{i}\t2\t{a}\t{b}")
    xm = mean / 2 if male else mean
    for i in range(n_x):
        a = int(nb(xm, 1)[0])
        b = int(nb(0.5, 1)[0])
        lines.append(f"X_m{i}\t2\t{a}\t{b}")
    for i in range(n_y):
        m = mean / 2 if male else 0.05
        a = int(nb(m, 1)[0])
        b = int(nb(0.5, 1)[0])
        lines.append(f"Y_m{i}\t2\t{a}\t{b}")
    return "\n".join(lines) + "\n"


def run_ours(args):
    from genometester4_tpu.cli.gmer_caller import main
    old = sys.stdout
    sys.stdout = io.StringIO()
    try:
        rc = main(args)
        out = sys.stdout.getvalue()
    finally:
        sys.stdout = old
    return rc, out


def both(tmp_path, counts_text, flags):
    p = tmp_path / "counts.txt"
    p.write_text(counts_text)
    ref = run_reference(["gmer_caller"] + flags + [str(p)], timeout=600)
    assert ref.returncode == 0, ref.stderr
    rc, out = run_ours(flags + [str(p)])
    assert rc == 0
    return ref.stdout.decode(), out


@pytest.mark.parametrize("flags", [
    ["--runs", "0", "--coverage", "30"],
    ["--runs", "0", "--coverage", "30", "--header", "--info",
     "--alternatives"],
    ["--runs", "0", "--coverage", "30", "--prob_cutoff", "0.9"],
    ["--runs", "0", "--coverage", "30", "--non_canonical"],
    ["--runs", "0", "--coverage", "30", "--model", "diploid"],
    ["--runs", "0", "--coverage", "15", "--model", "haploid"],
])
def test_no_training_identical(tmp_path, rng, flags):
    ref, ours = both(tmp_path, synth_counts(rng, n_a=1500, male=True), flags)
    assert ours == ref


def test_trained_male_identical(tmp_path, rng):
    ref, ours = both(tmp_path, synth_counts(rng, male=True),
                     ["--header", "--info"])
    assert ours == ref


def test_trained_female_identical(tmp_path, rng):
    ref, ours = both(tmp_path, synth_counts(rng, male=False),
                     ["--info"])
    assert ours == ref


def test_trained_params_roundtrip(tmp_path, rng):
    """--params pins the model: no training, pure posterior printing."""
    ref, ours = both(tmp_path, synth_counts(rng, n_a=1200),
                     ["--runs", "0", "--params", "0.05", "4e-05", "0.015",
                      "0.985", "28.5", "65.48", "-0.6792684"])
    assert ours == ref


def test_training_size_subset(tmp_path, rng):
    """Partial training subset exercises the rand_long_long shuffle."""
    ref, ours = both(tmp_path, synth_counts(rng, n_a=3000),
                     ["--training_size", "1000", "--info"])
    assert ours == ref


def test_counter_to_caller_pipeline(tmp_path, rng):
    """Full FastGT chain: reads -> gmer_counter -> gmer_caller, both
    implementations end to end."""
    from tests.test_gmercounter import make_db, make_reads, run_ours as run_counter

    w = 14
    db_text, kmers = make_db(rng, n_nodes=40, kmers_per_node=2, w=w)
    db = tmp_path / "db.txt"
    db.write_text(db_text)
    fa = tmp_path / "reads.fa"
    fa.write_text(make_reads(rng, kmers, w, n_reads=2000, read_len=80,
                             hit_prob=0.9))

    ref_cnt = run_reference(["gmer_counter", "-db", str(db), str(fa)])
    assert ref_cnt.returncode == 0
    (tmp_path / "ref.cnt").write_bytes(ref_cnt.stdout)
    rc, out = run_counter(["-db", str(db), str(fa)])
    assert rc == 0
    (tmp_path / "ours.cnt").write_text(out)
    assert out == ref_cnt.stdout.decode()

    ref_call = run_reference(["gmer_caller", "--runs", "0", "--coverage",
                              "10", str(tmp_path / "ref.cnt")], timeout=600)
    assert ref_call.returncode == 0, ref_call.stderr
    rc, call_out = run_ours(["--runs", "0", "--coverage", "10",
                             str(tmp_path / "ours.cnt")])
    assert rc == 0
    assert call_out == ref_call.stdout.decode()


def test_short_marker_lines_uninit_bug(tmp_path, rng):
    """Fuzz regression: a marker line with <4 tokens (single-kmer node)
    leaves the reference's SNPCall malloc'd memory uninitialized
    (src/gmer_caller.c:148,157) — zero pages in practice, so it prints
    counts 0/0 under LINE 0's name, scanning past the newline to the
    first tab. Byte-reproduced."""
    lines = ["#gmer_counter version 4.2.16 (stable)", "#TextDatabase\tdb"]
    for i in range(30):
        a, b = int(rng.integers(0, 9)), int(rng.integers(0, 9))
        if i % 7 == 3:
            lines.append(f"1_{i}\t1\t{a}")  # 3 tokens: skip path
        else:
            lines.append(f"1_{i}\t2\t{a}\t{b}")
    p = tmp_path / "counts.txt"
    p.write_text("\n".join(lines) + "\n")
    ref = run_reference(["gmer_caller", str(p)])
    assert ref.returncode == 0, ref.stderr
    rc, out = run_ours([str(p)])
    assert rc == 0
    assert out == ref.stdout.decode()
