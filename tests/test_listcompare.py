"""Differential tests: glistcompare vs the reference binary."""

import numpy as np
import pytest

from tests.conftest import run_reference, random_fasta
from genometester4_tpu.pipelines.listmaker import make_list
from genometester4_tpu.cli import glistcompare as cli


def _mk_lists(tmp_path, rng, k=16, overlap=True):
    """Two overlapping k-mer lists built by OUR listmaker (already proven
    byte-identical to the reference's)."""
    base = random_fasta(rng, 2, 4000, 8000)
    t1 = base + random_fasta(rng, 2, 2000, 4000)
    t2 = base + random_fasta(rng, 2, 2000, 4000)
    p1, p2 = tmp_path / "a.fa", tmp_path / "b.fa"
    p1.write_text(t1)
    p2.write_text(t2)
    l1, l2 = tmp_path / f"a_{k}.list", tmp_path / f"b_{k}.list"
    make_list([str(p1)], k, str(l1))
    make_list([str(p2)], k, str(l2))
    return l1, l2


def _cmp_out(tmp_path, name):
    ref = (tmp_path / f"ref_{name}").read_bytes()
    ours = (tmp_path / f"ours_{name}").read_bytes()
    assert ref == ours, f"{name}: outputs differ ({len(ref)} vs {len(ours)} bytes)"


FLAG_CASES = [
    (["-u"], ["16_union.list"]),
    (["-i"], ["16_intrsec.list"]),
    (["-d"], ["16_0_diff1.list"]),
    (["-dd"], ["16_0_diff1.list", "16_0_diff2.list"]),
    (["-du"], ["16_0_diff1.list"]),
    (["-u", "-i", "-d", "-dd"], ["16_union.list", "16_intrsec.list",
                                 "16_0_diff1.list", "16_0_diff2.list"]),
    (["-u", "-c", "2"], ["16_union.list"]),
    (["-i", "-c", "2"], ["16_intrsec.list"]),
    (["-i", "-r", "max"], ["16_intrsec.list"]),
    (["-i", "-r", "add"], ["16_intrsec.list"]),
    (["-i", "-r", "first"], ["16_intrsec.list"]),
    (["-i", "-r", "second"], ["16_intrsec.list"]),
    (["-u", "-r", "max"], ["16_union.list"]),
    (["-i", "-r", "7"], ["16_intrsec.list"]),
]


@pytest.mark.parametrize("flags,outputs", FLAG_CASES)
def test_pair_ops_byte_identical(tmp_path, rng, flags, outputs):
    l1, l2 = _mk_lists(tmp_path, rng)
    r = run_reference(["glistcompare", str(l1), str(l2)] + flags +
                      ["-o", str(tmp_path / "ref")])
    assert r.returncode == 0, r.stderr
    assert cli.main([str(l1), str(l2)] + flags + ["-o", str(tmp_path / "ours")]) == 0
    for name in outputs:
        _cmp_out(tmp_path, name)


def test_count_only_stdout(tmp_path, rng, capsys):
    l1, l2 = _mk_lists(tmp_path, rng)
    r = run_reference(["glistcompare", str(l1), str(l2), "-u", "-i",
                       "--count_only", "-o", str(tmp_path / "ref")])
    assert r.returncode == 0
    assert cli.main([str(l1), str(l2), "-u", "-i", "--count_only",
                     "-o", str(tmp_path / "ours")]) == 0
    assert capsys.readouterr().out == r.stdout.decode()


def test_multi_union_intersection(tmp_path, rng):
    k = 16
    ls = []
    base = random_fasta(rng, 1, 5000, 6000)
    for i in range(4):
        t = base + random_fasta(rng, 1, 2000, 3000)
        p = tmp_path / f"m{i}.fa"
        p.write_text(t)
        lp = tmp_path / f"m{i}_{k}.list"
        make_list([str(p)], k, str(lp))
        ls.append(str(lp))
    for flags, outputs in [(["-u"], ["16_union.list"]),
                           (["-i"], ["16_intrsec.list"]),
                           (["-u", "-r", "max"], ["16_union.list"]),
                           (["-i", "-r", "add"], ["16_intrsec.list"]),
                           (["-u", "-c", "3"], ["16_union.list"])]:
        r = run_reference(["glistcompare"] + ls + flags + ["-o", str(tmp_path / "ref")])
        assert r.returncode == 0, r.stderr
        assert cli.main(ls + flags + ["-o", str(tmp_path / "ours")]) == 0
        for name in outputs:
            _cmp_out(tmp_path, name)


@pytest.mark.parametrize("method", ["rand", "rand_unique", "rand_weighted_unique"])
def test_subset_exact_drand48_parity(tmp_path, rng, method):
    l1, _ = _mk_lists(tmp_path, rng)
    r = run_reference(["glistcompare", str(l1), "-ss", method, "500",
                       "--seed", "42", "-o", str(tmp_path / "ref")])
    assert r.returncode == 0, r.stderr
    assert cli.main([str(l1), "-ss", method, "500", "--seed", "42",
                     "-o", str(tmp_path / "ours")]) == 0
    _cmp_out(tmp_path, "subset_16.list")


@pytest.mark.parametrize("nmm", [1, 2])
def test_mismatch_difference(tmp_path, rng, nmm):
    l1, l2 = _mk_lists(tmp_path, rng, k=12)
    r = run_reference(["glistcompare", str(l1), str(l2), "-d", "-mm", str(nmm),
                       "-o", str(tmp_path / "ref")])
    assert r.returncode == 0, r.stderr
    assert cli.main([str(l1), str(l2), "-d", "-mm", str(nmm),
                     "-o", str(tmp_path / "ours")]) == 0
    _cmp_out(tmp_path, f"12_{nmm}_diff1.list")


def test_mismatch_ddiff(tmp_path, rng):
    l1, l2 = _mk_lists(tmp_path, rng, k=12)
    r = run_reference(["glistcompare", str(l1), str(l2), "-dd", "-mm", "1",
                       "-o", str(tmp_path / "ref")])
    assert r.returncode == 0, r.stderr
    assert cli.main([str(l1), str(l2), "-dd", "-mm", "1",
                     "-o", str(tmp_path / "ours")]) == 0
    _cmp_out(tmp_path, "12_1_diff1.list")
    _cmp_out(tmp_path, "12_1_diff2.list")


def test_mm_neighborhood_counts_presence_not_frequency(tmp_path):
    """Fuzz regression: the reference's mm filter sums FOUND FLAGS, not
    counts — gt4_word_dict_lookup returns 1/0 and search_query never
    reads inst->value (src/word-dict.c:61-71, glistcompare.c:1114-1127).
    A single neighbor with a huge count must NOT trip cutoff 2."""
    import numpy as np
    from genometester4_tpu.formats.list_format import write_list
    from genometester4_tpu.ops.encode import string_to_word
    from tests.conftest import run_reference
    w1 = np.array([string_to_word("AAGTTAAG")], np.uint64)
    write_list(str(tmp_path / "a.list"), 8, w1, np.array([4], np.uint32))
    w2 = np.array([string_to_word("AAATTAAG")], np.uint64)
    write_list(str(tmp_path / "b.list"), 8, w2,
               np.array([400882038], np.uint32))
    r = run_reference(["glistcompare", str(tmp_path / "a.list"),
                       str(tmp_path / "b.list"), "-d", "-mm", "1", "-c",
                       "2", "-o", str(tmp_path / "ref")])
    assert r.returncode == 0, r.stderr
    from genometester4_tpu.pipelines.listcompare import compare_pair_mm
    compare_pair_mm(str(tmp_path / "a.list"), str(tmp_path / "b.list"),
                    ["diff1"], str(tmp_path / "ours"), cutoff=2, nmm=1)
    assert (tmp_path / "ours_8_1_diff1.list").read_bytes() == (
        tmp_path / "ref_8_1_diff1.list").read_bytes()


@pytest.mark.parametrize("subtract", [False, True])
@pytest.mark.parametrize("nmm,cutoff", [(1, 1), (1, 3), (2, 2)])
def test_mm_filter_native_matches_numpy(tmp_path, rng, monkeypatch,
                                        subtract, nmm, cutoff):
    """fgx_mm_filter (the round-5 early-exit native -mm kernel) must be
    byte-identical to the vectorized numpy twin (GT4_MM_IMPL=numpy)
    across ops x subtract x nmm x cutoff on overlapping random lists."""
    import numpy as np
    from genometester4_tpu.formats.list_format import write_list
    from genometester4_tpu.pipelines.listcompare import compare_pair_mm
    k = 9
    pool = np.unique(rng.integers(0, 1 << (2 * k), size=3000)
                     .astype(np.uint64))
    from genometester4_tpu.ops.encode import canonical_u64
    pool = np.unique(canonical_u64(pool, k))
    w1 = pool[rng.random(len(pool)) < 0.5]
    w2 = pool[rng.random(len(pool)) < 0.5]
    if not len(w1) or not len(w2):
        pytest.skip("degenerate draw")
    c1 = rng.integers(1, 9, size=len(w1)).astype(np.uint32)
    c2 = rng.integers(1, 9, size=len(w2)).astype(np.uint32)
    write_list(str(tmp_path / "a.list"), k, w1, c1)
    write_list(str(tmp_path / "b.list"), k, w2, c2)
    outs = {}
    for impl in ("native", "numpy"):
        monkeypatch.setenv("GT4_MM_IMPL", impl)
        compare_pair_mm(str(tmp_path / "a.list"), str(tmp_path / "b.list"),
                        ["diff1", "diff2"], str(tmp_path / impl),
                        cutoff=cutoff, nmm=nmm, subtract=subtract)
        outs[impl] = tuple(
            (tmp_path / f"{impl}_{k}_{nmm}_{s}.list").read_bytes()
            for s in ("diff1", "diff2"))
    assert outs["native"] == outs["numpy"]


@pytest.mark.parametrize("impl", ["host", "device"])
def test_pair_ops_impl_twins_identical(tmp_path, rng, impl, monkeypatch):
    """Host numpy twins == device kernels == reference, all ops+rules."""
    monkeypatch.setenv("GT4_TPU_SETOPS_IMPL", impl)
    import numpy as np
    from genometester4_tpu.formats.list_format import write_list
    from genometester4_tpu.pipelines.listcompare import compare_pair
    w1 = np.unique(rng.integers(0, 1 << 20, size=700).astype(np.uint64))
    w2 = np.unique(rng.integers(0, 1 << 20, size=500).astype(np.uint64))
    c1 = rng.integers(1, 9, size=len(w1)).astype(np.uint32)
    c2 = rng.integers(1, 9, size=len(w2)).astype(np.uint32)
    write_list(str(tmp_path / "a.list"), 10, w1, c1)
    write_list(str(tmp_path / "b.list"), 10, w2, c2)
    r = run_reference(["glistcompare", str(tmp_path / "a.list"),
                       str(tmp_path / "b.list"), "-u", "-i", "-d", "-dd",
                       "-c", "2", "-o", str(tmp_path / "ref")])
    assert r.returncode == 0, r.stderr
    compare_pair(str(tmp_path / "a.list"), str(tmp_path / "b.list"),
                 ["union", "intrsec", "diff1", "diff2"],
                 str(tmp_path / "got"), cutoff=2)
    for suffix in ("union", "intrsec", "0_diff1", "0_diff2"):
        assert (tmp_path / f"got_10_{suffix}.list").read_bytes() == \
            (tmp_path / f"ref_10_{suffix}.list").read_bytes(), (impl, suffix)


@pytest.mark.parametrize("impl", ["host", "device"])
def test_multi_ops_impl_twins_identical(tmp_path, rng, impl, monkeypatch):
    monkeypatch.setenv("GT4_TPU_SETOPS_IMPL", impl)
    import numpy as np
    from genometester4_tpu.formats.list_format import write_list
    from genometester4_tpu.pipelines.listcompare import compare_multi
    paths = []
    for i in range(3):
        w = np.unique(rng.integers(0, 1 << 14, size=400).astype(np.uint64))
        c = rng.integers(1, 9, size=len(w)).astype(np.uint32)
        p = tmp_path / f"l{i}.list"
        write_list(str(p), 9, w, c)
        paths.append(str(p))
    for op, flag, name in (("union", "-u", "union"),
                           ("intrsec", "-i", "intrsec")):
        r = run_reference(["glistcompare"] + paths + [flag, "-c", "2",
                          "-o", str(tmp_path / f"ref{op}")])
        assert r.returncode == 0, r.stderr
        compare_multi(paths, op, str(tmp_path / f"got{op}"), cutoff=2)
        assert (tmp_path / f"got{op}_9_{name}.list").read_bytes() == \
            (tmp_path / f"ref{op}_9_{name}.list").read_bytes(), (impl, op)


def test_multi_invalid_rule_error_chrome(tmp_path, rng):
    """Fuzz regression (round 2): invalid rule x multi-list op must
    print the reference's exact stderr line (with its enum number) and
    exit 1 — not raise (src/glistcompare.c:518-523,617-623)."""
    import io
    import contextlib

    from tests.conftest import random_fasta, run_reference
    from genometester4_tpu.cli.glistcompare import main

    paths = []
    for i in range(3):
        fa = tmp_path / f"in{i}.fa"
        fa.write_text(random_fasta(rng, 2, 500, 1500))
        r = run_reference(["glistmaker", str(fa), "-w", "10", "-o",
                           str(tmp_path / f"l{i}")])
        assert r.returncode == 0
        paths.append(str(tmp_path / f"l{i}_10.list"))
    for op, rule in (("-i", "first"), ("-u", "subtract"), ("-u", "min"),
                     ("-i", "second")):
        ref = run_reference(["glistcompare"] + paths + [op, "-r", rule,
                            "-o", str(tmp_path / "r")])
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            try:
                rc = main(paths + [op, "-r", rule, "-o",
                                   str(tmp_path / "t")])
            except SystemExit as e:
                rc = e.code
        assert rc == ref.returncode
        assert err.getvalue() == ref.stderr.decode()


def test_pair_ops_omp_buckets_byte_identical(tmp_path, rng):
    """The OpenMP bucket-parallel pair path (multi-core hosts) must emit
    the same bytes as the sequential streaming path at any thread
    count: both inputs are cut at identical word boundaries and
    bucket-order concatenation preserves the zipper's output order."""
    import subprocess
    import sys as _sys
    import os as _os

    import numpy as np
    from genometester4_tpu.formats.list_format import write_list

    r = np.random.default_rng(9)
    pool = np.unique(r.integers(0, 1 << 40, 1_400_000,
                                dtype=np.int64).astype(np.uint64))
    w1 = pool[:1_000_000]
    w2 = np.sort(pool[500_000:])
    write_list(tmp_path / "a.list", 20, w1,
               r.integers(1, 60, len(w1)).astype(np.uint32))
    write_list(tmp_path / "b.list", 20, w2,
               r.integers(1, 60, len(w2)).astype(np.uint32))
    outs = {}
    for nt in ("1", "4"):
        code = (
            "import jax; jax.config.update('jax_platforms','cpu')\n"
            "from genometester4_tpu.pipelines.listcompare import "
            "compare_pair\n"
            f"compare_pair({str(tmp_path / 'a.list')!r}, "
            f"{str(tmp_path / 'b.list')!r}, "
            "['union','intrsec','diff1','diff2'], "
            f"outputname={str(tmp_path / ('o' + nt))!r}, cutoff=2)\n")
        env = dict(_os.environ, OMP_NUM_THREADS=nt)
        res = subprocess.run([_sys.executable, "-c", code], env=env,
                             capture_output=True)
        assert res.returncode == 0, res.stderr
        outs[nt] = [
            (tmp_path / f"o{nt}_20_{suf}.list").read_bytes()
            for suf in ("union", "intrsec", "0_diff1", "0_diff2")]
    assert outs["1"] == outs["4"]


@pytest.mark.parametrize("impl", ["host", "device"])
def test_multi_union_progress_ticks(tmp_path, rng, impl, monkeypatch,
                                    capsys):
    """Multi-list ops print "Words written: NM" at every 100M output
    words under -D (src/glistcompare.c:586-588, src/set-operations.c:
    111-113). The boundary is module-level so the crossing logic is
    testable without a 100M-word list; the reference's own line is only
    reachable on >1.2 GB outputs."""
    import numpy as np
    from genometester4_tpu.formats.list_format import write_list
    from genometester4_tpu.pipelines import listcompare as lc

    monkeypatch.setenv("GT4_TPU_SETOPS_IMPL", impl)
    monkeypatch.setattr(lc, "PROGRESS_TICK", 10_000_000)
    paths = []
    for i in range(3):
        w = np.unique(rng.integers(0, 1 << 16, size=12000).astype(np.uint64))
        c = rng.integers(1, 9, size=len(w)).astype(np.uint32)
        p = tmp_path / f"l{i}.list"
        write_list(str(p), 9, w, c)
        paths.append(str(p))
    # counts scaled so that n_words crosses two boundaries is impossible
    # at this size — instead verify the helper directly AND that a
    # debug run emits no spurious ticks below the boundary
    lc.compare_multi(paths, "union", str(tmp_path / "got"), debug=1)
    assert "Words written" not in capsys.readouterr().err
    # crossing logic: (prev, new] boundaries, multiple per append
    import io
    import contextlib
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        lc._emit_progress_ticks(9_999_999, 10_000_000)
        lc._emit_progress_ticks(10_000_000, 10_000_001)
        lc._emit_progress_ticks(19_000_000, 31_000_000)
    assert buf.getvalue() == ("Words written: 10M\n"
                              "Words written: 20M\n"
                              "Words written: 30M\n")


def test_subset_fast_path_differential(tmp_path, rng):
    """The numpy-free -ss fast path (pipelines/subset_fast.py) is
    byte-identical to the reference for every method, including the
    boundary size == n_words, and declines non-list inputs."""
    import numpy as np
    from genometester4_tpu.formats.list_format import write_list
    from genometester4_tpu.pipelines.subset_fast import try_fast_subset

    w = np.unique(rng.integers(0, 1 << 20, size=30000).astype(np.uint64))
    c = rng.integers(1, 9, size=len(w)).astype(np.uint32)
    p = str(tmp_path / "l_12.list")
    write_list(p, 12, w, c)
    # size == n_words only for rand_unique (p = out/in = 1 always, so
    # one pass suffices); for the other methods the reference's subset
    # loop has no end-of-list check and walks past the mmap (catalogued
    # UB, src/glistcompare.c:735-780) — not an oracle there
    sizes_of = {"rand": (1, 1000), "rand_unique": (1, 1000, len(w)),
                "rand_weighted_unique": (1, 1000)}
    for m in ("rand", "rand_unique", "rand_weighted_unique"):
        for size in sizes_of[m]:
            ref = run_reference(["glistcompare", p, "-ss", m, str(size),
                                 "--seed", "3", "-o",
                                 str(tmp_path / f"ref{m}{size}")])
            assert ref.returncode == 0, ref.stderr
            out = try_fast_subset(p, m, size,
                                  str(tmp_path / f"got{m}{size}"), 3)
            assert out is not None
            assert (tmp_path / f"got{m}{size}_subset_12.list"
                    ).read_bytes() == \
                (tmp_path / f"ref{m}{size}_subset_12.list").read_bytes(), \
                (m, size)
    # non-list input declines to the generic pipeline
    bogus = tmp_path / "x.bin"
    bogus.write_bytes(b"\x00" * 64)
    assert try_fast_subset(str(bogus), "rand", 5, str(tmp_path / "nope"),
                           1) is None
