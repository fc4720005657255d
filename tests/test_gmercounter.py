"""Differential tests: our gmer_counter vs the compiled reference binary.

Covers text-DB counting (all print options), binary GMDB write
byte-identity, and cross-implementation binary DB interop.
"""

import numpy as np
import pytest

from tests.conftest import run_reference, random_fasta, random_fastq

BASES = np.frombuffer(b"ACGT", np.uint8)


def make_db(rng, n_nodes, kmers_per_node, w, dup_word=None):
    lines = []
    kmers = []
    for i in range(n_nodes):
        ks = ["".join(chr(c) for c in rng.choice(BASES, w))
              for _ in range(kmers_per_node)]
        kmers.extend(ks)
        lines.append(f"SNP{i}\t{kmers_per_node}\t" + "\t".join(ks))
    return "\n".join(lines) + "\n", kmers


def make_reads(rng, kmers, w, n_reads=300, read_len=100, hit_prob=0.5):
    recs = []
    for r in range(n_reads):
        seq = "".join(chr(c) for c in rng.choice(BASES, read_len))
        if rng.random() < hit_prob:
            km = kmers[int(rng.integers(len(kmers)))]
            p = int(rng.integers(0, read_len - w))
            seq = seq[:p] + km + seq[p + w:]
        recs.append(f">r{r}\n{seq}")
    return "\n".join(recs) + "\n"


def run_ours(args):
    import io
    import sys
    from genometester4_tpu.cli.gmer_counter import main
    old = sys.stdout
    sys.stdout = io.StringIO()
    try:
        rc = main(args)
        outs = sys.stdout.getvalue()
    finally:
        sys.stdout = old
    return rc, outs


@pytest.mark.parametrize("w,flags", [
    (12, []),
    (12, ["--header", "--total", "--unique"]),
    (16, ["--stats", "--double_median"]),
    (25, ["--distribution", "4"]),
    (12, ["-32", "--total", "--unique"]),
])
def test_text_db_counting_identical(tmp_path, rng, w, flags):
    db_text, kmers = make_db(rng, n_nodes=25, kmers_per_node=2, w=w)
    reads = make_reads(rng, kmers, w)
    db = tmp_path / "db.txt"
    db.write_text(db_text)
    fa = tmp_path / "reads.fa"
    fa.write_text(reads)

    ref = run_reference(["gmer_counter", "-db", str(db)] + flags + [str(fa)])
    assert ref.returncode == 0, ref.stderr
    rc, out = run_ours(["-db", str(db)] + flags + [str(fa)])
    assert rc == 0
    assert out == ref.stdout.decode()


def test_fastq_and_multifile(tmp_path, rng):
    w = 14
    db_text, kmers = make_db(rng, n_nodes=10, kmers_per_node=3, w=w)
    db = tmp_path / "db.txt"
    db.write_text(db_text)
    fa = tmp_path / "a.fa"
    fa.write_text(make_reads(rng, kmers, w, n_reads=100))
    fq = tmp_path / "b.fq"
    fq.write_text(random_fastq(rng, 100, 60))

    ref = run_reference(["gmer_counter", "-db", str(db), str(fa), str(fq)])
    assert ref.returncode == 0, ref.stderr
    rc, out = run_ours(["-db", str(db), str(fa), str(fq)])
    assert rc == 0
    assert out == ref.stdout.decode()


def test_max_kmers_truncation(tmp_path, rng):
    w = 12
    db_text, kmers = make_db(rng, n_nodes=8, kmers_per_node=5, w=w)
    db = tmp_path / "db.txt"
    db.write_text(db_text)
    fa = tmp_path / "reads.fa"
    fa.write_text(make_reads(rng, kmers, w, n_reads=150))
    args = ["-db", str(db), "--max_kmers", "3", str(fa)]
    ref = run_reference(["gmer_counter"] + args)
    assert ref.returncode == 0, ref.stderr
    rc, out = run_ours(args)
    assert rc == 0
    assert out == ref.stdout.decode()


def test_binary_db_write_byte_identical(tmp_path, rng):
    # w=12 -> nbits 24 <= 28 so the trie root table stays small; trie
    # branch paths are covered by test_trie_roundtrip_with_branches
    db_text, _ = make_db(rng, n_nodes=20, kmers_per_node=2, w=12)
    db = tmp_path / "db.txt"
    db.write_text(db_text)
    ref = run_reference(["gmer_counter", "-db", str(db), "-w",
                         str(tmp_path / "ref.bin")])
    assert ref.returncode == 0, ref.stderr
    rc, _ = run_ours(["-db", str(db), "-w", str(tmp_path / "ours.bin")])
    assert rc == 0
    assert (tmp_path / "ours.bin").read_bytes() == (
        tmp_path / "ref.bin").read_bytes()


def test_binary_db_cross_interop(tmp_path, rng):
    w = 12
    db_text, kmers = make_db(rng, n_nodes=12, kmers_per_node=2, w=w)
    db = tmp_path / "db.txt"
    db.write_text(db_text)
    fa = tmp_path / "reads.fa"
    fa.write_text(make_reads(rng, kmers, w, n_reads=120))
    run_reference(["gmer_counter", "-db", str(db), "-w",
                   str(tmp_path / "ref.bin")])
    run_ours(["-db", str(db), "-w", str(tmp_path / "ours.bin")])

    # ours reading the reference's binary == reference reading ours
    ref = run_reference(["gmer_counter", "-dbb", str(tmp_path / "ours.bin"),
                         "--total", "--header", str(fa)])
    assert ref.returncode == 0, ref.stderr
    rc, out = run_ours(["-dbb", str(tmp_path / "ref.bin"), "--total",
                        "--header", str(fa)])
    assert rc == 0
    ref_lines = ref.stdout.decode().splitlines()
    our_lines = out.splitlines()
    # paths in the #BinaryDatabase line differ by design
    assert ref_lines[1].startswith("#BinaryDatabase")
    assert our_lines[1].startswith("#BinaryDatabase")
    assert ref_lines[:1] + ref_lines[2:] == our_lines[:1] + our_lines[2:]


def test_trie_roundtrip_with_branches(rng):
    """Branch/split logic: nbits > nbits_root forces shared-prefix splits.
    Round-trip (build -> serialize -> walk) must recover every code."""
    from genometester4_tpu.formats.gmerdb_binary import _TrieSim, _walk_trie

    nbits = 40
    sim = _TrieSim(nbits, nbits_root=6)  # tiny root -> deep branch chains
    words = rng.integers(0, 1 << nbits, size=2000, dtype=np.uint64)
    words = np.unique(words)
    expect = {}
    for i, wrd in enumerate(words):
        code = int(rng.integers(1, 2**31))
        sim.add_word(int(wrd), code)
        expect[int(wrd)] = code
    blob = sim.serialize()
    got_w, got_c = _walk_trie(np.frombuffer(blob, np.uint8))
    got = dict(zip(got_w.tolist(), got_c.tolist()))
    assert got == expect


def test_duplicate_kmer_codes_sum(rng):
    """The reference trie SUMS codes of duplicate canonical k-mers
    (src/trie.c:272-282); the sorted-array build must reproduce that."""
    from genometester4_tpu.formats.gmerdb import parse_text_db

    km = "ACGTACGTACGT"
    # pad past 256 bytes with a comment: the reference cannot load text
    # DBs smaller than the largest byte value (count_lines compares
    # bytes against csize, src/database.c:69), which we reproduce
    text = ("#" + "x" * 300 + "\n"
            + f"N0\t2\t{km}\tTTTTTTTTTTTA\nN1\t1\t{km}\n")
    db = parse_text_db(text.encode())
    assert db is not None
    # node0/kmer0 code + node1/kmer0 code, both forward (dir computed
    # per occurrence)
    from genometester4_tpu.ops.encode import string_to_word, canonical_u64
    w = canonical_u64(np.array([string_to_word(km)], np.uint64), 12)[0]
    idx = np.searchsorted(db.sorted_words, w)
    assert db.sorted_words[idx] == w
    kb = db.kmer_bits
    code0 = (1 << kb) | 0
    code1 = (2 << kb) | 0
    dir_bit = 0x80000000 if db.kmer_dirs[0] else 0
    expect = (code0 + code1 + 2 * dir_bit) & 0xFFFFFFFF
    assert int(db.sorted_codes[idx]) == expect


def make_fastq_reads(rng, kmers, w, n_reads=200, read_len=80, hit_prob=0.6):
    recs = []
    for r in range(n_reads):
        seq = "".join(chr(c) for c in rng.choice(BASES, read_len))
        if rng.random() < hit_prob:
            km = kmers[int(rng.integers(len(kmers)))]
            p = int(rng.integers(0, read_len - w))
            seq = seq[:p] + km + seq[p + w:]
        recs.append(f"@rd{r}\n{seq}\n+\n{'I' * read_len}")
    return "\n".join(recs) + "\n"


def test_compile_index_byte_identical(tmp_path, rng):
    """--compile_index: GMDB + read index file must match the reference
    byte for byte (reference run single-threaded: its per-kmer read
    list order is thread-schedule-dependent otherwise)."""
    w = 12
    db_text, kmers = make_db(rng, n_nodes=15, kmers_per_node=2, w=w)
    (tmp_path / "db.txt").write_text(db_text)
    (tmp_path / "reads.fq").write_text(make_fastq_reads(rng, kmers, w))
    # N bases inside reads exercise the printable-position semantics
    fa_extra = make_reads(rng, kmers, w, n_reads=50)
    fa_extra = fa_extra.replace("A", "N", 1)
    (tmp_path / "extra.fa").write_text(fa_extra)

    ref = run_reference(
        ["gmer_counter", "-db", "db.txt", "--compile_index", "ref.idx",
         "--num_threads", "1", "reads.fq", "extra.fa"], cwd=tmp_path)
    assert ref.returncode == 0, ref.stderr
    import os
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        rc, out = run_ours(["-db", "db.txt", "--compile_index", "ours.idx",
                            "--num_threads", "1", "reads.fq", "extra.fa"])
    finally:
        os.chdir(old)
    assert rc == 0
    assert (tmp_path / "ours.idx").read_bytes() == (
        tmp_path / "ref.idx").read_bytes()


def test_compile_index_verbose_dump(tmp_path, rng):
    w = 12
    db_text, kmers = make_db(rng, n_nodes=10, kmers_per_node=2, w=w)
    (tmp_path / "db.txt").write_text(db_text)
    (tmp_path / "reads.fq").write_text(
        make_fastq_reads(rng, kmers, w, n_reads=80))
    ref = run_reference(
        ["gmer_counter", "-db", "db.txt", "--compile_index", "ref.idx",
         "--verbose", "--num_threads", "1", "reads.fq"], cwd=tmp_path)
    assert ref.returncode == 0, ref.stderr
    import os
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        rc, out = run_ours(["-db", "db.txt", "--compile_index", "ours.idx",
                            "--verbose", "--num_threads", "1", "reads.fq"])
    finally:
        os.chdir(old)
    assert rc == 0
    assert out == ref.stdout.decode()


def test_streaming_count_matches_whole_file(tmp_path, rng):
    """Counting via tiny ingestion slabs == reference output, including
    --stats accumulators (records span slab seams)."""
    w = 14
    db_text, kmers = make_db(rng, 40, 3, w)
    reads = make_reads(rng, kmers, w, n_reads=120, read_len=400)
    (tmp_path / "db.txt").write_text(db_text)
    (tmp_path / "reads.fa").write_text(reads)
    r = run_reference(["gmer_counter", "-db", str(tmp_path / "db.txt"),
                       "--stats", str(tmp_path / "reads.fa")])
    assert r.returncode == 0, r.stderr
    from genometester4_tpu.pipelines import gmercount as gc_mod
    from genometester4_tpu.io import fasta as fasta_mod
    orig = fasta_mod.iter_code_slabs

    def tiny_slabs(path, k, slab_bytes=1 << 28):
        return orig(path, k, 333)

    fasta_mod.iter_code_slabs = tiny_slabs
    try:
        rc, ours = run_ours(["-db", str(tmp_path / "db.txt"), "--stats",
                             str(tmp_path / "reads.fa")])
    finally:
        fasta_mod.iter_code_slabs = orig
    assert rc == 0
    assert ours == r.stdout.decode()


def test_compile_index_streaming_tiny_slabs(tmp_path, rng):
    """--compile_index over FASTQ must stream in bounded slabs and stay
    byte-identical (absolute name offsets across slab seams)."""
    w = 16
    db_text, kmers = make_db(rng, 25, 2, w)
    reads = []
    for r in range(150):
        seq = "".join(chr(c) for c in rng.choice(BASES, 80))
        km = kmers[int(rng.integers(len(kmers)))]
        p = int(rng.integers(0, 80 - w))
        seq = seq[:p] + km + seq[p + w:]
        reads.append(f"@rd{r}\n{seq}\n+\n{'J' * len(seq)}")
    (tmp_path / "db.txt").write_text(db_text)
    (tmp_path / "reads.fq").write_text("\n".join(reads) + "\n")
    r = run_reference(["gmer_counter", "-db", "db.txt", "--compile_index",
                       "ref.idx", "--num_threads", "1", "reads.fq"],
                      cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    from genometester4_tpu.io import fasta as fasta_mod
    orig = fasta_mod.iter_code_slabs

    def tiny(path, k, slab_bytes=1 << 28):
        return orig(path, k, 429)

    fasta_mod.iter_code_slabs = tiny
    import os
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        rc, out = run_ours(["-db", "db.txt", "--compile_index", "ours.idx",
                            "reads.fq"])
    finally:
        os.chdir(old)
        fasta_mod.iter_code_slabs = orig
    assert rc == 0
    assert out == r.stdout.decode()
    assert (tmp_path / "ours.idx").read_bytes() == (
        tmp_path / "ref.idx").read_bytes()


def test_dump_index_byte_identical(tmp_path, rng):
    """--dump_index debug dump of a read-indexed binary DB
    (gt4_db_dump, src/database.c:543-572)."""
    w = 14
    db_text, kmers = make_db(rng, 10, 2, w)
    reads = make_reads(rng, kmers, w, n_reads=60, read_len=70)
    (tmp_path / "db.txt").write_text(db_text)
    (tmp_path / "reads.fa").write_text(reads)
    r = run_reference(["gmer_counter", "-db", "db.txt", "--compile_index",
                       "db.idx", "--num_threads", "1", "reads.fa"],
                      cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    ref = run_reference(["gmer_counter", "-dbb", "db.idx", "--dump_index",
                         "reads.fa"], cwd=tmp_path)
    assert ref.returncode == 0, ref.stderr
    import os
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        rc, out = run_ours(["-dbb", "db.idx", "--dump_index", "reads.fa"])
    finally:
        os.chdir(old)
    assert rc == 0
    assert out == ref.stdout.decode()


def test_double_median_odd_nodes_u32_wrap(tmp_path, rng):
    """Fuzz regression (round 2): --double_median with odd-nkmers nodes.
    The reference counts only floor(nk/2) pairs in `total` but scans the
    overrun pair too, so `equal = total - above - below` wraps as a C
    unsigned (src/gmer_counter.c:946-1013); the bisection must use u32
    semantics. (The LAST node stays even here: its overrun would read
    past the table — allocator-dependent, not an oracle.)"""
    import io
    import contextlib

    from tests.conftest import run_reference
    from genometester4_tpu.cli.gmer_counter import main

    g = "".join("ACGT"[int(x)] for x in rng.integers(0, 4, 1200))
    seen, lines = set(), []
    p = 0
    ws = 12

    def rc_(x):
        return x[::-1].translate(str.maketrans("ACGT", "TGCA"))

    nk_cycle = [1, 3, 1, 2, 3, 2]
    while p < len(g) - ws - 3 and len(lines) < 40:
        nk = nk_cycle[len(lines) % len(nk_cycle)]
        kms = [g[p + j:p + j + ws] for j in range(nk)]
        cano = [min(k, rc_(k)) for k in kms]
        if all(c not in seen for c in cano) and len(set(cano)) == nk:
            seen.update(cano)
            lines.append(f"m{len(lines)}\t{nk}\t" + "\t".join(kms))
        p += ws + 3
    while int(lines[-1].split("\t")[1]) % 2:
        lines.pop()
    db = tmp_path / "db.txt"
    db.write_text("\n".join(lines) + "\n")
    reads = tmp_path / "reads.fq"
    with open(reads, "w") as f:
        for r in range(60):
            st = int(rng.integers(0, len(g) - 50))
            s = g[st:st + 45]
            f.write(f"@q{r}\n{s}\n+\n{'H' * len(s)}\n")
    args = ["-db", str(db), "--num_threads", "1", "--double_median",
            str(reads)]
    ref = run_reference(["gmer_counter"] + args)
    assert ref.returncode == 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(args)
    assert (rc or 0) == 0
    assert out.getvalue().encode() == ref.stdout


def test_count_host_path_never_imports_jax(tmp_path):
    """With JAX_PLATFORMS=cpu the placement rule answers from the
    environment and count mode stays native-host: the whole run must
    finish without importing jax at all (utils.backend.prefer_host; the
    bin/ launchers' start-up contract)."""
    import os
    import subprocess
    import sys as _sys
    import random
    rnd = random.Random(3)
    db = tmp_path / "db.txt"
    lines = []
    for i in range(40):   # the format sniffer needs tens of lines
        k1 = "".join(rnd.choice("ACGT") for _ in range(25))
        k2 = "".join(rnd.choice("ACGT") for _ in range(25))
        lines.append(f"n{i}\t2\t{k1}\t{k2}")
    db.write_text("\n".join(lines) + "\n")
    fa = tmp_path / "r.fa"
    fa.write_text(">a\nACGTACGTACGTACGTACGTACGTACGTACGT\n")
    code = (
        "import sys\n"
        "from genometester4_tpu.cli.gmer_counter import main\n"
        "rc = main(['-db', %r, %r])\n"
        "assert rc == 0, rc\n"
        "assert 'jax' not in sys.modules, 'jax imported on host path'\n"
        "print('HOSTPATH-CLEAN')\n" % (str(db), str(fa)))
    env = dict(os.environ)
    env.pop("GT4_TPU_COUNT_IMPL", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    import sysconfig
    sp = sysconfig.get_paths()["purelib"]
    r = subprocess.run([_sys.executable, "-S", "-c",
                        "import sys;"
                        "sys.path.insert(0, %r);"
                        "sys.path.insert(0, %r);"
                        % (sp, env["PYTHONPATH"])
                        + code.replace("\n", ";")],
                       capture_output=True, timeout=120, env=env, text=True)
    assert "HOSTPATH-CLEAN" in r.stdout, (r.stdout, r.stderr)


def test_compile_index_from_binary_db_matches_text_chain(tmp_path, rng):
    """Upstream bug discovered in round 2: the reference's
    `-dbb DB.dbb --compile_index` writes a CORRUPT read index
    (truncated n_reads, garbage read_blocks tails; its own gassembler
    segfaults or emits nonsense on it), while its text-DB chain is
    fine. Our -dbb chain must equal our -db chain byte-for-byte in
    every real field (the reference text chain is the oracle for
    those), so a user gets a working binary-DB workflow."""
    w = 12
    db_text, kmers = make_db(rng, n_nodes=15, kmers_per_node=2, w=w)
    (tmp_path / "db.txt").write_text(db_text)
    (tmp_path / "reads.fq").write_text(make_fastq_reads(rng, kmers, w))
    import os
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        rc, _ = run_ours(["-db", "db.txt", "-w", "c.dbb"])
        assert rc == 0
        for dbargs, out in (( ["-db", "db.txt"], "ti.idx"),
                            (["-dbb", "c.dbb"], "bi.idx")):
            rc, _ = run_ours(dbargs + ["--compile_index", out, "--silent",
                                       "reads.fq"])
            assert rc == 0
    finally:
        os.chdir(old)
    a = (tmp_path / "ti.idx").read_bytes()
    b = (tmp_path / "bi.idx").read_bytes()
    assert a == b, "binary-DB index chain diverged from the text chain"


@pytest.mark.parametrize("impl", ["host", "device"])
def test_compile_index_impl_parity(tmp_path, rng, impl, monkeypatch):
    """The host (fgx_index_hits) and device (_make_index_fn) index
    lookups emit identical hit triples: the .idx bytes must match the
    reference on both placements."""
    w = 12
    db_text, kmers = make_db(rng, n_nodes=15, kmers_per_node=2, w=w)
    (tmp_path / "db.txt").write_text(db_text)
    (tmp_path / "reads.fq").write_text(make_fastq_reads(rng, kmers, w))
    ref = run_reference(
        ["gmer_counter", "-db", "db.txt", "--compile_index", "ref.idx",
         "--num_threads", "1", "reads.fq"], cwd=tmp_path)
    assert ref.returncode == 0, ref.stderr
    monkeypatch.setenv("GT4_TPU_COUNT_IMPL", impl)
    import os
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        rc, _ = run_ours(["-db", "db.txt", "--compile_index", "ours.idx",
                          "--num_threads", "1", "reads.fq"])
    finally:
        os.chdir(old)
    assert rc == 0
    assert ((tmp_path / "ours.idx").read_bytes()
            == (tmp_path / "ref.idx").read_bytes()), impl


def test_index_hits_batched_matches_plain():
    """The software-pipelined batched DB search (fgx_index_hits_batched,
    used past ~4M DB words) emits the exact hit stream + n_valid of the
    rolling kernel on random inputs with N resets, hits, and both
    directions (twins keep differential tests — CLAUDE.md)."""
    import ctypes

    import numpy as np

    from genometester4_tpu.models.fastgt_native import get_lib
    lib = get_lib()
    rng = np.random.default_rng(5)
    for k, n, ndb0 in ((25, 300_000, 5_000), (16, 100_000, 70_000),
                       (31, 200_000, 20_000), (7, 50_000, 300)):
        codes = rng.integers(0, 4, size=n, dtype=np.uint8)
        codes[rng.integers(0, n, size=n // 100)] = 255  # N resets
        # DB drawn from the stream's own canonical words so hits exist
        buf = np.empty(n, np.uint64)
        m0 = lib.fgx_extract_canonical(np.ascontiguousarray(codes), n, k,
                                       buf)
        pick = rng.choice(m0, size=min(ndb0, m0), replace=False)
        dbw = np.unique(buf[:m0][pick])
        dbc = np.arange(1, len(dbw) + 1, dtype=np.uint32)
        dbw = np.ascontiguousarray(dbw)
        cap = n - k + 1
        out = []
        for fn in (lib.fgx_index_hits, lib.fgx_index_hits_batched):
            hc = np.empty(cap, np.uint32)
            hp = np.empty(cap, np.int64)
            hd = np.empty(cap, np.uint8)
            nv = ctypes.c_longlong(0)
            m = fn(codes, ctypes.c_long(n), ctypes.c_int(k), dbw, dbc,
                   ctypes.c_long(len(dbw)), hc, hp, hd, ctypes.byref(nv))
            out.append((m, int(nv.value), hc[:m].copy(), hp[:m].copy(),
                        hd[:m].copy()))
        (m1, nv1, c1, p1, d1), (m2, nv2, c2, p2, d2) = out
        assert m1 == m2 and nv1 == nv2 and m1 > 0, (k, m1, m2)
        np.testing.assert_array_equal(c1, c2)
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_array_equal(d1, d2)


def test_duplicate_kmer_db_counts_stay_sane(tmp_path):
    """Deliberate divergence (COVERAGE.md Known gaps): on a text DB
    with CANONICAL-DUPLICATE k-mers the reference corrupts its own
    trie (trie.c:266-280 sums the two marker codes into the count
    field; the first window hitting the mangled code aborts the whole
    count table, gmer_counter.c:774-790) and silently drops every
    later window in the table. We do not emulate the self-corruption:
    every non-duplicate marker counts correctly regardless of where
    duplicate-word windows appear, and the duplicate word itself
    counts to neither marker (the reference's mangled-code
    no-increment outcome). Found by fuzz_fastgt_chain seed 9101."""
    import subprocess
    import sys
    db = (
        "mA\t2\tACGTACGTACGT\tGGCACTTAGGCG\n"
        "mB\t2\tTTTTCCCCAAAA\tCGCCTAAGTGCC\n"   # revcomp duplicate of mA k2
        "mC\t2\tCCTTCCACGCAG\tGACGACGACGAC\n"
    )
    (tmp_path / "db.txt").write_text(db)
    reads = (
        ">r0\nAAAGGCACTTAGGCGAAA\n"      # duplicate-word hit FIRST
        ">r1\nTTTCCTTCCACGCAGTTT\n"      # mC k1 after the dup hit
        ">r2\nGGGACGTACGTACGTGGG\n"      # mA k1 after the dup hit
    )
    (tmp_path / "reads.fa").write_text(reads)
    r = subprocess.run(
        [sys.executable, "-m", "genometester4_tpu.cli.gmer_counter",
         "-db", str(tmp_path / "db.txt"), "--kmers",
         str(tmp_path / "reads.fa")],
        capture_output=True, text=True, cwd="/root/repo")
    assert r.returncode == 0, r.stderr
    rows = {l.split("\t")[0]: l.split("\t") for l in
            r.stdout.splitlines() if l and not l.startswith("#")}
    # per-kmer count columns follow NODE and N_KMERS. Windows AFTER
    # the duplicate-word hit still count (the reference drops them via
    # the table break); the duplicate word itself counts to neither
    assert rows["mC"][2:] == ["1", "0"]
    assert rows["mA"][2:] == ["1", "0"]
    assert rows["mB"][2:] == ["0", "0"]
