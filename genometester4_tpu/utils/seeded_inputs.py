"""Seeded synthetic inputs shared by bench.py and chip_smoke.py.

Every generator is deterministic in its seed and writes its files from
numpy alone (no jax), so a parent process can build inputs without
touching an accelerator. Defaults are bench.py's sizes and seeds.
"""

from __future__ import annotations

import os

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _write_fasta_lines(f, seq: np.ndarray, width: int = 80) -> None:
    n = len(seq)
    full = n // width
    if full:
        body = np.empty((full, width + 1), np.uint8)
        body[:, :width] = seq[: full * width].reshape(full, width)
        body[:, width] = ord("\n")
        f.write(body.tobytes())
    if n % width:
        f.write(seq[full * width:].tobytes())
        f.write(b"\n")


def uniform_fasta(path: str, length: int = 50_000_000, seed: int = 42) -> None:
    """One record of i.i.d. uniform bases: essentially every k-mer is
    unique (the worst case for run detection, the biggest output)."""
    rng = np.random.default_rng(seed)
    bases = rng.choice(ACGT, size=length)
    with open(path, "wb") as f:
        f.write(b">chr1 synthetic %dbp\n" % length)
        _write_fasta_lines(f, bases)


def dup_heavy_fasta(path: str, n_segments: int = 50_000, segment: int = 1000,
                    source_length: int = 5_000_000, seed: int = 43) -> None:
    """Repeat-rich input: ``n_segments`` reads of ``segment`` bases
    sampled from a ``source_length`` source genome. At the defaults
    (50 Mbp from 5 Mbp, ~10x coverage) the mean canonical 25-mer count
    is ~9 — the distribution genomic counting actually sees."""
    rng = np.random.default_rng(seed)
    src = rng.choice(ACGT, size=source_length)
    starts = rng.integers(0, len(src) - segment, n_segments)
    with open(path, "wb") as f:
        for i, s in enumerate(starts):
            f.write(b">read%d\n" % i)
            f.write(src[s:s + segment].tobytes())
            f.write(b"\n")


def genomic_fasta(path: str, length: int = 50_000_000, seed: int = 44,
                  n_families: int = 60) -> None:
    """Genome-shaped input: GC-content isochores (100 kb blocks, GC
    fraction ~ Beta(2,2) per block) plus ``n_families`` planted repeat
    families (0.5-5 kb consensus, 20-200 copies each, 1% point
    mutations per copy, half the copies reverse-complemented). Gives
    the canonical A-rich-corner density concentration and near-duplicate
    k-mer neighbourhoods that a uniform i.i.d. stream lacks."""
    rng = np.random.default_rng(seed)
    blk = 100_000
    out = np.empty(length, np.uint8)
    for s in range(0, length, blk):
        gc = rng.beta(2.0, 2.0) * 0.6 + 0.2   # GC in [0.2, 0.8]
        p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
        out[s:s + blk] = rng.choice(ACGT, size=min(blk, length - s), p=p)
    comp = np.zeros(256, np.uint8)
    comp[ACGT] = np.frombuffer(b"TGCA", np.uint8)
    for _ in range(n_families):
        flen = int(rng.integers(500, 5000))
        fam = rng.choice(ACGT, size=flen)
        for _ in range(int(rng.integers(20, 200))):
            copy = fam.copy()
            nmut = max(1, int(0.01 * flen))
            pos = rng.integers(0, flen, nmut)
            copy[pos] = ACGT[rng.integers(0, 4, nmut)]
            if rng.random() < 0.5:
                copy = comp[copy][::-1]
            at = int(rng.integers(0, length - flen))
            out[at:at + flen] = copy
    with open(path, "wb") as f:
        f.write(b">chr1 genome-shaped %dbp (isochores + repeat families)\n"
                % length)
        _write_fasta_lines(f, out)


def fastgt_fixture(directory: str, n_markers: int = 15_000,
                   n_reads: int = 60_000, source_length: int = 4_000_000,
                   seed: int = 45) -> tuple[str, str]:
    """FastGT chain inputs: a biallelic marker DB (A/B 25-mers drawn from
    a source genome, alt = middle-base flip) and 100 bp FASTQ reads
    sampled from the source, with the alt allele planted on ~half the
    reads over het markers. Returns (db.txt, reads.fq) paths.

    Marker ids are FastGT-style "CHR:POS:RS:A/B": the caller classifies
    by the FIRST character (digit = autosome, X, Y —
    src/gmer_caller.c:668-694), and empty X/Y classes would send its
    sex-inference medians into a quirk path instead of calling."""
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    L = source_length
    src = rng.choice(ACGT, size=L)
    pos = np.sort(rng.choice(np.arange(100, L - 100, 40), n_markers,
                             replace=False))
    alt = src[pos + 12].copy()
    for i in range(n_markers):               # alt != ref at the middle base
        c = src[pos[i] + 12]
        alt[i] = ACGT[(np.where(ACGT == c)[0][0] + 1
                       + int(rng.integers(3))) % 4]
    chroms = rng.choice(
        np.array([str(c) for c in range(1, 23)] + ["X"] * 2 + ["Y"]),
        size=n_markers)
    db = os.path.join(directory, "db.txt")
    with open(db, "wb") as f:
        for i in range(n_markers):
            ka = src[pos[i]:pos[i] + 25].tobytes()
            kb_arr = src[pos[i]:pos[i] + 25].copy()
            kb_arr[12] = alt[i]
            name = "%s:%d:rs%d:A/B" % (chroms[i], int(pos[i]), i)
            f.write(b"%s\t2\t%s\t%s\n" % (name.encode(), ka,
                                          kb_arr.tobytes()))
    is_het = rng.random(n_markers) < 0.5
    reads = os.path.join(directory, "reads.fq")
    qual = b"I" * 100
    with open(reads, "wb") as f:
        for i in range(n_reads):
            s = int(rng.integers(0, L - 100))
            read = src[s:s + 100].copy()
            lo = np.searchsorted(pos, s - 24)
            hi = np.searchsorted(pos, s + 100 - 1)
            for mi in range(lo, hi):
                if is_het[mi] and rng.random() < 0.5:
                    off = pos[mi] + 12 - s
                    if 0 <= off < 100:
                        read[off] = alt[mi]
            f.write(b"@r%d\n" % i + read.tobytes() + b"\n+\n" + qual + b"\n")
    return db, reads


def katk_fixture(directory: str, n_regions: int = 200,
                 genome_length: int = 200_000, reads_per_hap: int = 40_000,
                 oversized_at: int | None = None, seed: int = 46,
                 ) -> tuple[str, str, str]:
    """KATK inputs: exome-style regions (150 bp, 4 anchor 25-mers each)
    over a random genome, ~40x diploid coverage of 100 bp reads with one
    planted het SNV per region. Returns (db.txt, regions.txt, reads.fq);
    the read index comes from ``gmer_counter --compile_index``.

    ``oversized_at``: make region ``oversized_at`` 300 bp (longer than
    gassembler's default max_reference_length of 200, so it is skipped)
    and give its two neighbours extra local coverage, so that each has
    more than 200 reads and gassembler draws rand() to subsample them."""
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    B = "ACGT"
    L = genome_length
    g = "".join(B[i] for i in rng.integers(0, 4, L))
    hap2 = list(g)
    region_lines, dblines = [], []
    hot = []
    for ri in range(n_regions):
        rs = ri * 1000
        re_ = rs + (300 if ri == oversized_at else 150)
        p = rs + 75
        hap2[p] = "G" if g[p] != "G" else "T"
        kms = [g[q:q + 25] for q in range(rs + 5, re_ - 30, 30)]
        for km in kms:
            dblines.append("R%d_%d\t1\t%s" % (ri, len(dblines), km))
        region_lines.append("1\t%d\t%d\t%s\t%s"
                            % (1000 + rs, 1000 + re_, g[rs:re_],
                               "\t".join(kms)))
        if oversized_at is not None and abs(ri - oversized_at) == 1:
            hot.append((rs, re_))
    hap2 = "".join(hap2)
    comp = str.maketrans("ACGT", "TGCA")
    reads = os.path.join(directory, "reads.fq")
    with open(reads, "w") as f:
        i = 0

        def emit(r):
            nonlocal i
            if rng.random() < 0.5:
                r = r.translate(comp)[::-1]
            f.write("@rd%d\n%s\n+\n%s\n" % (i, r, "J" * 100))
            i += 1

        for hap in (g, hap2):
            for _ in range(reads_per_hap):
                s = int(rng.integers(0, L - 100))
                emit(hap[s:s + 100])
            for rs, re_ in hot:
                for _ in range(200):
                    s = int(rng.integers(max(0, rs - 60), re_ - 40))
                    emit(hap[s:s + 100])
    db = os.path.join(directory, "db.txt")
    with open(db, "w") as f:
        f.write("\n".join(dblines) + "\n")
    regions = os.path.join(directory, "regions.txt")
    with open(regions, "w") as f:
        f.write("\n".join(region_lines) + "\n")
    return db, regions, reads
