"""gmer_caller equivalent: FastGT empirical-Bayes genotyping of
gmer_counter output.

Pipeline (reference: src/gmer_caller.c:495-780, SURVEY.md §3.4):

  line table -> chromosome classification (A / X / Y by first char)
  -> per-class pair-median coverage (iterative bisection over 6x-scaled
     per-marker pair means)
  -> sex inference: Poisson(x_med | a_med) vs Poisson(x_med | a_med/2)
  -> per-marker call = the k-mer pair whose sum is closest to the median
  -> model training (native exact simplex; glibc rand stream, srand(1))
  -> per-marker 15-genotype posterior + best call printing

The numeric core runs in the native exact library
(genometester4_tpu.models.fastgt_native); this module is parsing,
orchestration, and byte-identical output formatting.

Known reference UB reproduced as zeros: lines with <4 tokens leave the
per-marker medians/calls uninitialized in the reference
(src/gmer_caller.c:155,954-963 `continue` over malloc'd arrays); we use
zeros, which is what fresh glibc mmap'd pages contain in practice.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from genometester4_tpu.models import fastgt_native as native


def _genotype_batch_impl():
    """Posterior-batch backend for print_genotypes.

    The exact native path is the tool's output on every backend: it is
    byte-identical to the reference. ``GT4_TPU_CALLER_IMPL=device``
    selects the float32 device twin (models/genotype.genotype_batch_
    device), whose probabilities may differ in the last printed digit;
    its tests use that setting."""
    if os.environ.get("GT4_TPU_CALLER_IMPL") == "device":
        from genometester4_tpu.models.genotype import genotype_batch_device
        return genotype_batch_device
    return native.genotype_batch

GENOTYPES = ["-", "A", "B", "AA", "AB", "BB", "AAA", "AAB", "BBA", "BBB",
             "AAAA", "AAAB", "BBBA", "AABB", "BBBB"]
GT_A, GT_B, GT_AA, GT_AB, GT_BB = 1, 2, 3, 4, 5

MODEL_FULL, MODEL_DIPLOID, MODEL_HAPLOID = 0, 1, 2

# diploid initial parameters (src/gmer_caller.c:527-533)
DEFAULT_PARAMS = np.array(
    [0.0547219, 4.2603e-05, 0.014934, 0.985023, 0.0, 65.48, -0.6792684],
    np.float32)


def build_line_table(data: bytes):
    """Offsets of '\\n'-terminated lines (src/gmer_caller.c:113-142):
    a final unterminated line is ignored; the sentinel end is csize."""
    nl = np.flatnonzero(np.frombuffer(data, np.uint8) == 0x0A)
    starts = np.concatenate([[0], nl[:-1] + 1]) if len(nl) else np.empty(0, np.int64)
    ends = nl
    return starts.astype(np.int64), ends.astype(np.int64)


def split_line(data: bytes, start: int, max_tokens: int):
    """split_line semantics (src/utils.c:234-248): tokens are runs of
    bytes >= 0x20 up to the next '\\n' (which may live beyond this
    line's record in the raw buffer — the reference passes a length that
    spans to the next line start, so the newline always terminates)."""
    toks = []
    p = start
    n = len(data)
    while len(toks) < max_tokens and p < n and data[p] != 0x0A:
        s = p
        while p < n and data[p] >= 0x20:
            p += 1
        toks.append((s, p))
        if p < n and data[p] != 0x0A:
            p += 1
    return toks


def _strtol(data: bytes, span) -> int:
    s, e = span
    i = s
    if i < e and data[i] in b"+-":
        i += 1
    j = i
    while j < e and 0x30 <= data[j] <= 0x39:
        j += 1
    if j == i:
        return 0
    v = int(data[s if data[s] in b"+-" else i:j])
    return v


def classify_lines(data: bytes, starts: np.ndarray, model: int):
    """First-char chromosome classes (src/gmer_caller.c:668-694)."""
    if len(starts) == 0:
        return (np.empty(0, np.int64),) * 3
    first = np.frombuffer(data, np.uint8)[starts]
    if model != MODEL_FULL:
        return np.arange(len(starts), dtype=np.int64), \
            np.empty(0, np.int64), np.empty(0, np.int64)
    is_a = (first > ord("0")) & (first <= ord("9"))
    is_x = first == ord("X")
    is_y = first == ord("Y")
    idx = np.arange(len(starts), dtype=np.int64)
    return idx[is_a], idx[is_x], idx[is_y]


def _line_pairs(data: bytes, start: int):
    """First <=3 count pairs of a marker line (8-token split cap,
    src/gmer_caller.c:150,946)."""
    toks = split_line(data, start, 8)
    if len(toks) < 4:
        return None
    npairs = (len(toks) - 2) // 2
    vals = [_strtol(data, toks[2 + j]) for j in range(2 * npairs)]
    return vals


def get_pair_median(data: bytes, starts: np.ndarray, members: np.ndarray) -> int:
    """Iterative bisection median of 6x-scaled pair means
    (src/gmer_caller.c:966-1025). Unsigned 32-bit arithmetic."""
    n = len(members)
    med6 = np.zeros(n, np.int64)  # zeros stand in for reference UB
    for i, li in enumerate(members):
        vals = _line_pairs(data, int(starts[li]))
        if vals is None:
            continue
        npairs = len(vals) // 2
        sm = sum(vals) & 0xFFFFFFFF
        med6[i] = (sm * 6 & 0xFFFFFFFF) // npairs
    mx = int(med6.max(initial=0))
    mn = int(med6.min(initial=0xFFFFFFFF))
    med = (mn + mx) // 2
    while mx > mn:
        above = int((med6 > med).sum())
        below = int((med6 < med).sum())
        equal = n - above - below
        if mx == mn + 1:
            if above > below + equal:
                med = mx
            break
        if above > below:
            if above - below < equal:
                break
            mn = med
        elif below > above:
            if below - above < equal:
                break
            mx = med
        else:
            break
        med = (mn + mx) // 2
    return med // 6


def parse_calls(data: bytes, starts: np.ndarray, members: np.ndarray,
                pair_median: int):
    """Per marker, pick the pair whose sum is nearest the median
    (src/gmer_caller.c:144-175). Returns (uint16[n,2] counts — the
    reference truncates to unsigned short — and int64[n] name-line
    indices). A marker line with fewer than 4 tokens is skipped with
    ``continue``, leaving that SNPCall's malloc'd memory UNINITIALIZED
    (src/gmer_caller.c:148,157). For the autosome table (the first
    malloc) those are zero pages in practice, so the reference prints
    counts 0/0 under the name of LINE 0 — reproduced via name_line = 0
    for skipped markers (fuzz finding). For the X/Y tables the
    reference's malloc reuses freed heap and the stale bytes vary by
    allocator history — undefined, not emulated: we keep the zero-page
    semantics there (divergence only for X/Y marker lines with a single
    k-mer count, which also read uninitialized memory upstream)."""
    out = np.zeros((len(members), 2), np.uint16)
    name_line = np.zeros(len(members), np.int64)
    for i, li in enumerate(members):
        vals = _line_pairs(data, int(starts[li]))
        if vals is None:
            continue
        name_line[i] = li
        best_delta = 0x7FFFFFFF
        best = (0, 0)
        for j in range(len(vals) // 2):
            a, b = vals[2 * j], vals[2 * j + 1]
            delta = abs((a + b) - pair_median)
            if delta < best_delta:
                best = (a, b)
                best_delta = delta
        out[i, 0] = best[0] & 0xFFFF
        out[i, 1] = best[1] & 0xFFFF
    return out, name_line


def marker_id(data: bytes, start: int) -> str:
    """First <=255 bytes of the line up to '\\t' — the reference scans
    past the line end if the line has no tab (src/gmer_caller.c:420-424)."""
    j = start
    n = len(data)
    while j < n and data[j] != 0x09 and j - start < 255:
        j += 1
    return data[start:j].decode("latin1")


def _cdiv_fmt(x: float, y: float) -> str:
    """C "%.2f" of x/y: x86 0.0/0.0 is a NEGATIVE quiet NaN, so C
    prints "-nan" where numpy's nan would print "nan"."""
    if y == 0.0:
        if x == 0.0:
            return "-nan"
        return "inf" if x > 0 else "-inf"
    return "%.2f" % (x / y)


def print_genotypes(out, data: bytes, starts: np.ndarray,
                    name_lines: np.ndarray, calls: np.ndarray,
                    params: np.ndarray, pB: float, nalleles: int,
                    prob_cutoff: float, alternatives: bool):
    """src/gmer_caller.c:390-468 formatting."""
    if len(name_lines) == 0:
        return
    flat = np.ascontiguousarray(calls.reshape(-1), np.uint16)
    a, sums, best = _genotype_batch_impl()(flat, pB, params)
    lines = []
    for i, li in enumerate(name_lines):
        bg = int(best[i])
        pieces = [marker_id(data, int(starts[li]))]  # li = name line (0 for the reference's uninitialized skip path)
        cancall = (nalleles == 0
                   or (nalleles == 1 and bg in (GT_A, GT_B))
                   or (nalleles == 2 and bg in (GT_AA, GT_AB, GT_BB)))
        if a[i, bg] < prob_cutoff:
            cancall = False
        if calls[i, 0] == 0 and calls[i, 1] == 0:
            cancall = False
        if cancall:
            pieces.append("\t%s\t%s" % (GENOTYPES[bg],
                                         _cdiv_fmt(a[i, bg], sums[i])))
        else:
            pieces.append("\tNC\t")
        pieces.append("\t%u\t%u" % (calls[i, 0], calls[i, 1]))
        if alternatives:
            for j in range(15):
                pieces.append("\t" + _cdiv_fmt(a[i, j], sums[i]))
        lines.append("".join(pieces))
        if len(lines) >= 8192:
            out.write("\n".join(lines) + "\n")
            lines = []
    if lines:
        out.write("\n".join(lines) + "\n")


def run_caller(data: bytes, out, model: int = MODEL_FULL, nruns: int = 5,
               max_training: int = 100000, nthreads: int = 16,
               header: bool = False, non_canonical: bool = False,
               prob_cutoff: float = 0.0, alternatives: bool = False,
               info: bool = False, print_gt: bool = True,
               params0: np.ndarray | None = None,
               params_specified: bool = False,
               debug: int = 0,
               version_str: str = "4.2.16 (stable)") -> int:
    native.srand(1)

    params = (np.array(params0, np.float32) if params0 is not None
              else DEFAULT_PARAMS.copy())
    if model == MODEL_HAPLOID and not params_specified:
        params[2] = 0.985023
        params[3] = 0.014934

    starts, _ends = build_line_table(data)
    if len(starts) == 0:
        sys.stderr.write("File contains no lines\n")
        return 1
    # -D level-1 chatter, byte-formatted like src/gmer_caller.c:649-705
    if debug:
        sys.stderr.write("done (%u lines)\n" % len(starts))
        sys.stderr.write("Building line table...")
        sys.stderr.write("done\n")
        sys.stderr.write("Counting chromosomes...")
    a_idx, x_idx, y_idx = classify_lines(data, starts, model)
    if debug:
        sys.stderr.write("done\n")
        sys.stderr.write("Autosomes %u X %u Y %u\n"
                         % (len(a_idx), len(x_idx), len(y_idx)))

    if debug:
        sys.stderr.write("Calculating medians...")
    a_med = get_pair_median(data, starts, a_idx)
    x_med = y_med = 0
    if model == MODEL_FULL:
        x_med = get_pair_median(data, starts, x_idx)
        y_med = get_pair_median(data, starts, y_idx)
    if debug:
        sys.stderr.write("done\n")
        sys.stderr.write("Autosomes/unspecified %u X %u Y %u\n"
                         % (a_med, x_med, y_med))

    p_xx = p_x = p_y = p_1 = 0.0
    if model == MODEL_FULL:
        p_xx = native.poisson(x_med, float(a_med))
        p_x = native.poisson(x_med, float(a_med // 2))
        p_y = native.poisson(y_med, float(a_med // 2))
        p_1 = native.poisson(y_med, 1.0)
        if debug:
            sys.stderr.write("XX %g X %g Y %g 0 %g\n"
                             % (p_xx, p_x, p_y, p_1))
            sys.stderr.write("Probably female\n" if p_xx > p_x
                             else "Probably male\n")
        if p_xx > p_x:
            if p_y > p_1:
                sys.stderr.write(
                    "Y inconsistency: p_1 %g p_Y %g p_X %g p_XX %g\n"
                    % (p_1, p_y, p_x, p_xx))
        else:
            if p_y < p_1:
                sys.stderr.write(
                    "Y inconsistency: p_1 %g p_Y %g p_X %g p_XX %g\n"
                    % (p_1, p_y, p_x, p_xx))

    if debug:
        sys.stderr.write("Reading autosome/unspecified calls...")
    calls_a, lines_a = parse_calls(data, starts, a_idx, a_med)
    if debug:
        sys.stderr.write("done\n")

    if nruns and len(a_idx) > 0:
        if debug:
            sys.stderr.write("Training autosome/unspecified model\n")
        mul = 2 if model == MODEL_HAPLOID else 1
        _, pB = native.train_model(calls_a.reshape(-1), max_training, nruns,
                                   params, mul, nthreads, debug)
    else:
        pB = native.allele_freq(calls_a.reshape(-1))

    if info:
        # yes, "#gmer_counter": the reference prints the counter's name
        # here (src/gmer_caller.c:753)
        out.write(f"#gmer_counter version {version_str}\n")
        if model == MODEL_FULL:
            out.write("#Sex\t%s\n" % ("F" if p_xx > p_x else "M"))
        out.write("#EstimatedCoverage\t%g\n" % params[4])
        out.write("#AverageMAF\t%g\n" % pB)
        out.write("#AutosomeModel\t%g %g %g %g %g %g %g\n" % tuple(params))

    x_params = params.copy()
    calls_x = lines_x = None
    if model == MODEL_FULL:
        if debug:
            sys.stderr.write("Reading X calls...")
        calls_x, lines_x = parse_calls(data, starts, x_idx, x_med)
        if debug:
            sys.stderr.write("done\n")
        if len(x_idx) > 0 and nruns and p_xx <= p_x:
            if debug:
                sys.stderr.write("Training X model\n")
            x_params[2] = 0.98
            x_params[3] = 0.01
            _, pB = native.train_model(calls_x.reshape(-1), max_training,
                                       nruns, x_params, 2, nthreads, debug)
            if info:
                out.write("#XModel\t%g %g %g %g %g %g %g\n" % tuple(x_params))

    if print_gt:
        if header:
            out.write("#ID\tGT\tPROB\tA_KMERS\tB_KMERS"
                      + "".join(f"\t{g}" for g in GENOTYPES) + "\n")
        nall = 0 if non_canonical else (1 if model == MODEL_HAPLOID else 2)
        print_genotypes(out, data, starts, lines_a, calls_a, params, pB,
                        nall, prob_cutoff, alternatives)
        if model == MODEL_FULL:
            if p_xx > p_x:
                print_genotypes(out, data, starts, lines_x, calls_x, params,
                                pB, 0 if non_canonical else 2, prob_cutoff,
                                alternatives)
            else:
                print_genotypes(out, data, starts, lines_x, calls_x, x_params,
                                pB, 0 if non_canonical else 1, prob_cutoff,
                                alternatives)
                if debug:
                    sys.stderr.write("Reading Y calls...")
                calls_y, lines_y = parse_calls(data, starts, y_idx, y_med)
                if debug:
                    sys.stderr.write("done\n")
                print_genotypes(out, data, starts, lines_y, calls_y, x_params,
                                pB, 0 if non_canonical else 1, prob_cutoff,
                                alternatives)
    return 0
