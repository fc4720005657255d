"""Batched affine-gap local alignment (Smith-Waterman).

Replaces the reference's per-read DP loop (src/gassembler.c:2185-2321)
with an anti-diagonal wavefront evaluated over (read-batch x diagonal):
cell (i,j) depends on (i-1,j-1), (i,j-1), (i-1,j), so every cell on one
anti-diagonal is independent — the classic parallel SW schedule.

All arithmetic is integer (scores int16, gap lengths int8 with C wrap
semantics), so the wavefront computes EXACTLY the reference's matrices:
same scores, same tie-breaking (left-gap >= score, then top-gap >=
updated score), same int8 gap-length overflow, same first-maximum
(row-major argmax) traceback start.

Scores (src/gassembler.c:2173-2177): match +2, mismatch -3, N 0,
gap open -4, gap extend -2.

Two twins share the recurrence: the native C fill (with a fused
fill + traceback + filter kernel per region, native/listkernel.c, which
is gassembler's path on every backend) and a numpy implementation (the
differential reference). A device fill was measured against the fused
host kernel on an H100 and lost end to end, because traceback needs
the full matrices on the host (PERF.md).
"""

from __future__ import annotations

import numpy as np

M_SCORE = 2
N_SCORE = 0
MM_SCORE = -3
GAP_OPEN = -4
GAP_EXT = -2
NEG = -1000

NUCL_N = 4  # matrix.h nucleotide codes: A C G T N GAP NONE


def sw_matrices_batch(ref: np.ndarray, reads: np.ndarray):
    """Fill SW matrices for one reference vs a batch of reads — C fill
    (native/fastgt_exact.c fgx_sw_batch, ~30x the numpy wavefront on a
    host core; integer-exact, tested against it and the device twins).

    See sw_matrices_batch_numpy for parameter docs."""
    from genometester4_tpu.models.fastgt_native import get_lib
    lib = get_lib()  # cached handle after first call
    B, m = reads.shape
    n = len(ref)
    score = np.zeros((B, n + 1, m + 1), np.int16)
    sx = np.zeros((B, n + 1, m + 1), np.int8)
    sy = np.zeros((B, n + 1, m + 1), np.int8)
    if B and n and m:
        tg_s = np.empty(m + 1, np.int16)
        tg_l = np.empty(m + 1, np.int8)
        lib.fgx_sw_batch(np.ascontiguousarray(ref, np.int8), n,
                         np.ascontiguousarray(reads, np.int8), B, m,
                         score, sx, sy, tg_s, tg_l)
    return score, sx, sy


def sw_matrices_batch_numpy(ref: np.ndarray, reads: np.ndarray):
    """Fill SW matrices for one reference vs a batch of reads.

    Parameters
    ----------
    ref : int8[n] nucleotide codes (A=0..GAP=5)
    reads : int8[B, m] padded with NONE(6); padding cells still compute
        but their substitution score uses N semantics (>=N -> 0), which
        keeps scores from growing, and the caller masks them out of the
        argmax.

    Returns (score int16[B,n+1,m+1], sx int8[...], sy int8[...]).
    """
    B, m = reads.shape
    n = len(ref)
    score = np.zeros((B, n + 1, m + 1), np.int16)
    sx = np.zeros((B, n + 1, m + 1), np.int8)
    sy = np.zeros((B, n + 1, m + 1), np.int8)
    # gap state diagonals: for each j, values of the previous diagonal
    lg_s = np.full((B, m + 1), NEG, np.int16)  # left gap score, diag d-1
    lg_l = np.zeros((B, m + 1), np.int8)
    tg_s = np.full((B, m + 1), NEG, np.int16)
    tg_l = np.zeros((B, m + 1), np.int8)
    # border cells: row 0 / col 0 have gap scores -1000 (never chosen)
    ref_i = ref.astype(np.int16)
    reads_i = reads.astype(np.int16)

    old = np.seterr(over="ignore")
    try:
        sc_dm2 = np.zeros((B, m + 1), np.int16)  # score on diag d-2
        sc_dm1 = np.zeros((B, m + 1), np.int16)  # score on diag d-1
        for d in range(2, n + m + 1):
            j_lo = max(1, d - n)
            j_hi = min(m, d - 1)
            if j_lo > j_hi:
                continue
            js = np.arange(j_lo, j_hi + 1)
            iis = d - js
            a_n = ref_i[iis - 1]  # (L,)
            b_n = reads_i[:, js - 1]  # (B, L)
            sub = np.where((a_n[None, :] >= NUCL_N) | (b_n >= NUCL_N),
                           np.int16(N_SCORE),
                           np.where(a_n[None, :] == b_n, np.int16(M_SCORE),
                                    np.int16(MM_SCORE)))
            diag = sc_dm2[:, js - 1]
            cell = np.zeros_like(sub)
            csx = np.zeros((B, len(js)), np.int8)
            csy = np.zeros((B, len(js)), np.int8)
            dsc = diag + sub
            take = dsc > 0
            cell = np.where(take, dsc, cell)
            csx = np.where(take, np.int8(-1), csx)
            csy = np.where(take, np.int8(-1), csy)
            # left gap: from (i, j-1) on diag d-1 at j-1
            lgs = cell + np.int16(GAP_OPEN)
            lgl = np.zeros((B, len(js)), np.int8)
            prev_lgs = lg_s[:, js - 1]
            prev_lgl = lg_l[:, js - 1]
            ext = (prev_lgs + np.int16(GAP_EXT)) > lgs
            lgs = np.where(ext, prev_lgs + np.int16(GAP_EXT), lgs)
            lgl = np.where(ext, prev_lgl + np.int8(1), lgl)
            sel = lgs >= cell
            cell = np.where(sel, lgs, cell)
            csx = np.where(sel, (-lgl).astype(np.int8), csx)
            csy = np.where(sel, np.int8(0), csy)
            # top gap: from (i-1, j) on diag d-1 at j; uses UPDATED cell
            tgs = cell + np.int16(GAP_OPEN)
            tgl = np.zeros((B, len(js)), np.int8)
            prev_tgs = tg_s[:, js]
            prev_tgl = tg_l[:, js]
            ext = (prev_tgs + np.int16(GAP_EXT)) > tgs
            tgs = np.where(ext, prev_tgs + np.int16(GAP_EXT), tgs)
            tgl = np.where(ext, prev_tgl + np.int8(1), tgl)
            sel = tgs >= cell
            cell = np.where(sel, tgs, cell)
            csx = np.where(sel, np.int8(0), csx)
            csy = np.where(sel, (-tgl).astype(np.int8), csy)

            score[:, iis, js] = cell
            sx[:, iis, js] = csx
            sy[:, iis, js] = csy
            # roll diag state
            new_lg = np.full((B, m + 1), NEG, np.int16)
            new_lgl = np.zeros((B, m + 1), np.int8)
            new_tg = np.full((B, m + 1), NEG, np.int16)
            new_tgl = np.zeros((B, m + 1), np.int8)
            new_lg[:, js] = lgs
            new_lgl[:, js] = lgl
            new_tg[:, js] = tgs
            new_tgl[:, js] = tgl
            lg_s, lg_l, tg_s, tg_l = new_lg, new_lgl, new_tg, new_tgl
            new_sc = np.zeros((B, m + 1), np.int16)
            new_sc[:, js] = cell
            sc_dm2 = sc_dm1
            sc_dm1 = new_sc
    finally:
        np.seterr(**old)
    return score, sx, sy


def sw_traceback(score: np.ndarray, sx: np.ndarray, sy: np.ndarray,
                 m_valid: int):
    """Traceback one read's matrices (reference src/gassembler.c:2298-2320).

    ``m_valid``: true read length (padding columns are excluded from the
    maximum search). Returns (a_pos, b_pos) int arrays, aligned pairs in
    ascending order. C-backed (fgx_sw_traceback); the numpy twin below
    is the differential reference.
    """
    from genometester4_tpu.models.fastgt_native import get_lib
    lib = get_lib()
    n1, m1 = score.shape
    cap = n1 + m1
    a_pos = np.empty(cap, np.int32)
    b_pos = np.empty(cap, np.int32)
    cnt = lib.fgx_sw_traceback(
        np.ascontiguousarray(score, np.int16),
        np.ascontiguousarray(sx, np.int8),
        np.ascontiguousarray(sy, np.int8), n1, m1, m_valid, a_pos, b_pos)
    return a_pos[:cnt], b_pos[:cnt]


def sw_traceback_numpy(score: np.ndarray, sx: np.ndarray, sy: np.ndarray,
                       m_valid: int):
    """Numpy twin of sw_traceback (differential reference).
    """
    sub = score[:, : m_valid + 1]
    flat = int(np.argmax(sub))  # first maximum in row-major order
    mi, mj = divmod(flat, sub.shape[1])
    a_pos, b_pos = [], []
    while mi > 0 and mj > 0:
        cx = int(sx[mi, mj])
        cy = int(sy[mi, mj])
        if cx == 0 and cy == 0:
            break
        if score[mi, mj] < 1:
            break
        if cx and cy:
            a_pos.append(mi - 1)
            b_pos.append(mj - 1)
        mi += cy
        mj += cx
    a_pos.reverse()
    b_pos.reverse()
    return np.asarray(a_pos, np.int32), np.asarray(b_pos, np.int32)
