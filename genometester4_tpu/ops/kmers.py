"""Device k-mer extraction.

Replaces the reference's rolling-word byte state machine
(src/fasta.c:218-264 — one base at a time, maintaining forward word and
reverse complement incrementally) with a vectorized window build: for a
chunk of 2-bit base codes, all L-k+1 windows are materialized with k
shifted adds, invalid windows are masked via a prefix-sum over the
invalid indicator, and canonicalization is an element-wise min against
the vectorized reverse complement.

All shapes are static: chunks are padded to a fixed length so the jitted
program compiles once.
"""

from __future__ import annotations

from genometester4_tpu.utils.lazyjax import jax, jnp, jit

from genometester4_tpu.ops.encode import canonical_pair


@jit(static_argnames=("k", "canonical"))
def extract_kmers(codes, k: int, canonical: bool = True):
    """Extract all k-windows from a code chunk.

    Parameters
    ----------
    codes : uint8[L] — 2-bit base codes; 255 marks invalid bases and
        record separators (windows containing one are masked out).
    k : static word length, 1..32.

    Returns
    -------
    (hi, lo, valid): uint32[N], uint32[N], bool[N] with N = L - k + 1.
    Invalid windows carry arbitrary word bits and valid=False.
    """
    if not 1 <= k <= 32:
        raise ValueError("word length must be 1..32")
    L = codes.shape[0]
    n = L - k + 1
    invalid = codes == jnp.uint8(255)
    c = jnp.where(invalid, jnp.uint8(0), codes).astype(jnp.uint32)

    # Logarithmic doubling instead of k shifted slices: W[m][i] packs the
    # m bases starting at i (m a power of two, 2m bits, fits u32 for
    # m <= 16); bad[m][i] flags any invalid base among them. k shifted
    # full-array passes become ~log2(k) + popcount(k) elementwise passes,
    # which XLA fuses into a few memory-bound kernels.
    W = {1: c}
    bad = {1: invalid}
    m = 1
    while 2 * m <= min(k, 16):
        W[2 * m] = (W[m][: L - 2 * m + 1] << (2 * m)) | W[m][m: L - m + 1]
        bad[2 * m] = bad[m][: L - 2 * m + 1] | bad[m][m: L - m + 1]
        m *= 2
    while 2 * m <= k:  # validity chunks above 16 bases (no u32 word)
        bad[2 * m] = bad[m][: L - 2 * m + 1] | bad[m][m: L - m + 1]
        m *= 2

    # compose the k-base window from k's binary decomposition (16+16 for
    # k=32 — u32 chunks cap at 16 bases), most significant chunk first;
    # (hi, lo) tracks the 64-bit accumulator
    if k == 32:
        chunks = [16, 16]
    else:
        chunks = [1 << b for b in range(4, -1, -1) if k & (1 << b)]
    hi = jnp.zeros((n,), jnp.uint32)
    lo = jnp.zeros((n,), jnp.uint32)
    bad_k = jnp.zeros((n,), jnp.bool_)
    s = 0
    for p in chunks:
        if s:
            bits = 2 * p
            if bits < 32:
                hi = (hi << bits) | (lo >> (32 - bits))
                lo = lo << bits
            else:
                hi, lo = lo, jnp.zeros_like(lo)
        lo = lo | jax.lax.slice(W[p], (s,), (s + n,))
        bad_k = bad_k | jax.lax.slice(bad[p], (s,), (s + n,))
        s += p
    valid = ~bad_k

    if canonical:
        hi, lo = canonical_pair(hi, lo, k)
    return hi, lo, valid
