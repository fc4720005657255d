"""2-bit nucleotide encoding and k-mer canonicalization.

Semantics match reference src/sequence.c:43-86:

* A=0 C=1 G=2 T=U=3 (case-insensitive); any other byte is invalid and
  resets the extraction window.
* a k-mer is the 2k-bit big-endian base string packed into the LOW bits
  of a 64-bit word (first base most significant).
* reverse complement: complement every base, reverse base order.
* canonical form: unsigned min(word, revcomp).

Device representation
---------------------
On device a k-mer is an ``(hi, lo)`` pair of uint32 (hi = bits 63..32),
so the device path runs without JAX's 64-bit mode (ROADMAP 1.4 and 3.6
weigh a single u64 key on the GPU). All device functions here
are pure jnp element-wise ops — they fuse into the surrounding extraction
/ sort pipeline. Host-side helpers use numpy uint64.
"""

from __future__ import annotations

import numpy as np

from genometester4_tpu.utils.lazyjax import jnp

ALPHABET = "ACGTUacgtu"
_B2S = np.frombuffer(b"ACGT", dtype=np.uint8)

# 256-entry byte → 2-bit code table; 255 marks invalid characters.
NUCL_CODES = np.full(256, 255, dtype=np.uint8)
for _ch, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3), ("U", 3)):
    NUCL_CODES[ord(_ch)] = _v
    NUCL_CODES[ord(_ch.lower())] = _v

INVALID = np.uint8(255)


# ---------------------------------------------------------------------------
# Host (numpy u64) reference implementations — used for file I/O, tests and
# small CLI paths. Vectorized over arrays of words.
# ---------------------------------------------------------------------------

def get_nucl_value(ch: int) -> int:
    """Bit-trick char→code used for ANY byte, valid or not
    (src/sequence.c:45-53) — lenient paths depend on its garbage values."""
    if ch & 4:
        return ((ch >> 4) | 2) & 3
    return (ch & 6) >> 1


def string_to_word(s: str, strict: bool = True) -> int:
    """Pack a nucleotide string (len ≤ 32) into a u64 (src/sequence.c:118-130).

    ``strict=False`` mirrors the reference: warn on stderr for invalid
    characters but keep packing their bit-trick values.
    """
    import sys

    w = 0
    for ch in s[:32]:
        v = NUCL_CODES[ord(ch) & 0xFF]
        if v == 255:
            if strict:
                raise ValueError(f"invalid character {ch!r} in k-mer string")
            sys.stderr.write(f"Invalid character {ch} in string!\n")
            v = get_nucl_value(ord(ch) & 0xFF)
        w = ((w << 2) | int(v)) & 0xFFFFFFFFFFFFFFFF
    return w


def word_to_string(word: int, k: int) -> str:
    """Unpack a u64 into its k-character string (src/sequence.c:88-99)."""
    out = bytearray(k)
    w = int(word)
    for i in range(k):
        out[k - 1 - i] = _B2S[w & 3]
        w >>= 2
    return out.decode()


def words_to_strings(words: np.ndarray, k: int) -> list[str]:
    """Vectorized word→string for arrays (used by list dumps)."""
    words = np.asarray(words, dtype=np.uint64)
    shifts = np.arange(2 * (k - 1), -1, -2, dtype=np.uint64)
    codes = (words[:, None] >> shifts[None, :]) & np.uint64(3)
    chars = _B2S[codes.astype(np.intp)]
    return chars.view(f"S{k}").ravel().astype(str).tolist()


def reverse_complement_u64(words: np.ndarray, k: int) -> np.ndarray:
    """Vectorized reverse complement on u64 host arrays (src/sequence.c:65-79)."""
    w = (~np.asarray(words, dtype=np.uint64))  # complement every base
    # reverse 2-bit groups of the full 64-bit value via butterfly swaps
    w = ((w & np.uint64(0x3333333333333333)) << np.uint64(2)) | (
        (w >> np.uint64(2)) & np.uint64(0x3333333333333333))
    w = ((w & np.uint64(0x0F0F0F0F0F0F0F0F)) << np.uint64(4)) | (
        (w >> np.uint64(4)) & np.uint64(0x0F0F0F0F0F0F0F0F))
    w = w.byteswap()
    return w >> np.uint64(64 - 2 * k)


def canonical_u64(words: np.ndarray, k: int) -> np.ndarray:
    rc = reverse_complement_u64(words, k)
    return np.minimum(np.asarray(words, dtype=np.uint64), rc)


def split_u64(words: np.ndarray):
    """u64 host array → (hi, lo) uint32 pair (device layout)."""
    w = np.asarray(words, dtype=np.uint64)
    return (w >> np.uint64(32)).astype(np.uint32), w.astype(np.uint32)


def join_u64(hi, lo) -> np.ndarray:
    """(hi, lo) uint32 pair → u64 host array."""
    return (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(
        lo, dtype=np.uint64)


# ---------------------------------------------------------------------------
# Device (jnp uint32-pair) kernels. k is static; these trace into a handful
# of elementwise ops and fuse with neighbours.
# ---------------------------------------------------------------------------

def _rev2bit_u32(x):
    """Reverse the 16 2-bit groups inside each uint32 lane."""
    m2 = jnp.uint32(0x33333333)
    m4 = jnp.uint32(0x0F0F0F0F)
    m8 = jnp.uint32(0x00FF00FF)
    x = ((x & m2) << 2) | ((x >> 2) & m2)
    x = ((x & m4) << 4) | ((x >> 4) & m4)
    x = ((x & m8) << 8) | ((x >> 8) & m8)
    return (x << 16) | (x >> 16)


def _shr128pair(hi, lo, s: int):
    """Logical right shift of the (hi,lo) 64-bit pair by static 0 ≤ s < 64."""
    if s == 0:
        return hi, lo
    if s < 32:
        return hi >> s, (lo >> s) | (hi << (32 - s))
    if s == 32:
        return jnp.zeros_like(hi), hi
    return jnp.zeros_like(hi), hi >> (s - 32)


def reverse_complement_pair(hi, lo, k: int):
    """Element-wise reverse complement of (hi, lo) k-mer pairs on device."""
    chi, clo = ~hi, ~lo
    # full 64-bit bit-group reversal swaps the halves
    rhi, rlo = _rev2bit_u32(clo), _rev2bit_u32(chi)
    rhi, rlo = _shr128pair(rhi, rlo, 64 - 2 * k)
    if k <= 16:
        rhi = jnp.zeros_like(rhi)
    return rhi, rlo


def canonical_pair(hi, lo, k: int):
    """Element-wise canonical (min of word and revcomp) on device."""
    rhi, rlo = reverse_complement_pair(hi, lo, k)
    take_rc = (rhi < hi) | ((rhi == hi) & (rlo < lo))
    return jnp.where(take_rc, rhi, hi), jnp.where(take_rc, rlo, lo)


def pair_less(ahi, alo, bhi, blo):
    """Unsigned 64-bit a < b on uint32 pairs."""
    return (ahi < bhi) | ((ahi == bhi) & (alo < blo))


def pair_eq(ahi, alo, bhi, blo):
    return (ahi == bhi) & (alo == blo)
