"""genometester4_tpu — a JAX k-mer engine with a host-native twin.

A ground-up re-design of the capabilities of bioinfo-ut/GenomeTester4
(v4.2.16) for JAX/XLA on a GPU, with a host-native C engine that every
tool uses when JAX's backend is the CPU:

* k-mers live as ``(hi, lo)`` uint32 pairs on device (no 64-bit mode
  needed; sorted lexicographically with ``jax.lax.sort(..., num_keys=2)``).
* counting / merging / set operations are XLA programs over sorted arrays
  (sort + segmented reduction) instead of the reference's pthread
  table-merge pipeline (reference: src/glistmaker.c, src/set-operations.c).
* multi-chip scaling shards the k-mer space by most-significant prefix
  across a ``jax.sharding.Mesh`` so per-shard sorted outputs concatenate
  into a globally sorted list (reference has no distributed backend;
  see SURVEY.md §2c).
* on-disk formats (.list / .index / GMDB) are byte-compatible with the
  reference so users can interoperate with existing files.

Sub-packages
------------
formats   .list/.index/GMDB readers+writers (byte-compatible)
io        FASTA/FASTQ ingestion (vectorized host parse, gz support)
ops       device kernels: encode, extract, sort/count, set ops, lookup, SW
parallel  mesh construction, prefix sharding, collective count pipeline
models    FastGT statistics: binomial/negbin, 15-genotype model, simplex
pipelines high-level equivalents of the six reference CLI programs
cli       argv-compatible command line entry points
"""

__version__ = "0.1.0"

# Lazy re-exports (PEP 562): list_format drags numpy (~0.2 s of
# start-up), which would defeat the numpy-free bin/ stat fast paths.
_LAZY = {"ListHeader", "read_list", "write_list"}


def __getattr__(name):
    if name in _LAZY:
        from genometester4_tpu.formats import list_format
        return getattr(list_format, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
