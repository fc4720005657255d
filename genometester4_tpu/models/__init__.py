"""FastGT statistical models.

``fastgt_native``: host-exact C kernels (bit-for-bit gmer_caller parity
— glibc rand stream, float/double mixed precision, libm transcendentals).
``genotype``: float32 jnp implementation of the same 15-genotype
posterior for device batch genotyping (reached only through
``GT4_TPU_CALLER_IMPL=device``).
"""
