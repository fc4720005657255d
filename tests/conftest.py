"""Test configuration.

Tests run on the CPU backend with an 8-device virtual mesh, so the
multi-device sharding logic is exercised without accelerators. Both
must be set before JAX initializes. A run that names another platform
in JAX_PLATFORMS keeps it: that is how the tests marked ``gpu`` run on
the card (README, "Tests").
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

from genometester4_tpu.utils.lazyjax import configure_compile_cache

# persistent compile cache (JAX_COMPILATION_CACHE_DIR when set, else the
# checkout's .jax_cache): differential tests hit many (shape, op) combos
configure_compile_cache(jax)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import subprocess
from pathlib import Path

import numpy as np
import pytest

REF_BIN = Path(__file__).resolve().parent.parent / ".ref_build" / "src"


def has_reference() -> bool:
    return (REF_BIN / "glistmaker").exists()


def run_reference(args, cwd=None, input=None, timeout=120):
    """Run a reference binary (test oracle) and return CompletedProcess.

    timeout guards against latent reference bugs (e.g. the glistquery -l
    zipper infinite loop when the searched list exhausts first,
    src/glistquery.c:702-717).
    """
    prog = REF_BIN / args[0]
    if not prog.exists():
        pytest.skip(f"reference binary {args[0]} not built")
    return subprocess.run([str(prog)] + list(args[1:]), cwd=cwd, input=input,
                          capture_output=True, check=False, timeout=timeout)


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


@pytest.fixture
def gpu_backend():
    """For tests marked ``gpu``: skip unless JAX's backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; on the card run "
                    "`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`")
    return jax.devices()[0]


def random_fasta(rng, n_records, min_len, max_len, n_prob=0.0, line_width=70):
    """Generate a random FASTA text with optional Ns."""
    out = []
    for i in range(n_records):
        L = int(rng.integers(min_len, max_len + 1))
        bases = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=L)
        if n_prob:
            mask = rng.random(L) < n_prob
            bases = np.where(mask, np.uint8(ord("N")), bases)
        seq = bases.tobytes().decode()
        lines = [seq[j:j + line_width] for j in range(0, L, line_width)]
        out.append(f">seq{i} random\n" + "\n".join(lines) + "\n")
    return "".join(out)


def random_fastq(rng, n_records, read_len, n_prob=0.0):
    out = []
    for i in range(n_records):
        bases = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=read_len)
        if n_prob:
            mask = rng.random(read_len) < n_prob
            bases = np.where(mask, np.uint8(ord("N")), bases)
        qual = "I" * read_len
        out.append(f"@read{i}\n{bases.tobytes().decode()}\n+\n{qual}\n")
    return "".join(out)
