"""Multi-process (multi-host) paths: real jax.distributed groups.

The reference is single-node only (SURVEY.md §2c); the multi-host path
(parallel/multihost.py) is the cross-host half of the mesh design.
These tests spawn REAL process groups (Gloo collectives over loopback
stand in for the host network) through the production CLI entry points and
byte-compare the distributed output against the reference binary.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from tests.conftest import random_fasta, run_reference

DRIVER = Path(__file__).resolve().parent / "_mh_driver.py"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_group(nprocs, local_devices, tool, args, cwd):
    env = dict(os.environ)
    repo_root = str(DRIVER.parent.parent)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={local_devices}")
    coord = f"127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, str(DRIVER), coord, str(nprocs), str(i),
             tool] + [str(a) for a in args],
            env=env, cwd=cwd,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for i in range(nprocs)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"driver failed rc={rc}\n{err.decode()[-2000:]}"
    return outs


@pytest.mark.parametrize("nprocs,local", [(2, 2), (2, 1), (4, 2)])
def test_multihost_glistmaker_byte_identical(tmp_path, rng, nprocs, local):
    """N-process mesh output == reference bytes, multi-file input
    (exercises the cross-slab shard merge)."""
    f1 = tmp_path / "a.fa"
    f2 = tmp_path / "b.fa"
    f1.write_text(random_fasta(rng, 3, 3000, 6000, n_prob=0.01))
    f2.write_text(random_fasta(rng, 2, 2000, 4000))

    ref = run_reference(["glistmaker", str(f1), str(f2), "-w", "16",
                         "-o", str(tmp_path / "ref")], cwd=tmp_path)
    assert ref.returncode == 0, ref.stderr.decode()
    expected = (tmp_path / "ref_16.list").read_bytes()

    _run_group(nprocs, local, "glistmaker",
               [f1, f2, "-w", "16", "-o", str(tmp_path / "mh")], tmp_path)
    got = (tmp_path / "mh_16.list").read_bytes()
    assert got == expected


def test_multihost_glistcompare_pair_byte_identical(tmp_path, rng):
    """2-process SPMD pair ops: all four outputs byte-identical to the
    reference; only process 0 writes."""
    f1 = tmp_path / "a.fa"
    f2 = tmp_path / "b.fa"
    f1.write_text(random_fasta(rng, 2, 4000, 7000, n_prob=0.01))
    f2.write_text(random_fasta(rng, 2, 3000, 5000))
    for tag, f in (("A", f1), ("B", f2)):
        r = run_reference(["glistmaker", str(f), "-w", "14",
                           "-o", str(tmp_path / tag)], cwd=tmp_path)
        assert r.returncode == 0
    la, lb = str(tmp_path / "A_14.list"), str(tmp_path / "B_14.list")

    ref = run_reference(["glistcompare", la, lb, "-u", "-i", "-d", "-dd",
                         "-o", str(tmp_path / "ref")], cwd=tmp_path)
    assert ref.returncode == 0, ref.stderr.decode()

    _run_group(2, 2, "glistcompare",
               [la, lb, "-u", "-i", "-d", "-dd",
                "-o", str(tmp_path / "mh")], tmp_path)
    for suf in ("union", "intrsec", "0_diff1", "0_diff2"):
        exp = (tmp_path / f"ref_14_{suf}.list").read_bytes()
        got = (tmp_path / f"mh_14_{suf}.list").read_bytes()
        assert got == exp, suf


def test_multihost_glistcompare_multi_union(tmp_path, rng):
    """2-process SPMD 3-list union bytes == reference."""
    lists = []
    for i in range(3):
        f = tmp_path / f"s{i}.fa"
        f.write_text(random_fasta(rng, 2, 2000, 5000))
        r = run_reference(["glistmaker", str(f), "-w", "12",
                           "-o", str(tmp_path / f"L{i}")], cwd=tmp_path)
        assert r.returncode == 0
        lists.append(str(tmp_path / f"L{i}_12.list"))

    ref = run_reference(["glistcompare"] + lists
                        + ["-u", "-o", str(tmp_path / "ref")], cwd=tmp_path)
    assert ref.returncode == 0, ref.stderr.decode()
    expected = (tmp_path / "ref_12_union.list").read_bytes()

    _run_group(2, 2, "glistcompare",
               lists + ["-u", "-o", str(tmp_path / "mh")], tmp_path)
    assert (tmp_path / "mh_12_union.list").read_bytes() == expected


def test_multihost_gmer_counter_stdout_identical(tmp_path, rng):
    """2-process global-mesh DB counting: process 0's stdout equals the
    reference's; the other process prints nothing."""
    fa = tmp_path / "reads.fa"
    fa.write_text(random_fasta(rng, 4, 2000, 4000, n_prob=0.01))
    # build a small SNV-style text DB from substrings of the reads
    seqs = [ln for ln in fa.read_text().splitlines()
            if ln and not ln.startswith(">")]
    blob = "".join(seqs)
    lines = []
    for i in range(40):
        a = (i * 173) % (len(blob) - 60)
        k1 = blob[a:a + 16]
        k2 = blob[a + 30:a + 46]
        if "N" in k1 or "N" in k2:
            continue
        lines.append(f"N{i}\t2\t{k1}\t{k2}")
    db = tmp_path / "db.txt"
    db.write_text("\n".join(lines) + "\n")

    ref = run_reference(["gmer_counter", "-db", str(db), str(fa)],
                        cwd=tmp_path)
    assert ref.returncode == 0, ref.stderr.decode()

    outs = _run_group(2, 2, "gmer_counter",
                      ["-db", str(db), str(fa)], tmp_path)

    def degloo(b):
        # the Gloo transport (loopback stand-in for the host network) banners on
        # stdout; that noise is the test harness's, not the tool's
        return b"".join(ln for ln in b.splitlines(keepends=True)
                        if not ln.startswith(b"[Gloo]"))

    assert degloo(outs[0][1]) == ref.stdout
    assert degloo(outs[1][1]) == b""
