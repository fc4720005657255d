"""Device path vs host-native twin, byte for byte, on a GPU.

Marked ``gpu``: each case skips unless JAX's backend is a GPU (the
``gpu_backend`` fixture decides at run time). On the card run
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``. Every case runs
one tool's CLI twice in this process, with its placement pinned to the
host engine and then to the device path, and compares the outputs.
"""

import numpy as np
import pytest

from tests.conftest import random_fasta, random_fastq

PINS = ("GT4_TPU_COUNT_IMPL", "GT4_TPU_SETOPS_IMPL")


def _twice(monkeypatch, capfd, call):
    """call(side) under host then device placement; returns
    {side: (rc, stdout bytes)}."""
    out = {}
    for side in ("host", "device"):
        for var in PINS:
            monkeypatch.setenv(var, side)
        capfd.readouterr()
        rc = call(side)
        out[side] = (rc, capfd.readouterr().out)
    assert out["host"] == out["device"]
    return out


def _fasta(tmp_path, rng, name="in.fa", n=6):
    p = tmp_path / name
    p.write_text(random_fasta(rng, n, 20_000, 60_000, n_prob=0.001))
    return str(p)


def _glistmaker(tmp_path, rng, monkeypatch, capfd):
    from genometester4_tpu.cli.glistmaker import main
    fa = _fasta(tmp_path, rng)
    _twice(monkeypatch, capfd,
           lambda s: main([fa, "-w", "25", "-o", str(tmp_path / s)]))
    return [("host_25.list", "device_25.list")]


def _index(tmp_path, rng, monkeypatch, capfd):
    from genometester4_tpu.cli.glistmaker import main
    fa = _fasta(tmp_path, rng)
    _twice(monkeypatch, capfd, lambda s: main(
        [fa, "-w", "21", "-o", str(tmp_path / s), "--index"]))
    return [("host_21.index", "device_21.index")]


def _glistcompare(tmp_path, rng, monkeypatch, capfd):
    from genometester4_tpu.cli.glistcompare import main
    from genometester4_tpu.pipelines.listmaker import make_list
    monkeypatch.setenv("GT4_TPU_COUNT_IMPL", "host")
    lists = []
    for name in ("a", "b"):
        make_list([_fasta(tmp_path, rng, name + ".fa")], 25,
                  str(tmp_path / (name + "_25.list")))
        lists.append(str(tmp_path / (name + "_25.list")))
    _twice(monkeypatch, capfd, lambda s: main(
        lists + ["-u", "-i", "-d", "-o", str(tmp_path / s)]))
    return [("host_25_%s.list" % op, "device_25_%s.list" % op)
            for op in ("union", "intrsec", "0_diff1")]


def _glistquery(tmp_path, rng, monkeypatch, capfd):
    from genometester4_tpu.cli.glistquery import main
    from genometester4_tpu.formats.list_format import read_list, write_list
    from genometester4_tpu.pipelines.listmaker import make_list
    monkeypatch.setenv("GT4_TPU_COUNT_IMPL", "host")
    lst = str(tmp_path / "a_25.list")
    make_list([_fasta(tmp_path, rng)], 25, lst)
    _, words, _ = read_list(lst)
    q = np.unique(np.concatenate([
        np.asarray(words)[rng.integers(0, len(words), 6000)],
        rng.integers(0, 1 << 50, 6000, dtype=np.int64).astype(np.uint64)]))
    write_list(str(tmp_path / "q_25.list"), 25, q,
               np.ones(len(q), np.uint32))
    _twice(monkeypatch, capfd,
           lambda s: main([lst, "-l", str(tmp_path / "q_25.list")]))
    return []


def _db_text(rng, n=300):
    lines = []
    for i in range(n):
        a = rng.choice(list("ACGT"), 25)
        b = a.copy()
        b[12] = "ACGT"[("ACGT".index(a[12]) + 1) % 4]
        lines.append("%d:%d:rs%d:A/B\t2\t%s\t%s"
                     % (1 + i % 22, i, i, "".join(a), "".join(b)))
    return "\n".join(lines) + "\n"


def _gmer_counter(tmp_path, rng, monkeypatch, capfd):
    from genometester4_tpu.cli.gmer_counter import main
    (tmp_path / "db.txt").write_text(_db_text(rng))
    (tmp_path / "r.fq").write_text(random_fastq(rng, 20_000, 100))
    _twice(monkeypatch, capfd, lambda s: main(
        ["-db", str(tmp_path / "db.txt"), str(tmp_path / "r.fq")]))
    return []


def _gmer_counter_index(tmp_path, rng, monkeypatch, capfd):
    from genometester4_tpu.cli.gmer_counter import main
    (tmp_path / "db.txt").write_text(_db_text(rng))
    (tmp_path / "r.fq").write_text(random_fastq(rng, 20_000, 100))
    monkeypatch.chdir(tmp_path)
    _twice(monkeypatch, capfd, lambda s: main(
        ["-db", "db.txt", "--compile_index", s + ".idx", "--num_threads",
         "1", "r.fq"]))
    return [("host.idx", "device.idx")]


CASES = {"glistmaker": _glistmaker, "glistmaker_index": _index,
         "glistcompare": _glistcompare, "glistquery": _glistquery,
         "gmer_counter": _gmer_counter,
         "gmer_counter_index": _gmer_counter_index}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_device_path_matches_host(case, gpu_backend, tmp_path, rng,
                                  monkeypatch, capfd):
    for host, device in CASES[case](tmp_path, rng, monkeypatch, capfd):
        assert (tmp_path / host).read_bytes() == \
            (tmp_path / device).read_bytes(), (host, device)
