"""bin/ launcher tests.

The launchers start CPython with -S (no site init) and rely on
utils/lazyjax.py to keep the whole host path jax-free: `import jax`
costs seconds — more than most tool runs. These tests pin three
properties:

* every launcher runs and produces the same chrome as the module path;
* a real glistmaker run through the launcher is byte-identical to the
  reference binary;
* the host path genuinely never imports jax (the performance contract
  behind the launcher design).
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from tests.conftest import has_reference, run_reference, random_fasta

REPO = Path(__file__).resolve().parent.parent
BIN = REPO / "bin"

LAUNCHERS = ["glistmaker", "glistcompare", "glistquery", "gmer_counter",
             "gmer_caller", "gassembler", "kmer_predictor", "generate_vcf",
             "katk2vcf", "gt4_make_union", "gt4_make_intersection",
             "gt4_repeats"]


def run_launcher(args, cwd=None, input=None, timeout=120, env=None):
    e = dict(os.environ)
    if env:
        e.update(env)
    return subprocess.run([str(BIN / args[0])] + list(args[1:]), cwd=cwd,
                          input=input, capture_output=True, check=False,
                          timeout=timeout, env=e)


def test_all_launchers_exist_and_executable():
    for name in LAUNCHERS:
        p = BIN / name
        assert p.exists(), name
        assert os.access(p, os.X_OK), name


@pytest.mark.parametrize("tool", ["glistmaker", "glistcompare", "glistquery",
                                  "gmer_counter", "gmer_caller", "gassembler"])
def test_launcher_version_chrome_matches_reference(tool):
    if not has_reference():
        pytest.skip("reference not built")
    ref_names = {"gmer_counter": "gmer_counter", "gmer_caller": "gmer_caller",
                 "gassembler": "gassembler"}
    ref = run_reference([ref_names.get(tool, tool), "-v"])
    ours = run_launcher([tool, "-v"])
    assert ours.stdout == ref.stdout
    assert ours.returncode == ref.returncode


def test_glistmaker_launcher_byte_identical(tmp_path, rng):
    if not has_reference():
        pytest.skip("reference not built")
    fa = tmp_path / "in.fa"
    fa.write_text(random_fasta(rng, 5, 500, 900, n_prob=0.01))
    r1 = run_launcher(["glistmaker", str(fa), "-w", "12", "-o", "ours"],
                      cwd=tmp_path)
    assert r1.returncode == 0, r1.stderr
    r2 = run_reference(["glistmaker", str(fa), "-w", "12", "-o", "ref"],
                       cwd=tmp_path)
    assert (tmp_path / "ours_12.list").read_bytes() == \
           (tmp_path / "ref_12.list").read_bytes()


def test_glistcompare_launcher_byte_identical(tmp_path, rng):
    if not has_reference():
        pytest.skip("reference not built")
    fa1 = tmp_path / "a.fa"
    fa2 = tmp_path / "b.fa"
    fa1.write_text(random_fasta(rng, 4, 400, 800))
    fa2.write_text(random_fasta(rng, 4, 400, 800))
    for fa, pre in [(fa1, "a"), (fa2, "b")]:
        assert run_launcher(["glistmaker", str(fa), "-w", "11", "-o", pre],
                            cwd=tmp_path).returncode == 0
    ours = run_launcher(["glistcompare", "a_11.list", "b_11.list", "-u",
                         "-o", "ours"], cwd=tmp_path)
    assert ours.returncode == 0, ours.stderr
    run_reference(["glistcompare", "a_11.list", "b_11.list", "-u",
                   "-o", "ref"], cwd=tmp_path)
    assert (tmp_path / "ours_11_union.list").read_bytes() == \
           (tmp_path / "ref_11_union.list").read_bytes()


def test_host_path_never_imports_jax(tmp_path, rng):
    """The performance contract: a full glistmaker host run through the
    -S bootstrap must finish without jax ever entering sys.modules."""
    fa = tmp_path / "in.fa"
    fa.write_text(random_fasta(rng, 3, 300, 600))
    sp = os.path.join(os.environ.get("VIRTUAL_ENV", "/opt/venv"), "lib",
                      "python%d.%d" % sys.version_info[:2], "site-packages")
    code = (
        "import sys\n"
        f"sys.path.insert(0, {sp!r})\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from genometester4_tpu.cli.glistmaker import main\n"
        f"rc = main([{str(fa)!r}, '-w', '12', '-o', {str(tmp_path / 'x')!r}])\n"
        "assert rc == 0, rc\n"
        "assert 'jax' not in sys.modules, 'host path imported jax'\n"
        "print('OK')\n"
    )
    r = subprocess.run([sys.executable, "-S", "-c", code],
                       capture_output=True, timeout=120)
    assert r.returncode == 0, r.stderr.decode()
    assert b"OK" in r.stdout
    assert (tmp_path / "x_12.list").exists()


def test_launcher_fast_startup():
    """-v through the launcher must stay far under a jax import
    (seconds); generous bound for CI noise."""
    import time
    run_launcher(["glistmaker", "-v"])  # warm the OS caches
    t0 = time.time()
    r = run_launcher(["glistmaker", "-v"])
    dt = time.time() - t0
    assert r.returncode == 0
    assert dt < 2.0, f"launcher startup {dt:.2f}s"
