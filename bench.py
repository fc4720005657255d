"""Benchmark: k-mer count throughput of the device pipeline
(glistmaker core) plus end-to-end tool walls of the host engine.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

Inputs (genometester4_tpu.utils.seeded_inputs): uniform, duplicate-
heavy and genome-shaped 50 Mbp FASTAs, the FastGT chain fixture and the
KATK fixture.

Device metric: the device-resident count pipeline — 2-bit codes →
window extraction → canonicalization → sort → run marks — timed in a
child process on the default JAX backend (so this parent never holds
the card). Host FASTA parsing and the one-time host→device upload are
excluded from the timed region, and the result table stays on device
(scalars + checksum come back). If that section fails, or JAX finds no
accelerator, bench.py exits non-zero: no host number is ever reported
under the device metric.

End-to-end rows: fresh-process walls of the bin/ launchers with
``JAX_PLATFORMS=cpu``, i.e. the HOST engine's numbers (``*_e2e_*``
fields, labelled ``e2e_engine: "host"``), interleaved with the
reference binary when ``.ref_build`` holds one, outputs removed and
``sync`` between every run so no run pays for its predecessor's
dirty-page writeback.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

from genometester4_tpu.utils import seeded_inputs

REPO = os.path.dirname(os.path.abspath(__file__))
REF_BIN = os.path.join(REPO, ".ref_build", "src", "glistmaker")
REF_SRC = os.path.join(REPO, ".ref_build", "src")
WORK = os.path.join(tempfile.gettempdir(), "gt4_bench")
FASTA = os.path.join(WORK, "bench_50m.fa")
FASTA_DUP = os.path.join(WORK, "bench_50m_dup.fa")
FASTA_GEN = os.path.join(WORK, "bench_50m_genomic.fa")
FGT_DIR = os.path.join(WORK, "fastgt")
GASM_DIR = os.path.join(WORK, "gasm")
N_INSTANCES = 49_999_976       # uniform input, k=25
N_INSTANCES_DUP = 48_800_000   # dup input: 50_000 records x (1000-24)
K = 25
E2E_PAIRS = 3
# pad the device input to a multiple of this, not to a power of two;
# not yet tuned for H100 (ROADMAP 2.4)
PAD_QUANTUM = 1024 * 128
# end-to-end rows time the host engine (see module docstring)
HOST_ENV = dict(os.environ, JAX_PLATFORMS="cpu")


def _ensure(path, make, min_size=1):
    if os.path.exists(path) and os.path.getsize(path) >= min_size:
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    make()


def ensure_input():
    _ensure(FASTA, lambda: seeded_inputs.uniform_fasta(FASTA), 50_000_000)


def ensure_dup_input():
    _ensure(FASTA_DUP, lambda: seeded_inputs.dup_heavy_fasta(FASTA_DUP),
            50_000_000)


def ensure_genomic_input():
    _ensure(FASTA_GEN, lambda: seeded_inputs.genomic_fasta(FASTA_GEN),
            50_000_000)


def ensure_fastgt_fixture():
    _ensure(os.path.join(FGT_DIR, "reads.fq"),
            lambda: seeded_inputs.fastgt_fixture(FGT_DIR))


def ensure_gasm_fixture():
    """KATK fixture plus its read index (fixture prep, untimed)."""
    if os.path.exists(os.path.join(GASM_DIR, "db.idx")):
        return
    seeded_inputs.katk_fixture(GASM_DIR)
    counter = (os.path.join(REF_SRC, "gmer_counter")
               if os.path.exists(os.path.join(REF_SRC, "gmer_counter"))
               else os.path.join(REPO, "bin", "gmer_counter"))
    subprocess.run([counter, "-db", "db.txt", "--compile_index", "db.idx",
                    "--num_threads", "1", "reads.fq"], cwd=GASM_DIR,
                   check=True, capture_output=True, env=HOST_ENV)


def _timed_run(argv, outputs):
    """One fresh-process run: remove stale outputs, settle the page
    cache (sync flushes the PREVIOUS run's dirty pages so they cannot
    be charged to this one), run, then sync again INSIDE the timed
    region so each tool pays for its own writeback."""
    for p in outputs:
        try:
            os.unlink(p)
        except OSError:
            pass
    os.sync()
    t0 = time.time()
    subprocess.run(argv, check=True, capture_output=True, env=HOST_ENV)
    os.sync()
    return time.time() - t0


def run_e2e(fasta, tag, pairs=E2E_PAIRS):
    """Interleaved tool-vs-tool wall times. Returns (our_times,
    ref_times) lists; ref_times is [] without the oracle binary.
    Within-pair order alternates each rep so neither tool always runs
    into the other's cache footprint."""
    launcher = os.path.join(REPO, "bin", "glistmaker")
    ours_pre = os.path.join(WORK, "e2e_" + tag)
    ref_pre = os.path.join(WORK, "ref_" + tag)
    ours_out = "%s_%d.list" % (ours_pre, K)
    ref_out = "%s_%d.list" % (ref_pre, K)
    ours_argv = [launcher, fasta, "-w", str(K), "-o", ours_pre]
    ref_argv = [REF_BIN, fasta, "-w", str(K), "-o", ref_pre,
                "--num_threads", "8"]
    have_ref = os.path.exists(REF_BIN)
    our_times, ref_times = [], []
    for i in range(pairs):
        order = [("ours", ours_argv, [ours_out], our_times)]
        if have_ref:
            order.append(("ref", ref_argv, [ref_out], ref_times))
        if i % 2:
            order.reverse()
        for _, argv, outs, acc in order:
            acc.append(_timed_run(argv, outs))
    if have_ref:
        # the number is only meaningful if the tools produced the same
        # list — fail loudly rather than report a fast wrong answer
        import filecmp
        if not filecmp.cmp(ours_out, ref_out, shallow=False):
            raise SystemExit("[bench] e2e outputs differ from the "
                             "reference — refusing to report (%s)" % tag)
    return our_times, ref_times


def device_kernel_bench(fasta):
    """Device count-pipeline measurement; prints one JSON line
    {value, dt, n_unique, total, checksum, platform, device_kind,
    device_count}. Runs in a child process (run_device_bench)."""
    import jax
    import jax.numpy as jnp
    from genometester4_tpu.io.fasta import load_file
    from genometester4_tpu.ops.kmers import extract_kmers
    from genometester4_tpu.ops.sortcount import count_unique

    if jax.default_backend() == "cpu":
        raise SystemExit("[bench] no accelerator: the device metric is "
                         "not measured on the CPU")
    parsed = load_file(fasta)
    pad = -len(parsed.codes) % PAD_QUANTUM + len(parsed.codes)
    codes = np.full(pad, 255, np.uint8)
    codes[: len(parsed.codes)] = parsed.codes

    HB = 2 * K - 32

    @jax.jit
    def pipeline(c):
        hi, lo, valid = extract_kmers(c, K, canonical=True)
        ones = jnp.ones(hi.shape, jnp.uint32)
        shi, slo, head, tail, _, n = count_unique(
            hi, lo, ones, valid, hi_bits=HB,
            unit_weights=True, compact=False)
        total = jnp.sum(valid.astype(jnp.uint32))
        x = slo ^ shi
        p = jax.lax.broadcasted_iota(jnp.uint32, (x.shape[0], 1), 0).reshape(
            x.shape[0])
        checksum = (jnp.sum(jnp.where(tail, x * (p + 1), 0))
                    - jnp.sum(jnp.where(head, x * p, 0)))
        return n, total, checksum

    dc = jax.device_put(codes)
    r = [int(x) for x in pipeline(dc)]  # compile + sync
    n_unique, total_count, checksum = r
    times = []
    for _ in range(3):
        t0 = time.time()
        out = jax.block_until_ready(pipeline(dc))
        times.append(time.time() - t0)
        assert int(out[2]) == checksum and int(out[0]) == n_unique
    dt = min(times)
    d = jax.devices()[0]
    print(json.dumps({"value": total_count / dt, "dt": dt,
                      "n_unique": n_unique, "total": total_count,
                      "checksum": checksum, "platform": d.platform,
                      "device_kind": d.device_kind,
                      "device_count": len(jax.devices())}))


def run_device_bench(fasta, timeout=900):
    """Run the device section in a child process; a failure ends the
    benchmark with a non-zero exit."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--device-kernel-only", fasta],
                       timeout=timeout, capture_output=True, text=True)
    if r.returncode != 0:
        sys.stderr.write(r.stderr[-4000:])
        raise SystemExit("[bench] device section failed on %s" % fasta)
    return json.loads(r.stdout.strip().splitlines()[-1])


def baseline_kmers_per_s(ref_times) -> float | None:
    """Denominator for vs_baseline: the MEDIAN of the live reference
    re-times (None without the reference binary)."""
    if ref_times:
        return N_INSTANCES / statistics.median(ref_times)
    return None


def _r(x, nd=2):
    return round(x, nd)


def emit(dev, ref_times, our_times, dup_fields):
    base = baseline_kmers_per_s(ref_times)
    line = {
        "metric": "kmer_count_throughput_per_chip",
        "value": round(dev["value"], 1),
        "unit": "kmers/s",
        "vs_baseline": round(dev["value"] / base, 3) if base else None,
        "device": {"platform": dev["platform"], "kind": dev["device_kind"],
                   "count": dev["device_count"]},
        "e2e_engine": "host",
        "e2e_s": _r(min(our_times)),
        "e2e_runs": [_r(t) for t in our_times],
    }
    if ref_times:
        line["ref_e2e_s"] = _r(min(ref_times))
        line["e2e_vs_reference"] = _r(min(ref_times) / min(our_times))
        line["ref_e2e_runs"] = [_r(t) for t in ref_times]
    line.update(dup_fields)
    print(json.dumps(line))
    sys.stderr.write("[bench] " + json.dumps(line) + "\n")


def dup_e2e_fields(dev_dup):
    """Duplicate-heavy end-to-end rows plus the device value."""
    our_d, ref_d = run_e2e(FASTA_DUP, "dup")
    fields = {
        "dup_e2e_s": _r(min(our_d)),
        "dup_e2e_runs": [_r(t) for t in our_d],
    }
    if ref_d:
        fields["dup_ref_e2e_s"] = _r(min(ref_d))
        fields["dup_ref_e2e_runs"] = [_r(t) for t in ref_d]
        fields["e2e_dup_vs_reference"] = _r(min(ref_d) / min(our_d))
    fields["value_dup"] = round(dev_dup["value"], 1)
    return fields


def _timed_redirect(argv, out_path, cwd=None):
    """Fresh-process wall of one tool with stdout redirected to a file
    (same sync discipline as _timed_run)."""
    os.sync()
    t0 = time.time()
    with open(out_path, "wb") as f:
        subprocess.run(argv, check=True, stdout=f,
                       stderr=subprocess.DEVNULL, cwd=cwd, env=HOST_ENV)
    os.sync()
    return time.time() - t0


def fastgt_fields(pairs=2):
    """FastGT chain scoreboard: gmer_counter -db -> gmer_caller on the
    fixed 15k-marker/60k-read fixture, alternated
    single runs, outputs byte-compared. The chain wall is the sum of
    both tools' fresh-process walls."""
    if not os.path.exists(os.path.join(REF_SRC, "gmer_counter")):
        return {}
    ensure_fastgt_fixture()
    db = os.path.join(FGT_DIR, "db.txt")
    fq = os.path.join(FGT_DIR, "reads.fq")

    def chain(tag, counter, caller):
        cnt = os.path.join(FGT_DIR, "counts_%s.txt" % tag)
        calls = os.path.join(FGT_DIR, "calls_%s.txt" % tag)
        dt = _timed_redirect([counter, "-db", db, fq], cnt)
        dt += _timed_redirect([caller, cnt], calls)
        return dt

    ours = (os.path.join(REPO, "bin", "gmer_counter"),
            os.path.join(REPO, "bin", "gmer_caller"))
    ref = (os.path.join(REF_SRC, "gmer_counter"),
           os.path.join(REF_SRC, "gmer_caller"))
    our_times, ref_times = [], []
    for i in range(pairs):
        order = [("ours", ours, our_times), ("ref", ref, ref_times)]
        if i % 2:
            order.reverse()
        for tag, tools, acc in order:
            acc.append(chain(tag, *tools))
    for name in ("counts", "calls"):
        a = open(os.path.join(FGT_DIR, "%s_ours.txt" % name), "rb").read()
        b = open(os.path.join(FGT_DIR, "%s_ref.txt" % name), "rb").read()
        if a != b:
            raise SystemExit("[bench] fastgt %s outputs differ — refusing "
                             "to report" % name)
    return {
        "fastgt_e2e_s": _r(min(our_times)),
        "fastgt_ref_e2e_s": _r(min(ref_times)),
        "fastgt_e2e_vs_reference": _r(min(ref_times) / min(our_times)),
        "fastgt_e2e_runs": [_r(t) for t in our_times],
        "fastgt_ref_e2e_runs": [_r(t) for t in ref_times],
    }


def gasm_fields(pairs=2):
    """KATK scoreboard: gassembler over the 200-region fixture, --num_threads 1 both sides (the reference's
    threaded output is schedule-dependent, so the sequential surface is
    the only byte-comparable one; our parallel mode is byte-identical
    to our sequential at any thread count), stdout byte-compared."""
    if not os.path.exists(os.path.join(REF_SRC, "gassembler")):
        return {}
    ensure_gasm_fixture()
    args = ["--dbi", "db.idx", "--region_file", "regions.txt",
            "--coverage", "40", "--sex", "female", "--num_threads", "1"]

    def run_one(tag, exe):
        out = os.path.join(GASM_DIR, "calls_%s.txt" % tag)
        return _timed_redirect([exe] + args, out, cwd=GASM_DIR)

    our_exe = os.path.join(REPO, "bin", "gassembler")
    ref_exe = os.path.join(REF_SRC, "gassembler")
    our_times, ref_times = [], []
    for i in range(pairs):
        order = [("ours", our_exe, our_times), ("ref", ref_exe, ref_times)]
        if i % 2:
            order.reverse()
        for tag, exe, acc in order:
            acc.append(run_one(tag, exe))
    a = open(os.path.join(GASM_DIR, "calls_ours.txt"), "rb").read()
    b = open(os.path.join(GASM_DIR, "calls_ref.txt"), "rb").read()
    if a != b:
        raise SystemExit("[bench] gassembler outputs differ — refusing "
                         "to report")
    return {
        "gasm_e2e_s": _r(min(our_times)),
        "gasm_ref_e2e_s": _r(min(ref_times)),
        "gasm_e2e_vs_reference": _r(min(ref_times) / min(our_times)),
        "gasm_e2e_runs": [_r(t) for t in our_times],
        "gasm_ref_e2e_runs": [_r(t) for t in ref_times],
    }


def gen_e2e_fields(dev_gen):
    """Genome-shaped input rows."""
    our_g, ref_g = run_e2e(FASTA_GEN, "gen", pairs=2)
    fields = {
        "gen_e2e_s": _r(min(our_g)),
        "gen_e2e_runs": [_r(t) for t in our_g],
    }
    if ref_g:
        fields["gen_ref_e2e_s"] = _r(min(ref_g))
        fields["gen_ref_e2e_runs"] = [_r(t) for t in ref_g]
        fields["e2e_gen_vs_reference"] = _r(min(ref_g) / min(our_g))
    fields["value_gen"] = round(dev_gen["value"], 1)
    return fields


def main():
    ensure_input()
    ensure_dup_input()
    ensure_genomic_input()
    if "--device-kernel-only" in sys.argv:
        device_kernel_bench(sys.argv[-1] if sys.argv[-1].endswith(".fa")
                            else FASTA)
        return
    dev = run_device_bench(FASTA)
    dev_dup = run_device_bench(FASTA_DUP)
    dev_gen = run_device_bench(FASTA_GEN)
    sys.stderr.write(
        "[bench] device %s: %d instances, %d unique, best %.3fs "
        "(%.1f M kmers/s) checksum=%d\n"
        % (dev["device_kind"], dev["total"], dev["n_unique"], dev["dt"],
           dev["value"] / 1e6, dev["checksum"]))

    # end-to-end tool runs (parse -> count -> .list write) of the host
    # engine: HOST_ENV pins every child to the CPU backend
    our_times, ref_times = run_e2e(FASTA, "uni")
    dup_fields = dup_e2e_fields(dev_dup)
    dup_fields.update(gen_e2e_fields(dev_gen))
    dup_fields.update(fastgt_fields())
    dup_fields.update(gasm_fields())
    emit(dev, ref_times, our_times, dup_fields)


if __name__ == "__main__":
    main()
