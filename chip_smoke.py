"""Smoke test of every tool's device path on one GPU.

    python chip_smoke.py [--seed N]      # one card
    python chip_smoke.py --four-cards    # the mesh paths on four cards

Each phase runs one tool through its normal entry point (the bin/
launchers or the CLI modules) twice, in child processes: once on the
GPU, and once as the host-native twin (``JAX_PLATFORMS=cpu``,
``GT4_TPU_*_IMPL=host``). The outputs must be byte-identical. Inputs are
generated from ``--seed`` (genometester4_tpu.utils.seeded_inputs):

1. glistmaker, k=25, 50 Mbp genome-shaped FASTA (two 2^25-base device
   chunks + merge_sorted_shards), through bin/glistmaker;
2. glistmaker --index over 10 Mbp;
3. glistcompare union / intersection / difference of phase 1's list and
   a duplicate-heavy 50 Mbp list, then a glistquery batch lookup of
   ~1M query words against phase 1's list;
4. FastGT: gmer_counter -db (100k markers, 300k reads of 100 bp), then
   gmer_caller;
5. KATK: gmer_counter --compile_index, then gassembler over 200 regions
   with an oversized region between two regions of >200 reads.

This process never imports jax, so it never holds the card; the device
children run one at a time with ``CUDA_VISIBLE_DEVICES`` naming their
cards. Every line goes to stdout; the last one is the JSON result, and
it is printed only when every phase passed. Without a GPU the script
exits non-zero and prints no result.

``--four-cards`` runs only the multi-card paths and what they are
compared with: ``__graft_entry__.dryrun_multichip(4)``, then phase 1
and phase 4's counting on four cards against the same runs on one card,
with each device's peak memory printed after every four-card run.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BIN = os.path.join(REPO, "bin")

# platform the device children must run on; JAX_PLATFORMS pins it so a
# missing card or plug-in fails the child instead of falling back to CPU
DEVICE_PLATFORM = "cuda"
EXPECT_BACKEND = "gpu"
DEVICE_OVERRIDES: dict = {}       # extra env for device children
HOST_OVERRIDES = {"JAX_PLATFORMS": "cpu", "GT4_TPU_COUNT_IMPL": "host",
                  "GT4_TPU_SETOPS_IMPL": "host", "GT4_TPU_CALLER_IMPL": "host"}
IMPL_VARS = ("GT4_TPU_COUNT_IMPL", "GT4_TPU_SETOPS_IMPL",
             "GT4_TPU_CALLER_IMPL", "GT4_TPU_MESH")

SIZES = {
    "genome": 50_000_000,          # phase 1, bench.py's genome-shaped input
    "index_genome": 10_000_000,    # phase 2
    "dup_segments": 50_000,        # phase 3, x 1000 bp from 5 Mbp
    "dup_source": 5_000_000,
    "queries": 1 << 20,            # phase 3 glistquery lookups
    "markers": 100_000,            # phase 4
    "reads": 300_000,
    "marker_source": 8_000_000,
    "regions": 200,                # phase 5
    "region_genome": 200_000,
    "region_reads_per_hap": 40_000,
    "chunk_bases": 1 << 25,        # glistmaker's DEFAULT_CHUNK_BASES
}
CHILD_TIMEOUT = 900


class PhaseError(RuntimeError):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


def child_env(device: bool, visible: str = "0") -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    for k in IMPL_VARS:
        env.pop(k, None)
    if device:
        env["JAX_PLATFORMS"] = DEVICE_PLATFORM
        env["CUDA_VISIBLE_DEVICES"] = visible
        env.update(DEVICE_OVERRIDES)
    else:
        env.update(HOST_OVERRIDES)
    return env


def run(argv, env, cwd=None, stdout_path=None) -> tuple[float, str]:
    """Run one child to completion; returns (wall seconds, stderr)."""
    t0 = time.time()
    out = open(stdout_path, "wb") if stdout_path else subprocess.PIPE
    try:
        r = subprocess.run(argv, env=env, cwd=cwd, stdout=out,
                           stderr=subprocess.PIPE, timeout=CHILD_TIMEOUT)
    finally:
        if stdout_path:
            out.close()
    dt = time.time() - t0
    err = r.stderr.decode("utf-8", "replace")
    if r.returncode != 0:
        raise PhaseError("%s exited %d:\n%s" % (" ".join(map(str, argv[:4])),
                                                r.returncode, err[-3000:]))
    return dt, err


def tool_argv(tool: str, args) -> list:
    """Device child: a CLI module run under this script's checks."""
    return [sys.executable, os.path.abspath(__file__), "--device-child",
            EXPECT_BACKEND, tool] + [str(a) for a in args]


def host_tool(tool: str, args) -> list:
    return [sys.executable, "-m", "genometester4_tpu.cli." + tool] + \
        [str(a) for a in args]


def same(a: str, b: str, what: str) -> int:
    if not filecmp.cmp(a, b, shallow=False):
        raise PhaseError("%s: device output %s differs from host %s"
                         % (what, b, a))
    return os.path.getsize(a)


def peak_lines(err: str) -> list:
    return [ln for ln in err.splitlines() if ln.startswith("peak_bytes_in_use")]


# --------------------------------------------------------------------------
# device child: assert where it runs, run the tool, report peak memory
# --------------------------------------------------------------------------

def device_child(expect: str, tool: str, args) -> int:
    import importlib

    from genometester4_tpu.utils.backend import prefer_host
    from genometester4_tpu.utils.lazyjax import ensure_jax

    jax = ensure_jax()
    backend = jax.default_backend()
    if backend != expect:
        raise SystemExit("device child: backend %r, expected %r"
                         % (backend, expect))
    if expect != "cpu" and prefer_host():
        raise SystemExit("device child: placement picked the host engine")
    if tool == "dryrun_multichip":
        sys.path.insert(0, REPO)
        import __graft_entry__
        __graft_entry__.dryrun_multichip(int(args[0]))
        rc = 0
    elif tool == "chunk_memory":
        rc = chunk_memory(int(args[0]))
    else:
        rc = importlib.import_module(
            "genometester4_tpu.cli." + tool).main(list(args)) or 0
    sys.stdout.flush()
    for d in jax.local_devices():
        stats = d.memory_stats() or {}
        sys.stderr.write("peak_bytes_in_use %s %s\n"
                         % (d, stats.get("peak_bytes_in_use", "n/a")))
    return rc


def chunk_memory(chunk_bases: int) -> int:
    """Compile glistmaker's chunk step at its production shape and print
    ``compiled.memory_analysis()``."""
    import numpy as np

    from genometester4_tpu.pipelines.listmaker import _make_chunk_fn
    from genometester4_tpu.utils.lazyjax import ensure_jax

    jax = ensure_jax()
    step = _make_chunk_fn(25)
    spec = jax.ShapeDtypeStruct((chunk_bases,), np.uint8)
    t0 = time.time()
    compiled = step.lower(spec).compile()
    print("chunk step (2^%d bases) compiled in %.1f s; memory_analysis: %s"
          % (chunk_bases.bit_length() - 1, time.time() - t0,
             compiled.memory_analysis()))
    return 0


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def device_info(visible: str) -> dict:
    code = ("import json, jax; d = jax.devices(); print(json.dumps("
            "{'platform': d[0].platform, 'kind': d[0].device_kind, "
            "'count': len(d)}))")
    r = subprocess.run([sys.executable, "-c", code],
                       env=child_env(True, visible), capture_output=True,
                       timeout=300, text=True)
    if r.returncode != 0:
        raise PhaseError("no accelerator: %s" % r.stderr.strip()[-1500:])
    info = json.loads(r.stdout.strip().splitlines()[-1])
    if info["platform"] != EXPECT_BACKEND:
        raise PhaseError("JAX reports platform %r, not %r"
                         % (info["platform"], EXPECT_BACKEND))
    return info


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise PhaseError("nvidia-smi failed: %s" % r.stderr.strip())
    return r.stdout.strip()


def phase1_glistmaker(w: str, seed: int) -> str:
    from genometester4_tpu.utils import seeded_inputs

    fa = os.path.join(w, "genome.fa")
    seeded_inputs.genomic_fasta(fa, SIZES["genome"], seed=seed)
    host = os.path.join(w, "host_25.list")
    dt, _ = run([os.path.join(BIN, "glistmaker"), fa, "-w", "25", "-o",
                 os.path.join(w, "host")], child_env(False))
    say("phase 1 glistmaker host: %.2f s" % dt)
    dev_pre = os.path.join(w, "dev")
    dt, err = run([os.path.join(BIN, "glistmaker"), fa, "-w", "25", "-o",
                   dev_pre, "-D"], child_env(True))
    want = "Count placement: device (%s, 1 devices)" % EXPECT_BACKEND
    if want not in err:
        raise PhaseError("bin/glistmaker did not report %r:\n%s"
                         % (want, err[-2000:]))
    n = same(host, dev_pre + "_25.list", "phase 1 .list")
    say("phase 1 glistmaker device (bin/glistmaker, %s): %.2f s, "
        "%d bytes identical" % (want, dt, n))
    return host


def phase2_index(w: str, seed: int) -> None:
    from genometester4_tpu.utils import seeded_inputs

    fa = os.path.join(w, "genome10.fa")
    seeded_inputs.genomic_fasta(fa, SIZES["index_genome"], seed=seed + 1)
    dt_h, _ = run(host_tool("glistmaker", [fa, "-w", 25, "-o",
                                           os.path.join(w, "ih"), "--index"]),
                  child_env(False))
    dt_d, _ = run(tool_argv("glistmaker", [fa, "-w", 25, "-o",
                                           os.path.join(w, "id"), "--index"]),
                  child_env(True))
    n = same(os.path.join(w, "ih_25.index"), os.path.join(w, "id_25.index"),
             "phase 2 .index")
    say("phase 2 glistmaker --index: host %.2f s, device %.2f s, "
        "%d bytes identical" % (dt_h, dt_d, n))


def phase3_setops(w: str, seed: int, big_list: str) -> None:
    import numpy as np

    from genometester4_tpu.formats.list_format import read_list, write_list
    from genometester4_tpu.utils import seeded_inputs

    fa = os.path.join(w, "dup.fa")
    seeded_inputs.dup_heavy_fasta(fa, SIZES["dup_segments"],
                                  source_length=SIZES["dup_source"],
                                  seed=seed + 2)
    run([os.path.join(BIN, "glistmaker"), fa, "-w", "25", "-o",
         os.path.join(w, "dup")], child_env(False))
    dup_list = os.path.join(w, "dup_25.list")
    for side in ("h", "d"):
        os.makedirs(os.path.join(w, "cmp_" + side), exist_ok=True)
    args = [big_list, dup_list, "-u", "-i", "-d", "-o", "out"]
    dt_h, _ = run(host_tool("glistcompare", args), child_env(False),
                  cwd=os.path.join(w, "cmp_h"))
    dt_d, _ = run(tool_argv("glistcompare", args), child_env(True),
                  cwd=os.path.join(w, "cmp_d"))
    outs = sorted(os.listdir(os.path.join(w, "cmp_h")))
    if sorted(os.listdir(os.path.join(w, "cmp_d"))) != outs or not outs:
        raise PhaseError("phase 3 glistcompare output sets differ: %s"
                         % outs)
    n = sum(same(os.path.join(w, "cmp_h", f), os.path.join(w, "cmp_d", f),
                 "phase 3 glistcompare " + f) for f in outs)
    say("phase 3 glistcompare -u -i -d: host %.2f s, device %.2f s, "
        "%d files / %d bytes identical" % (dt_h, dt_d, len(outs), n))

    # query list: half words of the big list, half random 25-mers
    rng = np.random.default_rng(seed + 3)
    _, words, _ = read_list(big_list, mmap=True)
    words = np.asarray(words)
    half = SIZES["queries"] // 2
    pick = words[rng.integers(0, len(words), half)]
    rand = rng.integers(0, 1 << 50, half, dtype=np.int64).astype(np.uint64)
    q = np.unique(np.concatenate([pick, rand]))
    qpath = os.path.join(w, "query_25.list")
    write_list(qpath, 25, q, np.ones(len(q), np.uint32))
    outh, outd = os.path.join(w, "q_host.txt"), os.path.join(w, "q_dev.txt")
    dt_h, _ = run(host_tool("glistquery", [big_list, "-l", qpath]),
                  child_env(False), stdout_path=outh)
    dt_d, _ = run(tool_argv("glistquery", [big_list, "-l", qpath]),
                  child_env(True), stdout_path=outd)
    n = same(outh, outd, "phase 3 glistquery")
    say("phase 3 glistquery -l (%d query words): host %.2f s, device "
        "%.2f s, %d bytes identical" % (len(q), dt_h, dt_d, n))


def fastgt_inputs(w: str, seed: int) -> tuple[str, str]:
    from genometester4_tpu.utils import seeded_inputs

    return seeded_inputs.fastgt_fixture(
        os.path.join(w, "fastgt"), SIZES["markers"], SIZES["reads"],
        SIZES["marker_source"], seed=seed + 4)


def phase4_fastgt(w: str, seed: int) -> None:
    db, fq = fastgt_inputs(w, seed)
    d = os.path.dirname(db)
    ch, cd = os.path.join(d, "counts_host.txt"), os.path.join(d,
                                                             "counts_dev.txt")
    dt_h, _ = run(host_tool("gmer_counter", ["-db", db, fq]),
                  child_env(False), stdout_path=ch)
    dt_d, _ = run(tool_argv("gmer_counter", ["-db", db, fq]),
                  child_env(True), stdout_path=cd)
    n = same(ch, cd, "phase 4 gmer_counter")
    say("phase 4 gmer_counter -db: host %.2f s, device %.2f s, "
        "%d bytes identical" % (dt_h, dt_d, n))
    kh, kd = os.path.join(d, "calls_host.txt"), os.path.join(d,
                                                             "calls_dev.txt")
    dt_h, _ = run(host_tool("gmer_caller", [ch]), child_env(False),
                  stdout_path=kh)
    dt_d, _ = run(tool_argv("gmer_caller", [cd]), child_env(True),
                  stdout_path=kd)
    n = same(kh, kd, "phase 4 gmer_caller")
    say("phase 4 gmer_caller: host %.2f s, device %.2f s, "
        "%d bytes identical" % (dt_h, dt_d, n))


def katk_inputs(w: str, seed: int) -> str:
    """KATK fixture plus its read index (built by the host engine) in
    ``w/katk``; returns that directory."""
    from genometester4_tpu.utils import seeded_inputs

    d = os.path.join(w, "katk")
    seeded_inputs.katk_fixture(
        d, SIZES["regions"], SIZES["region_genome"],
        SIZES["region_reads_per_hap"], oversized_at=SIZES["regions"] // 2,
        seed=seed + 5)
    return d


def phase5_katk(w: str, seed: int) -> None:
    d = katk_inputs(w, seed)
    idx_args = ["-db", "db.txt", "--compile_index", "db.idx",
                "--num_threads", "1", "reads.fq"]
    for side in ("h", "d"):
        sd = os.path.join(d, side)
        os.makedirs(sd, exist_ok=True)
        for f in ("db.txt", "reads.fq", "regions.txt"):
            os.symlink(os.path.join(d, f), os.path.join(sd, f))
    dt_h, _ = run(host_tool("gmer_counter", idx_args), child_env(False),
                  cwd=os.path.join(d, "h"))
    dt_d, _ = run(tool_argv("gmer_counter", idx_args), child_env(True),
                  cwd=os.path.join(d, "d"))
    n = same(os.path.join(d, "h", "db.idx"), os.path.join(d, "d", "db.idx"),
             "phase 5 read index")
    say("phase 5 gmer_counter --compile_index: host %.2f s, device %.2f s, "
        "%d bytes identical" % (dt_h, dt_d, n))
    gargs = ["--dbi", "db.idx", "--region_file", "regions.txt",
             "--coverage", "40", "--sex", "female", "--num_threads", "1"]
    oh, od = os.path.join(d, "calls_host.txt"), os.path.join(d,
                                                             "calls_dev.txt")
    dt_h, _ = run(host_tool("gassembler", gargs), child_env(False),
                  cwd=os.path.join(d, "h"), stdout_path=oh)
    dt_d, _ = run(tool_argv("gassembler", gargs), child_env(True),
                  cwd=os.path.join(d, "d"), stdout_path=od)
    n = same(oh, od, "phase 5 gassembler")
    say("phase 5 gassembler (%d regions): host %.2f s, device %.2f s, "
        "%d bytes identical" % (SIZES["regions"], dt_h, dt_d, n))


def four_cards(w: str, seed: int) -> None:
    four = "0,1,2,3"
    dt, err = run(tool_argv("dryrun_multichip", [4]), child_env(True, four))
    say("four cards: dryrun_multichip(4) passed in %.2f s" % dt)
    for ln in peak_lines(err):
        say("  dryrun " + ln)

    # phase 1: four cards (mesh path) against one card, byte for byte
    from genometester4_tpu.utils import seeded_inputs

    fa = os.path.join(w, "genome.fa")
    seeded_inputs.genomic_fasta(fa, SIZES["genome"], seed=seed)
    outs = {}
    for tag, vis in (("one", "0"), ("four", four)):
        pre = os.path.join(w, tag)
        dt, err = run(tool_argv("glistmaker", [fa, "-w", 25, "-o", pre, "-D"]),
                      child_env(True, vis))
        want = "Count placement: device (%s, %d devices)" % (
            EXPECT_BACKEND, len(vis.split(",")))
        if want not in err:
            raise PhaseError("glistmaker did not report %r" % want)
        outs[tag] = pre + "_25.list"
        say("four cards: phase 1 glistmaker on %s: %.2f s" % (want, dt))
        if tag == "four":
            for ln in peak_lines(err):
                say("  glistmaker " + ln)
    n = same(outs["one"], outs["four"], "four-card phase 1 .list")
    say("four cards: phase 1 .list identical to one card (%d bytes)" % n)

    db, fq = fastgt_inputs(w, seed)
    counts = {}
    for tag, vis in (("one", "0"), ("four", four)):
        out = os.path.join(w, "counts_%s.txt" % tag)
        dt, err = run(tool_argv("gmer_counter", ["-db", db, fq]),
                      child_env(True, vis), stdout_path=out)
        counts[tag] = out
        say("four cards: phase 4 gmer_counter -db on %d card(s): %.2f s"
            % (len(vis.split(",")), dt))
        if tag == "four":
            for ln in peak_lines(err):
                say("  gmer_counter " + ln)
    n = same(counts["one"], counts["four"], "four-card phase 4 counts")
    say("four cards: phase 4 counts identical to one card (%d bytes)" % n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh paths")
    ap.add_argument("--work", help="scratch directory (default: a new "
                    "temporary directory, removed at the end)")
    args = ap.parse_args(argv)

    visible = "0,1,2,3" if args.four_cards else "0"
    try:
        info = device_info(visible)
    except (PhaseError, subprocess.TimeoutExpired) as e:
        sys.stderr.write("chip_smoke: %s\n" % e)
        return 1
    say("card: %s" % card_line())
    say("device: %s x%d (JAX platform %s)" % (info["kind"], info["count"],
                                              info["platform"]))
    if args.four_cards and info["count"] != 4:
        sys.stderr.write("chip_smoke: --four-cards needs 4 devices, JAX "
                         "sees %d\n" % info["count"])
        return 1
    from genometester4_tpu.utils.lazyjax import compile_cache_dir
    say("compile cache: %s" % compile_cache_dir())

    w = args.work or tempfile.mkdtemp(prefix="gt4_chip_smoke_")
    os.makedirs(w, exist_ok=True)
    t0 = time.time()
    try:
        if args.four_cards:
            four_cards(w, args.seed)
        else:
            big = phase1_glistmaker(w, args.seed)
            run(tool_argv("chunk_memory", [SIZES["chunk_bases"]]),
                child_env(True),
                stdout_path=os.path.join(w, "mem"))
            with open(os.path.join(w, "mem")) as f:
                say(f.read().strip())
            phase2_index(w, args.seed)
            phase3_setops(w, args.seed, big)
            phase4_fastgt(w, args.seed)
            phase5_katk(w, args.seed)
    except (PhaseError, subprocess.TimeoutExpired) as e:
        sys.stderr.write("chip_smoke: FAILED: %s\n" % e)
        return 1
    finally:
        if not args.work:
            shutil.rmtree(w, ignore_errors=True)
    say("all phases passed in %.1f s" % (time.time() - t0))
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 3 and sys.argv[1] == "--device-child":
        sys.exit(device_child(sys.argv[2], sys.argv[3], sys.argv[4:]))
    sys.exit(main())
