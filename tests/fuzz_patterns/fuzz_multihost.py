"""Fuzz the multi-host paths: random process counts x local
device counts x spill budgets x input kinds, byte-compared against the
reference binary (round-5 VERDICT #8 — test_multihost.py covers two
fixed shapes; this draws the rest of the space).

Each trial draws nprocs in {2,3,4}, local devices in {1,2,4}, an input
mix (record sizes, base skew, N runs, multi-file, optional gz), a spill
budget (sometimes tiny, forcing the durable spill-shard path through
the collate role of src/glistmaker.c:788-835), and a tool surface:

* glistmaker  — full multi-process mesh counting, .list bytes
* glistcompare pair/multi — sharded set ops over the global mesh
* gmer_counter — global-mesh DB counting, process-0 stdout

Real jax.distributed groups (Gloo over loopback stands in for the host network),
production CLI entry points via tests/_mh_driver.py.

Run:  python tests/fuzz_patterns/fuzz_multihost.py SEED [N_TRIALS]
"""

from __future__ import annotations

import gzip
import os
import random
import socket
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

DRIVER = os.path.join(REPO, "tests", "_mh_driver.py")
REF = os.path.join(REPO, ".ref_build", "src")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_group(nprocs, local_devices, tool, args, cwd, extra_env=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={local_devices}")
    if extra_env:
        env.update(extra_env)
    coord = f"127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, DRIVER, coord, str(nprocs), str(i), tool]
            + [str(a) for a in args],
            env=env, cwd=cwd,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for i in range(nprocs)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        if rc != 0:
            raise AssertionError(
                f"driver rc={rc}\n{err.decode()[-3000:]}")
    return outs


def random_fasta(rnd, rng, np, n_prob=0.0):
    sym = np.frombuffer(b"ACGT", np.uint8)
    n_rec = rnd.randrange(1, 5)
    recs = []
    for ri in range(n_rec):
        n = rnd.randrange(500, 30_000)
        skew = rnd.random()
        if skew < 0.35:
            p0 = 0.55 + 0.4 * rnd.random()
            rest = (1 - p0) / 3
            seq = sym[rng.choice(4, size=n, p=[p0, rest, rest, rest])]
        else:
            seq = rng.choice(sym, size=n)
        seq = bytearray(seq.tobytes())
        if n_prob and rnd.random() < 0.7:
            for _ in range(int(n * n_prob)):
                seq[rnd.randrange(n)] = ord("N")
        recs.append(b">r%d\n" % ri + bytes(seq))
    return b"\n".join(recs) + b"\n"


def ref_run(args, cwd):
    r = subprocess.run(args, cwd=cwd, capture_output=True)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    return r


def trial(t, rnd, np, tmp):
    nprocs = rnd.choice([2, 3, 4])
    local = rnd.choice([1, 2, 4])
    k = rnd.choice([12, 16, 21, 25])
    rng = np.random.default_rng(rnd.randrange(1 << 30))
    n_files = rnd.randrange(1, 4)
    files = []
    for fi in range(n_files):
        data = random_fasta(rnd, rng, np, n_prob=0.01)
        fn = os.path.join(tmp, f"in{t}_{fi}.fa")
        if rnd.random() < 0.25:
            fn += ".gz"
            with gzip.open(fn, "wb") as f:
                f.write(data)
        else:
            with open(fn, "wb") as f:
                f.write(data)
        files.append(fn)

    surface = rnd.choice(["glistmaker", "pair", "multi", "gmer_counter"])
    extra_env = {}
    if rnd.random() < 0.4:
        # tiny spill budget: force the durable spill-shard path
        extra_env["GT4_SPILL_BYTES"] = str(rnd.choice([1 << 14, 1 << 16]))

    if surface == "glistmaker":
        ref_run([os.path.join(REF, "glistmaker")] + files
                + ["-w", str(k), "-o", os.path.join(tmp, f"ref{t}")], tmp)
        argv = files + ["-w", str(k), "-o", os.path.join(tmp, f"mh{t}")]
        if rnd.random() < 0.3:
            c = rnd.randrange(2, 4)
            argv += ["-c", str(c)]
            ref_run([os.path.join(REF, "glistmaker")] + files
                    + ["-w", str(k), "-c", str(c),
                       "-o", os.path.join(tmp, f"ref{t}")], tmp)
        run_group(nprocs, local, "glistmaker", argv, tmp, extra_env)
        exp = open(os.path.join(tmp, f"ref{t}_{k}.list"), "rb").read()
        got = open(os.path.join(tmp, f"mh{t}_{k}.list"), "rb").read()
        assert got == exp, f"glistmaker bytes differ (t={t})"
        return f"glistmaker np={nprocs} local={local} k={k}"

    # the set-op surfaces need input lists
    lists = []
    for fi, fn in enumerate(files[:2] if surface == "pair" else files):
        ref_run([os.path.join(REF, "glistmaker"), fn, "-w", str(k),
                 "-o", os.path.join(tmp, f"L{t}_{fi}")], tmp)
        lists.append(os.path.join(tmp, f"L{t}_{fi}_{k}.list"))
    while len(lists) < 2:
        lists.append(lists[0])

    if surface == "pair":
        ops = rnd.sample(["-u", "-i", "-d", "-dd"],
                         rnd.randrange(1, 4))
        flags = list(ops)
        if rnd.random() < 0.5:
            flags += ["-c", str(rnd.randrange(1, 4))]
        if ops == ["-i"] and rnd.random() < 0.4:
            # min/subtract/first/second are intersection-only (ref help)
            flags += ["-r", rnd.choice(["min", "max", "first", "second",
                                        "add"])]
        ref_run([os.path.join(REF, "glistcompare")] + lists[:2] + flags
                + ["-o", os.path.join(tmp, f"ref{t}")], tmp)
        run_group(nprocs, local, "glistcompare",
                  lists[:2] + flags + ["-o", os.path.join(tmp, f"mh{t}")],
                  tmp, extra_env)
        sufs = {"-u": ["union"], "-i": ["intrsec"],
                "-d": ["0_diff1"], "-dd": ["0_diff2"]}
        for op in ops:
            for suf in sufs[op]:
                exp = open(os.path.join(tmp, f"ref{t}_{k}_{suf}.list"),
                           "rb").read()
                got = open(os.path.join(tmp, f"mh{t}_{k}_{suf}.list"),
                           "rb").read()
                assert got == exp, f"pair {suf} differs (t={t})"
        return f"pair np={nprocs} local={local} ops={ops}"

    if surface == "multi":
        op = rnd.choice(["-u", "-i"])
        ref_run([os.path.join(REF, "glistcompare")] + lists
                + [op, "-o", os.path.join(tmp, f"ref{t}")], tmp)
        run_group(nprocs, local, "glistcompare",
                  lists + [op, "-o", os.path.join(tmp, f"mh{t}")],
                  tmp, extra_env)
        suf = "union" if op == "-u" else "intrsec"
        exp = open(os.path.join(tmp, f"ref{t}_{k}_{suf}.list"), "rb").read()
        got = open(os.path.join(tmp, f"mh{t}_{k}_{suf}.list"), "rb").read()
        assert got == exp, f"multi {suf} differs (t={t})"
        return f"multi np={nprocs} local={local} op={op}"

    # gmer_counter: build a small DB from the input's own k-mers
    fa_plain = None
    for fn in files:
        if not fn.endswith(".gz"):
            fa_plain = fn
            break
    if fa_plain is None:
        with gzip.open(files[0], "rb") as f:
            data = f.read()
        fa_plain = files[0][:-3]
        with open(fa_plain, "wb") as f:
            f.write(data)
    seqs = [ln for ln in open(fa_plain, "rb").read().splitlines()
            if ln and not ln.startswith(b">")]
    blob = b"".join(seqs)
    w = rnd.choice([14, 16])
    dblines = []
    seen = set()
    for i in range(40):
        s = rnd.randrange(0, max(1, len(blob) - w))
        km = blob[s:s + w]
        if b"N" in km or km in seen or len(km) < w:
            continue
        seen.add(km)
        dblines.append(b"S%d\t1\t%s" % (len(dblines), km))
    if len(dblines) < 2:
        return "gmer_counter skipped (no clean kmers)"
    db = os.path.join(tmp, f"db{t}.txt")
    open(db, "wb").write(b"\n".join(dblines) + b"\n")
    ref = ref_run([os.path.join(REF, "gmer_counter"), "-db", db,
                   fa_plain], tmp)
    outs = run_group(nprocs, local, "gmer_counter",
                     ["-db", db, fa_plain], tmp, extra_env)

    def degloo(b):
        # Gloo loopback-transport banners are the harness's, not the
        # tool's (same filter as test_multihost.py)
        return b"".join(ln for ln in b.splitlines(keepends=True)
                        if not ln.startswith(b"[Gloo]"))

    assert degloo(outs[0][1]) == ref.stdout, \
        f"gmer_counter stdout differs (t={t})"
    for rc, out, err in outs[1:]:
        assert degloo(out) == b"", "non-zero process wrote stdout"
    return f"gmer_counter np={nprocs} local={local} w={w}"


def main():
    seed = int(sys.argv[1]) if len(sys.argv) > 1 else 0
    n_trials = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    if not os.path.exists(os.path.join(REF, "glistmaker")):
        print("reference not built — cannot fuzz", file=sys.stderr)
        return 1
    import numpy as np
    rnd = random.Random(seed)
    fails = 0
    with tempfile.TemporaryDirectory() as tmp:
        for t in range(n_trials):
            try:
                desc = trial(t, rnd, np, tmp)
                print(f"[{t}] ok {desc}", flush=True)
            except AssertionError as e:
                fails += 1
                print(f"[{t}] FAIL {e}", flush=True)
    print(f"done: {n_trials} trials, {fails} failures (seed {seed})")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
