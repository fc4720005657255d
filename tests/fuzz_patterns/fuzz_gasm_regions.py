"""gassembler region-surface fuzz: --region/--pos/--max_regions/--snvs/--fp
on randomized region files vs the reference, byte-compare everything."""
import subprocess, sys, os, random
random.seed(int(sys.argv[1]) if len(sys.argv) > 1 else 0)
FIX = "/tmp/gasm_bench"
if not os.path.exists(os.path.join(FIX, "regions.txt")):
    # regenerate the fixture via the test module's generator
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, os.path.dirname(sys.path[0]))
    import pathlib
    import test_gassembler as tg

    class _F:
        def mktemp(self, n):
            os.makedirs(FIX, exist_ok=True)
            return pathlib.Path(FIX)
    tg.katk_fixture.__wrapped__(_F())
regions = open(os.path.join(FIX, "regions.txt")).read().splitlines()
fails = 0
for trial in range(14):
    mode = random.choice(["file", "file", "region", "pos", "maxreg",
                          "snvfp", "tuning"])
    args = ["--dbi", "db.idx", "--num_threads", "1",
            "--coverage", "40", "--sex", "female"]
    rf = None
    if mode == "file":
        # random subset, shuffled, possibly duplicated lines
        sel = random.sample(regions, random.randint(1, 8))
        if random.random() < 0.3:
            sel += [random.choice(sel)]
        random.shuffle(sel)
        rf = "/tmp/fz_regions_%d.txt" % trial
        open(rf, "w").write("\n".join(sel) + ("\n" if random.random() < 0.8 else ""))
        args += ["--region_file", rf]
    elif mode == "region":
        parts = random.choice(regions).split("\t")
        args += ["--region", parts[0], parts[1], parts[2], parts[3]]
    elif mode == "pos":
        parts = random.choice(regions).split("\t")
        pos = int(parts[1]) + random.randint(0, 100)
        args += ["--region_file", "regions.txt",
                 "--pos", "%s:%d" % (parts[0], pos),
                 "--max_regions", str(random.randint(1, 5))]
    elif mode == "maxreg":
        args += ["--region_file", "regions.txt",
                 "--max_regions", str(random.choice([0, 1, 3, 250]))]
    elif mode == "tuning":
        args += ["--region_file", "regions.txt"]
        for flag, lo, hi in (("--max_read_length", 40, 250),
                             ("--max_reference_length", 100, 400),
                             ("--min_align_len", 3, 60),
                             ("--max_divergent", 1, 12),
                             ("--skip_end_align", 0, 20),
                             ("--skip_end_call", 0, 20),
                             ("--min_coverage", 1, 10),
                             ("--min_confirming", 1, 6),
                             ("--min_group_size", 1, 8),
                             ("--max_group_divergence", 0, 8)):
            if random.random() < 0.4:
                args += [flag, str(random.randint(lo, hi))]
        if random.random() < 0.3:
            args += ["--allow_one_dir"]
        if random.random() < 0.3:
            args += ["--exome"]
        if random.random() < 0.3:
            args += ["--alternatives"]
    else:
        parts = regions[0].split("\t")
        start = int(parts[1])
        rb = parts[3][50]
        alt = "G" if rb != "G" else "T"
        open("/tmp/fz_snv.txt", "w").write(
            "%s:%d:rs1:%s/%s\tAB\n" % (parts[0], start + 51, rb, alt))
        open("/tmp/fz_fp.txt", "w").write("%s:%d\n" % (parts[0], start + 60))
        args += ["--region_file", "regions.txt", "--snvs", "/tmp/fz_snv.txt",
                 "--fp", "/tmp/fz_fp.txt",
                 random.choice(["--output", "--output"]),
                 random.choice(["poly", "best", "all"])]
    try:
        r = subprocess.run(["/root/repo/.ref_build/src/gassembler"] + args,
                           capture_output=True, cwd=FIX, timeout=300)
        o = subprocess.run(["/root/repo/bin/gassembler"] + args,
                           capture_output=True, cwd=FIX, timeout=300)
    except subprocess.TimeoutExpired as e:
        # report and keep sweeping: this VM's IO stalls (identical
        # 384 MB writes measured 0.26-11.5 s) can park
        # a whole process for minutes; a reproducible hang will show
        # up again on the rerun
        print("TIMEOUT (rerun to confirm)", mode, e.cmd)
        fails += 1
        continue
    oerr = b"\n".join(l for l in o.stderr.splitlines() if b"xla_bridge" not in l)
    rerr = b"\n".join(r.stderr.splitlines())
    if r.returncode < 0:
        print("SKIP (ref crash)", mode, trial); continue
    if (r.returncode, r.stdout, rerr) != (o.returncode, o.stdout, oerr):
        fails += 1
        print("MISMATCH", mode, args)
        print("  rc", r.returncode, o.returncode,
              "stdout eq", r.stdout == o.stdout)
        if r.stdout != o.stdout:
            import difflib
            for l in list(difflib.unified_diff(
                    r.stdout.decode().splitlines(),
                    o.stdout.decode().splitlines()))[:8]:
                print("   ", l)
        if rerr != oerr:
            print("  ref err", rerr[:150])
            print("  our err", oerr[:150])
print("seed %s: fails %d" % (sys.argv[1] if len(sys.argv) > 1 else 0, fails))
