#!/usr/bin/env python
"""End-to-end short-read mapping benchmark on one accelerator.

Workload: synthetic 2 Mbp genome + 600k x 150 bp Illumina-like reads (0.5%
subs), mapped with the reference's published sr benchmark preset
(its README.md:41: -x sr -Z 10 -W 2 -k 21 -w 11 -i 2 -N 1
-r 0.05,150,200 -n 0.95,0.3 -s 100 --AF_max_loc 2).

Baseline: the reference GDiet binary (built from the reference source into
a scratch directory) mapping the same reads single-threaded from a prebuilt
index. Both sides are timed on mapping only (index prebuilt), including SAM
formatting. The timed region is >= 5 s per repetition on both sides, each
side runs N_REPS repetitions after a discarded warmup, and the stats record
median/min/max plus the host's core count, CPU model and load average, and
the device's platform and kind, so a swing is attributable from the
artifact alone. Defining the device DP metric is left to the benchmark
that replaces this script.

Prints one JSON line: {"metric", "value", "unit", "vs_baseline"}
with vs_baseline = ours_median / GDiet_avx_median. Any failed phase fails
the run.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

BENCH_DIR = pathlib.Path("/tmp/gdiet_bench")
REF_SRC = "/root/reference/GDiet-ShortReads"
REF_BUILD = pathlib.Path("/tmp/gdiet_ref/SR")

GENOME_LEN = 2_000_000
N_READS = 600_000  # >=5 s timed region on both sides
N_REPS = 5  # timed repetitions per side (after a discarded warmup)
READ_LEN = 150
SUB_RATE = 0.005
SEED = 20260816

REF_ARGS = [
    "-a", "-t", "1", "-x", "sr", "-Z", "10", "-W", "2", "-k", "21", "-w", "11",
    "-i", "2", "-N", "1", "-r", "0.05,150,200", "-n", "0.95,0.3", "-s", "100",
    "--AF_max_loc", "2",
]


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def gen_data():
    BENCH_DIR.mkdir(parents=True, exist_ok=True)
    fa = BENCH_DIR / "ref.fa"
    fq = BENCH_DIR / f"reads_{N_READS // 1000}k.fq"
    if fa.exists() and fq.exists():
        return fa, fq
    rng = np.random.default_rng(SEED)
    bases = np.frombuffer(b"ACGT", np.uint8)
    genome = rng.integers(0, 4, GENOME_LEN, dtype=np.int64)
    with open(fa, "w") as f:
        f.write(">chr1\n")
        seq = bases[genome].tobytes().decode()
        for i in range(0, GENOME_LEN, 80):
            f.write(seq[i : i + 80] + "\n")
    # vectorized read synthesis (300k reads: the per-read loop took minutes)
    st = rng.integers(0, GENOME_LEN - READ_LEN, N_READS)
    R = genome[st[:, None] + np.arange(READ_LEN)]
    sub = rng.random((N_READS, READ_LEN)) < SUB_RATE
    R = np.where(sub, (R + rng.integers(1, 4, R.shape)) % 4, R)
    rev = rng.random(N_READS) < 0.5
    R[rev] = 3 - R[rev, ::-1]
    qual = "I" * READ_LEN
    with open(fq, "w") as f:
        seqs = bases[R]
        for n in range(N_READS):
            f.write(f"@r{n}\n{seqs[n].tobytes().decode()}\n+\n{qual}\n")
    log(f"generated {fa} and {fq}")
    return fa, fq


def build_reference_binary(target: str = "GDiet") -> pathlib.Path | None:
    """Build a reference binary (`GDiet` scalar or `GDiet_avx` AVX-512)."""
    exe = REF_BUILD / target
    if exe.exists():
        return exe
    try:
        REF_BUILD.parent.mkdir(parents=True, exist_ok=True)
        if not REF_BUILD.exists():
            subprocess.run(["cp", "-r", REF_SRC, str(REF_BUILD)], check=True)
        subprocess.run(
            ["make", target], cwd=REF_BUILD, check=True,
            capture_output=True, timeout=600,
        )
        return exe if exe.exists() else None
    except Exception as e:  # baseline is best-effort; bench still reports
        log(f"reference build failed: {e}")
        return None


def _disp(times: list[float]) -> dict:
    """median/min/max reads-per-sec dispersion from repetition walls."""
    med = sorted(times)[len(times) // 2]
    return {
        "median": round(N_READS / med, 1),
        "min": round(N_READS / max(times), 1),
        "max": round(N_READS / min(times), 1),
        "rep_seconds": [round(t, 3) for t in times],
    }


def baseline_reads_per_sec(fa: pathlib.Path, fq: pathlib.Path) -> dict:
    """Time BOTH reference binaries: 1 discarded cold warmup + N_REPS warm
    repetitions each, recording median/min/max (a single best-of-3 on a
    0.5 s region is not reproducible). The target named by
    BASELINE.md is `GDiet_avx` single-socket at -t 1; a -t <nproc> anchor
    row is recorded alongside so the gap to a whole socket stays visible.
    """
    out: dict = {}
    idx = BENCH_DIR / "ref.gdi.mmi"
    nproc = os.cpu_count() or 1
    runs = [("GDiet", "ref_scalar", "1"), ("GDiet_avx", "ref_avx", "1")]
    if nproc > 1:
        runs.append(("GDiet_avx", "ref_avx_mt", str(nproc)))
    else:  # -t nproc == -t 1 here; record the alias so the row exists
        out["ref_avx_mt_nproc"] = 1
    for target, key, threads in runs:
        exe = build_reference_binary(target)
        if exe is None:
            continue
        if not idx.exists():
            subprocess.run(
                [str(exe), *REF_ARGS, "-d", str(idx), str(fa)],
                check=True, capture_output=True, timeout=600,
            )
        args = list(REF_ARGS)
        args[args.index("-t") + 1] = threads
        # the -t 1 avx run owns ref_out.sam (the parity golden)
        sam = "ref_out.sam" if key == "ref_avx" else f"{key}_out.sam"
        times = []
        for it in range(N_REPS + 1):  # iteration 0 = cold warmup, discarded
            t0 = time.perf_counter()
            subprocess.run(
                [str(exe), *args, "-o", str(BENCH_DIR / sam),
                 str(idx), str(fq)],
                check=True, capture_output=True, timeout=1800,
            )
            dt = time.perf_counter() - t0
            if it > 0:
                times.append(dt)
        d = _disp(times)
        out[f"{key}_reads_per_sec"] = d["median"]
        out[f"{key}_dispersion"] = d
        if key == "ref_avx_mt":
            out["ref_avx_mt_nproc"] = nproc
        log(f"reference {target} -t {threads}: median {d['median']:.0f} "
            f"reads/s over {N_REPS} reps (min {d['min']}, max {d['max']})")
    return out


def our_reads_per_sec(fa: pathlib.Path, fq: pathlib.Path) -> tuple[float, dict]:
    import gdiet_tpu  # noqa: F401
    import jax

    from gdiet_tpu.config import MM_F_NO_PRINT_2ND, options_for
    from gdiet_tpu.index.build import DietIndex, build_index
    from gdiet_tpu.io import sam as samio
    from gdiet_tpu.io.fastx import read_fastx
    from gdiet_tpu.pipeline import ShortReadMapper

    io_, mo = options_for(
        "sr", pattern="10", max_seeds=2.0, best_n=1, bw_frac=0.05,
        bw_min=150, bw_max=200, min_cnt=0.95, rec_threshold_frac=0.3,
        min_dp_max=100, AF_max_loc=2,
    )
    idx_path = BENCH_DIR / "ours.gdi.npz"
    if idx_path.exists():
        mi = DietIndex.load(str(idx_path))
    else:
        t0 = time.perf_counter()
        refs = [(r.name, r.seq) for r in read_fastx(str(fa))]
        mi = build_index(refs, io_)
        log(f"index build: {time.perf_counter() - t0:.1f}s")
        mi.save(str(idx_path))

    reads = list(read_fastx(str(fq)))
    # tuning knobs for profile-driven sweeps (eval/profile_sr.py companion);
    # defaults are the recorded bench configuration
    B = int(os.environ.get("GDIET_BENCH_B", 10016))
    Lmax = 160
    mapper = ShortReadMapper(
        mi, mo, max_read_len=Lmax,
        seed_budget=int(os.environ.get("GDIET_BENCH_S", 32)),
        shift_seed_budget=16,
        hit_budget=int(os.environ.get("GDIET_BENCH_A", 64)),
        dp_frac=float(os.environ.get("GDIET_BENCH_DPFRAC", 0.3125)),
    )

    batches = []
    for s in range(0, len(reads), B):
        batch = reads[s : s + B]
        if len(batch) < B:  # pad tail to the compiled batch shape
            batches.append((batch + [batch[0]] * (B - len(batch)), len(batch)))
        else:
            batches.append(batch)

    # warmup / compile (full first pass: every shape + steady-state caches)
    t0 = time.perf_counter()
    for _ in mapper.map_stream_sam(iter(batches[:2])):
        pass
    log(f"compile+warmup: {time.perf_counter() - t0:.1f}s")

    from gdiet_tpu.utils.profile import PROFILE

    times = []
    body = b""
    for rep in range(N_REPS):
        blobs = []
        PROFILE.reset()
        t0 = time.perf_counter()
        for blob in mapper.map_stream_sam(iter(batches)):
            blobs.append(blob)
        times.append(time.perf_counter() - t0)
        body = b"".join(blobs)
        log(f"rep {rep}: {times[-1]:.2f}s -> {len(reads) / times[-1]:.0f} reads/s")
    for ln in PROFILE.report().splitlines():
        log(ln)
    with open(BENCH_DIR / "ours_out.sam", "wb") as f:
        f.write(samio.sam_header(mi.names, [int(x) for x in mi.lengths]).encode())
        f.write(body)
    d = _disp(times)
    rps = d["median"]
    stats = {
        "seconds": sorted(times)[len(times) // 2],
        "ours_dispersion": d,
        "n_reads": len(reads),
        "n_records": body.count(b"\n"),
        "fallback_reads": mapper.stats["fallback_reads"],
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
    }
    log(f"gdiet_tpu: median {rps:.0f} reads/s over {N_REPS} reps "
        f"(min {d['min']}, max {d['max']}) on {stats['platform']}")
    return rps, stats


LR_REF_ARGS = [
    "-a", "-t", "1", "-x", "map-hifi", "-Z", "10", "-W", "2", "-k", "19",
    "-w", "19", "-i", "0.2", "-r", "500", "--vt_dis=650", "--vt_nb_loc=5",
    "--vt_df1=0.0106", "--vt_df2=0.2", "-s", "200", "--vt_cov", "0.04",
    "--vt_f=0.04",
]


def gen_lr_reads(fa: pathlib.Path) -> pathlib.Path:
    fq = BENCH_DIR / "reads_lr.fq"
    if fq.exists():
        return fq
    rng = np.random.default_rng(SEED + 1)
    bases = np.frombuffer(b"ACGT", np.uint8)
    genome = None
    seq = "".join(
        l.strip() for l in open(fa) if not l.startswith(">")
    )
    genome = np.frombuffer(seq.encode(), np.uint8)
    lut = np.zeros(256, np.int64)
    for i, c in enumerate(b"ACGT"):
        lut[c] = i
    g = lut[genome]
    with open(fq, "w") as f:
        for n in range(1000):
            L = int(rng.integers(1500, 4000))
            st = int(rng.integers(0, len(g) - L))
            r = g[st : st + L].copy()
            nsub = rng.binomial(L, 0.01)
            for _ in range(nsub):
                p = int(rng.integers(0, L))
                r[p] = (r[p] + int(rng.integers(1, 4))) % 4
            if rng.random() < 0.5:
                r = 3 - r[::-1]
            f.write(f"@h{n}\n{bases[r].tobytes().decode()}\n+\n{'I' * len(r)}\n")
    return fq


def lr_stats(fa: pathlib.Path) -> dict:
    """Long-read throughput vs the reference LongReads binary (stderr stat)."""
    import jax.numpy as jnp

    from gdiet_tpu.config import MM_F_NO_PRINT_2ND, options_for
    from gdiet_tpu.index.build import build_index
    from gdiet_tpu.io import sam as samio
    from gdiet_tpu.io.fastx import read_fastx
    from gdiet_tpu.pipeline.longread import LongReadMapper

    out: dict = {}
    fq = gen_lr_reads(fa)
    lr_bin = pathlib.Path("/tmp/gdiet_ref/LR/GDiet")
    if not lr_bin.exists():
        try:
            subprocess.run(["cp", "-r", "/root/reference/GDiet-LongReads",
                            "/tmp/gdiet_ref/LR"], check=True)
            subprocess.run(["make", "GDiet"], cwd="/tmp/gdiet_ref/LR",
                           check=True, capture_output=True, timeout=600)
        except Exception:
            pass
    if lr_bin.exists():
        t0 = time.perf_counter()
        subprocess.run(
            [str(lr_bin), *LR_REF_ARGS, "-o", str(BENCH_DIR / "lr_ref.sam"),
             str(fa), str(fq)],
            check=True, capture_output=True, timeout=1800,
        )
        out["lr_ref_reads_per_sec"] = round(1000 / (time.perf_counter() - t0), 1)

    io_, mo = options_for(
        "map-hifi", variant="lr", pattern="10", k=19, w=19, max_seeds=0.2,
        bw=500, vt_dis=650, vt_nb_loc=5, vt_df1=0.0106, vt_df2=0.2,
        min_dp_max=200, vt_cov=0.04, vt_f=0.04,
    )
    refs = [(r.name, r.seq) for r in read_fastx(str(fa))]
    mi = build_index(refs, io_)
    mapper = LongReadMapper(mi, mo, max_read_len=4096, seed_budget=512,
                            shift_seed_budget=128, hit_budget=2048,
                            vote_budget=512)
    reads = list(read_fastx(str(fq)))
    B = 256

    def batches():
        for s in range(0, len(reads), B):
            batch = reads[s : s + B]
            yield len(batch), (
                batch + [batch[0]] * (B - len(batch)) if len(batch) < B
                else batch
            )

    for _, b in batches():  # compile every batch shape
        for _ in mapper.map_stream(iter([b])):
            pass
    t0 = time.perf_counter()
    n_done = 0  # count only real (non-padding) reads
    all_lines = []
    gen = mapper.map_stream(b for _, b in batches())
    for (n_real, b), res in zip(batches(), gen):
        n_done += n_real
        for rec, regs in zip(b[:n_real], res[:n_real]):
            all_lines.extend(mapper.regs_to_sam_lines(rec, regs))
    out["lr_reads_per_sec"] = round(n_done / (time.perf_counter() - t0), 1)
    ref_sam = BENCH_DIR / "lr_ref.sam"
    if ref_sam.exists():
        ref_lines = [l for l in ref_sam.read_text().splitlines()
                     if not l.startswith("@")]
        if len(ref_lines) != len(all_lines):  # count mismatch counts against
            log(f"lr parity: record count differs "
                f"({len(ref_lines)} ref vs {len(all_lines)} ours)")
        same = sum(a == b_ for a, b_ in zip(all_lines, ref_lines))
        out["lr_sam_parity"] = round(
            same / max(len(ref_lines), len(all_lines), 1), 4)
    return out


ONT_REF_ARGS = [
    "-a", "-t", "1", "-x", "map-ont", "-Z", "10", "-W", "2", "-i", "0.2",
    "-k", "15", "-w", "10", "-N", "1", "-r", "1300", "--vt_dis=1000",
    "--vt_nb_loc=3", "--vt_df1=0.007", "--vt_df2=0.007",
    "--max_min_gap=4000", "--vt_f=0.04", "-s", "35000", "--vt_cov", "0.3",
    "--sort=merge", "--frag=no", "-F200,1",
]


def gen_ont_reads(fa: pathlib.Path) -> pathlib.Path:
    """30 kb ONT-like reads (the recipe's UltraLongReadSplitter output
    shape, Read-mapping-real-data-ONT.sh:16-18): 3% subs + 1% ins + 1% del."""
    fq = BENCH_DIR / "reads_ont.fq"
    if fq.exists():
        return fq
    rng = np.random.default_rng(SEED + 2)
    bases = np.frombuffer(b"ACGT", np.uint8)
    seq = "".join(l.strip() for l in open(fa) if not l.startswith(">"))
    lut = np.zeros(256, np.int64)
    for i, c in enumerate(b"ACGT"):
        lut[c] = i
    g = lut[np.frombuffer(seq.encode(), np.uint8)]
    L = 30_000
    with open(fq, "w") as f:
        for n in range(100):
            st = int(rng.integers(0, len(g) - L))
            src = g[st : st + L]
            out = []
            for b in src:
                r = rng.random()
                if r < 0.01:      # deletion
                    continue
                if r < 0.02:      # insertion
                    out.append(int(rng.integers(0, 4)))
                if r < 0.05:      # substitution
                    b = (b + int(rng.integers(1, 4))) % 4
                out.append(int(b))
            arr = np.array(out, np.int64)
            if rng.random() < 0.5:
                arr = 3 - arr[::-1]
            s_ = bases[arr].tobytes().decode()
            f.write(f"@o{n}\n{s_}\n+\n{'I' * len(s_)}\n")
    return fq


def ont_stats(fa: pathlib.Path) -> dict:
    """Ultralong ONT throughput + fallback check (30 kb reads through the
    DEVICE long-read path — no Python-oracle cliff)."""
    from gdiet_tpu.config import options_for
    from gdiet_tpu.index.build import build_index
    from gdiet_tpu.io.fastx import read_fastx
    from gdiet_tpu.pipeline.longread import LongReadMapper

    out: dict = {}
    fq = gen_ont_reads(fa)
    lr_bin = pathlib.Path("/tmp/gdiet_ref/LR/GDiet")
    if lr_bin.exists():
        t0 = time.perf_counter()
        subprocess.run(
            [str(lr_bin), *ONT_REF_ARGS, "-o", str(BENCH_DIR / "ont_ref.sam"),
             str(fa), str(fq)],
            check=True, capture_output=True, timeout=3600,
        )
        out["ont_ref_reads_per_sec"] = round(
            100 / (time.perf_counter() - t0), 2)

    io_, mo = options_for(
        "map-ont", variant="lr", pattern="10", k=15, w=10, max_seeds=0.2,
        bw=1300, vt_dis=1000, vt_nb_loc=3, vt_df1=0.007, vt_df2=0.007,
        max_min_gap=4000, vt_f=0.04, min_dp_max=35000, vt_cov=0.3,
        best_n=1,
    )
    refs = [(r.name, r.seq) for r in read_fastx(str(fa))]
    mi = build_index(refs, io_)
    mapper = LongReadMapper(mi, mo, max_read_len=32768, seed_budget=4096,
                            shift_seed_budget=1024, hit_budget=8192,
                            vote_budget=4096)
    reads = list(read_fastx(str(fq)))
    B = 16

    def batches():
        for s0 in range(0, len(reads), B):
            b = reads[s0 : s0 + B]
            yield len(b), (b + [b[0]] * (B - len(b)) if len(b) < B else b)

    for _, b in batches():  # compile every batch shape
        for res in mapper.map_stream(iter([b])):
            pass
    mapper.stats = dict.fromkeys(mapper.stats, 0)
    t0 = time.perf_counter()
    n_done = 0
    n_fb = 0
    all_lines = []
    for (n_real, b), res in zip(batches(),
                                mapper.map_stream(b for _, b in batches())):
        n_done += n_real
        n_fb += int(mapper.last_host_only[:n_real].sum())
        for rec, regs in zip(b[:n_real], res[:n_real]):
            all_lines.extend(mapper.regs_to_sam_lines(rec, regs))
    out["ont_reads_per_sec"] = round(n_done / (time.perf_counter() - t0), 2)
    out["ont_oracle_fallbacks"] = n_fb  # measured per batch (real reads only)
    ref_sam = BENCH_DIR / "ont_ref.sam"
    if ref_sam.exists():
        ref_lines = [l for l in ref_sam.read_text().splitlines()
                     if not l.startswith("@")]
        if len(ref_lines) != len(all_lines):
            log(f"ont parity: record count differs "
                f"({len(ref_lines)} ref vs {len(all_lines)} ours)")
        same = sum(a == b_ for a, b_ in zip(all_lines, ref_lines))
        out["ont_sam_parity"] = round(
            same / max(len(ref_lines), len(all_lines), 1), 4)
    return out


def check_parity() -> float | None:
    """Fraction of identical SAM body lines between ours and the reference."""
    ref_sam = BENCH_DIR / "ref_out.sam"
    our_sam = BENCH_DIR / "ours_out.sam"
    if not (ref_sam.exists() and our_sam.exists()):
        return None
    ref_lines = [l for l in ref_sam.read_text().splitlines() if not l.startswith("@")]
    our_lines = [l for l in our_sam.read_text().splitlines() if not l.startswith("@")]
    if len(ref_lines) != len(our_lines):
        log(f"parity: record count differs ({len(ref_lines)} vs {len(our_lines)})")
        return 0.0
    same = sum(a == b for a, b in zip(ref_lines, our_lines))
    frac = same / max(len(ref_lines), 1)
    log(f"parity: {same}/{len(ref_lines)} identical SAM records ({frac:.4f})")
    return frac


def gen_pe_reads(fa: pathlib.Path) -> tuple[pathlib.Path, pathlib.Path]:
    """FR paired-end reads from the bench genome (insert 250-450, 0.5%
    subs) — the steady-state PE throughput workload."""
    f1 = BENCH_DIR / "reads_pe_1.fq"
    f2 = BENCH_DIR / "reads_pe_2.fq"
    if f1.exists() and f2.exists():
        return f1, f2
    rng = np.random.default_rng(SEED + 3)
    bases = np.frombuffer(b"ACGT", np.uint8)
    seq = "".join(l.strip() for l in open(fa) if not l.startswith(">"))
    lut = np.zeros(256, np.int64)
    for i, c in enumerate(b"ACGT"):
        lut[c] = i
    g = lut[np.frombuffer(seq.encode(), np.uint8)]
    L = READ_LEN
    n_pairs = 10_000  # PE steady-state workload (decoupled from N_READS)
    with open(f1, "w") as o1, open(f2, "w") as o2:
        for n in range(n_pairs):
            ins = int(rng.integers(250, 450))
            st = int(rng.integers(0, len(g) - ins))
            r1 = g[st : st + L].copy()
            r2 = (3 - g[st + ins - L : st + ins][::-1]).copy()
            for r in (r1, r2):
                for _ in range(rng.binomial(L, SUB_RATE)):
                    p = int(rng.integers(0, L))
                    r[p] = (r[p] + int(rng.integers(1, 4))) % 4
            o1.write(f"@p{n}/1\n{bases[r1].tobytes().decode()}\n+\n{'I' * L}\n")
            o2.write(f"@p{n}/2\n{bases[r2].tobytes().decode()}\n+\n{'I' * L}\n")
    return f1, f2


def pe_stats(fa: pathlib.Path) -> dict:
    """Paired-end rows: (a) STEADY-STATE pairs/s on the bench genome —
    mapping-only after a warmup batch, through the native PE fast path
    (map_stream_sam_pe -> pe_finish_batch: mm_pair pe.c:76-177 + the
    n_seg=2 writer format.c:432-530); (b) R1 alignment-column parity of
    the PE fixture vs the single-end reference golden (the PE semantics
    contract — see tests/test_pe_parity.py for why full byte parity is
    masked)."""
    from gdiet_tpu.config import options_for
    from gdiet_tpu.index.build import DietIndex
    from gdiet_tpu.io.fastx import read_fastx
    from gdiet_tpu.pipeline.shortread import ShortReadMapper

    out: dict = {}
    # --- (a) steady-state throughput ---
    f1, f2 = gen_pe_reads(fa)
    _, mo = options_for(
        "sr", pattern="10", max_seeds=2.0, best_n=1, bw_frac=0.05,
        bw_min=150, bw_max=200, min_cnt=0.95, rec_threshold_frac=0.3,
        min_dp_max=100, AF_max_loc=2,
    )
    mi = DietIndex.load(str(BENCH_DIR / "ours.gdi.npz"))
    mapper = ShortReadMapper(
        mi, mo, max_read_len=160,
        seed_budget=int(os.environ.get("GDIET_BENCH_S", 32)),
        shift_seed_budget=16,
        hit_budget=int(os.environ.get("GDIET_BENCH_A", 64)),
        dp_frac=float(os.environ.get("GDIET_BENCH_DPFRAC", 0.3125)),
    )
    pairs = list(zip(read_fastx(str(f1)), read_fastx(str(f2))))
    P = 4096
    # warmup / compile on the first batch shape
    for _ in mapper.map_stream_sam_pe(iter([pairs[:P]])):
        pass

    def batches():
        for s in range(0, len(pairs), P):
            b = pairs[s : s + P]
            yield (b + [b[0]] * (P - len(b)), len(b)) if len(b) < P else b

    blobs = []
    t0 = time.perf_counter()
    for blob in mapper.map_stream_sam_pe(batches()):
        blobs.append(blob)
    dt = time.perf_counter() - t0
    out["pe_pairs_per_sec"] = round(len(pairs) / dt, 1)
    out["pe_fallback_pairs"] = mapper.stats["fallback_reads"]
    n_rec = sum(bytes(b).count(b"\n") for b in blobs)
    log(f"pe steady-state: {dt:.2f}s -> {out['pe_pairs_per_sec']} pairs/s "
        f"({n_rec} records, {out['pe_fallback_pairs']} fallback pairs)")

    # --- (b) fixture parity (R1 columns vs single-end reference golden) ---
    from gdiet_tpu.cli import main as cli_main

    data = pathlib.Path(__file__).parent / "tests" / "data"
    if not (data / "golden_pe_r1.sam").exists():
        return out
    sam = BENCH_DIR / "ours_pe.sam"
    rc = cli_main([
        "-a", "-t", "1", "-x", "sr", "-Z", "10", "-W", "2", "-k", "21",
        "-w", "11", "-i", "2", "-N", "1", "-r", "0.05,150,200",
        "-n", "0.95,0.3", "-s", "100", "--AF_max_loc", "2",
        "-o", str(sam), str(data / "ref_pe.fa"),
        str(data / "reads_pe_1.fq"), str(data / "reads_pe_2.fq"),
    ])
    if rc != 0:
        return out
    ours = {}
    for line in sam.read_text().splitlines():
        if line.startswith("@"):
            continue
        f = line.split("\t")
        fl = int(f[1])
        if (fl & 0x40) and not (fl & 0x900):
            ours[f[0]] = f
    golden = {}
    for line in (data / "golden_pe_r1.sam").read_text().splitlines():
        if line.startswith("@"):
            continue
        f = line.split("\t")
        nm = f[0]
        if len(nm) > 2 and nm[-2] == "/" and nm[-1].isdigit():
            nm = nm[:-2]
        if nm not in golden:
            golden[nm] = f
    same = total = 0
    for nm, gp in golden.items():
        if gp[2] == "*":
            continue
        total += 1
        mp = ours.get(nm)
        if mp and mp[2:4] == gp[2:4] and mp[5] == gp[5]:
            same += 1
    out["pe_r1_parity"] = round(same / max(total, 1), 4)
    return out


def env_info() -> dict:
    """Host identity for swing attribution: two hosts can differ by orders
    of magnitude in cores."""
    info: dict = {"cpu_count": os.cpu_count()}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    info["cpu_model"] = line.split(":", 1)[1].strip()
                    break
    except Exception:
        pass
    try:
        info["loadavg_start"] = round(os.getloadavg()[0], 2)
    except Exception:
        pass
    return info


def main():
    # GDIET_BENCH_SR_ONLY=1: time only the SR mapping path (skip reference
    # re-timing and aux workloads) — for config sweeps after a full run
    sr_only = bool(os.environ.get("GDIET_BENCH_SR_ONLY"))
    fa, fq = gen_data()
    base_stats = {} if sr_only else baseline_reads_per_sec(fa, fq)
    # vs_baseline target = GDiet_avx (BASELINE.md); scalar as fallback anchor
    base = base_stats.get("ref_avx_reads_per_sec") or \
        base_stats.get("ref_scalar_reads_per_sec")
    ours, stats = our_reads_per_sec(fa, fq)
    stats.update(base_stats)
    stats.update(env_info())
    parity = check_parity()
    result = {
        "metric": "sr_reads_per_sec_1chip",
        "value": round(ours, 1),
        "unit": "reads/s",
        "vs_baseline": round(ours / base, 3) if base else None,
    }
    if parity is not None:
        stats["sam_parity"] = round(parity, 4)
    if not sr_only:
        stats.update(lr_stats(fa))
        stats.update(ont_stats(fa))
        stats.update(pe_stats(fa))
    else:
        stats["sr_only_sweep"] = True
    log(f"stats: {json.dumps(stats)}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
