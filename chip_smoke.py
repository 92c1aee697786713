#!/usr/bin/env python
"""Smoke test: both mapping pipelines end to end on NVIDIA GPUs.

Run from the root of a checkout, on a machine with a GPU:

    python chip_smoke.py                # one card, phases 0-4
    python chip_smoke.py --four-cards   # (data, ref) meshes on four cards

One process drives every phase and stops at the first failure (non-zero
exit, no result line):

  0 device   the platform must be "gpu"; device kind and count, JAX version,
             compile-cache directory, and the card's name and power limit
             from nvidia-smi (a child process that does not import JAX)
  1 compile  builds the scale genome's index (build_index, as -d does), then
             compiles the fused short-read step at the bench shape, the
             paired-end step, both long-read fronts and every long-read DP
             bucket: compile seconds and memory_analysis() for each
  2 kernels  the CUDA DP kernel against ops/dp.py::extd2_batch at the
             short-read shape and at every long-read bucket the HiFi and ONT
             reads reach, with their bandwidths (scores, direction bytes,
             backtracked op streams and fin_i/fin_j), and the hit-expansion
             row selection against numpy with values up to 2^48 — all
             integer, tolerance zero
  3 golden   the tests/data byte-parity fixtures through the CLI
             (gdiet_tpu.cli.main, in process), compared as the tests do
  4 scale    short, paired-end, HiFi and 30 kb ONT reads made from --seed on
             the scale genome (1.5 Gbp) through ShortReadMapper /
             LongReadMapper, a sample of each compared byte for byte with
             the scalar oracle (long reads: only reads the device mapped);
             reads/s (smoke timings), fallback reads, host-DP segments, peak
             device memory

--four-cards runs only the sharded path (SR and LR on meshes 2x2 and 4x1)
and its comparison, the same reads mapped on one card, byte for byte.

The last stdout line is {"ok": true, "device": {"platform": "gpu",
"kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
DATA = REPO / "tests" / "data"
WORK = REPO / ".build" / "chip_smoke"
SEED = 20261016  # genome, reads and DP inputs

# the reference's published Illumina preset (its README.md:41)
SR_ARGS = ["-a", "-t", "1", "-x", "sr", "-Z", "10", "-W", "2", "-k", "21",
           "-w", "11", "-i", "2", "-N", "1", "-r", "0.05,150,200",
           "-n", "0.95,0.3", "-s", "100", "--AF_max_loc", "2"]
# the fixture generators' long-read commands (tests/data/make_lr_fixtures.py)
HIFI_FIXTURE_ARGS = [
    "-a", "-t", "1", "-x", "map-hifi", "-Z", "10", "-W", "2", "-k", "19",
    "-w", "19", "-i", "0.2", "-r", "200", "--vt_dis=650", "--vt_nb_loc=5",
    "--vt_df1=0.0106", "--vt_df2=0.2", "-s", "100", "--vt_cov", "0.04",
    "--vt_f=0.04"]
ONT_FIXTURE_ARGS = [
    "-a", "-t", "1", "-x", "map-ont", "-Z", "10", "-W", "2", "-k", "15",
    "-w", "10", "-r", "300", "--vt_dis=1000", "--vt_nb_loc=3",
    "--vt_df1=0.007", "--vt_df2=0.007", "-s", "100", "--vt_cov", "0.1"]


@dataclasses.dataclass
class Sizes:
    """Workload sizes; the defaults are the deployment-scale run."""

    # cut from GRCh38's 3.1 Gbp: with an empty compile cache the whole
    # script took 1166.6 s of its 1200 s at 3.1 Gbp on an H100
    genome_mbp: int = 1500
    sr_batch: int = 10016  # bench.py's batch shape
    sr_batches: int = 4
    pe_pairs: int = 4096  # the CLI's paired-end batch
    pe_batches: int = 2
    hifi_reads: int = 128
    hifi_len: tuple = (5000, 15000)
    ont_reads: int = 16
    ont_len: int = 30000
    sr_oracle: int = 500
    hifi_oracle: int = 50
    ont_oracle: int = 10
    dp_rows: int = 0  # 0: dp_rows(2 * sr_batch, 0.3125), the SR DP shape
    lr_dp_rows: int = 32
    hifi_lmax: int = 16384
    hifi_batch: int = 64
    ont_lmax: int = 32768
    ont_batch: int = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# --------------------------------------------------------------- phase 0
def phase_device(need: int = 1) -> dict:
    import jax

    import gdiet_tpu

    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX platform {d.platform!r})")
    if len(devs) < need:
        raise SystemExit(f"chip_smoke: {need} GPUs needed, {len(devs)} found")
    info = {"platform": d.platform, "kind": d.device_kind, "count": len(devs)}
    log(f"[device] {info} jax {jax.__version__} "
        f"cache {gdiet_tpu.compile_cache_dir()}")
    log(f"[device] nvidia-smi: {card_line()}")
    return info


# --------------------------------------------------------------- genome
def synth_genome(mbp: int, seed: int):
    """Repeat-rich genome (eval/scale_rehearsal.py::synth_genome) as
    (name, codes) chromosomes of at most 249 Mbp (the length of chr1)."""
    sys.path.insert(0, str(REPO / "eval"))
    from scale_rehearsal import synth_genome as synth

    codes, _ = synth(mbp * 1_000_000, seed=seed)
    step = 249_000_000
    return [(f"chr{i + 1}", codes[st:st + step])
            for i, st in enumerate(range(0, len(codes), step))]


def build_scale_index(sizes: Sizes, seed: int):
    from gdiet_tpu.config import options_for
    from gdiet_tpu.index.build import build_index

    t0 = time.perf_counter()
    chroms = synth_genome(sizes.genome_mbp, seed)
    t1 = time.perf_counter()
    io_, _ = options_for("sr", pattern="10")
    io_.k, io_.w = 21, 11
    mi = build_index(chroms, io_)
    t2 = time.perf_counter()
    log(f"[index] {sizes.genome_mbp} Mbp in {len(chroms)} chromosomes: "
        f"synthesis {t1 - t0:.1f} s, build_index {t2 - t1:.1f} s, "
        f"{len(mi.keys)} keys, {len(mi.positions)} positions")
    return mi, chroms, t2 - t1


# --------------------------------------------------------------- mappers
def sr_options():
    from gdiet_tpu.config import options_for

    return options_for(
        "sr", pattern="10", max_seeds=2.0, best_n=1, bw_frac=0.05,
        bw_min=150, bw_max=200, min_cnt=0.95, rec_threshold_frac=0.3,
        min_dp_max=100, AF_max_loc=2)[1]


def hifi_options():
    from gdiet_tpu.config import options_for

    # this repository's README HiFi command: -x map-hifi -Z 10 -W 2 -k 19
    # -w 19 -i 0.2 -r 1000 --vt_dis=650 --vt_nb_loc=5
    return options_for("map-hifi", variant="lr", pattern="10", k=19, w=19,
                       max_seeds=0.2, bw=1000, vt_dis=650, vt_nb_loc=5)[1]


def ont_options():
    from gdiet_tpu.config import options_for

    # the reference's ONT recipe (bench.py ONT_REF_ARGS)
    return options_for(
        "map-ont", variant="lr", pattern="10", k=15, w=10, max_seeds=0.2,
        bw=1300, vt_dis=1000, vt_nb_loc=3, vt_df1=0.007, vt_df2=0.007,
        max_min_gap=4000, vt_f=0.04, min_dp_max=35000, vt_cov=0.3,
        best_n=1)[1]


def sr_mapper(mi, mesh=None):
    from gdiet_tpu.pipeline.shortread import ShortReadMapper

    # the bench / CLI fast-path envelope at Lmax 160
    return ShortReadMapper(mi, sr_options(), max_read_len=160, seed_budget=32,
                           shift_seed_budget=16, hit_budget=64,
                           dp_frac=0.3125, mesh=mesh)


def hifi_mapper(mi, sizes: Sizes, mesh=None):
    from gdiet_tpu.pipeline.longread import LongReadMapper

    # reads of 5-15 kb vote over more than 512 hits per strand: the ONT
    # envelope's vote budget keeps them on the device
    return LongReadMapper(mi, hifi_options(), max_read_len=sizes.hifi_lmax,
                          seed_budget=2048, shift_seed_budget=256,
                          hit_budget=8192, vote_budget=4096, mesh=mesh)


def ont_mapper(mi, sizes: Sizes, mesh=None):
    from gdiet_tpu.pipeline.longread import LongReadMapper

    # bench.py's 30 kb ONT envelope
    return LongReadMapper(mi, ont_options(), max_read_len=sizes.ont_lmax,
                          seed_budget=4096, shift_seed_budget=1024,
                          hit_budget=8192, vote_budget=4096, mesh=mesh)


def reached_buckets(lmax: int) -> list[tuple[int, int]]:
    """The DP buckets a segment of a read of at most lmax bases can reach."""
    from gdiet_tpu.pipeline.longread import DP_BUCKETS

    out = []
    for lq, lt in DP_BUCKETS:
        if out and out[-1][0] >= lmax:
            break
        out.append((lq, lt))
    return out


def dp_params(mo) -> tuple:
    return (mo.a, mo.b, mo.q, mo.e, mo.q2, mo.e2)


# --------------------------------------------------------------- phase 1
def _report_compile(name: str, jitted, args: tuple, kw: dict) -> float:
    t0 = time.perf_counter()
    compiled = jitted.lower(*args, **kw).compile()
    dt = time.perf_counter() - t0
    log(f"[compile] {name}: {dt:.1f} s; {compiled.memory_analysis()}")
    return dt


def phase_compile(mi, sizes: Sizes, long_reads: bool = True) -> dict:
    """Compile every step at its real shape, four at a time (XLA compiles
    outside the GIL); each line's seconds overlap the others'."""
    import concurrent.futures

    import jax
    import jax.numpy as jnp

    sds = jax.ShapeDtypeStruct
    jobs = {}
    sr = sr_mapper(mi)
    f = sr.fused
    L = f.cfg.Lmax
    for name, B in (("sr_step", sizes.sr_batch), ("pe_step", 2 * sizes.pe_pairs)):
        comb = sds((B, L // 4 + L // 8 + 8), jnp.uint8)
        jobs[name] = (f"{name} B={B} Lmax={L}", f._jit_packed, (comb,),
                      f.arrays)
    lrs = ((("hifi", hifi_mapper(mi, sizes), sizes.hifi_batch),
            ("ont", ont_mapper(mi, sizes), sizes.ont_batch))
           if long_reads else ())
    for tag, lr, B in lrs:
        a = lr.arrays
        jobs[f"{tag}_front"] = (
            f"{tag}_front B={B} Lmax={lr.Lmax}", lr._front,
            (sds((B, lr.Lmax), jnp.uint8), sds((B,), jnp.int64),
             a["idx_keys"], a["idx_vals"], a["idx_positions"],
             a["idx_buckets"], a["maps"], a["pref"], sds((B,), jnp.int32),
             sds((B,), jnp.uint64)), {})
        N = sizes.lr_dp_rows
        for lq, lt in reached_buckets(lr.Lmax):
            jobs[f"{tag}_dp_{lq}"] = (
                f"{tag}_dp ({lq},{lt}) N={N}", lr._bucket_fn(lq, lt),
                (sds((N, lq), jnp.uint8), sds((N, lt), jnp.uint8),
                 sds((N,), jnp.int32), sds((N,), jnp.int32),
                 sds((N,), jnp.int32)), {})
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        futs = {k: pool.submit(_report_compile, *job)
                for k, job in jobs.items()}
        out = {k: fut.result() for k, fut in futs.items()}
    log(f"[compile] {len(jobs)} steps in {time.perf_counter() - t0:.1f} s")
    return out


# --------------------------------------------------------------- phase 2
def dp_pairs(rng, N: int, Lq: int, Lt: int, min_len: int = 1):
    """Related query/target windows with substitutions, indels and N bases
    (plus one empty row), as uint8 code arrays with lengths."""
    Q = np.zeros((N, Lq), np.uint8)
    T = np.zeros((N, Lt), np.uint8)
    ql = rng.integers(min_len, Lq + 1, N).astype(np.int32)
    tl = np.zeros(N, np.int32)
    for i in range(N):
        q = rng.integers(0, 4, ql[i]).astype(np.uint8)
        t = q.copy()
        for _ in range(int(rng.integers(0, 1 + ql[i] // 20))):
            j = int(rng.integers(0, len(t)))
            op = rng.random()
            if op < 0.6:
                t[j] = rng.integers(0, 5)
            elif op < 0.8:
                t = np.insert(t, j, rng.integers(0, 4))
            elif len(t) > 1:
                t = np.delete(t, j)
        if rng.random() < 0.1:
            t = rng.integers(0, 4, len(t)).astype(np.uint8)
        t = t[:Lt]
        Q[i, :ql[i]] = q
        T[i, :len(t)] = t
        tl[i] = len(t)
    ql[0] = 0
    return Q, T, ql, tl


def dp_fns(params, Lmax: int, Lt: int, band_budget: int):
    """(kernel, xla): jitted DP followed by the device backtrack, through
    ops/dp.py::extd2 (the CUDA kernel on the GPU) and the plain XLA scan."""
    import jax

    from gdiet_tpu.ops import dp as dpk
    from gdiet_tpu.pipeline.device_step import _backtrack_antidiag

    @jax.jit
    def kernel(q, t, l1, l2, b):
        s, d = dpk.extd2(q, t, l1, l2, b, params, Lmax, Lt, band_budget)
        return (s, d) + _backtrack_antidiag(d, l1, b, Lmax, tlens=l2, Lt=Lt,
                                            band_budget=band_budget)

    @jax.jit
    def plain(q, t, l1, l2, b):
        s, d = dpk.extd2_xla(q, t, l1, l2, b, params=params, Lmax=Lmax, Lt=Lt,
                             band_budget=band_budget)
        return (s, d) + _backtrack_antidiag(d, l1, b, Lmax, tlens=l2, Lt=Lt,
                                            band_budget=band_budget)

    return kernel, plain


def compare_dp(fns, args, label: str) -> dict:
    """Run the (kernel, xla) pair on args, a warm call then a timed one;
    exact equality of every output (score, dirs, ops, fin_i, fin_j)."""
    import jax

    times = {}
    res = {}
    for name, fn in zip(("kernel", "xla"), fns):
        jax.block_until_ready(fn(*args))
        t0 = time.perf_counter()
        res[name] = jax.block_until_ready(fn(*args))
        times[name] = time.perf_counter() - t0
    for field, a, b in zip(("score", "dirs", "ops", "fin_i", "fin_j"),
                           res["kernel"], res["xla"]):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape or not np.array_equal(a, b):
            bad = int((a != b).sum()) if a.shape == b.shape else -1
            raise AssertionError(f"DP {field} differs ({bad} elements) at "
                                 f"{label}")
    return times


def expand_select_check(rng, B: int = 64, S: int = 32, A: int = 256) -> None:
    """Hit-expansion row selection (device_step._select_rows) against numpy
    on int64 tables with values up to 2^48; exact."""
    import jax.numpy as jnp

    from gdiet_tpu.pipeline.device_step import _select_rows

    tbl = rng.integers(0, 1 << 48, (B, S), dtype=np.int64)
    sid = rng.integers(0, S, (B, A), dtype=np.int32)
    got = np.asarray(_select_rows(jnp.asarray(tbl), jnp.asarray(sid)))
    want = np.take_along_axis(tbl, sid, axis=1)
    if not np.array_equal(got, want):
        raise AssertionError("hit-expansion row selection differs from numpy")


def phase_kernels(sizes: Sizes, seed: int) -> dict:
    import concurrent.futures

    import jax.numpy as jnp

    from gdiet_tpu.pipeline.device_step import dp_rows

    rng = np.random.default_rng(seed)
    cases = []  # (key, label, DP inputs, params, Lmax, Lt, band budget)
    N2 = sizes.dp_rows or dp_rows(2 * sizes.sr_batch, 0.3125)
    Q, T, ql, _ = dp_pairs(rng, N2, 160, 160, min_len=100)
    band = rng.integers(150, 201, N2).astype(np.int32)
    cases.append(("sr", f"SR DP N={N2} Lmax=160 band<=200",
                  (Q, T, ql, ql, band), (2, 8, 12, 2, 24, 1), 160, 160, 200))
    N = sizes.lr_dp_rows
    for tag, mo, lmax in (("hifi", hifi_options(), sizes.hifi_lmax),
                          ("ont", ont_options(), sizes.ont_lmax)):
        for lq, lt in reached_buckets(lmax):
            Q, T, ql, tl = dp_pairs(rng, N, lq, lt)
            cases.append((f"{tag}_{lq}",
                          f"{tag} DP ({lq},{lt}) N={N} band {mo.bw}",
                          (Q, T, ql, tl, np.full(N, mo.bw, np.int32)),
                          dp_params(mo), lq, lt, mo.bw))
    # compile every pair four at a time, then run them one by one
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        jobs = []
        for key, label, inputs, prm, Lmax, Lt, bb in cases:
            args = [jnp.asarray(x) for x in inputs]
            futs = [pool.submit(lambda f, a: f.lower(*a).compile(), f, args)
                    for f in dp_fns(prm, Lmax, Lt, bb)]
            jobs.append((key, label, args, futs))
        out = {}
        for key, label, args, futs in jobs:
            fns = [f.result() for f in futs]
            out[key] = t = compare_dp(fns, args, label)
            log(f"[kernels] {label}: exact; "
                f"kernel+backtrack {t['kernel'] * 1e3:.2f} ms, "
                f"xla+backtrack {t['xla'] * 1e3:.2f} ms")
    expand_select_check(rng)
    log("[kernels] hit-expansion selection (values < 2^48): exact")
    return out


# --------------------------------------------------------------- phase 3
def _cli(argv: list[str]) -> None:
    from gdiet_tpu.cli import main

    buf = io.TextIOWrapper(io.BytesIO())  # the SAM fast path writes bytes
    with contextlib.redirect_stdout(buf):
        rc = main(["-v", "0", *argv])
    if rc != 0:
        raise AssertionError(f"CLI exited {rc}: {argv}")


def _body(path) -> list[str]:
    return [ln for ln in pathlib.Path(path).read_text().splitlines()
            if not ln.startswith("@")]


def _pe_check(out: pathlib.Path) -> int:
    """tests/test_pe_parity.py's comparison: R1 records equal the single-end
    golden except the fields pairing rewrites; R2 placement and NM/AS equal
    the golden of the reverse-complemented R2 file."""
    def recs(path, trim):
        d = {}
        for f in (ln.split("\t") for ln in _body(path)):
            nm = f[0]
            if trim and len(nm) > 2 and nm[-2] == "/" and nm[-1].isdigit():
                nm = nm[:-2]
            d.setdefault(nm, []).append(f)
        return d

    def tag(f, name):
        return next((t for t in f[11:] if t.startswith(name)), None)

    ours = recs(out, False)
    pe_bits = 0x1 | 0x2 | 0x8 | 0x20 | 0x40 | 0x80
    n = 0
    for mate, golden in ((0x40, "golden_pe_r1.sam"),
                         (0x80, "golden_pe_r2rc.sam")):
        for name, g in recs(DATA / golden, True).items():
            mine = [r for r in ours.get(name, []) if int(r[1]) & mate]
            if not mine:
                raise AssertionError(f"PE: no record for {name}")
            gp, mp = g[0], mine[0]
            if gp[2] == "*":
                continue
            if mate == 0x40:
                ok = (int(mp[1]) & ~pe_bits == int(gp[1]) & ~pe_bits
                      and mp[2:4] + mp[5:6] + mp[9:] == gp[2:4] + gp[5:6]
                      + gp[9:])
            else:
                ok = (mp[2:4] == gp[2:4]
                      and (int(mp[1]) & 0x10) != (int(gp[1]) & 0x10)
                      and all(tag(mp, t) == tag(gp, t)
                              for t in ("NM:i:", "AS:i:")))
            if not ok:
                raise AssertionError(f"PE record differs: {name}")
            n += 1
    return n


def _sr_args(pattern: str) -> list[str]:
    """SR_ARGS with -Z pattern -W len(pattern) (tests/data/README.md)."""
    args = list(SR_ARGS)
    args[args.index("-Z") + 1] = pattern
    args[args.index("-W") + 1] = str(len(pattern))
    return args


GOLDEN = {
    "golden.sam": (SR_ARGS, ["ref.fa", "reads.fq"]),
    **{f"golden2_{p}.sam": (_sr_args(p), ["ref2.fa", "reads2.fq"])
       for p in ("10", "110", "1110", "11")},
    "golden_pe": (SR_ARGS, ["ref_pe.fa", "reads_pe_1.fq", "reads_pe_2.fq"]),
    "golden_lr_hifi.sam": (HIFI_FIXTURE_ARGS, ["ref_lr.fa", "reads_lr.fq"]),
    "golden_lr_ont.sam": (ONT_FIXTURE_ARGS, ["ref_lr.fa", "reads_lr.fq"]),
    "golden_split.sam": (SR_ARGS + ["-I", "40k", "--split-prefix", "SPLIT"],
                         ["ref2.fa", "reads2.fq"]),
}


def phase_golden(names=tuple(GOLDEN)) -> None:
    WORK.mkdir(parents=True, exist_ok=True)
    for name in names:
        args, files = GOLDEN[name]
        out = WORK / f"out_{name}"
        args = [str(WORK / "sp") if a == "SPLIT" else a for a in args]
        t0 = time.perf_counter()
        _cli([*args, "-o", str(out), *(str(DATA / f) for f in files)])
        if name == "golden_pe":
            detail = f"{_pe_check(out)} records checked"
        else:
            mine, gold = _body(out), _body(DATA / name)
            if mine != gold:
                bad = next((i for i, (a, b) in enumerate(zip(mine, gold))
                            if a != b), min(len(mine), len(gold)))
                raise AssertionError(
                    f"{name}: SAM differs at record {bad} "
                    f"({len(mine)} vs {len(gold)} records)")
            detail = f"{len(gold)} records byte-identical"
        log(f"[golden] {name}: {detail} ({time.perf_counter() - t0:.1f} s)")


# --------------------------------------------------------------- phase 4
BASES = np.frombuffer(b"ACGTN", np.uint8)


def _pick(rng, chroms, n: int, length: int):
    """n windows of `length` bases without N, as (chrom, start)."""
    out = []
    while len(out) < n:
        c = int(rng.integers(0, len(chroms)))
        codes = chroms[c][1]
        if len(codes) <= length:
            continue
        st = int(rng.integers(0, len(codes) - length))
        if (codes[st:st + length] > 3).any():
            continue
        out.append((c, st))
    return out


def _record(name, codes, rng):
    from gdiet_tpu.io.fastx import SeqRecord

    if rng.random() < 0.5:
        codes = (3 - codes[::-1]).astype(np.uint8)
    seq = BASES[codes].tobytes().decode()
    return SeqRecord(name, seq, "I" * len(seq))


def make_sr_reads(rng, chroms, n: int, length: int = 150, tag: str = "s"):
    recs = []
    for i, (c, st) in enumerate(_pick(rng, chroms, n, length)):
        r = chroms[c][1][st:st + length].copy()
        sub = rng.random(length) < 0.005
        r[sub] = (r[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        recs.append(_record(f"{tag}{i}", r, rng))
    return recs


def make_pairs(rng, chroms, n: int, length: int = 150):
    from gdiet_tpu.io.fastx import SeqRecord

    pairs = []
    for i, (c, st) in enumerate(_pick(rng, chroms, n, 450)):
        ins = int(rng.integers(250, 450))
        frag = chroms[c][1][st:st + ins]
        r1 = frag[:length].copy()
        r2 = (3 - frag[ins - length:][::-1]).astype(np.uint8)
        seqs = [BASES[x].tobytes().decode() for x in (r1, r2)]
        pairs.append((SeqRecord(f"p{i}/1", seqs[0], "I" * length),
                      SeqRecord(f"p{i}/2", seqs[1], "I" * length)))
    return pairs


def make_long_reads(rng, chroms, n: int, lo: int, hi: int, sub: float,
                    indel: float, tag: str):
    recs = []
    for i in range(n):
        L = int(rng.integers(lo, hi + 1))
        c, st = _pick(rng, chroms, 1, L)[0]
        src = chroms[c][1][st:st + L].copy()
        r = rng.random(L)
        keep = r >= indel / 2  # deletions
        s = (r >= indel / 2) & (r < indel / 2 + sub)
        src[s] = (src[s] + rng.integers(1, 4, int(s.sum()))) % 4
        ins = r >= 1 - indel / 2  # an extra base after these
        out = np.repeat(src, np.where(ins, 2, 1))
        keep = np.repeat(keep, np.where(ins, 2, 1))
        recs.append(_record(f"{tag}{i}", out[keep].astype(np.uint8), rng))
    return recs


def _by_name(blob: bytes) -> dict:
    d: dict = {}
    for ln in blob.decode().splitlines():
        if ln:
            d.setdefault(ln.split("\t", 1)[0], []).append(ln)
    return d


def run_sr(mapper, batches) -> tuple[bytes, float]:
    t0 = time.perf_counter()
    blob = b"".join(mapper.map_stream_sam(iter(batches)))
    return blob, time.perf_counter() - t0


def run_lr(mapper, reads, B: int) -> tuple[list[str], float, set]:
    """SAM lines, seconds, and the names of the reads that left the device
    envelope (mapped by the scalar oracle)."""
    batches = []
    for s in range(0, len(reads), B):
        b = reads[s:s + B]
        batches.append((len(b), b + [b[0]] * (B - len(b))))
    lines = []
    fallback = set()
    t0 = time.perf_counter()
    for (n, b), res in zip(batches, mapper.map_stream(b for _, b in batches)):
        for rec, regs, host in zip(b[:n], res[:n], mapper.last_host_only):
            lines.extend(mapper.regs_to_sam_lines(rec, regs))
            if host:
                fallback.add(rec.name)
    return lines, time.perf_counter() - t0, fallback


def phase_scale(mi, chroms, sizes: Sizes, seed: int, card: str) -> dict:
    import jax

    from gdiet_tpu.io.fastx import split_ultralong
    from gdiet_tpu.oracle import longread as olr

    rng = np.random.default_rng(seed + 1)
    res = {}
    # ---- short reads: warm batch, then timed batches
    sr = sr_mapper(mi)
    B = sizes.sr_batch
    reads = make_sr_reads(rng, chroms, B * (sizes.sr_batches + 1))
    batches = [reads[i:i + B] for i in range(0, len(reads), B)]
    run_sr(sr, batches[:1])
    blob, dt = run_sr(sr, batches[1:])
    timed = reads[B:]
    dev = _by_name(blob)
    for rec in timed[:sizes.sr_oracle]:
        want = sr._oracle_sam(rec, 0).decode().splitlines()
        if dev.get(rec.name) != want:
            raise AssertionError(f"SR {rec.name}: device SAM != oracle "
                                 f"{dev.get(rec.name)} vs {want}")
    res["sr_reads_per_sec"] = len(timed) / dt
    res["sr_fallback_reads"] = sr.stats["fallback_reads"]
    log(f"[scale] SR: {len(timed)} reads in {dt:.2f} s = "
        f"{res['sr_reads_per_sec']:.0f} reads/s (smoke timing, {card}); "
        f"fallback reads {res['sr_fallback_reads']}; "
        f"{sizes.sr_oracle} sampled reads byte-identical to the oracle")
    # ---- paired-end
    P = sizes.pe_pairs
    pairs = make_pairs(rng, chroms, P * (sizes.pe_batches + 1))
    pbatches = [pairs[i:i + P] for i in range(0, len(pairs), P)]
    for _ in sr.map_stream_sam_pe(iter(pbatches[:1])):
        pass
    t0 = time.perf_counter()
    pblob = b"".join(sr.map_stream_sam_pe(iter(pbatches[1:])))
    dt = time.perf_counter() - t0
    n_rec = pblob.count(b"\n")
    if n_rec < 2 * P * sizes.pe_batches:
        raise AssertionError(f"PE: {n_rec} records for "
                             f"{P * sizes.pe_batches} pairs")
    res["pe_pairs_per_sec"] = P * sizes.pe_batches / dt
    log(f"[scale] PE: {P * sizes.pe_batches} pairs in {dt:.2f} s = "
        f"{res['pe_pairs_per_sec']:.0f} pairs/s (smoke timing, {card}); "
        f"fallback reads {sr.stats['fallback_reads']}")
    # ---- HiFi and ONT
    hifi = make_long_reads(rng, chroms, sizes.hifi_reads, *sizes.hifi_len,
                           sub=0.002, indel=0.002, tag="h")
    ont = make_long_reads(rng, chroms, sizes.ont_reads, sizes.ont_len,
                          sizes.ont_len + 500, sub=0.03, indel=0.02, tag="o")
    ont = list(split_ultralong(ont, 30000))
    for tag, mk, recs, B, n_or in (
            ("hifi", hifi_mapper, hifi, sizes.hifi_batch, sizes.hifi_oracle),
            ("ont", ont_mapper, ont, sizes.ont_batch, sizes.ont_oracle)):
        lr = mk(mi, sizes)
        run_lr(lr, recs[:B], B)  # compile every shape of the first batch
        lr.stats = dict.fromkeys(lr.stats, 0)
        lines, dt, fallback = run_lr(lr, recs, B)
        dev = _by_name("\n".join(lines).encode())
        # the oracle maps fallback reads itself: compare device reads only
        sample = [r for r in recs if r.name not in fallback][:n_or]
        if len(sample) < n_or:
            raise AssertionError(f"{tag}: {len(sample)} device-mapped reads, "
                                 f"{n_or} needed ({len(fallback)} fallbacks)")
        for rec in sample:
            regs = olr.map_read_lr(lr._oracle_mi(), rec.seq, lr.mo,
                                   lr.mid_occ, rec.name)
            want = lr.regs_to_sam_lines(rec, regs)
            if dev.get(rec.name) != want:
                raise AssertionError(f"{tag} {rec.name}: device SAM != oracle")
        res[f"{tag}_reads_per_sec"] = len(recs) / dt
        res[f"{tag}_stats"] = dict(lr.stats)
        log(f"[scale] {tag}: {len(recs)} reads in {dt:.2f} s = "
            f"{len(recs) / dt:.2f} reads/s (smoke timing, {card}); "
            f"stats {lr.stats}; {len(sample)} sampled device-mapped reads "
            f"byte-identical to the oracle ({len(fallback)} fallback reads "
            f"not sampled)")
    stats = jax.devices()[0].memory_stats() or {}
    res["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    log(f"[scale] peak device memory: {res['peak_bytes_in_use']} bytes")
    return res


# --------------------------------------------------------------- four cards
def phase_four_cards(mi, chroms, sizes: Sizes, seed: int) -> None:
    """SR and LR on (data, ref) meshes 2x2 and 4x1 against one card."""
    import jax

    from gdiet_tpu.parallel.dist import make_mesh

    rng = np.random.default_rng(seed + 2)
    B = sizes.sr_batch
    reads = make_sr_reads(rng, chroms, 2 * B)
    batches = [reads[:B], reads[B:]]
    hifi = make_long_reads(rng, chroms, sizes.hifi_batch, *sizes.hifi_len,
                           sub=0.002, indel=0.002, tag="h")
    one_sr, t_sr = run_sr(sr_mapper(mi), batches)
    one_lr, t_lr, _ = run_lr(hifi_mapper(mi, sizes), hifi, sizes.hifi_batch)
    log(f"[four] one card: SR {len(reads)} reads {t_sr:.2f} s, "
        f"HiFi {len(hifi)} reads {t_lr:.2f} s (first runs, compile included)")
    for shape in ((2, 2), (4, 1)):
        mesh = make_mesh(*shape)
        sr = sr_mapper(mi, mesh=mesh)
        lr = hifi_mapper(mi, sizes, mesh=mesh)
        check_placement(sr.fused._step.arrays, shape)
        check_placement(lr._mesh_front.arrays, shape)
        blob, t_sr = run_sr(sr, batches)
        if blob != one_sr:
            raise AssertionError(f"SR SAM on mesh {shape} != one card")
        lines, t_lr, _ = run_lr(lr, hifi, sizes.hifi_batch)
        if lines != one_lr:
            raise AssertionError(f"HiFi SAM on mesh {shape} != one card")
        log(f"[four] mesh {shape[0]}x{shape[1]}: SR {len(reads)} reads "
            f"{t_sr:.2f} s, HiFi {len(hifi)} reads {t_lr:.2f} s; SAM "
            f"byte-identical to one card")


def check_placement(arrays: dict, shape) -> None:
    """Every index array lives on all four cards, and the key-range shards
    are n_ref distinct slices (not all of it on the first card)."""
    n_ref = shape[1]
    for name, arr in arrays.items():
        devs = {s.device for s in arr.addressable_shards}
        if len(devs) != 4:
            raise AssertionError(f"{name} on {len(devs)} devices, mesh {shape}")
        if name.startswith("idx_"):
            slices = {s.index for s in arr.addressable_shards}
            if len(slices) != n_ref:
                raise AssertionError(
                    f"{name}: {len(slices)} distinct shards, n_ref {n_ref}")
    log(f"[four] mesh {shape[0]}x{shape[1]}: index on 4 cards, "
        f"{n_ref} key-range shard(s)")


# --------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four cards")
    ap.add_argument("--seed", type=int, default=SEED)
    args = ap.parse_args(argv)
    sizes = Sizes()
    if args.four_cards:  # HiFi at a 4 kb envelope: the meshes compile anew
        sizes = dataclasses.replace(sizes, hifi_lmax=4096,
                                    hifi_len=(2000, 4000))
    t_start = time.perf_counter()

    info = phase_device(need=4 if args.four_cards else 1)
    card = card_line()
    mi, chroms, _ = build_scale_index(sizes, args.seed)
    if args.four_cards:
        phase_four_cards(mi, chroms, sizes, args.seed)
    else:
        phase_compile(mi, sizes)
        phase_kernels(sizes, args.seed)
        phase_golden()
        phase_scale(mi, chroms, sizes, args.seed, card)
    log(f"[done] {time.perf_counter() - t_start:.1f} s on {card}")
    log(card)
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
