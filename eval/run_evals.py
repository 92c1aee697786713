#!/usr/bin/env python
"""Run the containment-search + taxonomic-profiling evaluations end-to-end
and write the numbers to chiprun_out/eval_results.md (git-ignored; a run on
the GPU brings it back from the chip machine).

Analogs of ReproducibleEvaluation/ContainmentSearch/ContainmentIndexing.sh
(pattern sweep 11/10/110/100/1110 x {seq, no-seq} index size/time) and
TaxonomicProfiling/TaxonomicProfiling.sh (GDiet inside a Metalign-style
profiler). Synthetic data sized for a single box; the recorded RATIOS are
the comparable quantities (the reference reports 72.7-75.9x search speed
and 723x space at sparser patterns on RefSeq-scale data, README.md:69).
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
WORK = pathlib.Path("/tmp/gdiet_evals")

PATTERNS = ["11", "10", "110", "100", "1110"]


def log(m):
    print(f"[evals] {m}", file=sys.stderr, flush=True)


def synth(rng, n):
    return "".join("ACGT"[c] for c in rng.integers(0, 4, n))


def containment():
    from gdiet_tpu.config import MM_I_NO_SEQ, options_for
    from gdiet_tpu.index.build import build_index
    from gdiet_tpu.io.fastx import read_fastx

    rng = np.random.default_rng(42)
    target = synth(rng, 8_000_000)
    fa = WORK / "cont_target.fa"
    with open(fa, "w") as f:
        f.write(">target\n")
        for i in range(0, len(target), 80):
            f.write(target[i : i + 80] + "\n")
    refs = [(r.name, r.seq) for r in read_fastx(str(fa))]

    rows = []
    for pat in PATTERNS:
        for no_seq in (False, True):
            io_, _ = options_for("map-hifi", variant="lr", pattern=pat,
                                 k=19, w=16)
            if no_seq:
                io_.flag |= MM_I_NO_SEQ
            # warm build first: each pattern's diet projection is a fresh
            # device-sketch shape with its own XLA compile — the recorded
            # number is the steady-state (warm) build a user pays per
            # genome; the reference binary pays no compile either
            build_index(refs, io_)
            t0 = time.perf_counter()
            mi = build_index(refs, io_)
            dt = time.perf_counter() - t0
            p = WORK / f"cont_idx_{pat}{'_noseq' if no_seq else ''}.npz"
            mi.save(str(p))
            rows.append({
                "pattern": pat, "no_seq": no_seq,
                "build_s": round(dt, 2),
                "bytes": p.stat().st_size,
                "keys": len(mi.keys), "positions": len(mi.positions),
            })
            log(rows[-1])

    # containment search: chunks of a CONTAINED genome (a 1 Mbp slice with
    # 1% divergence) vs an UNRELATED genome, against the pattern-10 index
    from gdiet_tpu.config import options_for as opt2
    from gdiet_tpu.index.build import DietIndex
    from gdiet_tpu.pipeline.longread import LongReadMapper
    from gdiet_tpu.io.fastx import SeqRecord

    contained = list(target[3_000_000:4_000_000])
    idx = rng.integers(0, len(contained), 10_000)
    for i in idx:
        contained[i] = "ACGT"[int(rng.integers(0, 4))]
    contained = "".join(contained)
    unrelated = synth(rng, 1_000_000)

    mi = DietIndex.load(str(WORK / "cont_idx_10.npz"))
    io_, mo = opt2(
        "map-hifi", variant="lr", pattern="10", k=19, w=16, max_seeds=0.2,
        bw=500, vt_dis=650, vt_nb_loc=5, vt_df1=0.0106, vt_df2=0.2,
        min_dp_max=200, vt_cov=0.04, vt_f=0.04,
    )
    search = {}
    for tag, q in [("contained", contained), ("unrelated", unrelated)]:
        chunks = [SeqRecord(f"c{i}", q[s0 : s0 + 2000])
                  for i, s0 in enumerate(range(0, len(q) - 2000, 2000))]
        with open(WORK / f"search_{tag}.fa", "w") as f:  # reference side
            for c in chunks:
                f.write(f">{c.name}\n{c.seq}\n")
        B = 512  # the whole 499-chunk search in ONE dispatch: sub-second
        # runs are dominated by the fixed per-dispatch cost
        # envelope sized FOR 2 kb chunks (the default Lmax-8192 LR
        # envelope wasted 4x padding per chunk here): chunks
        # are exactly 2000 bp, land in the (2048, 3072) DP bucket, and a
        # 1%-divergence containment hit needs far fewer seed slots than an
        # 8 kb HiFi read
        mapper = LongReadMapper(mi, mo, max_read_len=2048, seed_budget=256,
                                shift_seed_budget=64, hit_budget=1024)

        def batches():
            for s0 in range(0, len(chunks), B):
                b = chunks[s0 : s0 + B]
                yield b + [b[0]] * (B - len(b))

        # steady-state timing: compile/warm on the first batch shape, then
        # time mapping only (matches how the flagship bench rows time)
        for _ in mapper.map_stream(iter([next(batches())])):
            pass
        n_hit = 0
        t0 = time.perf_counter()
        for s0, res in zip(range(0, len(chunks), B),
                           mapper.map_stream(batches())):
            n_hit += sum(1 for r in res[: len(chunks) - s0] if r)
        search[tag] = {
            "chunks": len(chunks), "mapped": n_hit,
            "frac": round(n_hit / len(chunks), 4),
            "sec": round(time.perf_counter() - t0, 2),
            "fallback_reads": mapper.stats["fallback_reads"],
        }
        log(f"search {tag}: {search[tag]}")
    return rows, search


REF_LR = pathlib.Path("/tmp/gdiet_ref/LR/GDiet")
REF_SR = pathlib.Path("/tmp/gdiet_ref/SR/GDiet")


def _build_ref_binaries():
    """Build the reference binaries if absent (Makefile 'GDiet' target)."""
    for src, exe in (("GDiet-LongReads", REF_LR), ("GDiet-ShortReads", REF_SR)):
        if exe.exists():
            continue
        exe.parent.parent.mkdir(parents=True, exist_ok=True)
        if not exe.parent.exists():
            subprocess.run(
                ["cp", "-r", f"/root/reference/{src}", str(exe.parent)],
                check=True)
        subprocess.run(["make", "GDiet"], cwd=exe.parent, check=True,
                       capture_output=True, timeout=600)


def reference_side(cont_rows, search, tax):
    """Run the REFERENCE binary on the same synthetic workloads and record
    ours-vs-reference time/space ratios (the local anchor for the paper's
    72.7-75.9x / 723x headline ratios — ContainmentIndexing.sh:7-108,
    TaxonomicProfiling.sh). Single core, warm cache, same files."""
    _build_ref_binaries()
    out = {"containment": [], "search": {}, "taxonomic": {}}

    # --- containment indexing sweep (same FASTA, same k/w/pattern) ---
    fa = WORK / "cont_target.fa"
    for pat in PATTERNS:
        for no_seq in (False, True):
            mmi = WORK / f"ref_idx_{pat}{'_noseq' if no_seq else ''}.mmi"
            cmd = [str(REF_LR), "-t", "1", "-x", "map-hifi",
                   "-Z", pat, "-W", str(len(pat)), "-k", "19", "-w", "16"]
            if no_seq:
                cmd.append("--idx-no-seq")
            cmd += ["-d", str(mmi), str(fa)]
            t0 = time.perf_counter()
            subprocess.run(cmd, check=True, capture_output=True, timeout=1800)
            out["containment"].append({
                "pattern": pat, "no_seq": no_seq,
                "build_s": round(time.perf_counter() - t0, 2),
                "bytes": mmi.stat().st_size,
            })
            log(f"ref {out['containment'][-1]}")

    # --- containment search (same 2 kb chunk queries, pattern-10 index) ---
    for tag in ("contained", "unrelated"):
        qfa = WORK / f"search_{tag}.fa"
        if not qfa.exists():
            continue
        sam = WORK / f"ref_search_{tag}.sam"
        cmd = [str(REF_LR), "-a", "-t", "1", "-x", "map-hifi", "-Z", "10",
               "-W", "2", "-k", "19", "-w", "16", "-i", "0.2", "-r", "500",
               "--vt_dis", "650", "--vt_nb_loc", "5", "--vt_df1", "0.0106",
               "--vt_df2", "0.2", "-s", "200", "--vt_cov", "0.04",
               "--vt_f", "0.04", "-o", str(sam),
               str(WORK / "ref_idx_10.mmi"), str(qfa)]
        t0 = time.perf_counter()
        subprocess.run(cmd, check=True, capture_output=True, timeout=1800)
        dt = time.perf_counter() - t0
        mapped = sum(
            1 for l in open(sam)
            if not l.startswith("@") and l.split("\t", 3)[2] != "*"
        )
        out["search"][tag] = {"mapped": mapped, "sec": round(dt, 2)}
        log(f"ref search {tag}: {out['search'][tag]}")

    # --- taxonomic profiling (same 8-genome DB + 60k reads) ---
    db = WORK / "tax_db.fa"
    rq = WORK / "tax_reads.fq"
    if db.exists() and rq.exists():
        mmi = WORK / "ref_tax.mmi"
        base = [str(REF_SR), "-t", "1", "-x", "sr", "-Z", "10", "-W", "2",
                "-k", "21", "-w", "11"]
        t0 = time.perf_counter()
        subprocess.run([*base, "-d", str(mmi), str(db)], check=True,
                       capture_output=True, timeout=1800)
        build_s = time.perf_counter() - t0
        sam = WORK / "ref_tax.sam"
        t0 = time.perf_counter()
        subprocess.run(
            [*base, "-a", "-i", "2", "-N", "1", "-r", "0.05,150,200",
             "-n", "0.95,0.3", "-s", "100", "--AF_max_loc", "2",
             "-o", str(sam), str(mmi), str(rq)],
            check=True, capture_output=True, timeout=1800)
        map_s = time.perf_counter() - t0
        n = mapped = 0
        for l in open(sam):
            if l.startswith("@"):
                continue
            f = l.split("\t", 4)
            if int(f[1]) & 0x900:
                continue
            n += 1
            if f[2] != "*":
                mapped += 1
        out["taxonomic"] = {
            "build_s": round(build_s, 1), "map_s": round(map_s, 2),
            "reads_per_sec": round(n / map_s, 1),
            "reads": n, "mapped": mapped,
        }
        log(f"ref taxonomic: {out['taxonomic']}")
    return out


def taxonomic():
    from gdiet_tpu.config import options_for
    from gdiet_tpu.index.build import build_index
    from gdiet_tpu.io.fastx import SeqRecord
    from gdiet_tpu.pipeline.shortread import ShortReadMapper
    from collections import Counter

    rng = np.random.default_rng(7)
    n_taxa = 8
    genomes = {f"taxon{i}": synth(rng, 1_000_000) for i in range(n_taxa)}
    truth = {"taxon0": 0.5, "taxon1": 0.3, "taxon2": 0.2}
    reads = []
    for name, frac in truth.items():
        g = genomes[name]
        for j in range(int(60000 * frac)):
            st = int(rng.integers(0, len(g) - 150))
            r = list(g[st : st + 150])
            for _ in range(int(rng.binomial(150, 0.005))):
                p = int(rng.integers(0, 150))
                r[p] = "ACGT"[int(rng.integers(0, 4))]
            reads.append(SeqRecord(f"r{name}_{j}", "".join(r)))
    rng.shuffle(reads)
    with open(WORK / "tax_db.fa", "w") as f:  # reference side uses same data
        for name, g in genomes.items():
            f.write(f">{name}\n{g}\n")
    with open(WORK / "tax_reads.fq", "w") as f:
        for r in reads:
            f.write(f"@{r.name}\n{r.seq}\n+\n{'I' * len(r.seq)}\n")

    io_, mo = options_for(
        "sr", pattern="10", k=21, w=11, max_seeds=2.0, best_n=1,
        bw_frac=0.05, bw_min=150, bw_max=200, min_cnt=0.95,
        rec_threshold_frac=0.3, min_dp_max=100, AF_max_loc=2,
    )
    build_index(list(genomes.items()), io_)  # warm the sketch compile
    t0 = time.perf_counter()
    mi = build_index(list(genomes.items()), io_)
    build_s = time.perf_counter() - t0
    mapper = ShortReadMapper(mi, mo, max_read_len=160, seed_budget=32,
                             shift_seed_budget=16, hit_budget=256,
                             dp_frac=0.375)
    counts = Counter()
    total = mapped = 0
    # 60k reads in pipelined batches: enough work that the recorded rate is
    # steady-state mapping throughput, not the fixed per-dispatch cost (a
    # 6k-read single batch finishes in well under a second and measures
    # round-trip latency)
    B = 10016
    batches = []
    for s0 in range(0, len(reads), B):
        b = reads[s0 : s0 + B]
        batches.append((len(b), b + [b[0]] * (B - len(b))))
    # the profiling classifier only needs each read's primary RNAME: take
    # the benched fused-step -> native-SAM path (a Metalign-style wrapper
    # consumes GDiet's SAM the same way) and warm the compile first so the
    # recorded rate is steady-state mapping, not XLA compilation
    for _ in mapper.map_stream_sam(iter([batches[0][1]])):
        pass
    t0 = time.perf_counter()
    blobs = list(mapper.map_stream_sam(b for _, b in batches))
    dt = time.perf_counter() - t0
    for (n_real, _), blob in zip(batches, blobs):
        seen = 0
        last = None
        for ln in bytes(blob).splitlines():
            f = ln.split(b"\t", 4)
            if f[0] != last:
                seen += 1
                last = f[0]
            if seen > n_real:
                break
            if int(f[1]) & 0x900:  # secondary/supplementary
                continue
            total += 1
            if f[2] != b"*":
                mapped += 1
                counts[f[2].decode()] += 1
    profile = {t: round(c / mapped, 4) for t, c in counts.most_common()}
    l1 = sum(abs(profile.get(t, 0.0) - truth.get(t, 0.0))
             for t in set(profile) | set(truth))
    return {
        "db_taxa": n_taxa, "reads": total, "mapped": mapped,
        "build_s": round(build_s, 1), "map_s": round(dt, 2),
        "reads_per_sec": round(total / dt, 1),
        "profile": profile, "truth": truth, "l1_error": round(l1, 4),
    }


def _backend() -> str:
    import jax

    return jax.devices()[0].platform


def main():
    WORK.mkdir(parents=True, exist_ok=True)
    cont_rows, search = containment()
    tax = taxonomic()
    try:
        ref = reference_side(cont_rows, search, tax)
    except Exception as e:  # reference toolchain unavailable: record ours only
        log(f"reference side skipped: {e}")
        ref = None

    base = next(r for r in cont_rows if r["pattern"] == "11"
                and not r["no_seq"])
    lines = [
        "# Evaluation results (containment search + taxonomic profiling)",
        "",
        "Produced by `python eval/run_evals.py` (synthetic data; the",
        "comparable quantities are the RATIOS — reference headline numbers",
        "are 72.7-75.9x search speedup / 723x space on RefSeq-scale data,",
        "README.md:69, ContainmentIndexing.sh:7-108). The 'ref' columns are",
        "the reference GDiet binary on the SAME data/flags on this box.",
        "",
        f"Ours-side backend: **{_backend()}**. Space ratios are"
        " platform-independent; time ratios reflect the framework's"
        " target hardware only when the backend is gpu.",
        "",
        "## Containment indexing sweep (8 Mbp target, map-hifi k19 w16)",
        "",
        "| pattern | seq stored | build s | index bytes | vs 11+seq | ref build s | ref bytes | ours/ref bytes |",
        "|---|---|---|---|---|---|---|---|",
    ]
    ref_cont = {(r["pattern"], r["no_seq"]): r
                for r in (ref["containment"] if ref else [])}
    for r in cont_rows:
        rr = ref_cont.get((r["pattern"], r["no_seq"]))
        extra = (f" {rr['build_s']} | {rr['bytes']:,} | "
                 f"{r['bytes'] / rr['bytes']:.2f}x |" if rr else " - | - | - |")
        lines.append(
            f"| {r['pattern']} | {'no' if r['no_seq'] else 'yes'} | "
            f"{r['build_s']} | {r['bytes']:,} | "
            f"{base['bytes'] / r['bytes']:.2f}x smaller |" + extra)
    lines += [
        "",
        "## Containment search (pattern 10 index, 2 kb query chunks)",
        "",
        "| query | chunks | mapped | contained frac | wall s | ref mapped | ref wall s |",
        "|---|---|---|---|---|---|---|",
    ]
    for tag, v in search.items():
        rv = (ref or {}).get("search", {}).get(tag)
        extra = (f" {rv['mapped']} | {rv['sec']} |" if rv else " - | - |")
        lines.append(f"| {tag} | {v['chunks']} | {v['mapped']} | "
                     f"{v['frac']} | {v['sec']} |" + extra)
    lines += [
        "",
        "Sub-second rows are bounded by per-dispatch latency, not compute;"
        " the all-negative 'unrelated' search pays it with nothing to"
        " amortize it.",
    ]
    lines += [
        "",
        "## Taxonomic profiling (8-taxon DB, 60k reads from 3 taxa)",
        "",
        f"- DB build: {tax['build_s']} s; mapping: {tax['reads_per_sec']} "
        f"reads/s ({tax['mapped']}/{tax['reads']} mapped)",
        f"- recovered profile: `{json.dumps(tax['profile'])}`",
        f"- truth: `{json.dumps(tax['truth'])}`  |  L1 error: "
        f"{tax['l1_error']}",
    ]
    if ref and ref.get("taxonomic"):
        rt = ref["taxonomic"]
        lines.append(
            f"- reference binary, same DB/reads: build {rt['build_s']} s; "
            f"{rt['reads_per_sec']} reads/s ({rt['mapped']}/{rt['reads']} "
            f"mapped); ours/ref map speed: "
            f"{tax['reads_per_sec'] / rt['reads_per_sec']:.2f}x")
    lines += [
        "",
        f"Raw: `{json.dumps({'containment': cont_rows, 'search': search, 'taxonomic': tax, 'reference': ref})}`",
    ]
    out = REPO / "chiprun_out" / "eval_results.md"
    out.parent.mkdir(exist_ok=True)
    out.write_text("\n".join(lines) + "\n")
    log(f"wrote {out}")


if __name__ == "__main__":
    main()
