"""File-level mapping driver (the mm_map_file / main-loop analog).

Replaces the reference's kt_pipeline read->map->write loop
(GDiet-ShortReads/map.c:1165-1326, main.c:576-672): reads are streamed in
base-count mini-batches, fed to the batched device mapper with one-batch
lookahead (compute overlaps the host finish), and written in order as
SAM or PAF.
"""

from __future__ import annotations

import resource
import sys
import time

from gdiet_tpu.config import (
    MM_F_CIGAR,
    MM_F_NO_PRINT_2ND,
    MM_F_OUT_CG,
    MM_F_OUT_SAM,
    IndexOptions,
    MapOptions,
)
from gdiet_tpu import __version__
from gdiet_tpu.index.build import DietIndex, build_index
from gdiet_tpu.io import sam as samio
from gdiet_tpu.io.fastx import SeqRecord, read_frag_batches, read_fastx
from gdiet_tpu.utils.profile import PROFILE, Stage


def _log(verbose: int, t0: float, msg: str) -> None:
    if verbose >= 3:
        cpu = time.process_time()
        print(f"[M::gdiet::{time.perf_counter() - t0:.3f}*{cpu:.2f}] {msg}",
              file=sys.stderr)


def load_or_build_index(
    target: str, io: IndexOptions, verbose: int = 3, t0: float | None = None
) -> DietIndex:
    t0 = time.perf_counter() if t0 is None else t0
    if DietIndex.is_index(target):
        mi = DietIndex.load(target)
        _log(verbose, t0, f"loaded prebuilt index ({mi.n_seq} sequences)")
        if (mi.k != io.k or mi.w != io.w) and verbose >= 2:
            print(
                "[WARNING] Indexing parameters k/w differ from the CLI "
                "setting; using the index's", file=sys.stderr,
            )
        return mi
    with PROFILE.stage(Stage.INDEXING):
        # stream: each sequence's string is released after encoding
        mi = build_index(
            ((r.name, r.seq) for r in read_fastx(target)), io)
    _log(verbose, t0, f"built the index for {mi.n_seq} target sequence(s)")
    if verbose >= 3:  # mm_idx_stat (index.c:102-127)
        st = mi.stats()
        print(
            f"[M::mm_idx_stat] kmer size: {st['kmer_size']}; skip: "
            f"{st['skip']}; #seq: {st['n_seq']}; distinct minimizers: "
            f"{st['distinct_minimizers']} ({st['pct_singletons']:.2f}% are "
            f"singletons); average occurrences: {st['avg_occurrences']:.3f}; "
            f"average spacing: {st['avg_spacing']:.3f}",
            file=sys.stderr,
        )
    return mi


def _make_mapper(mi: DietIndex, mo: MapOptions, variant: str,
                 max_read_len: int | None):
    if variant == "sr":
        from gdiet_tpu.pipeline.shortread import ShortReadMapper

        return ShortReadMapper(mi, mo, max_read_len=max_read_len or 256)
    from gdiet_tpu.pipeline.longread import LongReadMapper

    return LongReadMapper(mi, mo)


def run_split_mapping(
    io: IndexOptions,
    mo: MapOptions,
    variant: str,
    target: str,
    queries: list[str],
    out,
    verbose: int,
    cli_line: str,
    max_read_len: int | None,
    t0: float,
) -> int:
    """Multi-part index mapping with --split-prefix merge re-ranking
    (map.c:1094-1163 merge_hits + splitidx.c, in-memory instead of temp
    files; the final ranking uses the ported hit.c/pe.c stack)."""
    from gdiet_tpu.config import MM_F_ALL_CHAINS, MM_F_CIGAR, MM_F_SR
    from gdiet_tpu.index.build import build_index_parts
    from gdiet_tpu.oracle import hit as ohit

    with PROFILE.stage(Stage.INDEXING):
        refs = [(r.name, r.seq) for r in read_fastx(target)]
        parts = list(build_index_parts(refs, io))
    _log(verbose, t0, f"built {len(parts)} index part(s)")

    group = queries if len(queries) == 2 else queries[:1]
    frags = []
    for fb in read_frag_batches(group, 1 << 62):
        frags.extend(fb)
    # per-part mapping, hits kept in memory (the splitidx.c temp-file analog)
    per_seg_regs: list[list] = []
    seg_meta: list[tuple[int, int]] = []  # (frag_idx, seg_idx)
    for fi, frag in enumerate(frags):
        for j, _ in enumerate(frag):
            seg_meta.append((fi, j))
            per_seg_regs.append([])
    for mi_part, rid_shift in parts:
        mapper = _make_mapper(mi_part, mo, variant, max_read_len)
        flat = [rec for frag in frags for rec in frag]
        results = mapper.map_batch(flat)
        for segi, regs in enumerate(results):
            for r in regs or []:
                r.rid += rid_shift
                per_seg_regs[segi].append(r)
    names: list[str] = []
    lens: list[int] = []
    for mi_part, _ in parts:
        names.extend(mi_part.names)
        lens.extend(int(x) for x in mi_part.lengths)

    # merge re-rank per fragment (merge_hits)
    flat_recs = [rec for frag in frags for rec in frag]
    for segi, regs in enumerate(per_seg_regs):
        rec = flat_recs[segi]
        if not regs:
            continue
        if not (mo.flag & MM_F_SR) and rec.l_seq >= mo.rank_min_len:
            ohit.update_dp_max(rec.l_seq, regs, mo.rank_frac, mo.a, mo.b)
        for r in regs:
            r.dp_max2 = 0
            r.subsc = 0
            r.n_sub = 0
        regs = ohit.hit_sort(regs)
        ohit.set_parent(regs, mo.mask_level, mo.mask_len, mo.a * 2 + mo.b)
        if not (mo.flag & MM_F_ALL_CHAINS):
            regs = ohit.select_sub(regs, mo.pri_ratio, 2 * io.k, mo.best_n)
            ohit.set_sam_pri(regs)
        ohit.set_mapq(regs, mo.min_chain_score, mo.a, 0, bool(mo.flag & MM_F_SR))
        per_seg_regs[segi] = regs
    # paired: proper-pair flags + PE mapq blend (map.c:1157-1159)
    segi = 0
    for frag in frags:
        if len(frag) == 2 and mo.pe_ori >= 0 and (mo.flag & MM_F_CIGAR):
            ohit.pair(0, mo.pe_bonus, mo.a * 2 + mo.b, mo.a,
                      [frag[0].l_seq, frag[1].l_seq],
                      [per_seg_regs[segi], per_seg_regs[segi + 1]])
        segi += len(frag)

    sam_mode = bool(mo.flag & MM_F_OUT_SAM)
    if sam_mode:
        out.write(samio.sam_header(names, lens, cli_line, __version__))
    # fake merged index for cs/MD (seq fetch spans parts)
    segi = 0
    n_out = 0
    for frag in frags:
        n = len(frag)
        for j, rec in enumerate(frag):
            regs = per_seg_regs[segi + j]
            mate = per_seg_regs[segi + (j + 1) % n] if n > 1 else None
            if regs:
                for r in regs:
                    if (mo.flag & MM_F_NO_PRINT_2ND) and r.id != r.parent:
                        continue
                    if sam_mode:
                        out.write(samio.sam_record(
                            rec.name, rec.seq, rec.qual, r, regs, names,
                            mo.flag, 0, j, n, mate,
                            comment=rec.comment) + "\n")
                    else:
                        out.write(samio.paf_record(
                            rec.name, rec.l_seq, r, names, lens, 0,
                            bool(mo.flag & MM_F_OUT_CG), mo.flag,
                            rec.comment) + "\n")
            elif sam_mode:
                out.write(samio.sam_record(
                    rec.name, rec.seq, rec.qual, None, [], names, mo.flag,
                    0, j, n, mate, comment=rec.comment) + "\n")
            n_out += 1
        segi += n
    _log(verbose, t0, f"mapped {n_out} sequences across {len(parts)} parts")
    return 0


def _run_sr_sam_fast(
    mi: DietIndex,
    mo: MapOptions,
    query: str,
    out_path: str | None,
    n_threads: int,
    verbose: int,
    cli_line: str,
    t0: float,
    batch_reads: int = 8192,
) -> int:
    """SR+SAM hot path: the benched ``map_stream_sam`` pipeline (fused device
    step -> native C batch finish -> SAM bytes) IS the CLI path, so README
    command users get the benchmark's throughput (one-path behavior of the
    reference's main.c:576-672). Budgets are the bench-tuned envelope scaled
    to the observed read length; out-of-envelope reads retry on the wider
    tier, then the oracle — output is identical to the generic path.

    The length envelope is ADAPTIVE: Lmax starts from the first batch, and
    when later batches accumulate enough length-overflow reads (which map
    correctly but slowly through the scalar oracle) the stream re-tiers to
    a wider compiled Lmax, so a FASTQ whose long reads appear late converges
    to the same fallback rate as a pre-sorted one."""
    from gdiet_tpu.pipeline.shortread import ShortReadMapper

    mesh = None
    if mo.mesh_shape is not None:
        from gdiet_tpu.parallel.dist import make_mesh

        mesh = make_mesh(*mo.mesh_shape)
        _log(verbose, t0, f"multi-chip mesh: data={mo.mesh_shape[0]} "
             f"ref={mo.mesh_shape[1]}")

    rdr = read_fastx(query)
    first: list[SeqRecord] = []
    for rec in rdr:
        first.append(rec)
        if len(first) >= batch_reads:
            break
    bout = (open(out_path, "wb") if out_path and out_path != "-"
            else sys.stdout.buffer)
    bout.write(samio.sam_header(
        mi.names, [int(x) for x in mi.lengths], cli_line, __version__
    ).encode())
    n_mapped = 0
    if first:
        # fixed compiled batch shape: full size for big inputs, the next
        # power of two for small ones (tail batches are padded)
        B = 1
        while B < len(first):
            B <<= 1
        B = min(B, batch_reads)
        HARD_CAP = 304  # reads beyond this always take the oracle

        def _round16(n: int) -> int:
            return min(HARD_CAP, -(-max(n, 64) // 16) * 16)

        def make_mapper(lmax: int) -> ShortReadMapper:
            scale = -(-lmax // 160)  # bench budgets are tuned at Lmax=160
            return ShortReadMapper(
                mi, mo, max_read_len=lmax, seed_budget=32 * scale,
                shift_seed_budget=16 * scale, hit_budget=64 * scale,
                dp_frac=0.3125, mesh=mesh, n_threads=n_threads,
                profile_stages=verbose >= 4,
            )

        Lmax = _round16(max(r.l_seq for r in first))
        mapper = make_mapper(Lmax)
        counter = [0]
        # re-tier bookkeeping: overflow reads SINCE the current tier was
        # built; a handful of long reads is cheaper on the oracle than a
        # recompile, a steady stream is not
        tier = {"over": 0, "max_len": 0, "hit": False}
        retier_at = max(32, B // 64)
        pending: list = []

        def raw_batches():
            buf = first
            for rec in rdr:
                if len(buf) == B:
                    yield buf
                    buf = []
                buf.append(rec)
            if len(buf) == B:
                yield buf
            elif buf:
                yield (buf + [buf[0]] * (B - len(buf)), len(buf))

        src = raw_batches()

        def gated():
            """Pass batches through until the overflow budget trips; then
            stash the triggering batch and end the stream so the caller can
            rebuild the mapper at the widened Lmax and resume."""
            while pending:
                counter[0] += (pending[0][1] if isinstance(pending[0], tuple)
                               else len(pending[0]))
                yield pending.pop(0)
            for b in src:
                batch, n = b if isinstance(b, tuple) else (b, len(b))
                if Lmax < HARD_CAP:
                    cap = min(300, Lmax)
                    longs = [r.l_seq for r in batch[:n]
                             if cap < r.l_seq <= HARD_CAP]
                    if longs:
                        tier["over"] += len(longs)
                        tier["max_len"] = max(tier["max_len"], max(longs))
                        if tier["over"] >= retier_at:
                            pending.append(b)
                            tier["hit"] = True
                            return
                counter[0] += n
                yield b

        # per-stage profile (DEVICE_FUSED/HOST_FINISH + oracle stages) is
        # recorded inside the mapper; total wall time is the Real time line
        while True:
            tier["hit"] = False
            for blob in mapper.map_stream_sam(gated()):
                bout.write(blob)
            if not tier["hit"]:
                break
            new_lmax = _round16(tier["max_len"])
            _log(verbose, t0,
                 f"re-tier: Lmax {Lmax} -> {new_lmax} after {tier['over']} "
                 f"length-overflow reads (oracle-mapped; output unchanged)")
            Lmax = new_lmax
            tier["over"], tier["max_len"] = 0, 0
            mapper = make_mapper(Lmax)
        n_mapped = counter[0]
    if bout is not sys.stdout.buffer:
        bout.close()
    _log(verbose, t0, f"mapped {n_mapped} sequences")
    if verbose >= 3:
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
        print(f"[M::gdiet] Version: {__version__}", file=sys.stderr)
        print(f"[M::gdiet] CMD: {cli_line}", file=sys.stderr)
        print(
            f"[M::gdiet] Real time: {time.perf_counter() - t0:.3f} sec; "
            f"CPU: {time.process_time():.3f} sec; "
            f"Peak RSS: {rss:.3f} GB", file=sys.stderr,
        )
        PROFILE.report(sys.stderr)
    return 0


def _run_sr_pe_sam_fast(
    mi: DietIndex,
    mo: MapOptions,
    q1: str,
    q2: str,
    out_path: str | None,
    n_threads: int,
    verbose: int,
    cli_line: str,
    t0: float,
    batch_pairs: int = 4096,
) -> int:
    """Paired-end SR+SAM hot path: both ends of each pair map as ordinary
    fused-step segments; pairing (mm_pair, pe.c:76-177) + mate-field SAM
    writing (format.c:432-530) run in one native C call per batch
    (pe_finish_batch). Output is identical to the generic per-record path."""
    from gdiet_tpu.pipeline.shortread import ShortReadMapper

    it1, it2 = read_fastx(q1), read_fastx(q2)
    first: list[tuple] = []
    odd: list[SeqRecord] = []  # unpaired leftovers (file length mismatch)
    for r1 in it1:
        r2 = next(it2, None)
        if r2 is None:
            odd.append(r1)
            break
        first.append((r1, r2))
        if len(first) >= batch_pairs:
            break
    bout = (open(out_path, "wb") if out_path and out_path != "-"
            else sys.stdout.buffer)
    bout.write(samio.sam_header(
        mi.names, [int(x) for x in mi.lengths], cli_line, __version__
    ).encode())
    n_mapped = 0
    if first:
        P = 1
        while P < len(first):
            P <<= 1
        P = min(P, batch_pairs)
        L0 = max(max(a.l_seq, b.l_seq) for a, b in first)
        Lmax = min(304, -(-max(L0, 64) // 16) * 16)
        scale = -(-Lmax // 160)
        mapper = ShortReadMapper(
            mi, mo, max_read_len=Lmax, seed_budget=32 * scale,
            shift_seed_budget=16 * scale, hit_budget=64 * scale,
            dp_frac=0.3125, n_threads=n_threads,
        )

        counter = [0]

        def batches():
            buf = first
            for r1 in it1:
                r2 = next(it2, None)
                if r2 is None:
                    odd.append(r1)
                    break
                if len(buf) == P:
                    counter[0] += 2 * len(buf)
                    yield buf
                    buf = []
                buf.append((r1, r2))
            counter[0] += 2 * len(buf)
            if len(buf) == P:
                yield buf
            elif buf:
                yield (buf + [buf[0]] * (P - len(buf)), len(buf))

        for blob in mapper.map_stream_sam_pe(batches()):
            bout.write(blob)
        n_mapped = counter[0]
        for rec in odd:  # trailing unpaired records map single-end
            bout.write(mapper._oracle_sam(rec, 0))
            n_mapped += 1
        for r2 in it2:
            bout.write(mapper._oracle_sam(r2, 0))
            n_mapped += 1
    if bout is not sys.stdout.buffer:
        bout.close()
    _log(verbose, t0, f"mapped {n_mapped} sequences")
    if verbose >= 3:
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
        print(f"[M::gdiet] Version: {__version__}", file=sys.stderr)
        print(f"[M::gdiet] CMD: {cli_line}", file=sys.stderr)
        print(
            f"[M::gdiet] Real time: {time.perf_counter() - t0:.3f} sec; "
            f"CPU: {time.process_time():.3f} sec; "
            f"Peak RSS: {rss:.3f} GB", file=sys.stderr,
        )
        PROFILE.report(sys.stderr)
    return 0


def run_mapping(
    io: IndexOptions,
    mo: MapOptions,
    variant: str,
    target: str,
    queries: list[str],
    fnw: str | None = None,
    out_path: str | None = None,
    n_threads: int = 3,
    verbose: int = 3,
    cli_line: str = "gdiet",
    max_read_len: int | None = None,
) -> int:
    t0 = time.perf_counter()

    # multi-host bring-up (SURVEY.md §5.8): join the pod when the driver
    # exports coordinator env vars (jax.distributed; NCCL collectives)
    import os as _os

    if _os.environ.get("GDIET_COORDINATOR"):
        from gdiet_tpu.parallel.dist import init_distributed

        init_distributed(
            _os.environ["GDIET_COORDINATOR"],
            int(_os.environ.get("GDIET_NUM_PROCESSES", "1")),
            int(_os.environ.get("GDIET_PROCESS_ID", "0")),
        )
        _log(verbose, t0,
             f"joined jax.distributed as process "
             f"{_os.environ.get('GDIET_PROCESS_ID', '0')}")

    # multi-part split mapping (-I small + --split-prefix)
    if mo.split_prefix and not DietIndex.is_index(target):
        total = sum(r.l_seq for r in read_fastx(target))
        if total > io.batch_size:
            out = open(out_path, "w") if out_path and out_path != "-" else sys.stdout
            rc = run_split_mapping(io, mo, variant, target, queries, out,
                                   verbose, cli_line, max_read_len, t0)
            if out is not sys.stdout:
                out.close()
            return rc

    mi = load_or_build_index(target, io, verbose, t0)
    if fnw:
        mi.save(fnw)
        _log(verbose, t0, f"dumped the index to {fnw}")
        if not queries:
            return 0

    sam_mode = bool(mo.flag & MM_F_OUT_SAM)

    # SR + plain SAM single-end runs take the benched fused path (native
    # batch finish); features the native writer doesn't cover (PE, MD/cs,
    # long-CIGAR tag, comment copying, --print-seeds, sdust) use the
    # per-record Python writer below
    from gdiet_tpu import debug as _debug
    from gdiet_tpu import native as _native
    from gdiet_tpu.config import (
        MM_F_COPY_COMMENT, MM_F_OUT_CS, MM_F_OUT_CS_LONG, MM_F_OUT_MD,
    )

    if (
        variant == "sr" and sam_mode and len(queries) == 1
        and mo.split_len <= 0 and _native.lib is not None
        and not (mo.flag & (MM_F_COPY_COMMENT | MM_F_OUT_MD | MM_F_OUT_CS
                            | MM_F_OUT_CS_LONG | MM_F_OUT_CG))
        and not _debug.enabled() and mo.sdust_thres <= 0
        and max_read_len is None
    ):
        return _run_sr_sam_fast(mi, mo, queries[0], out_path, n_threads,
                                verbose, cli_line, t0)
    if (
        variant == "sr" and sam_mode and len(queries) == 2
        and mo.split_len <= 0 and _native.lib is not None
        and not _os.environ.get("GDIET_NO_PE_FAST")
        and mo.pe_ori >= 0 and (mo.flag & MM_F_CIGAR)
        and not (mo.flag & (MM_F_COPY_COMMENT | MM_F_OUT_MD | MM_F_OUT_CS
                            | MM_F_OUT_CS_LONG | MM_F_OUT_CG))
        and not _debug.enabled() and mo.sdust_thres <= 0
        and max_read_len is None and mo.mesh_shape is None
    ):
        return _run_sr_pe_sam_fast(mi, mo, queries[0], queries[1], out_path,
                                   n_threads, verbose, cli_line, t0)

    out = open(out_path, "w") if out_path and out_path != "-" else sys.stdout

    if variant == "sr":
        from gdiet_tpu.pipeline.shortread import ShortReadMapper

        mesh = None
        if mo.mesh_shape is not None:
            from gdiet_tpu.parallel.dist import make_mesh

            mesh = make_mesh(*mo.mesh_shape)
            _log(verbose, t0,
                 f"multi-chip mesh: data={mo.mesh_shape[0]} "
                 f"ref={mo.mesh_shape[1]}")
        mapper = ShortReadMapper(mi, mo, max_read_len=max_read_len or 256,
                                 mesh=mesh, n_threads=n_threads)
    else:
        from gdiet_tpu.pipeline.longread import LongReadMapper

        lr_mesh = None
        if mo.mesh_shape is not None:
            from gdiet_tpu.parallel.dist import make_mesh

            lr_mesh = make_mesh(*mo.mesh_shape)
            _log(verbose, t0, f"multi-chip mesh: data={mo.mesh_shape[0]} "
                 f"ref={mo.mesh_shape[1]}")
        mapper = LongReadMapper(mi, mo, n_threads=n_threads, mesh=lr_mesh)

    if sam_mode:
        out.write(samio.sam_header(
            mi.names, [int(x) for x in mi.lengths], cli_line, __version__
        ))

    names = mi.names
    lens = [int(x) for x in mi.lengths]
    n_mapped = 0

    def _write(rec, r, regs, seg_idx=0, n_seg=1, mate_regs=None):
        if sam_mode:
            out.write(samio.sam_record(
                rec.name, rec.seq, rec.qual, r, regs or [], names, mo.flag,
                0, seg_idx, n_seg, mate_regs, index=mi,
                comment=rec.comment) + "\n")
        elif r is not None:
            out.write(samio.paf_record(
                rec.name, rec.l_seq, r, names, lens, 0,
                bool(mo.flag & MM_F_OUT_CG), mo.flag, rec.comment) + "\n")
        elif mo.flag & 0x200000:  # MM_F_PAF_NO_HIT
            out.write(samio.paf_record(rec.name, rec.l_seq, None, names, lens,
                                       0, False, mo.flag, rec.comment)
                      + "\n")

    def emit_frags(frags, results):
        """Per-fragment output with mate fields (worker_pipeline step 2,
        map.c:1208-1280)."""
        nonlocal n_mapped
        k = 0
        for frag in frags:
            n = len(frag)
            frag_res = results[k : k + n]
            k += n
            for j, rec in enumerate(frag):
                n_mapped += 1
                regs = frag_res[j]
                mate = frag_res[(j + 1) % n] if n > 1 else None
                if regs:
                    for r in regs:
                        if (mo.flag & MM_F_NO_PRINT_2ND) and r.id != r.parent:
                            continue
                        _write(rec, r, regs, j, n, mate)
                else:
                    _write(rec, None, [], j, n, mate)

    query_groups = [queries] if len(queries) == 2 else [[q] for q in queries]
    for group in query_groups:
        frag_batches = list(read_frag_batches(group, mo.mini_batch_size))
        if mo.split_len > 0:  # --split-reads (ultralong ONT chunking)
            from gdiet_tpu.io.fastx import split_ultralong

            frag_batches = [
                [[c] for frag in fb for rec in frag
                 for c in split_ultralong([rec], mo.split_len)]
                for fb in frag_batches
            ]

        # flatten segments for the batched mapper; pe_ori-revcomp paired
        # segments before mapping and flip coordinates back after
        # (worker_for, map.c:1057-1090)
        flat_batches = []
        flips: list[list[int]] = []
        for fb in frag_batches:
            flat: list = []
            flip: list[int] = []
            for frag in fb:
                for j, rec in enumerate(frag):
                    if len(frag) == 2 and (
                        (j == 0 and (mo.pe_ori >> 1) & 1)
                        or (j == 1 and mo.pe_ori & 1)
                    ):
                        flat.append(SeqRecord(
                            rec.name, samio.revcomp(rec.seq),
                            rec.qual[::-1] if rec.qual else None, rec.comment))
                        flip.append(len(flat) - 1)
                    else:
                        flat.append(rec)
            flat_batches.append(flat)
            flips.append(flip)

        # per-stage profile is recorded inside the mapper/oracle stages
        for fb, flat, flip, results in zip(
            frag_batches, flat_batches, flips, mapper.map_stream(flat_batches)
        ):
            # proper-pair selection + PE mapq blend on MAPPING-orientation
            # regs (mm_pair, pe.c:76-177: the s^rev key bit expects the
            # pe_ori-revcomp'd segment's regs BEFORE the strand flip-back).
            # The reference's own normal PE path never maps R2 at all —
            # mm_map_frag reads qlen_sum bytes from seqs[0] (a heap
            # overread) and never writes regs[1] (map.c:598-744) — so we
            # deliberately do NOT replicate that undefined behavior: both
            # ends map independently through the golden-proven single-end
            # pipeline and are then paired with pe.c's semantics.
            if mo.pe_ori >= 0 and (mo.flag & MM_F_CIGAR):
                from gdiet_tpu.oracle import hit as ohit

                # the reference's frag_gap is never computed in GDiet;
                # bound pairs by the frag-mode fragment budget instead
                # (-F / max_frag_len, 800 default — map.c:621-622)
                gap = (mo.max_gap_ref if mo.max_gap_ref >= 0
                       else max(mo.max_gap, mo.max_frag_len or 800))
                kk = 0
                for frag in fb:
                    if len(frag) == 2 and results[kk] is not None \
                            and results[kk + 1] is not None:
                        ohit.pair(
                            gap, mo.pe_bonus, mo.a * 2 + mo.b, mo.a,
                            [flat[kk].l_seq, flat[kk + 1].l_seq],
                            [results[kk], results[kk + 1]],
                        )
                    kk += len(frag)
            for idx in flip:  # flip back to the original read strand
                qlen = flat[idx].l_seq
                for r in results[idx] or []:
                    r.qs, r.qe = qlen - r.qe, qlen - r.qs
                    r.rev = 0 if r.rev else 1
            emit_frags(fb, results)
        _log(verbose, t0, f"mapped {n_mapped} sequences")

    if out is not sys.stdout:
        out.close()
    if verbose >= 3:
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
        print(f"[M::gdiet] Version: {__version__}", file=sys.stderr)
        print(f"[M::gdiet] CMD: {cli_line}", file=sys.stderr)
        print(
            f"[M::gdiet] Real time: {time.perf_counter() - t0:.3f} sec; "
            f"CPU: {time.process_time():.3f} sec; "
            f"Peak RSS: {rss:.3f} GB", file=sys.stderr,
        )
        PROFILE.report(sys.stderr)
    return 0
