"""Batched short-read mapping pipeline (fused device step + host finish).

Device re-design of GDiet-ShortReads mm_map_frag (map.c:586-1010).
Reads are processed as fixed-shape batches through ONE fused device dispatch
(pipeline/device_step.py): shift inference, query sketch, CSR seed lookup,
hit expansion, location voting, candidate window construction, exact-match
filter and batched banded dual-affine DP all run back to back on device.
The host then backtracks CIGARs, applies the reference's fix-ups and filters
(align.c:259, map.c:956-979), and assigns SAM params (hit.c:494).

Reads that leave the fixed-shape envelope (len > 300, occurrence-streak
selection possible, hit-budget overflow, active query-occurrence filter,
window geometry outside the budget) fall back to the scalar oracle,
preserving exactness everywhere.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from gdiet_tpu.config import MM_F_NO_PRINT_2ND, MapOptions
from gdiet_tpu.index.build import DietIndex
from gdiet_tpu.io.fastx import SeqRecord
from gdiet_tpu.oracle import align as oal
from gdiet_tpu.oracle import sketch as osk
from gdiet_tpu.oracle.pipeline import map_read, set_sam_params
from gdiet_tpu import native
from gdiet_tpu.ops import dp as dpk
from gdiet_tpu.pipeline.device_step import FusedMapper, unpack_outputs, unpack_ops

U32 = 0xFFFFFFFF


@dataclass
class MapResult:
    regs: list  # list[Reg]
    rep_len: int = 0


class ShortReadMapper:
    """Batched device mapper with oracle-exact host fallback."""

    def __init__(
        self,
        index: DietIndex,
        mo: MapOptions,
        max_read_len: int = 256,
        seed_budget: int = 160,
        shift_seed_budget: int = 64,
        hit_budget: int = 2048,
        dp_frac: float = 0.5,
        mesh=None,
        retry_hit_budget: int = 2048,
        retry_batch: int = 512,
        n_threads: int = 1,
        profile_stages: bool = False,
    ):
        self.mi = index
        self.mo = mo
        self.mid_occ = index.derive_mid_occ(mo)
        self.Lmax = max_read_len
        self.mesh = mesh
        if mesh is not None:
            # multi-chip: data-parallel reads x key-range-sharded index with
            # on-device hit merge (parallel/dist.py), same host finish
            from gdiet_tpu.parallel.dist import ShardedFused

            self.fused = ShardedFused(
                index, mo, mesh, Lmax=max_read_len, S=seed_budget,
                S2=shift_seed_budget, A=hit_budget, dp_frac=dp_frac,
            )
        else:
            self.fused = FusedMapper(
                index, mo, Lmax=max_read_len, S=seed_budget,
                S2=shift_seed_budget, A=hit_budget, dp_frac=dp_frac,
            )
        self._oracle_index = None
        self._retry_args = (seed_budget, shift_seed_budget, retry_hit_budget)
        self.retry_batch = retry_batch
        self._retry_fused = None
        # -t: the oracle fallbacks spend their time in numpy/C (which
        # release the GIL), so a thread pool is the kt_for analog for the
        # host finish (kthread.c:54)
        self.n_threads = max(1, n_threads)
        self._pool = None
        # verbose >= 4: re-run each batch cut at the phase boundaries to
        # print the reference's five-stage profile at exit (profile.h:6-28)
        self.profile_stages = profile_stages

    def _map_oracle(self, fn, items):
        if self.n_threads > 1 and len(items) > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(self.n_threads)
            return list(self._pool.map(fn, items))
        return [fn(x) for x in items]

    # ------------------------------------------------------------------
    def _retry_mapper(self):
        """Wider-budget fused variant for reads that overflow the primary
        envelope (hit/DP/seed budgets) — the bucketing-with-overflow-retry
        design from SURVEY.md §7: a second compiled tier keeps repeat-heavy
        reads on device instead of the scalar oracle."""
        S, S2, A2 = self._retry_args
        cfg = self.fused.cfg
        # the tier pays off whenever ANY envelope dimension widens: hit
        # budget, seed budget, or the DP-row budget (dp_frac < 1 makes
        # DP-row overflow the common fallback cause under CLI defaults)
        wider = (A2 > cfg.A) or (min(4 * S, 256) > cfg.S) or (cfg.dp_frac < 1.0)
        if not wider:
            return None
        if self._retry_fused is None:
            # always an UN-meshed single-device mapper: overflow reads are
            # rare, so retrying them locally keeps the mesh path simple
            # while preserving the tier under --mesh (map.c:1094-1163
            # semantics must hold under sharding too)
            self._retry_fused = FusedMapper(
                self.mi, self.mo, Lmax=self.Lmax, S=min(4 * S, 256), S2=S2,
                A=max(A2, cfg.A), dp_frac=1.0,
            )
        return self._retry_fused

    def _retry_batch_regs(self, reads_sub):
        """Map overflow reads through the retry tier; returns
        (regs per read | None where it still fell back)."""
        rf = self._retry_mapper()
        out: list = [None] * len(reads_sub)
        if rf is None:
            return out
        RB = self.retry_batch
        for s0 in range(0, len(reads_sub), RB):
            chunk = reads_sub[s0 : s0 + RB]
            if native.lib is not None:
                codes, lens = native.encode_batch(
                    [r.seq for r in chunk] + [""] * (RB - len(chunk)),
                    self.Lmax,
                )
            else:
                lens = np.zeros(RB, np.int64)
                codes = np.full((RB, self.Lmax), 255, np.uint8)
                for i, r in enumerate(chunk):
                    c = osk.seq_to_code(r.seq)[: self.Lmax]
                    codes[i, : len(c)] = c
                    lens[i] = r.l_seq
            dev = rf(codes, lens)
            # keep the full padded RB rows: _fetch splits the fused device
            # tensor on the DISPATCHED row count (pad rows map zero reads)
            regs_list, fb = self._finish_device(dev, codes, lens, fused=rf)
            for j in range(len(chunk)):
                if not fb[j]:
                    out[s0 + j] = regs_list[j]
        return out

    # ------------------------------------------------------------------
    def _oracle_mi(self):
        """Wrap the device index for the oracle fallback path."""
        if self._oracle_index is None:
            mi = self.mi

            class _Wrap:
                w, k, pattern = mi.w, mi.k, mi.pattern
                names, lengths = mi.names, [int(x) for x in mi.lengths]

                @staticmethod
                def get(minier):
                    return mi.get(minier)

                @staticmethod
                def getseq(rid, st, en, rev=False):
                    return mi.getseq(rid, st, en, rev)

            self._oracle_index = _Wrap()
        return self._oracle_index

    # ------------------------------------------------------------------
    def map_batch(self, reads: list[SeqRecord]) -> list[list[oal.Reg]]:
        state = self._prepare_and_dispatch(reads)
        return self._finish(state)

    def map_stream(self, batches):
        """Pipelined mapping: batch k+1 is dispatched to the device before
        batch k's host finish runs, hiding transfers and the host loop behind
        device compute (the kt_pipeline analog, kthread.c:97-159)."""
        prev = None
        for batch in batches:
            state = self._prepare_and_dispatch(batch)
            if prev is not None:
                yield self._finish(prev)
            prev = state
        if prev is not None:
            yield self._finish(prev)

    # ------------------------------------------------------------------
    def _prepare_and_dispatch(self, reads: list[SeqRecord], sam: bool = False):
        from gdiet_tpu.utils.profile import PROFILE, Stage

        _t0 = time.perf_counter_ns()
        B = len(reads)
        if native.lib is not None:
            codes, lens = native.encode_batch([r.seq for r in reads], self.Lmax)
        else:
            lens = np.array([r.l_seq for r in reads], np.int64)
            codes = np.full((B, self.Lmax), 255, np.uint8)
            for i, r in enumerate(reads):
                codes[i, : r.l_seq] = osk.seq_to_code(r.seq)[: self.Lmax]
        host_only = lens > min(300, self.Lmax)
        from gdiet_tpu import debug

        if debug.enabled():
            # --print-seeds: the stage-trace printfs live in the scalar
            # oracle (the reference forces 1 thread, main.c:290)
            host_only[:] = True
        if self.mo.sdust_thres > 0:
            # -T routing is PER READ (map.c:45-72): a fast C SDUST pass
            # flags reads with any masked interval — only those can have
            # minimizers dropped by mm_dust_minier, so only those take the
            # exact host path; clean reads (the vast majority on real
            # data) stay on the device fast path with byte parity
            host_only |= native.sdust_flags(
                [r.seq for r in reads], self.mo.sdust_thres
            ).astype(bool)
        device_idx = np.where(~host_only)[0]
        dev = None
        if len(device_idx):
            dc, dl = codes[device_idx], lens[device_idx]
            if self.mesh is not None:  # pad to the data-axis multiple
                pad = (-len(device_idx)) % self.fused.n_data
                if pad:
                    dc = np.concatenate(
                        [dc, np.full((pad, self.Lmax), 255, np.uint8)]
                    )
                    dl = np.concatenate([dl, np.zeros(pad, np.int64)])
            # async dispatch: returns immediately with device futures
            # (numpy in: FusedMapper ships ONE combined H2D tensor)
            dev = self.fused(dc, dl)
            # start the device->host copies early so they overlap the next
            # batch's device compute and this batch's host finish (single
            # fused u8 tensor off-mesh; meta+ops pair under a mesh)
            for v in dev.values():
                v.copy_to_host_async()
        PROFILE.add(Stage.HOST_PREP, time.perf_counter_ns() - _t0)
        blobs = None
        if sam and dev is not None and native.lib is not None:
            # prebuild the SAM string blobs NOW — this overlaps the device
            # compute instead of sitting on the blocking finish path
            with PROFILE.stage(Stage.HOST_BLOBS):
                di = device_idx
                blobs = native.make_sr_blobs(
                    [reads[i].name for i in di],
                    [reads[i].seq for i in di],
                    [reads[i].qual or "" for i in di],
                )
        return reads, codes, lens, host_only, device_idx, dev, blobs

    def _finish(self, state) -> list[list[oal.Reg]]:
        reads, codes, lens, host_only, device_idx, dev = state[:6]
        results: list[list[oal.Reg] | None] = [None] * len(reads)
        retry_i: list[int] = []
        if dev is not None:
            dev_results, fb = self._finish_device(
                dev, codes[device_idx], lens[device_idx]
            )
            for j, i in enumerate(device_idx):
                if fb[j]:
                    retry_i.append(i)
                else:
                    results[i] = dev_results[j]
        if retry_i:  # second, wider-budget device tier before the oracle
            retried = self._retry_batch_regs([reads[i] for i in retry_i])
            for i, regs in zip(retry_i, retried):
                if regs is not None:
                    results[i] = regs
                else:
                    host_only[i] = True
        idx = np.where(host_only)[0]
        for i, regs in zip(idx, self._map_oracle(
            lambda i: map_read(self._oracle_mi(), reads[i].seq, self.mo,
                               self.mid_occ, reads[i].name),
            list(idx),
        )):
            results[i] = regs
        return results

    # ------------------------------------------------------------------
    def map_stream_sam(self, batches, rep_len: int = 0):
        """Pipelined mapping straight to SAM text: yields one ``bytes`` blob
        of newline-terminated records per batch (read order preserved).
        The entire host finish — candidate regs, CIGAR fix-ups, filters,
        mm_set_sam_params, record formatting — runs in ONE native C call
        per batch (native/gdiet_native.c sr_finish_batch); only
        out-of-envelope reads take the Python oracle.

        A batch may be a plain list of reads or a ``(reads, n_real)`` tuple:
        callers padding the tail batch to the compiled shape pass the real
        read count and only those reads' records are emitted.

        Also accumulates ``self.stats`` = {"fallback_reads", "n_records"}.
        """
        self.stats = {"fallback_reads": 0, "n_records": 0}
        import queue
        import threading

        from gdiet_tpu.utils.profile import PROFILE, Stage

        q: queue.Queue = queue.Queue(maxsize=2)

        def producer():
            """Device leg (kt_pipeline steps 0+1, kthread.c:97-159): batch
            iteration/IO, encode, dispatch AND the blocking device fetch all
            run here, overlapping the main thread's native finish (ctypes
            releases the GIL, so the two legs genuinely run concurrently;
            the profiler's stage walls therefore overlap and may sum past
            the total)."""
            def _fetch_state(state):
                dev, device_idx = state[5], state[4]
                if dev is None:
                    return None
                with PROFILE.stage(Stage.DEVICE_FUSED):
                    return self._fetch(dev, len(device_idx))

            try:
                prev = None
                for batch in batches:
                    batch, n_real = (batch if isinstance(batch, tuple)
                                     else (batch, len(batch)))
                    state = (*self._prepare_and_dispatch(batch, sam=True),
                             n_real)
                    # one-batch lookahead: batch k+1 is dispatched BEFORE
                    # batch k's blocking fetch, keeping the device busy
                    # through the transfer wait
                    if prev is not None:
                        q.put((prev, _fetch_state(prev)))
                    prev = state
                if prev is not None:
                    q.put((prev, _fetch_state(prev)))
            except BaseException as e:  # surface in the consumer
                q.put(e)
            else:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            state, fetched = item
            yield self._finish_sam(state, rep_len, fetched=fetched)
        t.join()

    def _oracle_sam(self, rec: SeqRecord, rep_len: int) -> bytes:
        """Scalar-oracle mapping + Python SAM formatting for one read."""
        from gdiet_tpu.io import sam as samio

        mo = self.mo
        regs = map_read(self._oracle_mi(), rec.seq, mo, self.mid_occ, rec.name)
        max_idx = self.mi
        lines = []
        if regs:
            for r in regs:
                if (mo.flag & MM_F_NO_PRINT_2ND) and r.id != r.parent:
                    continue
                lines.append(samio.sam_record(
                    rec.name, rec.seq, rec.qual, r, regs, max_idx.names,
                    mo.flag, rep_len, index=max_idx,
                ))
        else:
            lines.append(samio.sam_record(
                rec.name, rec.seq, rec.qual, None, [], max_idx.names,
                mo.flag, rep_len,
            ))
        return ("\n".join(lines) + "\n").encode()

    def _finish_sam(self, state, rep_len: int, fetched=None) -> bytes:
        from gdiet_tpu.config import MM_F_SOFTCLIP

        reads, codes, lens, host_only, device_idx, dev, blobs, n_real = state
        mo = self.mo
        B = len(reads)
        spans: list = [None] * B
        buf = b""
        from gdiet_tpu.utils.profile import PROFILE, Stage

        if self.profile_stages and dev is not None:
            st = self.fused.staged_times(codes[device_idx], lens[device_idx])
            PROFILE.add(Stage.PATTERN_ALIGNMENT, int(st["pattern"] * 1e9))
            PROFILE.add(Stage.SEEDING, int(st["seed"] * 1e9))
            PROFILE.add(Stage.VOTING, int(st["vote"] * 1e9))
            PROFILE.add(Stage.SEQUENCE_ALIGNMENT, int(st["align"] * 1e9))
        if dev is not None:
            if fetched is not None:  # producer thread already fetched
                meta_np, ops_np = fetched
            else:
                with PROFILE.stage(Stage.DEVICE_FUSED):
                    # blocks until the fused dispatch + D2H copies complete:
                    # this is the device's pattern+seed+vote+align time
                    meta_np, ops_np = self._fetch(dev, len(device_idx))
            di = device_idx
            with PROFILE.stage(Stage.HOST_FINISH):
                res = native.sr_finish_batch(
                    meta_np, ops_np, self.fused.cfg.K, self.fused.cfg.Lmax,
                    codes[di], lens[di],
                    None, None, None,  # prebuilt blobs below
                    self.mi.codes, self.mi.seq_offsets,
                    self._ref_names_blob, self._ref_name_offs,
                    mo.a, mo.b, mo.q, mo.e, mo.min_dp_max,
                    0 if (mo.flag & MM_F_NO_PRINT_2ND) else mo.best_n,
                    bool(mo.flag & MM_F_NO_PRINT_2ND),
                    bool(mo.flag & MM_F_SOFTCLIP), rep_len,
                    blobs=blobs,
                )
            if res is None:  # no native library: regs path + Python writer
                results = self._finish(state[:6])
                out = []
                for rec, regs in zip(reads[:n_real], results[:n_real]):
                    out.append(self._regs_to_sam(rec, regs, rep_len))
                return b"".join(out)
            buf, rec_offs, done = res
            with PROFILE.stage(Stage.HOST_ASSEMBLE):
                # fast path: every read device-finished and in order — the
                # whole batch is one contiguous buffer slice (the common
                # case; the span loop below is only for fallback routing)
                if len(device_idx) == B and n_real == B and done.all():
                    end = int(rec_offs[B])
                    self.stats["n_records"] += buf.count(b"\n", 0, end)
                    return memoryview(buf)[:end]
                ro = rec_offs.tolist()
                for j, i in enumerate(di):
                    if done[j]:
                        spans[i] = (ro[j], ro[j + 1])
        retry_regs: dict[int, list] = {}
        retry_i = [i for i in range(n_real)
                   if spans[i] is None and not host_only[i]]
        if retry_i:  # second, wider-budget device tier before the oracle
            retried = self._retry_batch_regs([reads[i] for i in retry_i])
            for i, regs in zip(retry_i, retried):
                if regs is not None:
                    retry_regs[i] = regs
            self.stats["retried_reads"] = (
                self.stats.get("retried_reads", 0) + len(retry_i)
            )
        oracle_i = [i for i in range(n_real)
                    if spans[i] is None and i not in retry_regs]
        oracle_blobs = dict(zip(oracle_i, self._map_oracle(
            lambda i: self._oracle_sam(reads[i], rep_len), oracle_i,
        )))
        with PROFILE.stage(Stage.HOST_ASSEMBLE):
            view = memoryview(buf)
            out = []
            n_fb = 0
            i = 0
            while i < n_real:
                if spans[i] is not None:
                    s0 = spans[i][0]
                    e0 = spans[i][1]
                    while i + 1 < n_real and spans[i + 1] is not None \
                            and spans[i + 1][0] == e0:
                        i += 1
                        e0 = spans[i][1]
                    out.append(view[s0:e0])
                    i += 1
                elif i in retry_regs:
                    out.append(self._regs_to_sam(
                        reads[i], retry_regs[i], rep_len))
                    i += 1
                else:
                    n_fb += 1
                    out.append(oracle_blobs[i])
                    i += 1
            self.stats["fallback_reads"] += n_fb
            blob = b"".join(out)
            self.stats["n_records"] += blob.count(b"\n")
        return blob

    # ------------------------------------------------------------------
    # Paired-end fast path: both ends map as ordinary fused-step segments
    # (even rows R1 / odd rows R2, pe_ori-revcomp'd); pairing + mate-field
    # SAM writing run inside ONE native C call per batch (pe_finish_batch:
    # mm_pair pe.c:76-177 + format.c:432-530).
    # ------------------------------------------------------------------
    def _pe_gap(self) -> int:
        """Pair gap bound: the reference's frag_gap is never computed in
        GDiet; bound by the frag-mode fragment budget (map.c:621-622)."""
        mo = self.mo
        return (mo.max_gap_ref if mo.max_gap_ref >= 0
                else max(mo.max_gap, mo.max_frag_len or 800))

    def _pe_flips(self) -> tuple[int, int]:
        pe_ori = self.mo.pe_ori
        return (pe_ori >> 1) & 1, pe_ori & 1

    def map_stream_sam_pe(self, pair_batches, rep_len: int = 0):
        """Pipelined paired-end mapping straight to SAM text: yields one
        ``bytes`` blob per batch of read PAIRS (order preserved). A batch is
        a list of (r1, r2) ORIGINAL records or a ``(pairs, n_real)`` tuple
        for padded tails. Pairs outside the envelope fall back to the exact
        oracle + Python writer (identical output)."""
        self.stats = {"fallback_reads": 0, "n_records": 0}
        prev = None
        for batch in pair_batches:
            pairs, n_real = (batch if isinstance(batch, tuple)
                             else (batch, len(batch)))
            state = self._prepare_pe(pairs, n_real)
            if prev is not None:
                yield self._finish_pe(prev, rep_len)
            prev = state
        if prev is not None:
            yield self._finish_pe(prev, rep_len)

    def _prepare_pe(self, pairs, n_real: int):
        from gdiet_tpu.io import sam as samio
        from gdiet_tpu.utils.profile import PROFILE, Stage

        _t0 = time.perf_counter_ns()
        f0, f1 = self._pe_flips()
        mseqs: list[str] = []
        for r1, r2 in pairs:
            mseqs.append(samio.revcomp(r1.seq) if f0 else r1.seq)
            mseqs.append(samio.revcomp(r2.seq) if f1 else r2.seq)
        if native.lib is not None:
            codes, lens = native.encode_batch(mseqs, self.Lmax)
        else:
            lens = np.array([len(s) for s in mseqs], np.int64)
            codes = np.full((len(mseqs), self.Lmax), 255, np.uint8)
            for i, s in enumerate(mseqs):
                c = osk.seq_to_code(s)[: self.Lmax]
                codes[i, : len(c)] = c
        host_only_pair = (
            (lens > min(300, self.Lmax)).reshape(-1, 2).any(axis=1)
        )
        dev = self.fused(codes, lens)
        for v in dev.values():
            v.copy_to_host_async()
        PROFILE.add(Stage.HOST_PREP, time.perf_counter_ns() - _t0)
        blobs = None
        if native.lib is not None:
            with PROFILE.stage(Stage.HOST_BLOBS):
                names: list[str] = []
                seqs: list[str] = []
                quals: list[str] = []
                for r1, r2 in pairs:
                    names += [r1.name, r2.name]
                    seqs += [r1.seq, r2.seq]
                    quals += [r1.qual or "", r2.qual or ""]
                blobs = native.make_sr_blobs(names, seqs, quals)
        return pairs, codes, lens, host_only_pair, dev, blobs, n_real

    def _finish_pe(self, state, rep_len: int) -> bytes:
        from gdiet_tpu.config import MM_F_SOFTCLIP
        from gdiet_tpu.utils.profile import PROFILE, Stage

        pairs, codes, lens, host_only, dev, blobs, n_real = state
        mo = self.mo
        P = len(pairs)
        with PROFILE.stage(Stage.DEVICE_FUSED):
            meta_np, ops_np = self._fetch(dev, 2 * P)
        f0, f1 = self._pe_flips()
        res = None
        if blobs is not None:
            with PROFILE.stage(Stage.HOST_FINISH):
                res = native.pe_finish_batch(
                    meta_np, ops_np, self.fused.cfg.K, self.fused.cfg.Lmax,
                    codes, lens,
                    self.mi.codes, self.mi.seq_offsets,
                    self._ref_names_blob, self._ref_name_offs,
                    mo.a, mo.b, mo.q, mo.e, mo.min_dp_max,
                    0 if (mo.flag & MM_F_NO_PRINT_2ND) else mo.best_n,
                    bool(mo.flag & MM_F_NO_PRINT_2ND),
                    bool(mo.flag & MM_F_SOFTCLIP), rep_len,
                    bool(f0), bool(f1), self._pe_gap(), mo.pe_bonus,
                    blobs=blobs,
                )
        with PROFILE.stage(Stage.HOST_ASSEMBLE):
            spans: list = [None] * P
            if res is not None:
                buf, rec_offs, done = res
                ro = rec_offs.tolist()
                for pr in range(min(P, n_real)):
                    if done[pr] and not host_only[pr]:
                        spans[pr] = (ro[pr], ro[pr + 1])
            else:
                buf = b""
        view = memoryview(buf)
        out = []
        n_fb = 0
        i = 0
        while i < n_real:
            if spans[i] is not None:
                s0, e0 = spans[i]
                while i + 1 < n_real and spans[i + 1] is not None \
                        and spans[i + 1][0] == e0:
                    i += 1
                    e0 = spans[i][1]
                out.append(view[s0:e0])
                i += 1
            else:
                n_fb += 1
                out.append(self._oracle_sam_pe(pairs[i], rep_len))
                i += 1
        self.stats["fallback_reads"] += n_fb
        blob = b"".join(out)
        self.stats["n_records"] += blob.count(b"\n")
        return blob

    def _oracle_sam_pe(self, pair, rep_len: int) -> bytes:
        """Exact oracle PE finish for one pair (the generic run_mapping PE
        semantics: map both pe_ori-revcomp'd ends, mm_pair, flip back,
        n_seg=2 records)."""
        from gdiet_tpu.config import MM_F_CIGAR
        from gdiet_tpu.io import sam as samio
        from gdiet_tpu.oracle import hit as ohit

        mo = self.mo
        flips = self._pe_flips()
        recs = list(pair)
        mapped = []
        for j, rec in enumerate(recs):
            if flips[j]:
                mapped.append(SeqRecord(
                    rec.name, samio.revcomp(rec.seq),
                    rec.qual[::-1] if rec.qual else None, rec.comment))
            else:
                mapped.append(rec)
        results = [
            map_read(self._oracle_mi(), m.seq, mo, self.mid_occ, m.name)
            for m in mapped
        ]
        if mo.pe_ori >= 0 and (mo.flag & MM_F_CIGAR):
            ohit.pair(self._pe_gap(), mo.pe_bonus, mo.a * 2 + mo.b, mo.a,
                      [mapped[0].l_seq, mapped[1].l_seq], results)
        for j in range(2):
            if flips[j]:
                qlen = mapped[j].l_seq
                for r in results[j] or []:
                    r.qs, r.qe = qlen - r.qe, qlen - r.qs
                    r.rev = 0 if r.rev else 1
        lines = []
        for j, rec in enumerate(recs):
            regs = results[j]
            mate = results[1 - j]
            if regs:
                for r in regs:
                    if (mo.flag & MM_F_NO_PRINT_2ND) and r.id != r.parent:
                        continue
                    lines.append(samio.sam_record(
                        rec.name, rec.seq, rec.qual, r, regs, self.mi.names,
                        mo.flag, rep_len, j, 2, mate, index=self.mi))
            else:
                lines.append(samio.sam_record(
                    rec.name, rec.seq, rec.qual, None, [], self.mi.names,
                    mo.flag, rep_len, j, 2, mate))
        return ("\n".join(lines) + "\n").encode()

    def _regs_to_sam(self, rec: SeqRecord, regs, rep_len: int) -> bytes:
        from gdiet_tpu.io import sam as samio

        mo = self.mo
        lines = []
        if regs:
            for r in regs:
                if (mo.flag & MM_F_NO_PRINT_2ND) and r.id != r.parent:
                    continue
                lines.append(samio.sam_record(
                    rec.name, rec.seq, rec.qual, r, regs, self.mi.names,
                    mo.flag, rep_len, index=self.mi,
                ))
        else:
            lines.append(samio.sam_record(
                rec.name, rec.seq, rec.qual, None, [], self.mi.names,
                mo.flag, rep_len,
            ))
        return ("\n".join(lines) + "\n").encode()

    def _fetch(self, dev, n_rows: int, fused=None):
        """Device outputs -> (meta i32, ops u8) host arrays. Off-mesh this
        splits the single fused u8 tensor (device_step.unfuse_out); under a
        mesh it fetches the meta/ops pair with shard-index globalization.
        ``n_rows`` must equal the DISPATCHED device batch rows."""
        fused = fused or self.fused
        if "out" in dev:
            return fused.fetch(dev, n_rows)
        if self.mesh is not None and fused is self.fused:
            return self._meta_host(dev, n_rows), np.asarray(dev["ops"])
        return np.asarray(dev["meta"])[:n_rows], np.asarray(dev["ops"])

    def _meta_host(self, dev, n_rows: int) -> np.ndarray:
        """Fetch the meta tensor; under a mesh, globalize each data shard's
        LOCAL opsrow indices into the concatenated ops tensor and drop the
        data-axis padding rows."""
        meta = np.asarray(dev["meta"])
        if self.mesh is None:
            return meta[:n_rows]
        meta = meta.copy()
        K = self.fused.cfg.K
        nd = self.fused.n_data
        Bp = meta.shape[0]
        n2 = self.fused.n2_local(Bp)
        bl = Bp // nd
        cols = slice(3 + 11 * K, 3 + 12 * K)  # opsrow (device_step.PACK_BK)
        for d in range(1, nd):
            blk = meta[d * bl : (d + 1) * bl, cols]
            blk[blk >= 0] += d * n2
        return meta[:n_rows]

    @property
    def _ref_names_blob(self):
        if getattr(self, "_rn_blob", None) is None:
            self._rn_blob, self._rn_offs = native._blob(list(self.mi.names))
        return self._rn_blob

    @property
    def _ref_name_offs(self):
        _ = self._ref_names_blob
        return self._rn_offs

    # ------------------------------------------------------------------
    def _finish_device(self, dev, codes_np, lens_np, fused=None):
        """Host finish from the two packed device tensors.

        Exactly two device->host copies per batch (each transfer has a
        fixed latency): the packed [B, F] meta tensor and the 2-bit
        packed backtracked op streams. Window sequences for the CIGAR
        fix-ups are rebuilt host-side from the local read codes and
        reference codes.
        """
        from gdiet_tpu.utils.profile import PROFILE, Stage

        mo, mi = self.mo, self.mi
        fused = fused or self.fused
        B = len(lens_np)
        K = fused.cfg.K
        with PROFILE.stage(Stage.DEVICE_FUSED):
            meta_np, ops2 = self._fetch(dev, B, fused)
            out = unpack_outputs(meta_np, K)
        _t_host = time.perf_counter_ns()

        fallback = out["fallback"]
        live = out["c_valid"] & ~fallback[:, None]
        rows = out["opsrow"].reshape(-1)
        need = np.where((live & ~out["exact"]).reshape(-1) & (rows >= 0))[0]
        cigs_by_n: dict[int, list] = {}
        if len(need):
            op_rows = unpack_ops(ops2[rows[need]])
            fin_i = out["fin_i"].reshape(-1)[need]
            fin_j = out["fin_j"].reshape(-1)[need]
            lens_n = out["length"].reshape(-1)[need]
            sub = None
            if native.lib is not None:
                sub = native.rle_ops(op_rows, fin_i, fin_j, lens_n)
            if sub is None:
                sub = dpk.cigars_from_ops(op_rows, fin_i, fin_j, lens_n)
            cigs_by_n = dict(zip(need.tolist(), sub))

        regs_per_read: list[list[oal.Reg]] = [[] for _ in range(B)]
        scan_jobs: list[tuple] = []  # (Reg, qwin, twin) awaiting rescoring
        cand: list[tuple] = []  # (read index, Reg) in candidate order
        for i in range(B):
            if fallback[i]:
                continue
            qlen = int(lens_np[i])
            for c in range(K):
                if not live[i, c]:
                    continue
                n = i * K + c
                length = int(out["length"][i, c])
                rev = bool(out["c_strand"][i, c])
                so, eo = int(out["so"][i, c]), int(out["eo"][i, c])
                ts, te = int(out["ts"][i, c]), int(out["te"][i, c])
                chrom = int(out["chrom"][i, c])
                if out["exact"][i, c]:
                    # exact windows skip fix_cigar/update_extra: a single
                    # all-match op has mlen = blen = length - n_ambi and
                    # dp_max = a * mlen (ambiguous bases score 0)
                    ez_score = qlen * mo.a
                    off = int(mi.seq_offsets[chrom])
                    twin = mi.codes[off + ts : off + te + 1]
                    n_ambi = int((twin > 3).sum())
                    r = oal.Reg(
                        rid=chrom, score=ez_score, qs=so, qe=eo + 1,
                        rs=ts, re=te + 1, rev=rev,
                        cigar=[(length, oal.CIGAR_MATCH)],
                        dp_score=ez_score, blen=length - n_ambi,
                        mlen=length - n_ambi, n_ambi=n_ambi,
                        dp_max=mo.a * (length - n_ambi),
                    )
                else:
                    ez_score = int(out["dp_score"][i, c])
                    if out["opsrow"][i, c] == -2:  # substitution-only all-M
                        cigar = [(length, oal.CIGAR_MATCH)]
                    else:
                        cigar = cigs_by_n.get(n, [])
                    r = oal.Reg(
                        rid=chrom, score=ez_score, qs=so, qe=eo + 1,
                        rs=ts, re=te + 1, rev=rev, cigar=list(cigar),
                        dp_score=ez_score,
                    )
                    if rev:
                        qwin = (codes_np[i, so : eo + 1][::-1]) ^ 3
                    else:
                        qwin = codes_np[i, so : eo + 1]
                    off = int(mi.seq_offsets[chrom])
                    twin = mi.codes[off + ts : off + te + 1]
                    # fix_cigar + rescoring run in ONE native call for the
                    # whole batch after this loop; the clip filter below
                    # needs the fixed coordinates, so candidates are only
                    # collected here
                    scan_jobs.append((r, qwin, twin))
                cand.append((i, r))

        if scan_jobs:
            oal.update_extra_many(scan_jobs, mo.a, mo.b, mo.q, mo.e)

        for i, r in cand:
            qlen = int(lens_np[i])
            clip0 = qlen - r.qe if r.rev else r.qs
            clip1 = r.qs if r.rev else qlen - r.qe
            if not (clip0 < qlen and clip1 < qlen) or r.dp_score < mo.min_dp_max:
                continue
            lst = regs_per_read[i]
            lst.append(r)
            k = len(lst) - 1
            while k > 0 and lst[k].score > lst[k - 1].score:
                lst[k], lst[k - 1] = lst[k - 1], lst[k]
                k -= 1

        max_nb_sec = 0 if (mo.flag & MM_F_NO_PRINT_2ND) else mo.best_n
        for i in range(B):
            if not fallback[i] and regs_per_read[i]:
                set_sam_params(regs_per_read[i], int(lens_np[i]), mo.a, max_nb_sec)
        PROFILE.add(Stage.HOST_FINISH, time.perf_counter_ns() - _t_host)
        return regs_per_read, fallback
