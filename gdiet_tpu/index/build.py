"""Diet minimizer index: device build, CSR layout, lookup, serialization.

Device re-design of the reference's bucketed khash index
(GDiet-ShortReads/index.c): instead of 2^14 buckets of open-address hash
tables (index.c:29-34,216-271), the index is three dense arrays —

  keys      [K]   uint64  sorted unique minimizer hash keys (x >> 8)
  starts    [K+1] int64   CSR offsets into positions
  positions [P]   uint64  packed hits (rid<<32 | pos<<1 | strand), sorted
                          ascending within each key (index.c:255-257)

so mm_idx_get (index.c:84-100) becomes a batched binary search + gather and
the whole structure lives in HBM. The reference sequence is kept as nt4
codes for the alignment stage's window gathers (mm_idx_getseq,
index.c:157-188); mm_idx_dump/load (index.c:480-571) becomes an .npz
checkpoint. Occurrence quantile mm_idx_cal_max_occ (index.c:190-210) is a
partition over per-key counts.

Construction runs the device sketch (ops/sketch.py) over fixed-size chunks
of each sequence with (2w+k) overlap — enough context for the emitted-mask
to be exact at chunk interiors — then a single sort builds the CSR arrays.
"""

from __future__ import annotations

import json
from collections.abc import Iterable  # noqa: F401 (annotation)
from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from gdiet_tpu import pattern as pat
from gdiet_tpu.config import IndexOptions
from gdiet_tpu.ops.sketch import sketch_emit_build
from gdiet_tpu.oracle.sketch import seq_to_code

CHUNK = 1 << 14  # diet positions per row
GROUP = 64  # rows per device call

# set by eval/profile tooling: {"stage","dispatch","fetch","collect"} wall
# accumulators + overflow count for _sketch_sequence (None = off)
BUILD_PROF: dict | None = None


@dataclass
class DietIndex:
    k: int
    w: int
    pattern: str
    names: list[str]
    lengths: np.ndarray  # [n_seq] int64
    seq_offsets: np.ndarray  # [n_seq] int64 offsets into codes
    codes: np.ndarray  # [total_len] uint8 nt4 codes (4 = N)
    keys: np.ndarray  # [K] uint64 sorted unique
    starts: np.ndarray  # [K+1] int64
    positions: np.ndarray  # [P] uint64
    flag: int = 0
    _device: dict = field(default_factory=dict, repr=False)

    @property
    def n_seq(self) -> int:
        return len(self.names)

    # ---- queries ----------------------------------------------------------
    def get(self, minier: int) -> np.ndarray:
        """mm_idx_get analog for host callers."""
        i = np.searchsorted(self.keys, np.uint64(minier))
        if i < len(self.keys) and self.keys[i] == np.uint64(minier):
            return self.positions[self.starts[i] : self.starts[i + 1]]
        return np.zeros((0,), dtype=np.uint64)

    def lookup(self, q: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Batched mm_idx_get: query keys [..] -> (start, count) int64.
        Missing keys get count 0."""
        keys = self.device("keys")
        idx = jnp.searchsorted(keys, q)
        idx_c = jnp.clip(idx, 0, len(self.keys) - 1)
        found = (len(self.keys) > 0) & (jnp.take(keys, idx_c) == q)
        starts = self.device("starts")
        s = jnp.take(starts, jnp.clip(idx, 0, len(self.keys)))
        e = jnp.take(starts, jnp.clip(idx + 1, 0, len(self.keys)))
        cnt = jnp.where(found, e - s, 0)
        return jnp.where(found, s, 0), cnt

    def getseq(self, rid: int, st: int, en: int, rev: bool = False) -> np.ndarray:
        """mm_idx_getseq2 (host side)."""
        if len(self.codes) == 0 and int(self.lengths.sum()) > 0:
            raise ValueError(
                "index was built with --idx-no-seq (MM_I_NO_SEQ): reference "
                "bases are unavailable; alignment/cs/MD need a full index"
            )
        off = int(self.seq_offsets[rid])
        ln = int(self.lengths[rid])
        en = min(en, ln)
        if not rev:
            return self.codes[off + st : off + en].copy()
        frag = self.codes[off + ln - en : off + ln - st][::-1]
        return np.where(frag < 4, 3 - frag, frag).astype(np.uint8)

    def device(self, name: str) -> jnp.ndarray:
        """Device-resident copy of an index array (cached)."""
        if name not in self._device:
            self._device[name] = jnp.asarray(getattr(self, name))
        return self._device[name]

    def device_packed(self):
        """Device-resident 2-bit pack of ``codes`` + N bitmask (cached,
        shared by every mapper on this index — see
        pipeline.device_step.pack_ref_codes). 4x less HBM than uint8."""
        if "packed" not in self._device:
            from gdiet_tpu.pipeline.device_step import pack_ref_codes

            packed, nmask = pack_ref_codes(self.codes)
            self._device["packed"] = jnp.asarray(packed)
            self._device["nmask"] = (
                jnp.asarray(nmask) if nmask is not None else None
            )
        return self._device["packed"], self._device["nmask"]

    def device_cuckoo(self):
        """Device-resident cuckoo probe table over (keys, packed CSR vals),
        cached and shared by every mapper on this index (index/cuckoo.py).
        Returns (tbl_keys, tbl_vals, c1, c2, n_buckets_per_side)."""
        if "cuckoo" not in self._device:
            from gdiet_tpu.index.cuckoo import build_cuckoo

            tk, tv, c1, c2, lt = build_cuckoo(self.keys, lookup_vals(self.starts))
            self._device["cuckoo"] = (
                jnp.asarray(tk), jnp.asarray(tv), c1, c2, lt
            )
        return self._device["cuckoo"]

    def device_cuckoo_kv(self):
        """Merged-row cuckoo table: each bucket holds (k0..k3, v0..v3) so
        ONE row gather per side serves both the key compare and the value
        fetch — half the gather rows of the split-table layout. Shipped as
        [rows, 128] u64 — 16 buckets per row, the probe picks its bucket's
        8 lanes in-register; this layout was shaped for a 128-lane tiled
        device memory and moves 1 KB per probe to use 64 B on a GPU
        (ROADMAP, Speed).
        Built host-side (no transient 2x HBM peak) and cached.
        Returns (tbl_kv [rows,128] u64, c1, c2, n_buckets_per_side)."""
        if "cuckoo_kv" not in self._device:
            from gdiet_tpu.index.cuckoo import build_cuckoo

            tk, tv, c1, c2, lt = build_cuckoo(self.keys, lookup_vals(self.starts))
            kv = np.concatenate(
                [np.asarray(tk).reshape(-1, 4), np.asarray(tv).reshape(-1, 4)],
                axis=1,
            ).ravel()
            pad = (-len(kv)) % 128
            if pad:  # sentinel keys: EMPTY never equals a real query
                kv = np.concatenate(
                    [kv, np.full(pad, 0xFFFFFFFFFFFFFFFF, np.uint64)]
                )
            self._device["cuckoo_kv"] = (
                jnp.asarray(kv.reshape(-1, 128)), c1, c2, lt
            )
        return self._device["cuckoo_kv"]

    def cal_max_occ(self, f: float) -> int:
        """mm_idx_cal_max_occ (index.c:190-210)."""
        if f <= 0.0 or len(self.keys) == 0:
            return 2**31 - 1
        counts = (self.starts[1:] - self.starts[:-1]).astype(np.uint32)
        n = len(counts)
        idx = min(int((1.0 - f) * n), n - 1)
        return int(np.partition(counts, idx)[idx]) + 1

    def derive_mid_occ(self, mo) -> int:
        """mm_mapopt_update (options.c:64-76)."""
        if mo.mid_occ > 0:
            return mo.mid_occ
        mid = self.cal_max_occ(mo.mid_occ_frac)
        mid = max(mid, mo.min_mid_occ)
        if mo.max_mid_occ > mo.min_mid_occ:
            mid = min(mid, mo.max_mid_occ)
        return mid

    def stats(self) -> dict:
        """mm_idx_stat analog (index.c:102-127)."""
        counts = self.starts[1:] - self.starts[:-1]
        n = len(self.keys)
        total = int(self.lengths.sum())
        return {
            "kmer_size": self.k,
            "skip": self.w,
            "n_seq": self.n_seq,
            "distinct_minimizers": n,
            "pct_singletons": 100.0 * float((counts == 1).sum()) / n if n else 0.0,
            "avg_occurrences": float(counts.mean()) if n else 0.0,
            "avg_spacing": total / float(counts.sum()) if n else 0.0,
            "total_length": total,
        }

    # ---- serialization (mm_idx_dump/load analog) --------------------------
    MAGIC = "GDI\x01"

    def save(self, path: str):
        """Serialize with the sequence 2-bit packed + N bitmask (the disk
        analog of the reference's 4-bit mm_idx_dump pack, index.c:480-517,
        at twice the density)."""
        from gdiet_tpu.pipeline.device_step import pack_ref_codes

        meta = {
            "magic": self.MAGIC,
            "k": self.k,
            "w": self.w,
            "pattern": self.pattern,
            "flag": self.flag,
            "names": self.names,
            "codes_len": int(len(self.codes)),
        }
        packed, nmask = pack_ref_codes(self.codes)
        np.savez(
            path,
            meta=json.dumps(meta),
            lengths=self.lengths,
            seq_offsets=self.seq_offsets,
            codes_packed=packed,
            codes_nmask=(nmask if nmask is not None
                         else np.zeros(0, np.uint8)),
            keys=self.keys,
            starts=self.starts,
            positions=self.positions,
        )

    @classmethod
    def load(cls, path: str) -> "DietIndex":
        z = np.load(path, allow_pickle=False)
        meta = json.loads(str(z["meta"]))
        if meta.get("magic") != cls.MAGIC:
            raise ValueError(f"{path}: not a gdiet index")
        if "codes" in z.files:  # pre-pack format
            codes = z["codes"]
        else:
            L = meta["codes_len"]
            packed = z["codes_packed"]
            codes = np.zeros(len(packed) * 4, np.uint8)
            for t in range(4):
                codes[t::4] = (packed >> (2 * t)) & 3
            nmask = z["codes_nmask"]
            if len(nmask):
                bits = np.unpackbits(
                    nmask, bitorder="little"
                )[: len(codes)].astype(bool)
                codes[bits] = 4
            codes = codes[:L]
        return cls(
            k=meta["k"],
            w=meta["w"],
            pattern=meta["pattern"],
            flag=meta["flag"],
            names=list(meta["names"]),
            lengths=z["lengths"],
            seq_offsets=z["seq_offsets"],
            codes=codes,
            keys=z["keys"],
            starts=z["starts"],
            positions=z["positions"],
        )

    @staticmethod
    def is_index(path: str) -> bool:
        """mm_idx_is_idx analog (index.c:573-593)."""
        try:
            z = np.load(path, allow_pickle=False)
            return json.loads(str(z["meta"])).get("magic") == DietIndex.MAGIC
        except Exception:
            return False


def lookup_vals(starts) -> np.ndarray:
    """Packed per-key (start << 24 | count) lookup values: the device CSR
    probe then needs ONE value gather instead of two starts gathers.
    Counts saturate at 2^24-1 — far above any usable mid_occ, and saturated
    keys are dropped by the occurrence filter anyway (seed.c:66)."""
    s = np.asarray(starts, np.uint64)
    cnt = np.minimum(s[1:] - s[:-1], 0xFFFFFF).astype(np.uint64)
    return (s[:-1] << np.uint64(24)) | cnt


def bucket_table(keys: np.ndarray, k: int, max_bits: int = 22):
    """Direct-address bucket index over the sorted key array (the device
    analog of the reference's 2^b hash buckets, index.c:29-34).

    Buckets are the top ``b`` bits of the 2k-bit invertible hash, so they
    respect the global sort order: bucket j covers keys in
    [table[j], table[j+1]). Returns (table [2^b+1] int64, shift, iters) with
    ``iters`` = fixed binary-search depth covering the largest bucket.
    """
    nk = len(keys)
    b = max(8, int(np.ceil(np.log2(nk))) + 2) if nk else 8
    b = min(max_bits, 2 * k, b)
    shift = max(2 * k - b, 0)
    bounds = np.arange((1 << b) + 1, dtype=np.uint64) << np.uint64(shift)
    tbl = np.searchsorted(keys, bounds).astype(np.int64)
    maxb = int(np.max(np.diff(tbl))) if nk else 0
    iters = max(1, int(np.ceil(np.log2(maxb + 1))) + 1)
    return tbl, shift, iters


def _sketch_sequence(codes: np.ndarray, k: int, w: int, pattern: str, rid: int):
    """Run the device sketch over one sequence as batched fixed-size rows
    with (2w+k) overlap. Returns (keys, ys) numpy arrays (unordered).

    The true sequence end needs the strict final-flush rule (mm_sketch's
    l > w+k-1, sketch.c:1760) and is processed as its own single-row call;
    interior rows use the non-strict rule because their artificial ends sit
    inside the next row's ownership window.

    Host-device transfers bound the build, so the loop is shaped around
    bytes moved: H2D ships only the diet codes + per-row scalars
    (real coordinates are re-derived on device from the pattern —
    sketch_emit_build), D2H is one fused (xs|ys) tensor sliced to ~1.5x the
    expected 2/(w+1) minimizer density, and each group's fetch is deferred
    until the NEXT group has been dispatched (double buffering) so host
    staging and device compute overlap the transfers. Rows that overflow
    the sliced budget (pathological duplicate storms) rerun full-width.
    """
    dcodes = pat.diet_codes(codes, pattern, 0)
    D = len(dcodes)
    if D == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    ones_loc = pat.ones_locations(pattern)
    plen = len(pattern)
    ov = 2 * w + k  # context needed for exact emission at interiors
    width = CHUNK + 2 * ov
    starts = list(range(0, D, CHUNK))
    keys_out, ys_out = [], []

    # ~2x the expected 2/(w+1) minimizer density: overflows (which rerun
    # full-width AND pay a one-off full-width compile) should stay in
    # duplicate-storm territory, not merely repetitive sequence
    max_out = int(min(width, 4 * width // (w + 1) + 64))

    import time as _time

    prof = BUILD_PROF
    # one-u64-per-emission D2H (halves the fetch bytes — the measured build
    # bottleneck): hash needs 2k bits, the row-relative position 18
    packed = (2 * k + 18 <= 64) and (width * plen < (1 << 17))

    def dispatch(rows, flush_ge, out_budget=None):
        """rows: list of (start, end); one async device call."""
        t0 = _time.perf_counter()
        G = len(rows)
        budget = out_budget or max_out
        dc = np.full((G, width), 255, np.uint8)
        ns = np.zeros((G,), np.int64)
        los = np.zeros((G,), np.int64)
        bounds = []
        for g, (st, en) in enumerate(rows):
            lo, hi = max(0, st - ov), min(D, en + ov)
            bounds.append((lo, hi, st, en))
            if st == en:  # pure padding row: emit nothing (no overflow risk)
                continue
            n = hi - lo
            dc[g, :n] = dcodes[lo:hi]  # contiguous: the diet gather happened
            ns[g] = n                  # once per sequence (pat.diet_codes)
            los[g] = lo
        t1 = _time.perf_counter()
        xy, cnt = sketch_emit_build(
            jnp.asarray(dc), jnp.asarray(ns), jnp.asarray(los),
            jnp.full((G,), rid, np.int64), k, w, budget,
            ones_loc, plen, final_flush_ge=flush_ge, packed=packed,
        )
        xy.copy_to_host_async()
        cnt.copy_to_host_async()
        t2 = _time.perf_counter()
        if prof is not None:
            prof["stage"] += t1 - t0
            prof["dispatch"] += t2 - t1
        return (rows, flush_ge, budget, bounds, xy, cnt)

    def collect(pending):
        rows, flush_ge, budget, bounds, xy, cnt = pending
        t0 = _time.perf_counter()
        cnt = np.asarray(cnt)
        if budget < width and int(cnt.max(initial=0)) > budget:
            # rare overflow: rerun full-width, synchronously
            if prof is not None:
                prof["fetch"] += _time.perf_counter() - t0
                prof["overflows"] += 1
            collect(dispatch(rows, flush_ge, out_budget=width))
            return
        xy = np.asarray(xy)
        t1 = _time.perf_counter()
        if packed:
            rid64 = np.uint64(rid << 32)
            for g, (lo, hi, st, en) in enumerate(bounds):
                m = int(cnt[g])
                pk = xy[g, :m]
                base2 = np.uint64(
                    int(pat.real_location(lo, pattern, 0)) << 1)
                posbit = (pk & np.uint64(0x3FFFF)) + base2
                p_real = (posbit >> np.uint64(1)).astype(np.int64)
                p_diet = pat.diet_location(p_real, pattern, 0)
                own = (p_diet >= st) & (p_diet < en)
                keys_out.append((pk >> np.uint64(18))[own])
                ys_out.append((rid64 | posbit)[own])
            if prof is not None:
                prof["fetch"] += t1 - t0
                prof["collect"] += _time.perf_counter() - t1
            return
        xs, ys = xy[:, :budget], xy[:, budget:]
        for g, (lo, hi, st, en) in enumerate(bounds):
            m = int(cnt[g])
            xg, yg = xs[g, :m], ys[g, :m]
            p_real = (yg & np.uint64(0xFFFFFFFF)) >> np.uint64(1)
            # real -> diet in closed form (pattern periodicity): no
            # searchsorted, no materialized gather map
            p_diet = pat.diet_location(p_real.astype(np.int64), pattern, 0)
            own = (p_diet >= st) & (p_diet < en)
            keys_out.append((xg[own] >> np.uint64(8)).astype(np.uint64))
            ys_out.append(yg[own].astype(np.uint64))
        if prof is not None:
            prof["fetch"] += t1 - t0
            prof["collect"] += _time.perf_counter() - t1

    interior = [(st, min(st + CHUNK, D)) for st in starts[:-1]]
    # keep a few groups in flight (not just one): a single pending group
    # leaves the device idle for a full transfer round trip per collect
    DEPTH = 3
    pending: list = []
    for i in range(0, len(interior), GROUP):
        grp = interior[i : i + GROUP]
        if len(grp) < GROUP:
            grp = grp + [(D, D)] * (GROUP - len(grp))  # pad to one shape
        pending.append(dispatch(grp, flush_ge=True))
        if len(pending) > DEPTH:
            collect(pending.pop(0))
    pending.append(dispatch([(starts[-1], D)], flush_ge=False))
    for p in pending:
        collect(p)
    return np.concatenate(keys_out), np.concatenate(ys_out)


def build_index_parts(
    seqs: list[tuple[str, str]],
    io: IndexOptions,
):
    """Multi-part indexing (mm_idx_reader_read with -I batch_size,
    index.c:624-640): sequences accumulate into parts of ~batch_size bases;
    yields (DietIndex, rid_shift) per part."""
    part: list[tuple[str, str]] = []
    total = 0
    shift = 0
    for name, seq in seqs:
        part.append((name, seq))
        total += len(seq)
        if total >= io.batch_size:
            yield build_index(part, io), shift
            shift += len(part)
            part, total = [], 0
    if part:
        yield build_index(part, io), shift


def build_index(
    seqs: "Iterable[tuple[str, str]] | dict[str, str]",
    io: IndexOptions,
) -> DietIndex:
    """mm_idx_gen analog: sketch every sequence on device, then build CSR.

    ``seqs`` may be any iterable of (name, seq) — pass a GENERATOR for
    large genomes (e.g. streaming read_fastx records): each sequence's
    string is then released right after encoding instead of all of
    GRCh38's strings staying alive through the build; streaming
    matches the reference's one-batch-at-a-time mm_idx_gen pipeline
    (index.c:306-412).

    With MM_I_NO_SEQ (--idx-no-seq, index.c:339-349) the reference skips
    storing the packed sequence — the containment-search workloads' 723x
    space story depends on it; here ``codes`` stays empty and alignment-
    stage features (window gathers, cs/MD) are unavailable.
    """
    from gdiet_tpu.config import MM_I_NO_SEQ

    no_seq = bool(io.flag & MM_I_NO_SEQ)
    items = seqs.items() if isinstance(seqs, dict) else seqs
    names, lengths, offsets, codes_all = [], [], [], []
    all_keys, all_ys = [], []
    off = 0
    k, w = io.k, io.w
    if k * 2 < io.bucket_bits:  # mm_idx_init clamps b, irrelevant for CSR
        pass
    for rid, (name, seq) in enumerate(items):
        codes = seq_to_code(seq) if isinstance(seq, (str, bytes)) else seq
        del seq  # release the ASCII string before sketching (streaming)
        names.append(name)
        lengths.append(len(codes))
        offsets.append(off)
        off += len(codes)
        if not no_seq:
            codes_all.append(codes)
        ks, ys = _sketch_sequence(codes, k, w, io.pattern, rid)
        all_keys.append(ks)
        all_ys.append(ys)
    keys = np.concatenate(all_keys) if all_keys else np.zeros(0, np.uint64)
    ys = np.concatenate(all_ys) if all_ys else np.zeros(0, np.uint64)
    from gdiet_tpu import native

    # radix_sort_128x analog (index.c:225-266): a C LSD radix pass beats
    # np.lexsort by >10x at GRCh38 scale (hundreds of M minimizers).
    # The sketch's analytic emission order is position-monotonic per
    # sequence and rids ascend, so ys is usually ALREADY sorted: one O(n)
    # check lets the stable radix skip its val passes (~half the scatter
    # work at 250M minimizers)
    ys_presorted = len(ys) < 2 or bool(np.all(ys[1:] >= ys[:-1]))
    if not native.radix_sort_kv(keys, ys, vals_presorted=ys_presorted):
        order = np.lexsort((ys, keys))
        keys, ys = keys[order], ys[order]
    if len(keys):
        # keys are sorted: unique boundaries come from one diff pass
        # (np.unique would re-sort the whole array)
        bound = np.empty(len(keys), bool)
        bound[0] = True
        np.not_equal(keys[1:], keys[:-1], out=bound[1:])
        start_idx = np.flatnonzero(bound)
        uniq = keys[start_idx]
    else:
        uniq, start_idx = keys, np.zeros(0, np.int64)
    starts = np.concatenate([start_idx.astype(np.int64), [len(ys)]])
    return DietIndex(
        k=k,
        w=w,
        pattern=io.pattern,
        names=names,
        lengths=np.array(lengths, np.int64),
        seq_offsets=np.array(offsets, np.int64),
        codes=np.concatenate(codes_all) if codes_all else np.zeros(0, np.uint8),
        keys=uniq,
        starts=starts,
        positions=ys,
        flag=io.flag,
    )
