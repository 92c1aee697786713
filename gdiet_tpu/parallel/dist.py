"""Multi-chip mapping: data-parallel reads x key-range-sharded index.

The reference is a single pthread process; its only multi-shard construct is
the multi-part index whose per-part hits are merged on disk
(GDiet-ShortReads/splitidx.c, map.c:1094-1163). This design replaces that
with a 2-D device mesh (SURVEY.md §2.6/§5.8):

  data axis — read batches are sharded across devices (the kt_for analog);
  ref axis  — the CSR minimizer index is split into contiguous key ranges,
              one shard per device. Seed lookups run against the local shard
              only; global per-seed occurrence counts come from a ``psum``
              and per-shard hit streams are merged with ``all_gather`` +
              re-sort before voting (the device analog of merge_hits).

Everything runs inside one ``shard_map`` over the fused step
(pipeline/device_step.py); XLA hands the psum/all_gather collectives to
NCCL. The cards of one host are joined all to all by NVLink, so the mesh
shape follows the workload alone.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gdiet_tpu.index.build import DietIndex, lookup_vals
from gdiet_tpu.pipeline.device_step import StepConfig, _pattern_tables, fused_map_step

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Multi-host bring-up (SURVEY.md §5.8): initialize jax.distributed so
    every host contributes its local GPUs to one global mesh. Safe to call
    on a single host (no-op without a coordinator address); per-host FASTQ
    sharding + an `(data, ref)` mesh over `jax.devices()` then give
    data-parallel read batches and a key-range-sharded index across hosts,
    with the shard_map collectives run by NCCL (NVLink within a host, the
    network between hosts)."""
    if coordinator is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(n_data: int, n_ref: int, devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    assert devices.size >= n_data * n_ref, "not enough devices for mesh"
    return Mesh(devices[: n_data * n_ref].reshape(n_data, n_ref), ("data", "ref"))


def _place(mesh: Mesh, arrays: dict, sharded: tuple) -> dict:
    """Put each array on the mesh once, at build time: the names in
    ``sharded`` split their leading (n_ref) axis over "ref", the rest are
    replicated. Unplaced arrays would sit on the first device and be
    resharded on every call."""
    return {k: jax.device_put(v, NamedSharding(
        mesh, P("ref") if k in sharded else P())) for k, v in arrays.items()}


_INDEX_KEYS = ("idx_keys", "idx_vals", "idx_positions", "idx_buckets")


class ShardedIndex:
    """Key-range split of a DietIndex CSR into n_ref padded shards.

    Every occurrence list stays whole on its owning shard, so local counts
    are exact (0 on non-owners) and the psum of local counts is the global
    occurrence count.
    """

    def __init__(self, index: DietIndex, n_ref: int):
        from gdiet_tpu.index.build import bucket_table

        K = len(index.keys)
        bounds = [K * i // n_ref for i in range(n_ref + 1)]
        kpad = max(bounds[i + 1] - bounds[i] for i in range(n_ref)) if n_ref else 0
        ppad = 1
        shards = []
        for i in range(n_ref):
            lo, hi = bounds[i], bounds[i + 1]
            pos_lo, pos_hi = int(index.starts[lo]), int(index.starts[hi])
            shards.append(
                (
                    index.keys[lo:hi],
                    (index.starts[lo : hi + 1] - pos_lo).astype(np.int64),
                    index.positions[pos_lo:pos_hi],
                )
            )
            ppad = max(ppad, pos_hi - pos_lo)
        keys = np.full((n_ref, max(kpad, 1)), U64_MAX, np.uint64)
        starts = np.zeros((n_ref, max(kpad, 1) + 1), np.int64)
        positions = np.zeros((n_ref, ppad), np.uint64)
        for i, (k, s, p) in enumerate(shards):
            keys[i, : len(k)] = k
            starts[i, : len(s)] = s
            starts[i, len(s) :] = len(p)  # padded keys get zero counts
            positions[i, : len(p)] = p
        # per-shard bucket tables sharing the full-index geometry
        _, self.bucket_shift, _ = bucket_table(index.keys, index.k)
        buckets, iters = [], 1
        for i in range(n_ref):
            tbl, sh, it = bucket_table(shards[i][0], index.k) if len(
                shards[i][0]
            ) else (None, self.bucket_shift, 1)
            # rebuild with the common shift so every shard hashes identically
            b = 2 * index.k - self.bucket_shift
            bnds = np.arange((1 << b) + 1, dtype=np.uint64) << np.uint64(
                self.bucket_shift
            )
            buckets.append(np.searchsorted(shards[i][0], bnds).astype(np.int64))
            if len(shards[i][0]):
                iters = max(
                    iters, int(np.ceil(np.log2(np.max(np.diff(buckets[-1])) + 1))) + 1
                )
        self.buckets = np.stack(buckets)
        self.bucket_iters = iters
        self.n_ref = n_ref
        self.keys = keys
        self.starts = starts
        self.positions = positions


def sharded_step(
    mesh: Mesh,
    index: DietIndex,
    cfg: StepConfig,
    maps: np.ndarray,
    pref: np.ndarray,
    backtrack: bool = True,
):
    """Build the jitted multi-chip mapping step over ``mesh``.

    Returns fn(codes [B, Lmax], lens [B]) -> per-read outputs, with B a
    multiple of the data-axis size.
    """
    n_ref = mesh.shape["ref"]
    sh = ShardedIndex(index, n_ref)
    from dataclasses import replace as dc_replace

    cfg = dc_replace(cfg, bucket_shift=sh.bucket_shift, bucket_iters=sh.bucket_iters)
    packed, nmask = index.device_packed()
    arrays = dict(
        idx_keys=jnp.asarray(sh.keys),
        idx_vals=jnp.asarray(
            np.stack([lookup_vals(sh.starts[i]) for i in range(n_ref)])
        ),
        idx_positions=jnp.asarray(sh.positions),
        idx_buckets=jnp.asarray(sh.buckets),
        ref_codes=packed,  # 2-bit pack, replicated per device (4x HBM cut)
        ref_offsets=jnp.asarray(index.seq_offsets),
        ref_lengths=jnp.asarray(index.lengths),
        maps=jnp.asarray(maps),
        pref=jnp.asarray(pref),
    )
    has_nmask = nmask is not None
    if has_nmask:
        arrays["ref_nmask"] = nmask
    arrays = _place(mesh, arrays, _INDEX_KEYS)

    def local(codes, lens, idx_keys, idx_vals, idx_positions, idx_buckets,
              ref_codes, ref_offsets, ref_lengths, maps_, pref_, *nm):
        return fused_map_step(
            codes, lens,
            idx_keys[0], idx_vals[0], idx_positions[0], idx_buckets[0],
            ref_codes, ref_offsets, ref_lengths, maps_, pref_,
            cfg=cfg, ref_axis="ref", n_ref=n_ref, backtrack=backtrack,
            ref_nmask=nm[0] if nm else None,
        )

    shard_fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P("data"), P("data"),
            P("ref"), P("ref"), P("ref"), P("ref"),
            P(), P(), P(), P(), P(),
            *([P()] if has_nmask else []),
        ),
        # meta rows and compacted op streams are both data-parallel; the
        # ref axis is fully reduced by the psum/all_gather merge inside
        out_specs={"meta": P("data"), "ops": P("data")},
        check_vma=False,
    )

    names = list(arrays)
    jitted = jax.jit(shard_fn)

    def step(codes, lens):
        return jitted(codes, lens, *(arrays[k] for k in names))

    step.arrays = arrays  # the placed index, for placement checks
    return step


def sharded_lr_front(
    mesh: Mesh,
    index: DietIndex,
    cfg: StepConfig,
    maps: np.ndarray,
    pref: np.ndarray,
    k: int,
    vt_df1: float,
    vt_f: float,
    bw: int,
):
    """Long-read analog of sharded_step: the LR device front (hit collect +
    2-round voting, pipeline/lr_step.lr_front) under shard_map on a
    (data, ref) mesh. Per-shard hit streams merge inside collect_hits; the
    packed meta tensor comes back data-sharded, so the host finish is
    unchanged (LongReadMapper consumes it identically)."""
    from gdiet_tpu.pipeline.lr_step import lr_front

    n_ref = mesh.shape["ref"]
    sh = ShardedIndex(index, n_ref)
    from dataclasses import replace as dc_replace

    cfg = dc_replace(cfg, probe="bisect", bucket_shift=sh.bucket_shift,
                     bucket_iters=sh.bucket_iters)
    arrays = dict(
        idx_keys=jnp.asarray(sh.keys),
        idx_vals=jnp.asarray(
            np.stack([lookup_vals(sh.starts[i]) for i in range(n_ref)])
        ),
        idx_positions=jnp.asarray(sh.positions),
        idx_buckets=jnp.asarray(sh.buckets),
        maps=jnp.asarray(maps),
        pref=jnp.asarray(pref),
    )
    arrays = _place(mesh, arrays, _INDEX_KEYS)

    def local(codes, lens, cov_thr, vt_dis, idx_keys, idx_vals,
              idx_positions, idx_buckets, maps_, pref_):
        return lr_front(
            codes, lens,
            idx_keys[0], idx_vals[0], idx_positions[0], idx_buckets[0],
            maps_, pref_, cov_thr, vt_dis,
            cfg=cfg, k=k, vt_df1=vt_df1, vt_f=vt_f, bw=bw,
            ref_axis="ref", n_ref=n_ref,
        )

    shard_fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P("data"), P("data"), P("data"), P("data"),
            P("ref"), P("ref"), P("ref"), P("ref"),
            P(), P(),
        ),
        out_specs={"meta": P("data")},
        check_vma=False,
    )

    names = ("idx_keys", "idx_vals", "idx_positions", "idx_buckets", "maps",
             "pref")
    jitted = jax.jit(shard_fn)

    def front(codes, lens, cov_thr, vt_dis):
        return jitted(codes, lens, cov_thr, vt_dis,
                      *(arrays[k] for k in names))

    front.arrays = arrays  # the placed index, for placement checks
    return front


def build_sharded_mapper(index: DietIndex, mo, mesh: Mesh,
                         Lmax: int = 256, S: int = 160, S2: int = 64,
                         A: int = 1024, dp_frac: float = 1.0,
                         backtrack: bool = True):
    """Convenience: StepConfig + pattern tables + sharded step for (index, mo)."""
    from dataclasses import replace as dc_replace

    from gdiet_tpu import pattern as pat

    mid_occ = index.derive_mid_occ(mo)
    dmax = pat.diet_length(Lmax, mo.pattern, 0)
    cfg = StepConfig.from_options(
        index, mo, mid_occ, Lmax, min(S, dmax), min(S2, dmax), A
    )
    cfg = dc_replace(cfg, dp_frac=dp_frac)
    maps, pref, _ = _pattern_tables(cfg)
    return cfg, sharded_step(mesh, index, cfg, maps, pref, backtrack)


class ShardedFused:
    """Drop-in replacement for pipeline.device_step.FusedMapper running the
    fused step under shard_map on a (data, ref) mesh: reads data-parallel,
    CSR index key-range-sharded, cross-shard hit merge on device (the
    end-to-end analog of the reference's split-index merge_hits,
    map.c:1094-1163 + splitidx.c).

    The returned ops tensor concatenates each data shard's compacted rows;
    ``opsrow_offsets(B)`` gives the host-side base row per data shard so
    opsrow indices can be globalized before the native finish.
    """

    def __init__(self, index: DietIndex, mo, mesh: Mesh, Lmax: int = 256,
                 S: int = 160, S2: int = 64, A: int = 1024,
                 dp_frac: float = 1.0):
        self.mesh = mesh
        self.n_data = mesh.shape["data"]
        self.cfg, self._step = build_sharded_mapper(
            index, mo, mesh, Lmax=Lmax, S=S, S2=S2, A=A, dp_frac=dp_frac,
        )

    def n2_local(self, B: int) -> int:
        from gdiet_tpu.pipeline.device_step import dp_rows

        return dp_rows((B // self.n_data) * self.cfg.K, self.cfg.dp_frac)

    def __call__(self, codes, lens):
        return self._step(codes, lens)
