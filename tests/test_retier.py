"""Adaptive Lmax re-tiering in the SR CLI fast path.

The fast path derives its compiled read-length envelope from the FIRST
batch; a FASTQ whose long reads appear late used to route every one of
them to the scalar oracle for the rest of the run. `_run_sr_sam_fast`
now re-tiers (rebuilds the mapper at a widened Lmax) once the overflow
count trips, so input order no longer changes the fallback rate — the
one-path behavior of the reference's main.c:576-672.
"""

import numpy as np
import pytest

from gdiet_tpu import native
from gdiet_tpu.config import options_for
from gdiet_tpu.index.build import build_index
from gdiet_tpu.pipeline.shortread import ShortReadMapper
from gdiet_tpu.runtime import _run_sr_sam_fast


def _mk(tmp_path, seed=3, glen=80_000):
    rng = np.random.default_rng(seed)
    bases = "ACGT"
    g = rng.integers(0, 4, glen)
    seq = "".join(bases[c] for c in g)
    io_, mo = options_for(
        "sr", pattern="10", max_seeds=2.0, best_n=1, bw_frac=0.05,
        bw_min=150, bw_max=200, min_cnt=0.95, rec_threshold_frac=0.3,
        min_dp_max=100, AF_max_loc=2,
    )
    mi = build_index([("chrT", seq)], io_)

    def mk_read(j, L):
        st = int(rng.integers(0, glen - L))
        r = g[st : st + L].copy()
        r[int(rng.integers(0, L))] ^= 1
        return f"@q{j}_{L}\n" + "".join(bases[c] for c in r) + \
            "\n+\n" + "I" * L + "\n"

    shorts = [mk_read(j, 100) for j in range(64)]
    longs = [mk_read(64 + j, 240) for j in range(96)]
    late = tmp_path / "late_long.fq"     # long reads only after batch 1
    srt = tmp_path / "sorted.fq"         # long reads visible in batch 1
    late.write_text("".join(shorts + longs))
    srt.write_text("".join(longs + shorts))
    return mi, mo, late, srt


@pytest.mark.skipif(native.lib is None, reason="needs the native library")
def test_late_long_reads_retier(tmp_path, monkeypatch):
    mi, mo, late, srt = _mk(tmp_path)

    calls = {"oracle": 0, "mappers": 0}
    orig_sam = ShortReadMapper._oracle_sam
    orig_init = ShortReadMapper.__init__

    def counting_sam(self, rec, rep_len):
        calls["oracle"] += 1
        return orig_sam(self, rec, rep_len)

    def counting_init(self, *a, **kw):
        calls["mappers"] += 1
        return orig_init(self, *a, **kw)

    monkeypatch.setattr(ShortReadMapper, "_oracle_sam", counting_sam)
    monkeypatch.setattr(ShortReadMapper, "__init__", counting_init)

    import time

    def run(fq, out):
        calls["oracle"] = calls["mappers"] = 0
        rc = _run_sr_sam_fast(mi, mo, str(fq), str(out), 1, 0, "test",
                              time.perf_counter(), batch_reads=64)
        assert rc == 0
        return calls["oracle"], calls["mappers"]

    o_srt, m_srt = run(srt, tmp_path / "srt.sam")
    o_late, m_late = run(late, tmp_path / "late.sam")

    # re-tier fired exactly once on the late-long input (incl. retry tiers
    # a mapper may build internally, the late run builds exactly one more
    # ShortReadMapper than the sorted run)
    assert m_late == m_srt + 1, (m_late, m_srt)
    # ... and the fallback rate matches the pre-sorted input
    assert o_late == o_srt, (o_late, o_srt)

    # record ORDER differs between the two inputs by construction; the
    # record SET must not
    def body(p):
        return sorted(l for l in p.read_text().splitlines()
                      if not l.startswith("@"))

    a, b = body(tmp_path / "srt.sam"), body(tmp_path / "late.sam")
    assert len(a) == 160 and a == b
