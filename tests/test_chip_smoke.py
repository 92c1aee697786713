"""chip_smoke.py off the card: its phase functions at a tiny size on the CPU
(where ops/dp.py::extd2 lowers to the XLA scan), and its refusal to report
a result without a GPU or without the rest of the repository."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke as cs  # noqa: E402

TINY = cs.Sizes(
    genome_mbp=2, sr_batch=256, sr_batches=1, pe_pairs=64, pe_batches=1,
    hifi_reads=3, hifi_len=(1500, 2000), ont_reads=1, ont_len=2600,
    sr_oracle=40, hifi_oracle=2, ont_oracle=1, dp_rows=48, lr_dp_rows=3,
    hifi_lmax=2048, hifi_batch=2, ont_lmax=4096, ont_batch=1,
)


@pytest.fixture(scope="module")
def scale_index():
    return cs.build_scale_index(TINY, seed=3)


def test_phases_at_tiny_size(scale_index, capsys):
    mi, chroms, _ = scale_index
    times = cs.phase_compile(mi, TINY, long_reads=False)
    assert set(times) == {"sr_step", "pe_step"}
    cs.phase_kernels(TINY, seed=3)
    cs.phase_golden(("golden.sam",))
    res = cs.phase_scale(mi, chroms, TINY, seed=3, card="cpu")
    assert res["sr_reads_per_sec"] > 0 and res["pe_pairs_per_sec"] > 0
    assert res["hifi_stats"]["host_dp_segments"] == 0
    out = capsys.readouterr().out
    assert "byte-identical" in out and "exact" in out


def test_long_reads_cross_several_dp_buckets(scale_index):
    """Reads long enough for the first three DP buckets, device SAM vs the
    scalar oracle (the phase-4 comparison) on the CPU."""
    import numpy as np

    from gdiet_tpu.oracle import longread as olr

    mi, chroms, _ = scale_index
    rng = np.random.default_rng(11)
    reads = cs.make_long_reads(rng, chroms, 2, 3000, 3600, sub=0.01,
                               indel=0.01, tag="x")
    lr = cs.hifi_mapper(mi, cs.Sizes(hifi_lmax=4096))
    lines, _, fallback = cs.run_lr(lr, reads, 2)
    assert not fallback
    dev = cs._by_name("\n".join(lines).encode())
    for rec in reads:
        regs = olr.map_read_lr(lr._oracle_mi(), rec.seq, lr.mo, lr.mid_occ,
                               rec.name)
        assert dev[rec.name] == lr.regs_to_sam_lines(rec, regs)
    assert lr.stats["host_dp_segments"] == 0
    assert len(lr._bucket_fns) >= 1  # the segment DP ran on the device path


def _run(cwd, env_extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(env_extra)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_main_exits_nonzero_without_gpu():
    proc = _run(REPO, {"JAX_PLATFORMS": "cpu"})
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(tmp_path, {"JAX_PLATFORMS": "cpu"})
    assert proc.returncode != 0
    assert not any(line.startswith("{") and json.loads(line).get("ok")
                   for line in proc.stdout.splitlines())
