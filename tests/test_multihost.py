"""Multi-host bring-up smoke test (SURVEY.md §5.8).

Two OS processes join one jax.distributed cluster via the GDIET_COORDINATOR
env wiring (runtime.py) and each maps its shard of the reads through
`run_mapping` on a tiny index; the concatenated SAM must equal the golden
single-process output. Real N-host scaling needs several machines;
this proves the coordinator/join/map/emit path works end to end, which is
the part the env wiring can get wrong.
"""

import os
import pathlib
import subprocess
import sys

DATA = pathlib.Path(__file__).parent / "data"
REPO = pathlib.Path(__file__).resolve().parent.parent

WORKER = r"""
import sys

import jax

# pin the CPU backend even if a plugin imported jax before the env var
jax.config.update("jax_platforms", "cpu")

from gdiet_tpu.config import MM_F_CIGAR, MM_F_OUT_SAM, options_for
from gdiet_tpu.runtime import run_mapping

pid = int(sys.argv[1])
ref, fq, out = sys.argv[2], sys.argv[3], sys.argv[4]
io_, mo = options_for(
    "sr", pattern="10", max_seeds=2.0, best_n=1, bw_frac=0.05, bw_min=150,
    bw_max=200, min_cnt=0.95, rec_threshold_frac=0.3, min_dp_max=100,
    AF_max_loc=2,
)
mo.flag |= MM_F_OUT_SAM | MM_F_CIGAR  # -a
rc = run_mapping(io_, mo, "sr", ref, [fq], out_path=out, verbose=0,
                 cli_line="gdiet-test")
import jax
assert jax.process_count() == 2, jax.process_count()
sys.exit(rc)
"""


def test_two_process_bringup(tmp_path):
    # split the golden read set into two per-process shards
    reads = (DATA / "reads.fq").read_text().splitlines()
    recs = [reads[i : i + 4] for i in range(0, len(reads), 4)]
    half = len(recs) // 2
    shards = [recs[:half], recs[half:]]
    fqs = []
    for p, shard in enumerate(shards):
        fq = tmp_path / f"shard{p}.fq"
        fq.write_text("\n".join(l for rec in shard for l in rec) + "\n")
        fqs.append(fq)

    worker_py = tmp_path / "worker.py"
    worker_py.write_text(WORKER)
    port = 29517
    procs = []
    outs = []
    for p in range(2):
        env = dict(os.environ)
        env.update(
            JAX_PLATFORMS="cpu",
            GDIET_COORDINATOR=f"127.0.0.1:{port}",
            GDIET_NUM_PROCESSES="2",
            GDIET_PROCESS_ID=str(p),
        )
        env.pop("XLA_FLAGS", None)  # one local CPU device per process
        env["PYTHONPATH"] = str(REPO) + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
        )
        out = tmp_path / f"out{p}.sam"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, str(worker_py), str(p), str(DATA / "ref.fa"),
             str(fqs[p]), str(out)],
            env=env, cwd=str(REPO), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
        ))
    for pr in procs:
        _, err = pr.communicate(timeout=600)
        assert pr.returncode == 0, err.decode()[-2000:]

    golden = [l for l in (DATA / "golden.sam").read_text().splitlines()
              if not l.startswith("@")]
    got = []
    for out in outs:
        got.extend(l for l in out.read_text().splitlines()
                   if not l.startswith("@"))
    assert got == golden
