"""Device long-read pipeline vs the reference binary's golden SAM.

Every non-exact segment takes the device DP (ops/dp.py::extd2: the XLA scan
here, the CUDA kernel on a GPU); none is beyond the largest bucket."""

import numpy as np
import pytest

from gdiet_tpu.config import MM_F_NO_PRINT_2ND, options_for
from gdiet_tpu.index import build_index
from gdiet_tpu.io import sam as samio
from gdiet_tpu.io.fastx import read_fastx
from gdiet_tpu.pipeline.longread import LongReadMapper
from tests.test_longread_oracle import CONFIGS


@pytest.mark.parametrize("tag,n_threads", [
    ("hifi", 1), ("ont", 1), pytest.param("hifi", 3, marks=pytest.mark.slow),
])
def test_lr_device_parity(data_dir, tag, n_threads):
    cfg = dict(CONFIGS[tag])
    preset = cfg.pop("preset")
    io_, mo = options_for(preset, variant="lr", pattern="10", **cfg)
    refs = [(r.name, r.seq) for r in read_fastx(str(data_dir / "ref_lr.fa"))]
    mi = build_index(refs, io_)
    # n_threads=3 proves the -t host pool (prepare/finalize/oracle on a
    # thread pool, kt_for analog) is order-preserving and byte-identical
    mapper = LongReadMapper(
        mi, mo, max_read_len=4096, seed_budget=512, shift_seed_budget=128,
        hit_budget=1024, n_threads=n_threads,
    )
    reads = list(read_fastx(str(data_dir / "reads_lr.fq")))
    golden = [
        l.rstrip("\n")
        for l in open(data_dir / f"golden_lr_{tag}.sam")
        if not l.startswith("@")
    ]
    produced = []
    for rec, regs in zip(reads, mapper.map_batch(reads)):
        if regs:
            for r in regs:
                if (mo.flag & MM_F_NO_PRINT_2ND) and r.id != r.parent:
                    continue
                produced.append(
                    samio.sam_record(rec.name, rec.seq, rec.qual, r, regs,
                                     mi.names, mo.flag, 0)
                )
        else:
            produced.append(
                samio.sam_record(rec.name, rec.seq, rec.qual, None, [],
                                 mi.names, mo.flag, 0)
            )
    assert len(produced) == len(golden)
    for i, (mine, gold) in enumerate(zip(produced, golden)):
        assert mine == gold, f"record {i}"
    assert mapper.stats["host_dp_segments"] == 0
    assert mapper._bucket_fns  # the segment DP ran through extd2
