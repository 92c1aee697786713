"""Command-line driver (the reference's two main.c binaries as one command).

Option surface mirrors GDiet-ShortReads/main.c:131-473 and
GDiet-LongReads/main.c:131-480 (same letters, same comma syntaxes), with one
command covering both sibling programs: presets ``sr``/``short`` select the
ShortReads pipeline, everything else the LongReads pipeline (override with
``--variant``).

Usage (matches the reference README commands):
  gdiet -a -t 1 -x sr -Z 10 -W 2 -k 21 -w 11 -i 2 -N 1 -r 0.05,150,200 \
        -n 0.95,0.3 -s 100 --AF_max_loc 2 ref.fa reads.fq > out.sam
  gdiet -a -x map-hifi -Z 10 -W 2 -k 19 -w 19 -i 0.2 -r 1000 \
        --vt_dis=650 --vt_nb_loc=5 ref.fa hifi.fq > out.sam
  gdiet -d ref.gdi.npz -x sr -Z 10 -W 2 ref.fa      # build + dump index
"""

from __future__ import annotations

import sys
import time

from gdiet_tpu.config import (
    MM_F_2_IO_THREADS,
    MM_F_CIGAR,
    MM_F_COPY_COMMENT,
    MM_F_EQX,
    MM_F_FOR_ONLY,
    MM_F_HEAP_SORT,
    MM_F_LONG_CIGAR,
    MM_F_NO_PRINT_2ND,
    MM_F_OUT_CG,
    MM_F_OUT_MD,
    MM_F_OUT_SAM,
    MM_F_PAF_NO_HIT,
    MM_F_RADIX_SORT,
    MM_F_REV_ONLY,
    MM_F_SOFTCLIP,
    MM_I_HPC,
    MM_I_NO_SEQ,
    IndexOptions,
    MapOptions,
    apply_cli_defaults,
    apply_cli_defaults_lr,
    check_options,
    set_preset,
)
from gdiet_tpu import __version__

SR_PRESETS = {"sr", "short"}

_NUM_SUFFIX = {"k": 1e3, "K": 1e3, "m": 1e6, "M": 1e6, "g": 1e9, "G": 1e9}


def _parse_num(s: str) -> int:
    """mm_parse_num (main.c:96-110): 4k / 100M / 1G suffixes."""
    if s and s[-1] in _NUM_SUFFIX:
        return int(float(s[:-1]) * _NUM_SUFFIX[s[-1]] + 0.499)
    return int(float(s) + 0.499)


# option letter -> takes argument?
SHORT_OPTS = {
    "2": False, "a": False, "S": False, "D": False, "w": True, "k": True,
    "K": True, "t": True, "r": True, "f": True, "V": False, "v": True,
    "g": True, "G": True, "I": True, "d": True, "X": False, "T": True,
    "s": True, "x": True, "H": False, "c": False, "p": True, "M": True,
    "n": True, "z": True, "A": True, "B": True, "O": True, "E": True,
    "m": True, "N": True, "Q": False, "u": True, "R": True, "h": False,
    "F": True, "L": False, "C": True, "y": False, "Y": False, "P": False,
    "o": True, "e": True, "U": True, "Z": True, "W": True, "i": True,
}

LONG_OPTS_ARG = {
    "bucket-bits", "seed", "max-chain-skip", "max-chain-iter", "min-dp-len",
    "end-bonus", "end-seed-pen", "max-clip-ratio", "min-occ-floor",
    "score-N", "split-prefix", "cap-sw-mem", "max-qlen", "junc-bed",
    "junc-bonus", "chain-gap-scale", "chain-skip-scale", "alt", "alt-drop",
    "mask-len", "cap-kalloc", "q-occ-frac", "AF_dis", "AF_max_loc",
    "vt_dis", "vt_nb_loc", "vt_cov", "vt_df1", "vt_df2", "vt_f",
    "max_max_gap", "max_min_gap", "frag", "secondary", "sort", "variant",
    "batch", "split-reads", "mesh",
}
LONG_OPTS_FLAG_DOC = {"print-seeds", "print-qname", "idx-no-seq"}
LONG_OPTS_OPTARG = {"cs", "rmq"}


def _tokenize(argv: list[str]):
    """ketopt-style scan: yields (opt, arg) pairs and positional args."""
    out = []
    pos = []
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok.startswith("--"):
            body = tok[2:]
            if "=" in body:
                name, arg = body.split("=", 1)
                out.append((name, arg))
            elif body in LONG_OPTS_ARG:
                i += 1
                if i >= len(argv):
                    raise SystemExit(f"[ERROR] missing option argument for --{body}")
                out.append((body, argv[i]))
            else:
                out.append((body, None))
        elif tok.startswith("-") and len(tok) > 1:
            j = 1
            while j < len(tok):
                c = tok[j]
                if c not in SHORT_OPTS:
                    raise SystemExit(f"[ERROR] unknown option in \"{tok}\"")
                if SHORT_OPTS[c]:
                    if j + 1 < len(tok):
                        out.append((c, tok[j + 1 :]))
                    else:
                        i += 1
                        if i >= len(argv):
                            raise SystemExit("[ERROR] missing option argument")
                        out.append((c, argv[i]))
                    break
                out.append((c, None))
                j += 1
        else:
            pos.append(tok)
        i += 1
    return out, pos


HELP = """Usage: gdiet [options] <target.fa>|<target.gdi.npz> [query.fa/q [...]]
A GPU-accelerated sparsified ("Genome-on-Diet") read mapper. Options mirror the
reference GDiet binaries; presets sr/short select the short-read pipeline,
all others the long-read pipeline (override with --variant short|long).
Key options:
  -x STR     preset: sr, map-ont, map-hifi, map-pb, asm5/10/20, ava-*
  -Z STR     1/0 sparsification pattern (e.g. 10, 110, 1110)  [11]
  -W INT     pattern length  [2]
  -i FLOAT   max seeds for pattern-shift inference (<1: fraction of read)
  -k/-w INT  k-mer size / minimizer window
  -d FILE    dump the index to FILE (npz)
  -a         output SAM (default PAF)
  -o FILE    output file  [stdout]
  -t INT     host worker threads
  -N INT     max secondary alignments
  -r ...     bandwidth: short: frac[,min,max]; long: INT
  -n F[,F2]  vote threshold fraction [, recovery fraction]
  -s INT     min DP score to output
  --AF_max_loc INT   short-read: max voted locations per read
  --vt_dis/--vt_nb_loc/--vt_cov/--vt_df1/--vt_df2/--vt_f   long-read voting
  --secondary yes|no   output secondary alignments
  --version  print version
"""


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts, pos = _tokenize(argv)

    # pass 1: preset + variant (main.c:148-162)
    preset = None
    variant = None
    for name, arg in opts:
        if name == "x":
            preset = arg
        elif name == "variant":
            variant = {"short": "sr", "sr": "sr", "long": "lr", "lr": "lr"}.get(arg)
            if variant is None:
                raise SystemExit(f"[ERROR] unknown variant '{arg}'")
    if variant is None:
        variant = "sr" if preset in SR_PRESETS else "lr"

    io, mo = IndexOptions(), MapOptions()
    if variant == "lr":
        mo.bw = 1000
    if preset is not None:
        try:
            set_preset(preset, io, mo)
        except ValueError as ex:
            raise SystemExit(f"[ERROR] {ex}")
    if variant == "lr":
        apply_cli_defaults_lr(io, mo)
    else:
        apply_cli_defaults(io, mo)

    fnw = None
    out_path = None
    n_threads = 3
    verbose = 3
    for name, arg in opts:
        if name in ("x", "variant"):
            continue
        elif name == "w":
            io.w = int(arg)
        elif name == "k":
            io.k = int(arg)
        elif name == "Z":
            io.pattern = mo.pattern = arg
        elif name == "W":
            io.pattern_len = mo.pattern_len = int(arg)
        elif name == "i":
            mo.max_seeds = float(arg)
            if mo.max_seeds < 0:
                mo.max_seeds = 0.1
        elif name == "H":
            io.flag |= MM_I_HPC
        elif name == "d":
            fnw = arg
        elif name == "t":
            n_threads = int(arg)
        elif name == "v":
            verbose = int(arg)
        elif name == "g":
            mo.max_gap = _parse_num(arg)
        elif name == "F":
            parts = arg.split(",")
            mo.max_frag_len = _parse_num(parts[0])
            if len(parts) > 1:
                mo.max_nb_rounds = int(parts[1])
        elif name == "N":
            mo.best_n = int(arg)
        elif name == "p":
            mo.pri_ratio = float(arg)
        elif name == "M":
            mo.mask_level = float(arg)
        elif name == "c":
            mo.flag |= MM_F_OUT_CG | MM_F_CIGAR
        elif name == "a":
            mo.flag |= MM_F_OUT_SAM | MM_F_CIGAR
        elif name == "Q":
            mo.flag |= 0x10  # MM_F_NO_QUAL
        elif name == "Y":
            mo.flag |= MM_F_SOFTCLIP
        elif name == "L":
            mo.flag |= MM_F_LONG_CIGAR
        elif name == "y":
            mo.flag |= MM_F_COPY_COMMENT
        elif name == "T":
            mo.sdust_thres = int(arg)
        elif name == "n":
            parts = arg.split(",")
            mo.min_cnt = float(parts[0])
            if len(parts) > 1:
                mo.rec_threshold_frac = float(parts[1])
        elif name == "m":
            mo.min_chain_score = int(arg)
        elif name == "A":
            mo.a = int(arg)
        elif name == "B":
            mo.b = int(arg)
        elif name == "s":
            mo.min_dp_max = int(arg)
        elif name == "I":
            io.batch_size = _parse_num(arg)
        elif name == "K":
            mo.mini_batch_size = _parse_num(arg)
        elif name == "e":
            mo.occ_dist = _parse_num(arg)
        elif name == "h" or name == "help":
            print(HELP)
            return 0
        elif name == "2":
            mo.flag |= MM_F_2_IO_THREADS
        elif name == "o":
            out_path = arg
        elif name == "V" or name == "version":
            print(__version__)
            return 0
        elif name == "r":
            if variant == "lr":
                mo.bw = int(float(arg) + 0.499)
            else:
                parts = arg.split(",")
                x = float(parts[0])
                if x < 1.0:
                    mo.bw_frac = x
                    if len(parts) > 1:
                        mo.bw_min = int(parts[1])
                    if len(parts) > 2:
                        mo.bw_max = int(parts[2])
                else:
                    mo.bw = int(x + 0.499)
        elif name == "U":
            parts = arg.split(",")
            mo.min_mid_occ = int(parts[0])
            if len(parts) > 1:
                mo.max_mid_occ = int(parts[1])
        elif name == "f":
            parts = arg.split(",")
            x = float(parts[0])
            if x < 1.0:
                mo.mid_occ_frac, mo.mid_occ = x, 0
            else:
                mo.mid_occ = int(x + 0.499)
            if len(parts) > 1:
                mo.max_occ = int(float(parts[1]) + 0.499)
        elif name == "z":
            parts = arg.split(",")
            mo.zdrop = mo.zdrop_inv = int(parts[0])
            if len(parts) > 1:
                mo.zdrop_inv = int(parts[1])
        elif name == "O":
            parts = arg.split(",")
            mo.q = mo.q2 = int(parts[0])
            if len(parts) > 1:
                mo.q2 = int(parts[1])
        elif name == "E":
            parts = arg.split(",")
            mo.e = mo.e2 = int(parts[0])
            if len(parts) > 1:
                mo.e2 = int(parts[1])
        elif name == "bucket-bits":
            io.bucket_bits = int(arg)
        elif name == "seed":
            mo.seed = int(arg)
        elif name == "min-occ-floor":
            mo.min_mid_occ = int(arg)
        elif name == "q-occ-frac":
            mo.q_occ_frac = float(arg)
        elif name == "max-qlen":
            mo.max_qlen = _parse_num(arg)
        elif name == "idx-no-seq":
            io.flag |= MM_I_NO_SEQ
        elif name == "eqx":
            mo.flag |= MM_F_EQX
        elif name == "MD":
            mo.flag |= MM_F_OUT_MD
        elif name == "cs":
            from gdiet_tpu.config import MM_F_OUT_CS, MM_F_OUT_CS_LONG

            mo.flag |= MM_F_OUT_CS | MM_F_CIGAR
            if arg == "long":
                mo.flag |= MM_F_OUT_CS_LONG
            elif arg == "none":
                mo.flag &= ~MM_F_OUT_CS
            else:
                mo.flag &= ~MM_F_OUT_CS_LONG
        elif name == "paf-no-hit":
            mo.flag |= MM_F_PAF_NO_HIT
        elif name == "for-only":
            mo.flag |= MM_F_FOR_ONLY
        elif name == "rev-only":
            mo.flag |= MM_F_REV_ONLY
        elif name == "split-prefix":
            mo.split_prefix = arg
        elif name == "AF_dis":
            mo.AF_dis = float(arg)
        elif name == "AF_max_loc":
            mo.AF_max_loc = int(float(arg))
        elif name == "vt_dis":
            mo.vt_dis = int(arg)
        elif name == "vt_nb_loc":
            mo.vt_nb_loc = int(arg)
        elif name == "vt_cov":
            mo.vt_cov = float(arg)
        elif name == "vt_df1":
            mo.vt_df1 = float(arg)
        elif name == "vt_df2":
            mo.vt_df2 = float(arg)
        elif name == "vt_f":
            mo.vt_f = float(arg)
        elif name == "max_max_gap":
            mo.max_max_gap = int(arg)
        elif name == "max_min_gap":
            mo.max_min_gap = int(arg)
        elif name == "secondary":
            if arg in ("yes", "y"):
                mo.flag &= ~MM_F_NO_PRINT_2ND
            elif arg in ("no", "n"):
                mo.flag |= MM_F_NO_PRINT_2ND
        elif name == "sort":
            if arg == "radix":
                mo.flag = (mo.flag | MM_F_RADIX_SORT) & ~MM_F_HEAP_SORT
            elif arg == "heap":
                mo.flag = (mo.flag | MM_F_HEAP_SORT) & ~MM_F_RADIX_SORT
            elif arg == "merge":
                mo.flag &= ~(MM_F_HEAP_SORT | MM_F_RADIX_SORT)
            else:
                raise SystemExit("[ERROR]: Unknown sort algorithm (merge, radix, heap)")
        elif name == "batch":
            mo.mini_batch_size = _parse_num(arg)
        elif name == "G":
            mo.max_gap_ref = _parse_num(arg)
        elif name == "frag":
            # frag mode (main.c:330): changes the seed cap + R2 revcomp
            from gdiet_tpu.config import MM_F_FRAG_MODE

            if arg in ("yes", "y", None):
                mo.flag |= MM_F_FRAG_MODE
            elif arg in ("no", "n"):
                mo.flag &= ~MM_F_FRAG_MODE
        elif name == "mesh":
            # multi-chip mapping: --mesh DATAxREF (e.g. 4x2) shards read
            # batches over `data` and the CSR index over `ref`
            # (parallel/dist.py); requires that many local devices
            parts = arg.lower().split("x")
            mo.mesh_shape = (int(parts[0]),
                             int(parts[1]) if len(parts) > 1 else 1)
        elif name == "split-reads":
            # integrated UltraLongReadSplitter (the ONT recipe's 30 kb
            # pre-split, Read-mapping-real-data-ONT.sh:16)
            mo.split_len = _parse_num(arg)
        elif name == "print-seeds":
            # stage-trace oracle (main.c:289-298): force single-read oracle
            # mapping and dump per-stage intermediates to stderr
            from gdiet_tpu import debug

            debug.set_print_seed(True)
            n_threads = 1
        else:
            # parsed-for-compatibility options whose semantics are dead in
            # the GDiet hot path; warn so silent drops are visible
            if verbose >= 2:
                print(f"[WARNING]\x1b[1;31m option '{'--' if len(name) > 1 else '-'}{name}"
                      f" is accepted but has no effect in gdiet_tpu\x1b[0m",
                      file=sys.stderr)

    if io.pattern_len < 2:
        io.pattern_len = mo.pattern_len = 2
        io.pattern = mo.pattern = "11"
    try:
        check_options(io, mo)
    except ValueError as ex:
        raise SystemExit(f"[ERROR] {ex}")

    if not pos:
        print(HELP)
        return 1
    if len(pos) == 1 and fnw is None:
        raise SystemExit("[ERROR] missing input: please specify a query file "
                         "or use -d to build an index")

    from gdiet_tpu.runtime import run_mapping

    return run_mapping(
        io, mo, variant, target=pos[0], queries=pos[1:], fnw=fnw,
        out_path=out_path, n_threads=n_threads, verbose=verbose,
        cli_line="gdiet " + " ".join(argv),
    )


if __name__ == "__main__":
    sys.exit(main())
