"""gdiet_tpu — a sparsified-genomics read-mapping framework for accelerators.

A from-scratch JAX/XLA rebuild (with one CUDA kernel, ops/cuda) of the
capabilities of CMU-SAFARI/Genome-on-Diet: pattern
("diet") sparsified minimizer indexing, per-read pattern-shift inference,
compressed seeding, location voting, and banded dual affine-gap alignment
producing SAM/PAF records for Illumina / HiFi / ONT reads.

Everything on the device side is fixed-shape batched tensor computation;
variable-length constructs from the reference (kvec/khash/kthread) are
replaced by padded arrays + masks, device sorts, and segmented scans.

64-bit integers are required for minimizer hash keys (up to 2k=56 bits), so
x64 mode is enabled at import. All device code uses explicit dtypes.
"""

import os
import pathlib

import jax


def compile_cache_dir(environ=os.environ) -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else ``.jax_cache`` at the root
    of the checkout: a fixed path, since the path is part of the key."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        pathlib.Path(__file__).resolve().parent.parent / ".jax_cache")


jax.config.update("jax_enable_x64", True)
# persistent compile cache: index-build / mapping shapes compile once per
# checkout, not once per process
jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
# numeric tripwires (the asan/tsan analog, SURVEY.md §5.2): fail fast on
# NaN/Inf leaving any device computation when debugging
if os.environ.get("GDIET_DEBUG_NANS"):
    jax.config.update("jax_debug_nans", True)
    jax.config.update("jax_debug_infs", True)

from gdiet_tpu.config import IndexOptions, MapOptions, set_preset  # noqa: E402

__version__ = "0.1.0"

__all__ = ["IndexOptions", "MapOptions", "set_preset", "__version__"]
