"""findkmer-tpu: an exact k-mer counting engine on JAX.

A from-scratch JAX/XLA framework with the capabilities of the
reference tool soundude462/findKmer (see SURVEY.md for the reference
analysis).  The reference is a single-threaded C scanning loop; this
framework replaces it with:

  * host-side vectorized FASTA parsing + 2-bit encoding (io/),
  * device-side rolling-window k-mer extraction and count accumulation
    (ops/),
  * device-resident count tables, direct-addressed or sparse (table.py),
  * data-parallel + table-sharded distribution over a device mesh with
    XLA collectives (parallel/),
  * a streaming, checkpointable pipeline (pipeline.py) and CLI (cli.py).

Correctness bar: bit-exact spectra versus the scalar oracle in oracle/
(the stand-in for the reference; SURVEY.md §0.3).
"""

from findkmer_tpu.version import __version__
from findkmer_tpu.config import Config


def __getattr__(name):
    # lazy: importing findkmer_tpu must stay cheap (no jax import)
    # NOTE: no lazy export may share a name with a submodule (e.g.
    # "sketch"): once the submodule is imported it becomes the package
    # attribute and would shadow the function — hence sketch_sample
    if name in ("count", "count_text", "count_per_record", "Spectrum",
                "sketch_sample", "similarity", "filter_reads", "matrix",
                "expr"):
        from findkmer_tpu import api

        return getattr(api, name)
    raise AttributeError(name)


__all__ = ["Config", "count", "count_text", "count_per_record",
           "Spectrum", "sketch_sample", "similarity", "filter_reads",
           "matrix", "expr", "__version__"]
