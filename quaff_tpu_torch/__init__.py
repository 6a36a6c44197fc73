"""quaff_tpu_torch: the PyTorch / CUDA port of quaff-tpu.

The JAX package `quaff_tpu` stays the reference; this package runs the
same pipelines with PyTorch on an explicit device (`device.py`), and every
Pallas kernel on a ported path becomes a kernel written by hand for
Hopper (`csrc/`, built at first use by `kernels.py`).

Ported so far: `quaff align` (cli.py -> aligner.py -> dp/fill_v2.py, whose
banded Viterbi/Forward score fill is the CUDA kernel csrc/band_fill.cu).

The jax-free modules of `quaff_tpu` (alphabet, io.fastseq, model,
envelope, formats.alignment, native, logger, cli's parsing helpers) are
imported, not copied; the numpy pieces that live in modules importing JAX
(dp.scores, dp.engine's PairBatch, dp.traceback, dp.debug) have jax-free
copies under dp/.  Nothing here imports `jax`.
"""

__version__ = "0.1.0"
