"""quaff_tpu_torch: the PyTorch / CUDA port of quaff-tpu.

The JAX package `quaff_tpu` stays the reference; this package runs the
same pipelines with PyTorch on an explicit device (`device.py`), and every
Pallas kernel on a ported path becomes a kernel written by hand for
Hopper (`csrc/`, built at first use by `kernels.py`).

Ported so far: `quaff align` (cli.py -> aligner.py -> dp/fill_v2.py, whose
banded Viterbi score fill is the CUDA kernel csrc/band_fill.cu),
`quaff train` / `count` (cli.py -> trainer.py -> dp/estep.py, whose fused
E-step is the CUDA kernels of csrc/estep.cu; dp/counts.py is the exact
engine), `quaff overlap` (cli.py -> overlap.py -> dp/ov_fill.py, the CUDA
kernel csrc/ov_fill.cu), and the speed-of-light probes of the card (prof/,
whose chain kernel is csrc/sol_probe.cu).

The package stands alone: it imports nothing of `quaff_tpu` and no `jax`.
It keeps its own copies of the jax-free modules it needs, under the JAX
package's names (alphabet, io, model, envelope, formats, logger, memsize,
checkpoint, cliargs for cli's argument helpers, and the bindings of
native, whose library build.py compiles from native/*.cpp), and jax-free
copies of the numpy pieces of modules that import JAX (dp.scores,
dp.engine's PairBatch, dp.traceback, dp.debug).
"""

__version__ = "0.1.0"
