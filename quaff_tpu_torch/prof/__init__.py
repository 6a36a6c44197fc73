"""Speed-of-light probes of the card for the row-loop kernels: the
counterparts of tools/prof/roofline_probe.py (P1) and
tools/prof/sol_transcendental.py (P2), with their chain kernel
csrc/sol_probe.cu.  Run them on a CUDA card:

    python -m quaff_tpu_torch.prof.roofline_probe
    python -m quaff_tpu_torch.prof.sol_transcendental

and, without running a kernel, each kernel's registers, spills and row-loop
instructions from the built library (kernel_sass):

    python -m quaff_tpu_torch.prof.kernel_sass band_fill
"""
