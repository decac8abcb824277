"""hisat2_tpu_torch — the PyTorch/CUDA port of hisat2_tpu.

A second package beside the JAX one, slice by slice, main path first:
single-end DNA alignment (--no-spliced-alignment) against an index that
carries a k-mer seed table, through to SAM. Plain tensor work is PyTorch;
the hand-written kernels, CUDA C++ for sm_90a built by ops/nvcc.py, are
the affine-gap DP fill (csrc/dp_score.cu, ops/dp_cuda.py) and the
spliced path's anchor scan (csrc/anchor_scan.cu, ops/anchor_cuda.py).
Host modules (io, index builders, native C++, scoring) are the package's
own copies.

Entry points run on "cuda" unless the caller passes device="cpu"; a CPU
tensor always takes a kernel's plain PyTorch version, a CUDA tensor
always the kernel.

Layout mirrors hisat2_tpu:
  utils/   — alphabet, metrics
  io/      — reads, reference, SAM output
  index/   — suffix array, seed table, FM index (+ device bundle)
  ops/     — text windows, seeding, ungapped verify, DP (plain + kernel)
  align/   — scoring, MAPQ, the fused SE step, SAM emission
  native/  — C++ host components built with g++ on first use
  csrc/    — CUDA sources built with nvcc on first use
"""

__version__ = "0.1.0"
