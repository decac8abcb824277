"""Batched tensor stages of the SE path: text windows (rank), seeding
(search), ungapped verify (extend), the DP fill (sw: plain version and
host traceback; dp_cuda: the CUDA kernel's wrapper)."""
