"""Batched tensor stages of the SE path: text windows (rank), seeding
(search), ungapped verify (extend), the DP fill (sw: plain version and
host traceback; dp_cuda: the CUDA kernel's wrapper); the spliced path's
ops (splice; anchor_cuda: the anchor-scan kernel's wrapper); nvcc: the
build of the CUDA sources."""


def zero_launches() -> None:
    """Sets the kernel wrappers' launch counts to 0 (read back with
    read_launches; on the CPU they stay 0: the plain versions run)."""
    from . import anchor_cuda, dp_cuda
    for counts in (dp_cuda.launches, anchor_cuda.launches):
        for k in counts:
            counts[k] = 0


def read_launches() -> dict:
    """The kernel wrappers' launch counts, one dict."""
    from . import anchor_cuda, dp_cuda
    return {**dp_cuda.launches, **anchor_cuda.launches}
