"""L6/L7 command-line drivers: build / align / inspect / repeat
(reference hisat2_build.cpp, hisat2.cpp, hisat2_inspect.cpp,
hisat2_repeat.cpp roles), the PyTorch port's copies of hisat2_tpu's.

Entry points:
    python -m hisat2_tpu_torch.cli.build    <ref.fa[,...]> <index-prefix>
    python -m hisat2_tpu_torch.cli.align    -x <prefix> {-U r.fq | -1 a -2 b}
                                            [-S out] [--device cuda|cpu]
    python -m hisat2_tpu_torch.cli.inspect  <prefix>
    python -m hisat2_tpu_torch.cli.repeat   <ref.fa[,...]> <base>

The index on disk is the JAX package's format: an index either package
builds, the other loads.
"""
