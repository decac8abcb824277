"""Native (C++) host-side components, built on demand with g++ and loaded
via ctypes (no pybind dependency):

  sais.cpp      — linear-time SA-IS suffix array construction
  kmersort.cpp  — threaded counting sort behind the k-mer seed table
  samfmt.cpp    — batched SAM record formatting (finish_se_native,
                  format_se_batch2, format_se_batch3; finish_pe_native,
                  format_pe_mix, format_pe_batch)
  dpkernel.cpp  — single-pair affine-gap DP traceback
  juncscore.cpp — threaded host junction scorer + acceptance gates
                  (ops/splice_host.junction_score_gate)

The sources are copies of the JAX package's, so both packages format SAM
and trace back gapped alignments with the same code. Libraries build into
the package's own `_build/native/` directory (git-ignored). A failed
build raises: the aligner has no slower path to fall back to.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np
from numpy.ctypeslib import ndpointer

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build", "native")

_libs: dict[str, ctypes.CDLL] = {}


def _build(name: str, src: str) -> str:
    """Compile <src> to BUILD_DIR/<name>.so unless an up-to-date one
    exists; returns its path. The library is written under a temporary
    name and renamed into place, so concurrent test workers never load a
    half-written file."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    src_path = os.path.join(_DIR, src)
    so_path = os.path.join(BUILD_DIR, name + ".so")
    if (os.path.exists(so_path)
            and os.path.getmtime(so_path) >= os.path.getmtime(src_path)):
        return so_path
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            ["g++", "-O3", "-march=native", "-std=c++17", "-pthread",
             "-shared", "-fPIC", "-o", tmp, src_path],
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {src}:\n{proc.stderr}")
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so_path


def load(name: str, src: str) -> ctypes.CDLL:
    if name not in _libs:
        _libs[name] = ctypes.CDLL(_build(name, src))
    return _libs[name]


_i16 = ndpointer(np.int16, flags="C_CONTIGUOUS")
_i32 = ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64 = ndpointer(np.int64, flags="C_CONTIGUOUS")
_u8 = ndpointer(np.uint8, flags="C_CONTIGUOUS")
_c_i32, _c_i64, _c_f64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_double


def samfmt_lib() -> ctypes.CDLL:
    lib = load("samfmt", "samfmt.cpp")
    if not getattr(lib, "_configured", False):
        lib.finish_se_native.restype = _c_i64
        lib.finish_se_native.argtypes = [
            _c_i32, _c_i64, _c_i32,      # B, Lp, nthreads
            _i16, _c_i32, _c_i32,        # fp, fpw, KFB
            _i32, _i16, _c_i32, _c_i32, _c_i32,  # tier0
            _i32, _i16, _c_i32, _c_i32, _c_i32,  # tier1
            _u8, _u8, _c_i32,            # seq codes, quals, qconst
            _i64, _u8,                   # lens, yf_qc
            _i64, _i64, _i64, _i32, _c_i32,  # frag tables, nfrag
            _u8, _i64,                   # refname buf/off
            _u8, _i64,                   # name buf/off (per batch row)
            _c_f64, _c_f64,              # min I/S
            _c_f64, _c_f64,              # nceil I/S
            _c_i32, _c_i32, _c_i32, _c_i32,
            # match_bonus, khits, KF, omit_sec
            _u8, _i64,                   # fast_out, read_end
            ctypes.c_char_p, _c_i64, _i64,  # out, cap, stats
            _i32, _i16, _i64]            # cols, mm_out, rec_ends scratch
        lib.finish_pe_native.restype = _c_i64
        lib.finish_pe_native.argtypes = [
            _c_i32, _c_i64, _c_i64, _c_i32,  # B, Lp1, Lp2, nthreads
            _i16, _c_i32, _c_i32,        # fp, fpw, NRB
            _i32, _i16, _c_i32, _c_i32, _c_i32,  # tier0
            _i32, _i16, _c_i32, _c_i32, _c_i32,  # tier1
            _u8, _u8, _i64,              # seq1, qual1, lens1
            _u8, _u8, _i64,              # seq2, qual2, lens2
            _c_i32,                      # qconst
            _i64, _i64, _i64, _i32, _c_i32,  # frag tables, nfrag
            _u8, _i64,                   # refname buf/off
            _u8, _i64,                   # name buf/off (per pair)
            _c_f64, _c_f64,              # min I/S
            _c_i32, _c_i32, _c_i32, _c_i32,
            # match_bonus, khits, NR, omit_sec
            _u8,                         # force_slow
            _u8, _i64,                   # fast_out, pair_end
            ctypes.c_char_p, _c_i64, _i64,  # out, cap, stats
            _i32, _i16, _i64]            # cols, mm_out, rec_ends scratch
        lib.format_pe_mix.restype = _c_i64
        lib.format_pe_mix.argtypes = [
            _c_i32,                      # nrec
            _i32, _i32, _i32,            # pair mate flag
            _i32, _i32, _i32,            # rname pos1 mapq
            _i32, _i32, _i32,            # c5 mid c3
            _i32, _i32,                  # rnext pnext1
            _i32, _i32, _i32, _i32, _i32,  # score zs nmm nh cnt
            _i16, _c_i32,                # mm lanes, MMX
            _u8, _i64,                   # name buf/off (per pair)
            _u8, _u8, _c_i64, _i32,      # seq1 qual1 Lp1 lens1
            _u8, _u8, _c_i64, _i32,      # seq2 qual2 Lp2 lens2
            _c_i32,                      # qconst
            _u8, _i64,                   # refname buf/off
            ctypes.c_char_p, _c_i64, _i64]  # out, cap, rec_ends
        lib.format_pe_batch.restype = _c_i64
        lib.format_pe_batch.argtypes = [
            _c_i32,
            _i32, _i32,                  # read_of flag
            _i32, _i32, _i32,            # rname pos1 mapq
            _i32, _i32, _i32,            # c5 mid c3
            _i32, _i32, _i32,            # pnext tlen yt_code
            _i32, _i32, _i32, _i32, _i32,  # score nmm nm zs nh
            _u8, _i64,                   # name buf/off (per read)
            _u8, _u8, _u8, _u8, _i64,    # seq_f qual_f seq_r qual_r off
            _i32, _u8, _i64,             # mm cols/ref/off (per record)
            _u8, _i64,                   # refname buf/off
            ctypes.c_char_p, _c_i64, _i64,  # out, cap, rec_ends
            _i32, _i32, _i32]            # m1, gapN, xs (spliced records)
        lib.format_se_batch2.restype = _c_i64
        lib.format_se_batch2.argtypes = [
            _c_i32,
            _i32, _i32,                  # read_of flag
            _i32, _i32, _i32,            # rname pos1 mapq
            _i32, _i32, _i32,            # c5 mid c3
            _i32, _i32, _i32, _i32, _i32,  # score nmm nm zs nh
            _u8, _i64,                   # name buf/off (per read)
            _u8, _u8, _u8, _u8, _i64,    # seq_f qual_f seq_r qual_r off
            _i32, _u8, _i64,             # mm cols/ref/off (per record)
            _u8, _i64,                   # refname buf/off
            ctypes.c_char_p, _c_i64, _i64,  # out, cap, rec_ends
            _i32, _i32, _i32]            # m1, gapN, xs (spliced records)
        lib.format_se_batch3.restype = _c_i64
        lib.format_se_batch3.argtypes = [
            _c_i32, _c_i32,              # nrec, nthreads
            _i32, _i32,                  # read_of flag
            _i32, _i32, _i32,            # rname pos1 mapq
            _i32, _i32, _i32,            # c5 mid c3
            _i32, _i32, _i32, _i32,      # score nmm zs nh
            _i16, _i32, _c_i32,          # mm lanes/cnt/stride
            _u8, _i64,                   # name buf/off (per fast read)
            _i32, _u8, _u8,              # rows, seq codes, quals
            _c_i32, _c_i64, _i32,        # qconst, Lp, lens
            _u8, _i64,                   # refname buf/off
            ctypes.c_char_p, _c_i64, _i64,  # out, cap, rec_ends
            _i32, _i32, _i32]            # m1, gapN, xs
        lib._configured = True
    return lib


def dpkernel_lib() -> ctypes.CDLL:
    lib = load("dpkernel", "dpkernel.cpp")
    if not getattr(lib, "_configured", False):
        p32 = ctypes.POINTER(ctypes.c_int32)
        lib.dp_traceback_one.restype = _c_i32
        lib.dp_traceback_one.argtypes = [
            _u8, _u8, _c_i32,            # rd qual L
            _u8, _c_i32,                 # ref W
            _i32, _i32,                  # mm_pens sc_pens
            _c_i32, _c_i32,              # match_bonus n_pen
            _c_i32, _c_i32,              # rd_open rd_ext
            _c_i32, _c_i32,              # rf_open rf_ext
            p32, p32,                    # out_score, out_ref_start
            _u8, _i32, p32,              # cigar ops/lens/count
            _i32, p32]                   # mds buf/count
        lib._configured = True
    return lib


def sais_lib() -> ctypes.CDLL:
    lib = load("sais", "sais.cpp")
    if not getattr(lib, "_configured", False):
        lib.sais_u8_i32.argtypes = [_u8, _i32, _c_i32, _c_i32]
        lib.sais_u8_i64.argtypes = [_u8, _i64, _c_i64, _c_i64]
        lib.kasai_lcp_i64.restype = None
        lib.kasai_lcp_i64.argtypes = [_u8, _i64, _i64, _c_i64]
        lib._configured = True
    return lib


def kmersort_lib() -> ctypes.CDLL:
    lib = load("kmersort", "kmersort.cpp")
    if not getattr(lib, "_configured", False):
        lib.kmer_table.restype = _c_i32
        lib.kmer_table.argtypes = [
            _u8, _c_i64, _c_i32, _i32, _i32, _c_i32, _c_i32]
        lib._configured = True
    return lib


def juncscore_lib() -> ctypes.CDLL:
    lib = load("juncscore", "juncscore.cpp")
    if not getattr(lib, "_configured", False):
        i8 = ndpointer(np.int8, flags="C_CONTIGUOUS")
        f32 = ndpointer(np.float32, flags="C_CONTIGUOUS")
        f64 = ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.junc_score_batch.restype = None
        lib.junc_score_batch.argtypes = [
            _u8, _c_i64, ctypes.c_void_p,   # joined, n, overlay or null
            i8, i8, _i64,                # rd q rdlens
            _i64, _i64, _c_i64, _c_i64,  # posA posB C L
            _i64, _i64, _c_i64,          # kleft kright nK
            _i64, _i64,                  # mm_pens sc_pens
            _c_i64, _c_i64,              # n_pen match_bonus
            _c_f64, _c_f64,              # smin I S
            _c_i64, _c_i32,              # max_intron dta
            _c_i64, _c_i64,              # canon/noncanon pen
            f64, f64,                    # donor/acceptor PWM
            _i64, f32, _c_i32]           # out, out_ps, nthreads
        lib._configured = True
    return lib
