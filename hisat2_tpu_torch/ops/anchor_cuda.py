"""The spliced path's anchor scan: the CUDA kernel's wrapper.

The JAX package scans in plain XLA here (hisat2_tpu/ops/splice.py:
anchor_scan), with no Pallas kernel; the port's plain version is
ops/splice.anchor_scan_plain_core, which stays as the CPU path and the
oracle. The kernel is csrc/anchor_scan.cu (CUDA C++ for sm_90a), built
with nvcc on first use into the package's git-ignored `_build/kernels/`
directory (ops/nvcc.py) and bound through ctypes to a plain C entry
point. ops/splice.anchor_scan sends a CUDA tensor here and a CPU tensor
to the plain core; `anchor_scan_core` launches the kernel for a CUDA
tensor and raises for any other.

Two launches a call, queued with no host synchronisation between them:
the tile-0 scan, counted in `launches["anchor_scan"]`, and, when
tiles > 1, the deeper tiles, counted in `launches["anchor_scan_deep"]`.
The deep launch returns at once on the device unless the tile-0 launch
found a live row without an N anchor that had no hit (the JAX version's
lax.cond); when it does take the branch it adds one to a per-device
counter that `deep_calls` reads (a synchronising read, for measurements
and tests, never on the step's path).
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import nvcc

SOURCE = os.path.join(nvcc.CSRC, "anchor_scan.cu")
MAX_NC = 32            # entries a row the kernel serves (its lists)
# csrc/anchor_scan.cu's geometry
ROWS_PER_BLOCK = 1     # scan rows a block
THREADS = 256          # threads a block
SEG_WORDS = 2048       # words a staged segment: the unit a row stops at
STRIP_WORDS = 256      # words of a segment one warp scans

launches = {"anchor_scan": 0, "anchor_scan_deep": 0}
_state: dict = {}
_deep_calls: dict = {}


def build() -> tuple[str, str]:
    """Compile csrc/anchor_scan.cu into a shared library (once per
    process). Returns (library path, the compiler's -Xptxas -v report)."""
    return nvcc.build(SOURCE)[0]


def _lib() -> ctypes.CDLL:
    lib = _state.get("lib")
    if lib is None:
        lib = ctypes.CDLL(build()[0])
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.anchor_scan_launch.restype = ci
        lib.anchor_scan_launch.argtypes = ([vp, cll] + [vp] * 6 + [ci] * 6
                                           + [vp] * 5 + [ci, vp])
        _state["lib"] = lib
    return lib


def _counter(device: torch.device) -> torch.Tensor:
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    t = _deep_calls.get(device)
    if t is None:
        t = torch.zeros(1, dtype=torch.int64, device=device)
        _deep_calls[device] = t
    return t


def deep_calls(device="cuda") -> int:
    """Calls on `device` whose deep launch took the branch (synchronises)."""
    return int(_counter(torch.device(device)).item())


def window_tests(kvalid: torch.Tensor, mpos: torch.Tensor, pos, down,
                 rdlens, has_n, live, min_intron, *, W: int, A: int,
                 NC: int, tiles: int) -> torch.Tensor:
    """The window tests one anchor scan needs, on the scan's device as an
    int64 scalar, with no host synchronisation: 16 a word, and each row
    tests words nearest first until it holds its NC-th hit, else to the
    end of tile 0, or of its last tile when the deep branch is taken (some
    live row without an N anchor has no hit in tile 0). This is
    chip_smoke.anchor_need's rule, worked out from the core's answer
    (kvalid, mpos) and its inputs, for either core.

    An entry's word is mpos // 16. Tile t's window starts at word b_t, the
    window's first character clamped at 0, over 16: b_0 + t * W/16 down,
    b_0 - t * W/16 up, and windows clamped at 0 all cover words [0, W/16).
    A row's entries run nearest first, tile by tile; within a tile the
    words only rise (down) or fall (up), so a word that does not marks a
    new tile, and an entry's tile is the first at or past that bound whose
    window holds its word."""
    dev = pos.device
    S = pos.shape[0]
    i64 = torch.int64
    if S == 0:
        return torch.zeros((), dtype=i64, device=dev)
    NW = W // 16
    pos, rdl = pos.to(i64), rdlens.to(i64)
    mi = torch.as_tensor(min_intron, dtype=i64, device=dev)
    ws = torch.where(down, pos + mi + rdl - A, pos - mi - W)
    b0 = torch.div(ws, 16, rounding_mode="floor")
    q0 = torch.div(b0, NW, rounding_mode="floor")
    # down: tiles below tc are clamped; up: tiles from tc on
    tc = torch.where(down, (-q0).clamp_min(0), (q0 + 1).clamp_min(0))
    big = torch.full_like(pos, 1 << 40)
    t = prev = None
    for k in range(NC):
        w = torch.div(mpos[:, k].to(i64), 16, rounding_mode="floor")
        lo = torch.zeros_like(pos) if k == 0 else t + torch.where(
            down, w <= prev, w >= prev).to(i64)
        tf = torch.where(down, torch.div(w - b0, NW, rounding_mode="floor"),
                         torch.div(b0 + NW - 1 - w, NW,
                                   rounding_mode="floor"))
        in0 = w < NW                 # inside the clamped windows
        t = torch.where(
            down,
            torch.minimum(torch.where(in0 & (lo < tc), lo, big),
                          torch.where(tf >= torch.maximum(lo, tc), tf, big)),
            torch.minimum(torch.where((tf >= lo) & (tf < tc), tf, big),
                          torch.where(in0, torch.maximum(lo, tc), big)))
        prev = w
        if k == 0:
            t0 = t
    bt = torch.where(down, b0 + t * NW, b0 - t * NW).clamp_min(0)
    need = t * NW + torch.where(down, w - bt, bt + NW - 1 - w) + 1
    live_t = torch.ones_like(has_n) if live is None else live.to(torch.bool)
    deep = torch.zeros((), dtype=torch.bool, device=dev)
    if tiles > 1:
        deep = (live_t & ~has_n & ~(kvalid[:, 0] & (t0 == 0))).any()
    rest = torch.where(deep, tiles * NW, NW)
    return 16 * torch.where(kvalid[:, NC - 1], need, rest).sum()


def anchor_scan_core(rows: torch.Tensor, pos: torch.Tensor,
                     down: torch.Tensor, rdlens: torch.Tensor,
                     acode: torch.Tensor, has_n: torch.Tensor, live,
                     min_intron, *, W: int, A: int, NC: int,
                     tiles: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The anchor scan's core on the card: (kvalid (S, NC) bool, mpos (S,
    NC) int32), equal to ops/splice.anchor_scan_plain_core's. rows (R, 16)
    int64 text words (idx["text_rows"]); pos, rdlens (S,) int32; down,
    has_n (S,) bool; acode (S,) the anchor codes; live (S,) bool or None;
    min_intron an int. Serves A = 8, W a multiple of 16 with W / 16 >= NC,
    1 <= NC <= 32, tiles >= 1, and raises on anything else."""
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"anchor_scan_core: no kernel for device {dev}")
    if A != 8 or W < 16 or W % 16 or not 1 <= NC <= MAX_NC \
            or W // 16 < NC or tiles < 1:
        raise ValueError(f"anchor_scan_core: the kernel serves A = 8, W a "
                         f"multiple of 16 with W / 16 >= NC, 1 <= NC <= "
                         f"{MAX_NC} and tiles >= 1, not A={A} W={W} NC={NC} "
                         f"tiles={tiles}")
    S = pos.shape[0]
    if rows.dim() != 2 or rows.shape[1] != 16 or rows.shape[0] < 1 \
            or rows.dtype != torch.int64:
        raise ValueError(f"anchor_scan_core: text rows must be (R >= 1, 16) "
                         f"int64, not {tuple(rows.shape)} {rows.dtype}")
    ins = {"rows": rows, "pos": pos, "down": down, "rdlens": rdlens,
           "acode": acode, "has_n": has_n}
    if live is not None:
        ins["live"] = live
    for name, t in ins.items():
        if t.device != dev:
            raise ValueError(f"anchor_scan_core: {name} on {t.device}, pos "
                             f"on {dev}")
        if name != "rows" and tuple(t.shape) != (S,):
            raise ValueError(f"anchor_scan_core: {name} has shape "
                             f"{tuple(t.shape)}, expected ({S},)")
    kvalid = torch.empty((S, NC), dtype=torch.bool, device=dev)
    mpos = torch.empty((S, NC), dtype=torch.int32, device=dev)
    if S == 0:
        return kvalid, mpos
    i32, u8 = torch.int32, torch.uint8
    rows = rows.contiguous()
    pos = pos.to(i32).contiguous()
    rdlens = rdlens.to(i32).contiguous()
    acode = acode.to(i32).contiguous()
    down = down.to(torch.bool).contiguous().view(u8)
    has_n = has_n.to(torch.bool).contiguous().view(u8)
    if live is not None:
        live = live.to(torch.bool).contiguous().view(u8)
    scratch = torch.empty(S + 1, dtype=i32, device=dev)   # counts, flag
    lib = _lib()
    with torch.cuda.device(dev):
        counter = _counter(dev)
        stream = torch.cuda.current_stream().cuda_stream
        for deep, key in ((0, "anchor_scan"), (1, "anchor_scan_deep")):
            if deep and tiles == 1:
                break
            err = lib.anchor_scan_launch(
                rows.data_ptr(), rows.shape[0], pos.data_ptr(),
                down.data_ptr(), rdlens.data_ptr(), acode.data_ptr(),
                has_n.data_ptr(), None if live is None else live.data_ptr(),
                S, int(min_intron), W, A, NC, tiles, kvalid.data_ptr(),
                mpos.data_ptr(), scratch.data_ptr(),
                scratch[S:].data_ptr(), counter.data_ptr(), deep, stream)
            if err != 0:
                raise RuntimeError(f"{key} kernel launch refused or failed "
                                   f"for S={S} W={W} NC={NC} tiles={tiles}: "
                                   f"CUDA error {err}")
            launches[key] += 1
    return kvalid, mpos
