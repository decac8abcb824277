"""What the benchmark wraps around the program's calls, from its own files.

Every wrapper replaces a module attribute that the program looks up at
call time, and `restore` puts the original back:

  * the window's opening: `io.reads._open_text`, the read layer opening a
    reads file (here the pipe), on its first call once armed;
  * spans (trace runs): the attributes the per-layer metrics name, each
    call (or each step of a returned iterator) timed on its thread with a
    tag; a span inside one of the same tag on its thread is marked nested;
  * the two hand kernels, `ops.dp_cuda.dp_score` (every module that holds
    it by `from ... import`) and `ops.anchor_cuda.anchor_scan_core`: a
    uniform sample of the window's calls, drawn from the seed (a
    reservoir), keeps copies of the inputs and the outputs on the device
    (queued on the call's stream, no host synchronisation), for the
    reference after the window; trace runs also keep each DP call's shape
    and read lengths for its bound;
  * plants (never in the driver's runs): the control and the faults of
    the correctness check (PERF.md), put in the program's place.
"""

from __future__ import annotations

import importlib
import resource
import sys
import threading
import time

import numpy as np

PKG = "hisat2_tpu_torch"
DP_KEEP = 8                 # DP calls kept for the reference (a reservoir)
ANCHOR_KEEP = 4             # anchor-scan calls kept


class TimedIter:
    """An iterator whose every step is a span."""

    def __init__(self, it, probes, tag):
        self.it, self.probes, self.tag = it, probes, tag

    def __iter__(self):
        return self

    def __next__(self):
        with self.probes.span(self.tag):
            return next(self.it)


class _Span:
    __slots__ = ("p", "tag", "t0", "nested")

    def __init__(self, p, tag):
        self.p, self.tag = p, tag

    def __enter__(self):
        st = self.p._stack()
        self.nested = self.tag in st
        st.append(self.tag)
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.p._stack().pop()
        self.p.spans.append((self.tag, threading.get_ident() == self.p.main,
                             self.t0, t1, self.nested))
        return False


class Probes:
    def __init__(self, seed: int, trace: bool):
        self.rng = np.random.default_rng(seed)
        self.trace = trace
        self.main = threading.get_ident()
        self.tls = threading.local()
        self.lock = threading.Lock()
        self.spans: list = []
        self.missing: set = set()     # (module, attr) no longer there
        self.dp_shapes: list = []     # trace: (C, L, W, ov, rdlens copy)
        self.dp_kept: list = []       # (inputs, consts, output) on device
        self.anchor_kept: list = []
        self.dp_calls = 0
        self.anchor_calls = 0
        self.t_open = None            # (time.time(), perf_counter_ns)
        self.ru_open = None           # resource usage at the opening
        self.on_open = None
        self.armed = False
        self._orig: list = []

    # ---- plumbing ---------------------------------------------------------
    def _stack(self):
        st = getattr(self.tls, "st", None)
        if st is None:
            st = self.tls.st = []
        return st

    def span(self, tag):
        return _Span(self, tag)

    def _set(self, mod, attr, value):
        self._orig.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, value)

    def restore(self):
        for mod, attr, val in reversed(self._orig):
            setattr(mod, attr, val)
        self._orig.clear()

    def _holders(self, fn):
        """(module, attribute) of every loaded module of the program that
        holds fn."""
        out = []
        for name, mod in list(sys.modules.items()):
            if mod is None or not (name == PKG or name.startswith(PKG + ".")):
                continue
            for attr, val in list(vars(mod).items()):
                if val is fn:
                    out.append((mod, attr))
        return out

    def _slot(self, k: int, have: int, size: int):
        """Reservoir sampling over the window's calls: the slot the k-th
        call takes, or None (each call is kept with equal chance)."""
        if have < size:
            return have
        j = int(self.rng.integers(k))
        return j if j < size else None

    def _put(self, kept: list, slot: int, item) -> None:
        with self.lock:
            if slot < len(kept):
                kept[slot] = item
            else:
                kept.append(item)

    # ---- the window's opening ----------------------------------------------
    def install_open(self):
        mod = importlib.import_module(PKG + ".io.reads")
        orig = mod._open_text

        def _open_text(path):
            if self.armed and self.t_open is None:
                if self.on_open is not None:       # the profiler's start
                    self.on_open()
                self.t_open = (time.time(), time.perf_counter_ns())
                self.ru_open = resource.getrusage(resource.RUSAGE_SELF)
            return orig(path)
        self._set(mod, "_open_text", _open_text)

    # ---- spans ------------------------------------------------------------
    def install_spans(self, specs):
        """specs: (module, attribute, "call" | "iter", tag), each once."""
        seen = set()
        for modname, attr, kind, tag in specs:
            if (modname, attr) in seen:
                continue
            seen.add((modname, attr))
            try:
                mod = importlib.import_module(modname)
                fn = getattr(mod, attr)
            except (ImportError, AttributeError):
                self.missing.add((modname, attr))
                continue
            self._set(mod, attr, self._wrap(fn, kind, tag))

    def _wrap(self, fn, kind, tag):
        if kind == "iter":
            def w(*a, **k):
                return TimedIter(iter(fn(*a, **k)), self, tag)
        else:
            def w(*a, **k):
                with self.span(tag):
                    return fn(*a, **k)
        w.__wrapped__ = fn
        return w

    # ---- the hand kernels ----------------------------------------------------
    def install_kernels(self, plant=None, device="cuda"):
        """On the CPU (the tests' rehearsals) the anchor scan's plain core
        stands where the kernel does on the card, and is wrapped instead."""
        import torch
        dp_mod = importlib.import_module(PKG + ".ops.dp_cuda")
        an_mod = importlib.import_module(
            PKG + (".ops.anchor_cuda" if device == "cuda" else ".ops.splice"))
        dp_orig = dp_mod.dp_score
        an_orig = (an_mod.anchor_scan_core if device == "cuda"
                   else an_mod.anchor_scan_plain_core)
        dp_impl = plants.dp(plant, dp_orig)
        an_impl = plants.anchor(plant, an_orig)

        def dp_score(rd, pen, rdlens, ref, scp_cum, *, ov=None, plan=None,
                     **consts):
            out = dp_impl(rd, pen, rdlens, ref, scp_cum, ov=ov, plan=plan,
                          **consts)
            if self.t_open is None:
                return out
            with self.lock:
                self.dp_calls += 1
                slot = self._slot(self.dp_calls, len(self.dp_kept), DP_KEEP)
            if self.trace:
                self.dp_shapes.append((*rd.shape, ref.shape[1],
                                       ov is not None, rdlens.clone()))
            if slot is not None:
                ins = {k: v.clone() for k, v in (
                    ("rd", rd), ("pen", pen), ("rdlens", rdlens),
                    ("ref", ref), ("scp_cum", scp_cum), ("ov", ov))
                    if v is not None}
                self._put(self.dp_kept, slot, (ins, dict(consts), out.clone()))
            return out

        def anchor_scan_core(rows, pos, down, rdlens, acode, has_n, live,
                             min_intron, *, W, A, NC, tiles):
            kv, mpos = an_impl(rows, pos, down, rdlens, acode, has_n, live,
                               min_intron, W=W, A=A, NC=NC, tiles=tiles)
            if self.t_open is None:
                return kv, mpos
            with self.lock:
                self.anchor_calls += 1
                slot = self._slot(self.anchor_calls, len(self.anchor_kept),
                                  ANCHOR_KEEP)
            if slot is not None:
                ins = {"pos": pos.clone(), "down": down.clone(),
                       "rdlens": rdlens.clone(), "acode": acode.clone(),
                       "has_n": has_n.clone(),
                       "live": None if live is None else live.clone(),
                       "min_intron": (min_intron.clone()
                                      if torch.is_tensor(min_intron)
                                      else min_intron),
                       "W": W, "A": A, "NC": NC, "tiles": tiles}
                self._put(self.anchor_kept, slot,
                          (ins, kv.clone(), mpos.clone()))
            return kv, mpos

        for mod, attr in self._holders(dp_orig):
            self._set(mod, attr, dp_score)
        for mod, attr in self._holders(an_orig):
            self._set(mod, attr, anchor_scan_core)
        plants.install_io(plant, self)


from . import plants  # noqa: E402  (plants uses Probes._set)
