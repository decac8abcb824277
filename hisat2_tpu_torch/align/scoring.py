"""Scoring model + SimpleFunc-style function-valued options.

Equivalent role to the reference's scoring.{h,cpp} + simple_func.h
(SURVEY.md §2.3 "Scoring"): match bonus (0 end-to-end), quality-scaled
mismatch penalty (MIN=2..MAX=6 over q in [0,40], scoring.h:117-128),
constant N penalty 1, affine gaps (open = const+linear = 5+3, extend =
linear = 3, scoring.h:447-470), minimum-score function `L,0,-0.2` and
N-ceiling `L,0,0.15` (hisat2.cpp:441-443).

Device form: the per-quality penalty tables are tiny int32 tensors and the
scalars are 0-dim int32 tensors on the aligner's device (device_tables); the
DP kernel takes the six gap/match integers as plain arguments (dp_consts).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class SimpleFunc:
    """Function-valued option: f(x) = clamp(I + S * g(x), mn, mx) with g per
    type C(0)/L(x)/S(sqrt x)/G(ln x) — reference simple_func.h semantics
    (MANUAL.markdown:247-270)."""
    type: str = "C"     # C | L | S | G
    I: float = 0.0      # intercept
    S: float = 1.0      # slope / coefficient
    mn: float = -float("inf")
    mx: float = float("inf")

    def __call__(self, x: float) -> float:
        if self.type == "C":
            g = 0.0
        elif self.type == "L":
            g = x
        elif self.type == "S":
            g = np.sqrt(max(x, 0.0))
        elif self.type == "G":
            g = np.log(max(x, 1.0))
        else:
            raise ValueError(f"bad SimpleFunc type {self.type}")
        return float(np.clip(self.I + self.S * g, self.mn, self.mx))

    @staticmethod
    def parse(s: str) -> "SimpleFunc":
        """Parse 'L,0,-0.2' CLI syntax (type,intercept,slope)."""
        parts = s.split(",")
        t = parts[0].strip().upper()
        I = float(parts[1]) if len(parts) > 1 else 0.0
        S = float(parts[2]) if len(parts) > 2 else 0.0
        return SimpleFunc(t, I, S)


def _qual_pens(mn: int, mx: int) -> np.ndarray:
    """Quality -> penalty table, reference scoring.h:117-128: linear ramp
    mn..mx over q=0..40, flat above."""
    q = np.minimum(np.arange(64), 40)
    return (mn + ((q / 40.0) * (mx - mn)).astype(np.int32)).astype(np.int32)


@dataclass(frozen=True)
class Scoring:
    """Alignment scoring parameters (end-to-end defaults; `local=True` flips
    to local-mode constants, scoring.h:29-52)."""
    local: bool = False
    no_softclip: bool = False       # --no-softclip
    match_bonus: int = 0            # 2 in local mode
    mm_pen_max: int = 6
    mm_pen_min: int = 2
    n_pen: int = 1
    sc_pen_max: int = 2             # soft-clip penalty (local), qual-scaled
    sc_pen_min: int = 1
    read_gap_const: int = 5
    read_gap_linear: int = 3
    ref_gap_const: int = 5
    ref_gap_linear: int = 3
    score_min: SimpleFunc = field(default_factory=lambda: SimpleFunc("L", 0.0, -0.2))
    n_ceil: SimpleFunc = field(default_factory=lambda: SimpleFunc("L", 0.0, 0.15))
    # spliced-alignment penalties (hisat2.cpp:493-497)
    canonical_splice_pen: int = 0
    noncanonical_splice_pen: int = 12
    conflict_splice_pen: int = 1000000
    canonical_intronlen_pen: SimpleFunc = field(default_factory=lambda: SimpleFunc("G", -8.0, 1.0))
    noncanonical_intronlen_pen: SimpleFunc = field(default_factory=lambda: SimpleFunc("G", -8.0, 1.0))

    @classmethod
    def local_default(cls) -> "Scoring":
        return cls(local=True, match_bonus=2,
                   score_min=SimpleFunc("G", 20.0, 8.0))

    # ------- derived tables / scalars -------

    @property
    def monotone(self) -> bool:
        return not self.local and self.match_bonus == 0

    def mm_pens(self) -> np.ndarray:
        """(64,) int32 penalty per phred quality (memoized — per-read
        slow paths call this in loops)."""
        t = getattr(self, "_mm_pens_memo", None)
        if t is None:
            t = _qual_pens(self.mm_pen_min, self.mm_pen_max)
            object.__setattr__(self, "_mm_pens_memo", t)
        return t

    def sc_pens(self) -> np.ndarray:
        """Per-quality soft-clip penalty (--sp 1,2 default); a prohibitive
        constant under --no-softclip so the max-subarray scorer degenerates
        to full-length alignment. Memoized."""
        t = getattr(self, "_sc_pens_memo", None)
        if t is None:
            t = (np.full(64, 1 << 20, dtype=np.int32) if self.no_softclip
                 else _qual_pens(self.sc_pen_min, self.sc_pen_max))
            object.__setattr__(self, "_sc_pens_memo", t)
        return t

    def read_gap_open(self) -> int:
        return self.read_gap_const + self.read_gap_linear

    def read_gap_extend(self) -> int:
        return self.read_gap_linear

    def ref_gap_open(self) -> int:
        return self.ref_gap_const + self.ref_gap_linear

    def ref_gap_extend(self) -> int:
        return self.ref_gap_linear

    def perfect_score(self, rdlen: int) -> int:
        return self.match_bonus * rdlen

    def min_score(self, rdlen: int) -> int:
        """Minimum valid alignment score for a read of this length
        (reference scoreMin, default -0.2*L). Cached per length — this is
        called once per finalized alignment."""
        cache = object.__getattribute__(self, "_min_cache") if \
            "_min_cache" in self.__dict__ else None
        if cache is None:
            cache = {}
            object.__setattr__(self, "_min_cache", cache)
        v = cache.get(rdlen)
        if v is None:
            v = int(np.ceil(self.score_min(rdlen)))
            cache[rdlen] = v
        return v

    def max_ns(self, rdlen: int) -> int:
        return int(self.n_ceil(rdlen))

    def device_tables(self, device="cuda"):
        """Small tensors + ramp parameters consumed by batched kernels, on
        `device`.

        The per-quality tables are linear ramps (scoring.h:117-128); batched
        kernels evaluate the ramp ARITHMETICALLY (mm_pen_of/sc_pen_of), so a
        64-entry table lookup never becomes a per-element gather. The
        integer form is checked against the reference's float-truncation
        table here so kernel scores stay bit-identical."""
        import torch
        q = np.minimum(np.arange(64), 40)
        mm_formula = self.mm_pen_min + \
            (q * (self.mm_pen_max - self.mm_pen_min)) // 40
        if not (mm_formula == self.mm_pens()).all():
            raise ValueError("integer ramp diverges from reference table (mm)")
        if not self.no_softclip:
            sc_formula = self.sc_pen_min + \
                (q * (self.sc_pen_max - self.sc_pen_min)) // 40
            if not (sc_formula == self.sc_pens()).all():
                raise ValueError(
                    "integer ramp diverges from reference table (sc)")

        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device=device)
        return dict(
            mm_pens=torch.as_tensor(self.mm_pens(), device=device),
            sc_pens=torch.as_tensor(self.sc_pens(), device=device),
            mm_min=i32(self.mm_pen_min),
            mm_delta=i32(self.mm_pen_max - self.mm_pen_min),
            sc_min=i32((1 << 20) if self.no_softclip else self.sc_pen_min),
            sc_delta=i32(0 if self.no_softclip
                         else self.sc_pen_max - self.sc_pen_min),
            n_pen=i32(self.n_pen),
            match_bonus=i32(self.match_bonus),
            rd_open=i32(self.read_gap_open()),
            rd_ext=i32(self.read_gap_extend()),
            rf_open=i32(self.ref_gap_open()),
            rf_ext=i32(self.ref_gap_extend()),
        )

    def dp_consts(self) -> dict:
        """The six scoring integers the DP kernel takes as arguments."""
        return dict(match_bonus=int(self.match_bonus), n_pen=int(self.n_pen),
                    rd_open=int(self.read_gap_open()),
                    rd_ext=int(self.read_gap_extend()),
                    rf_open=int(self.ref_gap_open()),
                    rf_ext=int(self.ref_gap_extend()))


def mm_pen_of(sctab, q):
    """Qual-scaled mismatch penalty, arithmetic ramp (== mm_pens[q] for
    q clipped to [0, 63]); q int32 tensor, any shape. `//` floors, as
    jnp's does."""
    qq = q.clamp(0, 40)
    return sctab["mm_min"] + (qq * sctab["mm_delta"]) // 40


def sc_pen_of(sctab, q):
    """Qual-scaled soft-clip penalty, arithmetic ramp (== sc_pens[q])."""
    qq = q.clamp(0, 40)
    return sctab["sc_min"] + (qq * sctab["sc_delta"]) // 40


DEFAULT_SCORING = Scoring()
