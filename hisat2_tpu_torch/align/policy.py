"""Seed-alignment policy strings (reference presets.cpp:30-88 +
aligner_seed_policy.cpp SeedAlignmentPolicy::parseString).

The reference's presets and the -N/-L/-i/-D/-R flags all append
semicolon-separated components to ONE policy string parsed in a second
pass: SEED=mm[,len]; SEEDLEN=len; IVAL=F,c,m; DPS=n; ROUNDS=n; MA=n;
MMP=Cn|Q; NP=Cn|Q; RDG=o,e; RFG=o,e; MIN=F,c,m; NCEIL=F,c,m.

This module is the same two-pass surface over OUR knobs. The seeding
machinery differs by design (direct-address k-mer tables instead of FM
multiseed, index/seed_table.py), so the seed components translate to
equivalent BUDGETS rather than literal seed geometry:

  SEED/SEEDLEN  seed length L -> smaller L = denser sampling: the seed
                count for a 100bp read at interval IVAL(100) with length
                L is ceil((100 - L) / ival) + 1 -> opts.n_seeds
  IVAL=F,c,m    interval function f(x) (C constant / L linear / S sqrt,
                simple_func.h semantics) evaluated at x=100
  DPS=n         DP extension budget -> opts.verify_cands (candidate
                loci verified per orientation; the reference's n is its
                max DP streak, hisat2.cpp:469)
  ROUNDS=n      re-seeding rounds -> opts.max_seeds scales n/2x from
                its base (the fallback segment pass re-seeds once)
  MA/MMP/NP/RDG/RFG/MIN/NCEIL -> Scoring fields directly.
"""

from __future__ import annotations

from dataclasses import replace


def _func_val(ftype: str, const: float, coef: float, x: float) -> float:
    """simple_func.h F,B,A semantics: C constant, L linear, S sqrt,
    G log."""
    import math
    if ftype == "C":
        return const
    if ftype == "L":
        return const + coef * x
    if ftype == "S":
        return const + coef * math.sqrt(x)
    if ftype == "G":
        return const + coef * math.log(x)
    raise ValueError(f"unknown function type {ftype!r}")


def apply_policy(polstr: str, opts, scoring, rdlen: int = 100):
    """Apply a semicolon policy string to (opts, scoring) in place;
    returns the possibly-replaced scoring (Scoring is frozen-ish).
    Unknown components raise ValueError (parseString rejects too)."""
    from .scoring import SimpleFunc

    seed_len = None
    ival = None
    for comp in polstr.split(";"):
        comp = comp.strip()
        if not comp:
            continue
        if "=" not in comp:
            raise ValueError(f"bad policy component {comp!r}")
        key, val = comp.split("=", 1)
        key = key.upper()
        args = val.split(",")
        if key == "SEED":
            # mm[,len]: mismatches in seed widen verification
            mm = int(args[0])
            if mm > 0:
                opts.verify_cands = max(opts.verify_cands, 24)
            if len(args) > 1:
                seed_len = int(args[1])
        elif key == "SEEDLEN":
            seed_len = int(args[0])
        elif key == "IVAL":
            ival = (args[0], float(args[1]) if len(args) > 1 else 0.0,
                    float(args[2]) if len(args) > 2 else 0.0)
        elif key == "DPS":
            opts.verify_cands = max(4, min(64, int(args[0])))
        elif key == "ROUNDS":
            n = int(args[0])
            opts.max_seeds = max(8, min(32, 8 * n))
        elif key == "MA":
            scoring = replace(scoring, match_bonus=int(args[0]))
        elif key == "MMP":
            a0 = args[0]
            if a0.startswith("C"):
                v = int(a0[1:])
                scoring = replace(scoring, mm_pen_max=v, mm_pen_min=v)
            elif a0 == "Q":
                pass                      # full qual scaling = default
            else:
                scoring = replace(scoring, mm_pen_max=int(a0),
                                  mm_pen_min=int(args[1])
                                  if len(args) > 1 else int(a0))
        elif key == "NP":
            a0 = args[0]
            scoring = replace(
                scoring, n_pen=int(a0[1:] if a0.startswith("C") else a0))
        elif key == "RDG":
            scoring = replace(
                scoring, read_gap_const=int(float(args[0])),
                read_gap_linear=(int(float(args[1])) if len(args) > 1
                                 else scoring.read_gap_linear))
        elif key == "RFG":
            scoring = replace(
                scoring, ref_gap_const=int(float(args[0])),
                ref_gap_linear=(int(float(args[1])) if len(args) > 1
                                else scoring.ref_gap_linear))
        elif key in ("MIN", "NCEIL"):
            # F,c,m / C,c / c,m (linear) — parseString's accepted forms
            if args[0][:1].isalpha():
                f = SimpleFunc(args[0].upper(),
                               float(args[1]) if len(args) > 1 else 0.0,
                               float(args[2]) if len(args) > 2 else 0.0)
            else:
                f = SimpleFunc("L", float(args[0]),
                               float(args[1]) if len(args) > 1 else 0.0)
            scoring = replace(scoring, **(
                {"score_min": f} if key == "MIN" else {"n_ceil": f}))
        else:
            raise ValueError(f"unknown policy component {key!r}")

    if seed_len is not None or ival is not None:
        L = seed_len if seed_len is not None else 22
        if ival is not None:
            iv = max(1.0, _func_val(ival[0], ival[1], ival[2], rdlen))
        else:
            iv = max(1.0, _func_val("S", 1, 1.15, rdlen))
        n_seeds = int((max(0, rdlen - L)) // iv) + 1
        opts.n_seeds = max(4, min(16, n_seeds))
    return scoring


PRESETS = {
    # reference presets.cpp:30-88 (end-to-end family; hisat2 is E2E)
    "very-fast": "SEED=0,22;DPS=5;ROUNDS=1;IVAL=S,0,2.50",
    "fast": "SEED=0,22;DPS=10;ROUNDS=2;IVAL=S,0,2.50",
    "sensitive": "SEED=0,22;DPS=15;ROUNDS=2;IVAL=S,1,1.15",
    "very-sensitive": "SEED=0,20;DPS=20;ROUNDS=3;IVAL=S,1,0.50",
}
