"""Mapping quality (MAPQ), V2 model — reference unique.h:170 (BowtieMapq2),
the default (mapqv=2, hisat2.cpp:480), capped at 60.

Semantics reproduced from the reference (behavior, not code):
  * unique-without-exhaustive-search fast path -> 60 (unique.h:212-216):
    when reporting wasn't capped and the search didn't exhaust and there is
    no equal-scoring second-best, the read gets MAPQ 60.
  * otherwise a table keyed on (bestOver, bestdiff) / diff buckets, where
    diff = perfect - minScore, bestOver = best - minScore,
    bestdiff = |best - secbest| (unique.h:230-345), end-to-end branch.

This is scalar host-side work on the 1-2 selected alignments per read; the
device only supplies best/second-best scores.
"""

from __future__ import annotations


def mapq_v2(best: int, secbest: int | None, perfect: int, min_score: int,
            *, exhausted: bool = False, can_max: bool = False,
            local: bool = False) -> int:
    """MAPQ for the primary alignment of one read (or concordant pair, with
    scores/bounds summed over both mates)."""
    has_sec = secbest is not None
    equal_sec = has_sec and secbest == best
    if not can_max and not exhausted and not equal_sec:
        return 60
    diff = max(perfect - min_score, 1)
    best_over = best - min_score
    if not local:
        if not has_sec:
            for frac, q in ((0.8, 42), (0.7, 40), (0.6, 24), (0.5, 23),
                            (0.4, 8), (0.3, 3)):
                if best_over >= diff * frac:
                    return q
            return 0
        bestdiff = abs(abs(best) - abs(secbest))
        if bestdiff >= diff * 0.9:
            return 39 if best_over == diff else 33
        if bestdiff >= diff * 0.8:
            return 38 if best_over == diff else 27
        if bestdiff >= diff * 0.7:
            return 37 if best_over == diff else 26
        if bestdiff >= diff * 0.6:
            return 36 if best_over == diff else 22
        if bestdiff >= diff * 0.5:
            if best_over == diff:
                return 35
            if best_over >= diff * 0.84:
                return 25
            return 16 if best_over >= diff * 0.68 else 5
        if bestdiff >= diff * 0.4:
            if best_over == diff:
                return 34
            if best_over >= diff * 0.84:
                return 21
            return 14 if best_over >= diff * 0.68 else 4
        if bestdiff >= diff * 0.3:
            if best_over == diff:
                return 32
            if best_over >= diff * 0.88:
                return 18
            return 15 if best_over >= diff * 0.67 else 3
        if bestdiff >= diff * 0.2:
            if best_over == diff:
                return 31
            if best_over >= diff * 0.88:
                return 17
            return 11 if best_over >= diff * 0.67 else 0
        if bestdiff >= diff * 0.1:
            if best_over == diff:
                return 30
            if best_over >= diff * 0.88:
                return 12
            return 7 if best_over >= diff * 0.67 else 0
        if bestdiff > 0:
            return 6 if best_over >= diff * 0.67 else 2
        return 1 if best_over >= diff * 0.67 else 0
    # local-mode branch (unique.h:347-...)
    if not has_sec:
        for frac, q in ((0.8, 44), (0.7, 42), (0.6, 41), (0.5, 36),
                        (0.4, 28), (0.3, 24)):
            if best_over >= diff * frac:
                return q
        return 22
    bestdiff = abs(abs(best) - abs(secbest))
    for frac, q in ((0.9, 40), (0.8, 39), (0.7, 38), (0.6, 37)):
        if bestdiff >= diff * frac:
            return q
    for frac, qeq, qhi, qlo in ((0.5, 35, 25, 20), (0.4, 34, 21, 19),
                                (0.3, 33, 18, 16), (0.2, 32, 17, 12),
                                (0.1, 31, 14, 9)):
        if bestdiff >= diff * frac:
            if best_over == diff:
                return qeq
            return qhi if best_over >= diff * 0.5 else qlo
    if bestdiff > 0:
        return 11 if best_over >= diff * 0.5 else 2
    return 1 if best_over >= diff * 0.5 else 0


# ---------------------------------------------------------------------------
# V3 model (reference unique.h:95 BowtieMapq3, tables unique.cpp:26-66):
# stratifies best score and best/second-best difference into 10 bins.
# Selectable via Aligner mapq_v=3 (the reference hard-wires V2 at
# hisat2.cpp:480; V3 kept for parity with the Mapq class family).
# ---------------------------------------------------------------------------

_UNP_NOSEC_PERF = 44
_UNP_NOSEC = (43, 42, 41, 36, 32, 27, 20, 11, 4, 1, 0)
_UNP_SEC_PERF = (2, 16, 23, 30, 31, 32, 34, 36, 38, 40, 42)
_UNP_SEC = (
    (2, 2, 2, 1, 1, 0, 0, 0, 0, 0, 0),
    (20, 14, 7, 3, 2, 1, 0, 0, 0, 0, 0),
    (20, 16, 10, 6, 3, 1, 0, 0, 0, 0, 0),
    (20, 17, 13, 9, 3, 1, 1, 0, 0, 0, 0),
    (21, 19, 15, 9, 5, 2, 2, 0, 0, 0, 0),
    (22, 21, 16, 11, 10, 5, 0, 0, 0, 0, 0),
    (23, 22, 19, 16, 11, 0, 0, 0, 0, 0, 0),
    (24, 25, 21, 30, 0, 0, 0, 0, 0, 0, 0),
    (30, 26, 29, 0, 0, 0, 0, 0, 0, 0, 0),
    (30, 27, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (30, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
)
_PAIR_NOSEC_PERF = 44


def mapq_v3(best: int, secbest: int | None, perfect: int, min_score: int,
            *, paired: bool = False, exhausted: bool = False,
            can_max: bool = False) -> int:
    """MAPQ under the V3 model. `best`/`secbest` are alignment scores
    (pair-summed when paired... the reference returns a constant for
    pairs)."""
    if paired:
        return _PAIR_NOSEC_PERF
    has_sec = secbest is not None
    if not can_max and not exhausted and not has_sec:
        return 255
    span = max(perfect - min_score, 1)
    best_delta = perfect - best
    best_bin = min(int(best_delta * (10.0 / span) + 0.5), 10)
    if has_sec:
        diff = best - secbest
        diff_bin = min(int(diff * (10.0 / span) + 0.5), 10)
        if best == perfect:
            return _UNP_SEC_PERF[best_bin]
        return _UNP_SEC[diff_bin][best_bin]
    if best == perfect:
        return _UNP_NOSEC_PERF
    return _UNP_NOSEC[best_bin]
