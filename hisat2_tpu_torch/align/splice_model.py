"""Splice-site signal model + novel-junction acceptance policy.

Equivalent role to the reference's SpliceSiteDB::probscore
(splice_site.cpp:788, active non-NEW_PROB_MODEL branch) and the
spliced-alignment acceptance gates in GenomeHit score adjustment
(hi_aligner.h:3760-3800) and MaxIntronLen (hi_aligner.h:48-79).

The ACTIVE reference model is a position-weight matrix over a 9bp donor
window (3 exonic + 6 intronic) and a 15bp acceptor window (14 intronic +
1 exonic): probscore = sigmoid(sum of log(p/background)) — the reference
precomputes exp(-sum) lookup tables (splice_site.cpp:75-103) and returns
1/(1+prod), which is the same sigmoid. (The 6,224-line MaxEntScan tables
in splice_site_mem.h sit behind the never-defined NEW_PROB_MODEL flag —
dead code, deliberately not ported.)

PWM probabilities are model DATA from the reference's cited sources
(donor: splice_site.cpp:30; acceptor: splice_site.cpp:37 — Solovyev,
"Bioinformatics - From Genomes to Drugs" Ch.3; background
splice_site.h:66).
"""

from __future__ import annotations

import numpy as np

DONOR_EXONIC = 3
DONOR_INTRONIC = 6
DONOR_LEN = DONOR_EXONIC + DONOR_INTRONIC          # 9
ACCEPTOR_INTRONIC = 14
ACCEPTOR_EXONIC = 1
ACCEPTOR_LEN = ACCEPTOR_INTRONIC + ACCEPTOR_EXONIC  # 15

BACKGROUND = np.array([0.27, 0.23, 0.23, 0.27], np.float32)

# rows A,C,G,T x window position
DONOR_PWM = np.array([
    [0.340, 0.604, 0.092, 0.001, 0.001, 0.526, 0.713, 0.071, 0.160],
    [0.363, 0.129, 0.033, 0.001, 0.001, 0.028, 0.076, 0.055, 0.165],
    [0.183, 0.125, 0.803, 1.000, 0.001, 0.419, 0.118, 0.814, 0.209],
    [0.114, 0.142, 0.073, 0.001, 1.000, 0.025, 0.093, 0.059, 0.462],
], np.float32)

ACCEPTOR_PWM = np.array([
    [0.090, 0.084, 0.075, 0.068, 0.076, 0.080, 0.097, 0.092, 0.076,
     0.078, 0.237, 0.042, 1.000, 0.001, 0.239],
    [0.310, 0.310, 0.307, 0.293, 0.326, 0.330, 0.373, 0.385, 0.410,
     0.352, 0.309, 0.708, 0.001, 0.001, 0.138],
    [0.125, 0.115, 0.106, 0.104, 0.110, 0.113, 0.113, 0.085, 0.066,
     0.064, 0.212, 0.003, 0.001, 1.000, 0.520],
    [0.463, 0.440, 0.470, 0.494, 0.471, 0.463, 0.408, 0.429, 0.445,
     0.504, 0.240, 0.246, 0.001, 0.001, 0.104],
], np.float32)

DONOR_LOGODDS = np.log(DONOR_PWM / BACKGROUND[:, None]).astype(np.float32)
ACCEPTOR_LOGODDS = np.log(ACCEPTOR_PWM
                          / BACKGROUND[:, None]).astype(np.float32)


def probscore_np(donor_codes: np.ndarray, acc_codes: np.ndarray
                 ) -> np.ndarray:
    """probscore for (..., 9) donor and (..., 15) acceptor windows of
    base codes 0..3 (N -> treated as A, matching the reference's
    `if(base > 3) base = 0`, hi_aligner.h:1672)."""
    d = np.clip(donor_codes, 0, 3)
    a = np.clip(acc_codes, 0, 3)
    pos_d = np.arange(DONOR_LEN)
    pos_a = np.arange(ACCEPTOR_LEN)
    s = (DONOR_LOGODDS[d, pos_d].sum(axis=-1)
         + ACCEPTOR_LOGODDS[a, pos_a].sum(axis=-1))
    return 1.0 / (1.0 + np.exp(-s))


def probscore_thresh(intron_len) -> np.ndarray:
    """Minimum probscore for a novel canonical junction, stricter for
    long introns (hi_aligner.h:3778-3784)."""
    il = np.asarray(intron_len, np.int64)
    t = np.full(il.shape, 0.8, np.float32)
    t = np.where(il >> 12 != 0, 0.88, t)
    t = np.where(il >> 13 != 0, 0.91, t)
    t = np.where(il >> 14 != 0, 0.94, t)
    t = np.where(il >> 15 != 0, 0.97, t)
    t = np.where(il >> 16 != 0, 0.99, t)
    return t


def max_intron_len(anchor, min_anchor: int = 7) -> np.ndarray:
    """Longest intron a `anchor`-bp anchored canonical junction may span
    (hi_aligner.h:48: 2^clamp(2*anchor-4, 13, 30), 0 below min anchor)."""
    a = np.maximum(np.asarray(anchor, np.int64), 2)
    shift = np.clip(2 * a - 4, 13, 30)
    return np.where(np.asarray(anchor) >= min_anchor,
                    np.int64(1) << shift, 0)


def max_intron_len_noncan(anchor, min_anchor: int = 14) -> np.ndarray:
    """Non-canonical variant (hi_aligner.h:70: 2^min(2*anchor-10, 30))."""
    a = np.maximum(np.asarray(anchor, np.int64), 5)
    shift = np.minimum(2 * a - 10, 30)
    return np.where(np.asarray(anchor) >= min_anchor,
                    np.int64(1) << shift, 0)
