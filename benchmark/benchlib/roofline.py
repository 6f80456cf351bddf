"""The least time the card could take for a kernel's work: the yardstick of
the ``*_roofline`` metrics.

Frozen copies, as of commit c5dc2a4, of ``chip_smoke.py``'s ``bound`` (its
byte and float32 terms) and ``em_bound``.  They count from shapes, not
tensors: the bytes a function must move (each input read once, each
output written once) and its float32 operations, against the published
peaks of one NVIDIA H100 SXM (700 W data sheet).
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound(nbytes: int, ops: int) -> dict:
    """The larger of the bytes over HBM_BYTES_PER_S and the f32 operations
    over F32_OPS_PER_S: ``bound_ms`` in ms, ``bound_term`` the term that
    sets it."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S, "f32": ops / F32_OPS_PER_S}
    term = max(terms, key=terms.get)
    return {"bound_ms": terms[term] * 1e3, "bound_term": term, "bytes": int(nbytes),
            "ops": int(ops)}


def valid_windows(lens, S: int, W: int) -> int:
    """Window starts i with i + W <= len, over all rows and strands."""
    return S * int(np.maximum(np.asarray(lens, np.int64) - W + 1, 0).sum())


def em_bound(S: int, N: int, L: int, lens, R1: int, W: int, M: int) -> dict:
    """E+M pass of M seeds over int32 codes [S, N, L]: codes, lens, M LUTs
    and q in, M count tables and ll out; 2W + 6 f32 operations a valid
    window and seed (W adds to score it, a max, an exp and an add for
    log Z, an exp for r, W adds of r)."""
    nbytes = S * N * L * 4 + N * 4 + 2 * M * (R1 * W * 4 + 4)
    return bound(nbytes, M * valid_windows(lens, S, W) * (2 * W + 6))
