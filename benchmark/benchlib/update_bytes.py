"""The bytes of the EM loop's fused model update (``em_update_kernel``), the
yardstick of ``em_update_roofline``.

A seed pass is one active seed's update at one iteration, over a count
table of R1 combined rows (the sentinel row among them) and W columns
and N sequences.  It reads each input byte once and writes each output
byte once: the float64 counts read and set to zero for the next pass,
the per-sequence log marginals read, the conditionals v (R1 - 1 rows)
read and written, the log-odds LUT's R1 - 1 rows written (the sentinel
row stays zero), the seed's pseudo-count strengths read and the
background's R1 - 1 conditionals read.  Its float32 operations (a few an
entry) lie three orders of magnitude under the bytes' time at the H100's
peaks, so bytes set the bound.
"""

from __future__ import annotations

from benchlib import roofline

F64, F32 = 8, 4
A = 4


def seed_pass_bytes(R1: int, W: int, N: int, K: int) -> int:
    """The bytes one seed pass must move."""
    R = R1 - 1
    counts = 2 * F64 * R1 * W          # read, then zeroed
    logz = F32 * N
    v = 2 * F32 * R * W                # read and written
    lut = F32 * R * W
    inputs = F32 * (K + 1) * W + F32 * R  # alphas, the background's conditionals
    return counts + logz + v + lut + inputs


def update_bound(passes: int, R1: int, W: int, N: int, K: int) -> dict:
    """``roofline.bound`` of ``passes`` seed passes at (R1, W, N, K)."""
    return roofline.bound(passes * seed_pass_bytes(R1, W, N, K), 0)
