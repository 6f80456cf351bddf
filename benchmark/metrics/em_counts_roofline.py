"""em_counts_roofline: the least time of the EM iterations' E+M passes over
the device time of ``em_counts_kernel`` in the traced jobs, in %.  The
work: at each iteration i of a (W, K) group, one pass of the seeds still
running at i (a seed's ``iterations``), ``roofline.em_bound``, so a seed
that has stopped adds nothing."""

from benchlib import roofline
from benchlib.readers import em_groups, roofline_share, rows_r1, shape


def least_ms(run, job) -> float:
    S, N, L, _opts = shape(run, job)
    total = 0.0
    for (W, K), (_secs, its) in em_groups(job).items():
        by_m: dict = {}
        for i in range(1, max(its) + 1):
            M = sum(n >= i for n in its)
            if M not in by_m:
                by_m[M] = roofline.em_bound(S, N, L, [L] * N, rows_r1(K), W, M)["bound_ms"]
            total += by_m[M]
    return total


def read(run):
    return roofline_share(run, "em_counts_kernel", lambda job: least_ms(run, job))
