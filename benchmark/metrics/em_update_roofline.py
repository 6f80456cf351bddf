"""em_update_roofline: the least time of the EM loops' fused model updates
over the device time of ``em_update_kernel`` in the traced jobs, in %.
The work: each (W, K) group's seed passes (the sum of its seeds'
``iterations``), each one active seed's update at the group's table
(``update_bytes.seed_pass_bytes``, R1 from the ``em.group`` span).  A
program whose ``em.group`` spans carry no ``R1`` gives nothing to read."""

from benchlib import update_bytes
from benchlib.readers import roofline_share, shape


def least_ms(run, job) -> float | None:
    _S, N, _L, _opts = shape(run, job)
    groups = [s["attrs"] for s in job["events"].get("span", []) if s["name"] == "em.group"]
    if not groups or any("R1" not in g for g in groups):
        return None
    return sum(update_bytes.update_bound(sum(g["iterations"]), g["R1"], g["W"], N,
                                         g["K"])["bound_ms"] for g in groups)


def read(run):
    if not run.traced or any(least_ms(run, job) is None for job in run.traced):
        return None
    return roofline_share(run, "em_update_kernel", lambda job: least_ms(run, job))
