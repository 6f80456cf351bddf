"""em_host_s.refine: a job's seconds in its ``em`` span less the ``em.loop``
spans inside it: the EM stage's host work around the loops (each group's
data and seed tensors, its loop's set-up, the results read back), mean
over the window's jobs."""

from benchlib.spans import less_inner, per_job_mean


def read(run):
    return per_job_mean(run, less_inner("em", "em.loop"))
