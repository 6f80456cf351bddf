"""refine_job_s: the window's seconds over its completed jobs (host clock)."""

from benchlib.readers import job_s


def read(run):
    return job_s(run)
