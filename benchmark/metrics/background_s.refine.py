"""background_s.refine: a job's seconds in its ``background`` span (the
background model fit to the positives), mean over the window's jobs."""

from benchlib.spans import per_job_mean, total


def read(run):
    return per_job_mean(run, total("background"))
