"""write_s.refine: a job's seconds in its ``write`` spans (the background
and model files written), mean over the window's jobs."""

from benchlib.spans import per_job_mean, total


def read(run):
    return per_job_mean(run, total("write"))
