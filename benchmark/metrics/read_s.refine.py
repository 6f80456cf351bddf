"""read_s.refine: a job's seconds in its ``read`` spans (the positive and
negative FASTA files parsed), mean over the window's jobs."""

from benchlib.spans import per_job_mean, total


def read(run):
    return per_job_mean(run, total("read"))
