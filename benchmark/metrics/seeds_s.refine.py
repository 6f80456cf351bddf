"""seeds_s.refine: a job's seconds in its ``seeds`` span (the seed MEME file
read and the seeds lifted to the model order), mean over the window's
jobs."""

from benchlib.spans import per_job_mean, total


def read(run):
    return per_job_mean(run, total("seeds"))
