"""cli_rest_s.refine: a job's run seconds (``runtime_seconds``) less its EM
stage (each (W, K) group's ``group_seconds`` once): FASTA parsing, the
background fit, seed loading and the writes.  Mean over the window's
jobs."""

from benchlib.readers import em_groups, mean


def read(run):
    return mean([job["result"]["runtime_seconds"]
                 - sum(s for s, _its in em_groups(job).values()) for job in run.jobs])
