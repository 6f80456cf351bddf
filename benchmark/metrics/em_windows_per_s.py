"""em_windows_per_s: windows the EM loops scored (every seed's iterations x
the windows of both strands) over the EM groups' seconds (each group's
``group_seconds`` once), summed over the window's jobs."""

from benchlib.readers import em_groups


def read(run):
    windows = sum(r.windows_scored for job in run.jobs
                  for r in job["result"].get("em_results") or [])
    secs = sum(s for job in run.jobs for s, _its in em_groups(job).values())
    return windows / secs if secs > 0 else None
