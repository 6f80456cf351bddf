"""idle_share.refine: the share of the traced --EM jobs' seconds in which no
device operation ran (torch.profiler), in %."""

from benchlib.readers import idle_share


def read(run):
    return idle_share(run)
