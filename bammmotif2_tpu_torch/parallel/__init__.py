"""Multi-process runs over ``torch.distributed``: ``distributed`` brings up
the process group from a launcher's environment, ``mesh`` lays the ranks
out on (data, seed) axes and holds the collectives."""

from bammmotif2_tpu_torch.parallel import distributed, mesh

__all__ = ["distributed", "mesh"]
