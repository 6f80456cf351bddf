"""setup_s: seconds from the run's start to the end of its warm-up job
(imports, CUDA context, the pool, library loads, the loop graphs'
captures)."""


def read(run):
    return run.setup_s
