"""bammmotif2_tpu_torch — the PyTorch / CUDA port of bammmotif2_tpu.

The JAX package ``bammmotif2_tpu`` is the reference; this package mirrors
its module names (``ops.encode``, ``models.motif``, ``refinement.em``, ...)
so each counterpart is easy to find, and is held to it by the
``tests/test_torch_*.py`` parity tests.  Plain tensor code is PyTorch
(float32 throughout, an explicit ``device`` threaded through).
Hand-written CUDA kernels carry the hot paths: the fused E+M data pass of
one EM iteration (``csrc/em_counts.cu``, bound in ``ops.cuda_em``), the
seed-stacked window scores of scanning and FDR (``csrc/window_scores.cu``,
``ops.cuda_scores``), the counts of a Gibbs sweep
(``csrc/counts_from_r.cu``, ``ops.cuda_counts``), and the three passes on
base-(A+1) k-mer codes (``csrc/flat.cu``, ``ops.cuda_flat``).  Under a
multi-process launch ``parallel`` shards EM and CGS over the ranks with
``torch.distributed`` (``parallel.distributed``, ``parallel.mesh``).  Entry
points run on the current CUDA device unless given ``device="cpu"``
(``utils.device.resolve``).

The port imports neither ``jax`` nor anything of ``bammmotif2_tpu``.  It
keeps its own copies of the reference's host modules: ``utils.{alphabet,
fasta,config,metrics}`` and ``io.native`` (tests/test_torch_imports.py
holds it to that).
"""

__version__ = "0.1.0"

from bammmotif2_tpu_torch.utils.alphabet import Alphabet
from bammmotif2_tpu_torch.utils.config import Params

__all__ = ["Alphabet", "Params", "__version__"]
