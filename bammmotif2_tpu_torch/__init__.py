"""bammmotif2_tpu_torch — the PyTorch / CUDA port of bammmotif2_tpu.

The JAX package ``bammmotif2_tpu`` is the reference; this package mirrors
its module names (``ops.encode``, ``models.motif``, ``refinement.em``, ...)
so each counterpart is easy to find, and is held to it by the
``tests/test_torch_*.py`` parity tests.  Plain tensor code is PyTorch
(float32 throughout, an explicit ``device`` threaded through).  Two
hand-written CUDA kernels carry the hot paths: the fused E+M data pass of
one EM iteration (``csrc/em_counts.cu``, bound in ``ops.cuda_em``) and the
seed-stacked window scores of scanning and FDR (``csrc/window_scores.cu``,
bound in ``ops.cuda_scores``).

The port never imports ``jax``.  It reuses the reference's jax-free host
modules by import: ``bammmotif2_tpu.utils.{alphabet,fasta,config,metrics}``
and ``bammmotif2_tpu.io.native``.
"""

__version__ = "0.1.0"
