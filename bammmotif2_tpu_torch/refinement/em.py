"""ZOOPS EM refinement: the data pass and what the EM loops share.

Port of ``bammmotif2_tpu.refinement.em`` (``EM::optimize``, ``EStep``,
``MStep``, ``optimizeQ``).  One EM iteration:

    E: rebuild the [R+1, W] log-odds LUT, score every window, log-space
       ZOOPS posterior
    M: fractional combined count rows, marginalize to per-order counts,
       apply the interpolated pseudo-count estimator, optionally update q

This module holds the E+M data pass (``data_pass``) and its set-up; the
model update, the convergence loop and its entry points (``run_em``,
``run_em_multi``) are ``refinement.multi``'s, which imports from here and
never the other way.  Two data paths produce the same counts and
likelihood:
  * ``"cuda"``: the fused CUDA kernel (``ops.cuda_em.em_counts_multi``);
  * ``"plain"``: the PyTorch escore ops, on the CPU or on the card
    (``--no-pallas``).

With a mesh (``parallel.mesh``) the rows shard over the data axis: each
rank runs the data pass on its block, and one all-reduce an iteration sums
the float64 counts and the likelihoods over the data group, which are
rounded to float32 once, as a single process rounds its sums.  Every rank
then holds the same sums and takes the same stop decision.
"""

from __future__ import annotations

import dataclasses

import torch

from bammmotif2_tpu_torch.utils.config import Params
from bammmotif2_tpu_torch.utils.fasta import SequenceSet
from bammmotif2_tpu_torch.models.background import BackgroundModel
from bammmotif2_tpu_torch.ops import cuda_em, encode
from bammmotif2_tpu_torch.parallel import mesh as mesh_mod


@dataclasses.dataclass
class EMResult:
    iterations: int
    ll: float
    q: float
    v_diff: float
    converged: bool
    ll_history: list
    seconds: float       # execution time of the EM loop (kernel build
                         # excluded); in batched group runs: this seed's
                         # iteration share of the group wall-clock
    windows_scored: int  # total windows scored across all iterations
    group_seconds: float = 0.0    # raw wall-clock of the batched group
                                  # this seed ran in (its em.loop span;
                                  # 0 = solo run)

    @property
    def windows_per_sec(self) -> float:
        return self.windows_scored / self.seconds if self.seconds > 0 else 0.0


def prepare_data(sset: SequenceSet, bg: BackgroundModel, K: int, ss: bool, device) -> dict:
    """One-time tensorization for EM: {cidx [S, N, L], lens [N], bg_flat [R]}.

    (cidx, lens) are the set's memoised ``encode.strand_indices``, which
    the background fit may have built already.  Callers never mutate the
    returned tensors.
    """
    device = torch.device(device)
    cidx, lens = encode.strand_indices(sset, K, ss, device)
    return {
        "cidx": cidx,
        "lens": lens,
        "bg_flat": torch.as_tensor(bg.conditional_flat(K), dtype=torch.float32, device=device),
    }


def counts_fn(path: str):
    """The E+M data pass of a path: the kernel or its plain version."""
    return cuda_em.em_counts_multi if path == "cuda" else cuda_em.em_counts_multi_ref


def data_pass(path: str, s_flat, data: dict, q, mesh=None) -> tuple:
    """(C f32 [M, R+1, W], ll f32 [M]) of the E+M data pass for M seeds.

    With a mesh: this rank's rows, then one all-reduce over the data group
    of the float64 counts and the likelihoods, rounded to float32 once.
    """
    if mesh is None:
        return counts_fn(path)(s_flat, data["cidx"], data["lens"], q)
    Cd, ll = counts_fn(path)(s_flat, data["cidx"], data["lens"], q, unrounded=True)
    M = q.shape[0]
    buf = mesh_mod.all_reduce(torch.cat([Cd.reshape(-1), ll.to(torch.float64)]),
                              mesh.data_group)
    return buf[:-M].reshape(Cd.shape).to(torch.float32), buf[-M:].to(torch.float32)


def choose_path(params: Params, device) -> str:
    """``"cuda"`` for data on a CUDA device unless --no-pallas; else
    ``"plain"``."""
    if params.use_pallas and torch.device(device).type == "cuda":
        return "cuda"
    return "plain"


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def load_kernels(path: str) -> None:
    """Build/load the path's kernel now, so EM timings exclude it."""
    if path == "cuda":
        cuda_em.library()
