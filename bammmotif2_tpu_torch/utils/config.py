"""Run configuration with the reference's flag names and defaults.

The port's copy of ``bammmotif2_tpu.utils.config``, with the same fields
and defaults, so both CLIs read a command line alike.  Equivalent of
``src/Global/Global.{h,cpp}`` (static globals + vendored getopt_pp): a
plain dataclass consumed everywhere, plus an argparse front-end in
``bammmotif2_tpu_torch.cli`` that accepts the reference's command lines
unmodified (``BaMMmotif OUTDIR POSFASTA --EM --FDR ...``).

Defaults follow SURVEY.md section 2 (Global row) and section 2.9:
model order 2, background order 2, q=0.9, alpha_0=1, alpha_k=beta*gamma^(k-1)
with beta=7 gamma=3, background strength A~=10, cvFold=5, sOrder=2.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Params:
    # --- positional ---------------------------------------------------- #
    outputDirectory: str = "."
    posSequenceFile: str = ""

    # --- sequence options ---------------------------------------------- #
    negSequenceFile: str | None = None      # --negSeqFile
    alphabetType: str = "STANDARD"          # --alphabet
    ss: bool = False                        # --ss : single strand only

    # --- initial model ------------------------------------------------- #
    bindingSiteFile: str | None = None      # --bindingSiteFile
    PWMFile: str | None = None              # --PWMFile (MEME / PEnG minimal MEME)
    BaMMFile: str | None = None             # --BaMMFile (.ihbcp)
    pattern: str | None = None              # --pattern IUPAC seed(s), ';'-separated
    baseBgModelFile: str | None = None      # --baseBgModelFile : .hbcp paired
                                            #   with --BaMMFile; its order-0
                                            #   marginals become f_bg
    maxPWM: int | None = None               # --maxPWM : cap number of seeds

    # --- model options ------------------------------------------------- #
    modelOrder: int = 2                     # -k / --order
    modelAlpha: float = 1.0                 # -a / --alpha : alpha_0
    modelBeta: float = 7.0                  # -b / --beta
    modelGamma: float = 3.0                 # -r / --gamma
    extend: tuple = (0, 0)                  # --extend L R : pad motif with bg

    # --- background model ---------------------------------------------- #
    bgModelOrder: int = 2                   # -K / --Order
    bgModelAlpha: float = 10.0              # -A / --Alpha
    bgModelFile: str | None = None          # --bgModelFile (.hbcp)

    # --- EM ------------------------------------------------------------ #
    EM: bool = False                        # --EM
    epsilon: float = 1e-3                   # -e / --epsilon : conv. threshold
    maxEMIterations: int = 1000             # --maxEMIterations
    q: float = 0.9                          # -q : ZOOPS occurrence prior
    optimizeQ: bool = False                 # --optimizeQ

    # --- Gibbs sampling ------------------------------------------------ #
    CGS: bool = False                       # --CGS
    maxCGSIterations: int = 100             # --maxCGSIterations
    noAlphaOptimization: bool = False       # --noAlphaOptimization
    noZSampling: bool = False               # --noZSampling
    noQSampling: bool = False               # --noQSampling
    cgsBurnIn: int = 0                      # --cgsBurnIn N : discard first N
                                            #   sweeps, average the rest
                                            #   (0 = final-sweep, reference-like)

    # --- FDR / evaluation ---------------------------------------------- #
    FDR: bool = False                       # --FDR
    mFold: int = 10                         # -m / --mFold : #neg = mFold * #pos
    cvFold: int = 5                         # -n / --cvFold
    sOrder: int = 2                         # -s / --sOrder : sampling bg order

    # --- scanning ------------------------------------------------------ #
    scoreSeqset: bool = False               # --scoreSeqset
    pvalCutoff: float = 1e-4                # --pvalCutoff

    # --- output -------------------------------------------------------- #
    basename: str | None = None             # --basename
    saveBaMMs: bool = True                  # --saveBaMMs
    saveInitialBaMMs: bool = False          # --saveInitialBaMMs
    savePRs: bool = True                    # --savePRs
    savePvalues: bool = False               # --savePvalues
    saveLogOdds: bool = False               # --saveLogOdds
    verbose: bool = False                   # --verbose

    # --- extensions (absent in reference) -------------------------------- #
    seed: int = 42                          # PRNG seed (jax.random's PRNGKey)
    use_pallas: bool = True                 # the hand-written kernels (--no-pallas: plain)
    multiDevice: bool = True                # shard over all devices/hosts if >1
    data_axis: str = "data"                 # mesh axis name for sequence sharding
    jsonl: bool = False                     # --jsonl : structured metrics file
    profile: str | None = None              # --profile DIR : torch.profiler trace
    checkpointEvery: int = 0                # --checkpointEvery N : save model
                                            #   every N EM iterations (restartable)

    def alpha_for_order(self, k: int) -> float:
        """alpha_k default: alpha_0 for k=0, beta*gamma^(k-1) for k>=1."""
        if k == 0:
            return self.modelAlpha
        return self.modelBeta * self.modelGamma ** (k - 1)
