"""MotifSet: fan-out from the chosen seed source to a list of Motifs.

Port of ``bammmotif2_tpu.models.motifset`` (``MotifSet::MotifSet``): one
Motif per seed, capped by --maxPWM, with optional --extend padding using
background frequencies.
"""

from __future__ import annotations

import numpy as np

from bammmotif2_tpu_torch.utils.alphabet import Alphabet
from bammmotif2_tpu_torch.utils.config import Params
from bammmotif2_tpu_torch.models import seeds as seeds_mod
from bammmotif2_tpu_torch.models.motif import Motif


def extend_motif(m: Motif, left: int, right: int) -> Motif:
    """Pad a motif with background-distributed positions (--extend L R)."""
    if left == 0 and right == 0:
        return m
    A = m.A
    W = m.W + left + right
    v = []
    for k in range(m.K + 1):
        pad = np.empty((A ** (k + 1), 1))
        # order-0 background marginal on the newest base, uniform over context
        pad[:, 0] = np.tile(m.f_bg, A ** k) if k == 0 else m.f_bg[np.arange(A ** (k + 1)) % A]
        v.append(np.concatenate(
            [np.repeat(pad, left, axis=1), m.v[k], np.repeat(pad, right, axis=1)], axis=1
        ))
    alphas = np.concatenate(
        [
            np.repeat(m.alphas[:, :1], left, axis=1),
            m.alphas,
            np.repeat(m.alphas[:, -1:], right, axis=1),
        ],
        axis=1,
    )
    return Motif(W, m.K, v, alphas, m.f_bg, m.alphabet, name=m.name)


def load_motifs(params: Params, f_bg: np.ndarray, alphabet: Alphabet | None = None) -> list:
    """Build the seed MotifSet from params.

    Exactly one of PWMFile / BaMMFile / bindingSiteFile / pattern must be
    set; ``pattern`` is one or more ';'-separated IUPAC strings lifted to
    softened PWMs.
    """
    alphabet = alphabet or Alphabet.from_type(params.alphabetType)
    K = params.modelOrder
    motifs: list = []

    sources = [
        s
        for s in (params.PWMFile, params.BaMMFile, params.bindingSiteFile, params.pattern)
        if s
    ]
    if len(sources) != 1:
        raise ValueError(
            "exactly one of --PWMFile, --BaMMFile, --bindingSiteFile, "
            "--pattern must be given"
        )

    if params.pattern:
        patterns = [p for p in params.pattern.split(";") if p.strip()]
        if params.maxPWM is not None:
            patterns = patterns[: params.maxPWM]
        if not patterns:
            raise ValueError(f"--pattern {params.pattern!r}: no patterns found")
        if alphabet.size != 4:
            raise ValueError(
                "--pattern uses IUPAC DNA codes and is defined for the "
                "STANDARD alphabet; extended-alphabet letters collide "
                "with IUPAC ambiguity codes (e.g. METHYLC's M) — seed "
                "via --PWMFile or --bindingSiteFile instead"
            )
        for i, pat in enumerate(patterns):
            pwm = seeds_mod.iupac_to_pwm(pat)
            alphas = _alphas_from_params(params, K, pwm.shape[0])
            motifs.append(
                seeds_mod.motif_from_pwm(
                    pwm, K, f_bg, alphas, alphabet=alphabet, name=f"motif_{i + 1}",
                )
            )
    elif params.PWMFile:
        pwm_seeds = seeds_mod.read_meme(params.PWMFile, alphabet)
        if params.maxPWM is not None:
            pwm_seeds = pwm_seeds[: params.maxPWM]
        for i, s in enumerate(pwm_seeds):
            alphas = _alphas_from_params(params, K, s.pwm.shape[0])
            motifs.append(
                seeds_mod.motif_from_pwm(
                    s.pwm, K, f_bg, alphas, nsites=s.nsites, alphabet=alphabet,
                    name=f"motif_{i + 1}",
                )
            )
    elif params.BaMMFile:
        if params.baseBgModelFile:
            # the background paired with the saved BaMM: its mono-nucleotide
            # marginals replace the positive set's as the order-0 base
            from bammmotif2_tpu_torch.models.background import BackgroundModel

            f0 = np.asarray(BackgroundModel.read(params.baseBgModelFile, alphabet).v[0], np.float64)
            f_bg = f0 / f0.sum()
        m = Motif.read(params.BaMMFile, f_bg=f_bg, alphabet=alphabet)
        m.alphas = _alphas_from_params(params, m.K, m.W)
        m.name = "motif_1"
        motifs.append(m)
    else:
        W = _binding_site_width(params.bindingSiteFile)
        alphas = _alphas_from_params(params, K, W)
        motifs.append(
            seeds_mod.motif_from_binding_sites(
                params.bindingSiteFile, K, f_bg, alphas, alphabet, name="motif_1"
            )
        )

    left, right = params.extend
    return [extend_motif(m, left, right) for m in motifs]


def _alphas_from_params(params: Params, K: int, W: int) -> np.ndarray:
    return Motif.default_alphas(K, W, params.modelAlpha, params.modelBeta, params.modelGamma)


def _binding_site_width(path: str) -> int:
    with open(path) as fh:
        for line in fh:
            s = line.strip()
            if s and not s.startswith("#"):
                return len(s.split()[0])
    raise ValueError(f"{path}: no binding sites found")
