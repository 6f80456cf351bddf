"""The benchmark's inputs: planted-motif FASTA sets and their seed MEME files.

Frozen copies, as of commit c5dc2a4, of ``chip_smoke.py``'s
``write_meme`` and ``config4_problem``
(with ``bammmotif2_tpu_torch.models.seeds.iupac_to_pwm`` and
``utils.fasta.write_fasta``), written in numpy alone so that the inputs
do not move when the program does.  Each generator takes the entropy of
its numpy generator (``np.random.default_rng(entropy)``): entropy 0 and
the default sizes give chip_smoke's files byte for byte.

A generator returns an ``Input``: the codes it planted (int8 [N, L],
A=0 C=1 G=2 T=3), the seed PWMs as written, and the two files.  A
configuration file names its generator in ``generator`` and its keyword
arguments in ``args``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

LETTERS = "ACGT"
IUPAC = {
    "A": "A", "C": "C", "G": "G", "T": "T", "U": "T",
    "R": "AG", "Y": "CT", "S": "CG", "W": "AT", "K": "GT", "M": "AC",
    "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG", "N": "ACGT",
}


@dataclasses.dataclass
class Input:
    codes: np.ndarray  # int8 [N, L]
    pwms: list         # [(name, [W, 4] float64)] as written to the MEME file
    fasta: str
    meme: str


def write_meme(path: str, pwms: list) -> None:
    with open(path, "w") as fh:
        fh.write("MEME version 4\n\n")
        for name, pwm in pwms:
            fh.write(f"MOTIF {name}\nletter-probability matrix: alength= 4 w= {len(pwm)} "
                     f"nsites= 100\n")
            fh.writelines(" ".join(f"{p:.6f}" for p in row) + "\n" for row in pwm)
            fh.write("\n")


def write_fasta(path: str, codes: np.ndarray, width: int = 60) -> None:
    """Rows ``s0``, ``s1``, ... of equal length, ``width`` letters a line."""
    letters = np.frombuffer(LETTERS.encode(), np.uint8)[codes.astype(np.int64)]
    L = codes.shape[1]
    with open(path, "w") as fh:
        for i, row in enumerate(letters):
            s = row.tobytes().decode()
            fh.write(f">s{i}\n")
            fh.writelines(s[off : off + width] + "\n" for off in range(0, L, width))


def iupac_to_pwm(pattern: str, soft: float = 0.7) -> np.ndarray:
    """soft * uniform(members) + (1 - soft) * uniform(all bases), a row a
    letter of the IUPAC ``pattern``."""
    pwm = np.empty((len(pattern), 4))
    for j, ch in enumerate(pattern.upper()):
        members = IUPAC[ch]
        pwm[j] = (1.0 - soft) / 4.0
        for b in members:
            pwm[j, LETTERS.index(b)] += soft / len(members)
    return pwm


def encode(motif: str) -> np.ndarray:
    return np.array([LETTERS.index(c) for c in motif], np.int8)


def config4_problem(outdir: str, entropy=0, n_seqs: int = 10_000, seq_len: int = 200,
                    motifs: tuple = ("TGACTCAG", "CACGTGACTT", "GGGGCGGGGCCA"),
                    n_seeds: int = 10, tag: str = "c4") -> Input:
    """``n_seqs`` uniform rows; motif i planted in 80% of rows i, i + m,
    ... (m motifs); ``n_seeds`` seeds: the motifs' soft IUPAC PWMs, then
    copies perturbed by a factor in [0.8, 1.25) an entry, renormalised."""
    rng = np.random.default_rng(entropy)
    codes = rng.integers(0, 4, (n_seqs, seq_len)).astype(np.int8)
    for i, mot in enumerate(motifs):
        enc = encode(mot)
        rows = np.arange(i, n_seqs, len(motifs))
        pos = rng.integers(0, seq_len - len(enc), rows.size)
        keep = rng.random(rows.size) < 0.8
        for r, p, k in zip(rows, pos, keep):
            if k:
                codes[r, p : p + len(enc)] = enc
    fasta = os.path.join(outdir, f"{tag}.fasta")
    write_fasta(fasta, codes)
    pwms = []
    for s in range(n_seeds):
        pwm = iupac_to_pwm(motifs[s % len(motifs)], soft=0.7)
        if s >= len(motifs):
            pwm = pwm * rng.uniform(0.8, 1.25, pwm.shape)
        pwms.append((f"seed{s + 1}", pwm / pwm.sum(axis=1, keepdims=True)))
    meme = os.path.join(outdir, f"{tag}.meme")
    write_meme(meme, pwms)
    return Input(codes, pwms, fasta, meme)


GENERATORS = {"config4_problem": config4_problem}


def make_input(config: dict, outdir: str, entropy, tag: str) -> Input:
    """The input of ``config`` (a configuration file's dict) from
    ``entropy``, written into ``outdir`` as ``<tag>.fasta`` and
    ``<tag>.meme``."""
    return GENERATORS[config["generator"]](outdir, entropy, tag=tag, **config["args"])

