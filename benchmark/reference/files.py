"""Readers of the files a job reads and writes, by their text: the seed
MEME file, a model's ``.ihbcp`` and the ``--jsonl`` metrics events."""

from __future__ import annotations

import json

import numpy as np


def read_meme(path: str) -> list:
    """[(name, PWM [W, 4] float64, nsites)] of a MEME file."""
    out, rows = [], None
    with open(path) as fh:
        for line in fh:
            s = line.split()
            if s[:1] == ["MOTIF"]:
                name, rows = s[1], None
            elif line.startswith("letter-probability"):
                nsites = float(line.split("nsites=")[1].split()[0])
                rows = []
                out.append((name, rows, nsites))
            elif rows is not None and len(s) == 4:
                rows.append([float(x) for x in s])
            else:
                rows = None
    return [(n, np.array(r, np.float64), ns) for n, r, ns in out]


def read_ihbcp(path: str, A: int = 4) -> list:
    """The conditionals [A^(k+1), W] a order of a model file: blocks of K+1
    lines a position, after '#' header lines, blank lines between."""
    blocks, cur = [], []
    with open(path) as fh:
        for line in fh:
            s = line.strip()
            if s.startswith("#"):
                continue
            if not s:
                if cur:
                    blocks.append(cur)
                cur = []
                continue
            cur.append(np.array([float(x) for x in s.split()]))
    if cur:
        blocks.append(cur)
    return [np.stack([b[k] for b in blocks], axis=1) for k in range(len(blocks[0]))]


def read_events(path: str) -> dict:
    """The ``--jsonl`` events of a run by kind, each a list in order."""
    out: dict = {}
    with open(path) as fh:
        for line in fh:
            e = json.loads(line)
            out.setdefault(e["event"], []).append(e)
    return out
