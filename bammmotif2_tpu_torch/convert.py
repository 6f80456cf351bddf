"""Carry state from the JAX package into the port's tensors and objects.

Everything goes through numpy (``np.asarray`` reads a JAX array without this
module importing jax) and is cast explicitly: ``torch.from_numpy`` of a
float64 array would stay float64 and silently run the port in f64 against
the reference's f32.  Host objects (alphabet, sequence set, parameters,
models) become the port's own classes, read field by field.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bammmotif2_tpu_torch.models.background import BackgroundModel
from bammmotif2_tpu_torch.models.motif import Motif
from bammmotif2_tpu_torch.utils.alphabet import Alphabet
from bammmotif2_tpu_torch.utils.config import Params
from bammmotif2_tpu_torch.utils.fasta import SequenceSet


def floats(x, device) -> torch.Tensor:
    """An array-like as a float32 tensor on ``device`` (always a copy)."""
    return torch.tensor(np.asarray(x, np.float32), dtype=torch.float32, device=device)


def indices(x, device) -> torch.Tensor:
    """An integer array-like (cidx, lens) as an int32 tensor on ``device``."""
    return torch.tensor(np.asarray(x, np.int32), dtype=torch.int32, device=device)


def motif_state(m, device) -> tuple:
    """(v tuple of [A^(k+1), W], alphas [K+1, W], f_bg [A]) as float32
    tensors, from a Motif of either package."""
    return tuple(floats(vk, device) for vk in m.v), floats(m.alphas, device), floats(m.f_bg, device)


def cgs_state(m, q, device) -> tuple:
    """(v tuple of [A^(k+1), W], q [], log alphas [K+1, W], default alphas
    [K+1, W], f_bg [A]) as float32 tensors: a CGS chain's start from a
    Motif of either package, as ``refinement.gibbs.gibbs_step`` takes it.
    log alphas is the float32 log of the float32 alphas."""
    alphas = floats(m.alphas, device)
    return (tuple(floats(vk, device) for vk in m.v), floats(q, device), torch.log(alphas),
            alphas, floats(m.f_bg, device))


def em_data(cidx, lens, bg_flat, device) -> dict:
    """The dict ``refinement.em.prepare_data`` makes, from the reference's
    ``prepare_data`` output (or any cidx [S, N, L], lens [N], bg_flat [R])."""
    return {
        "cidx": indices(cidx, device),
        "lens": indices(lens, device),
        "bg_flat": floats(bg_flat, device),
    }


def alphabet(a) -> Alphabet:
    """The port's Alphabet of the same type as ``a`` (either package's)."""
    return Alphabet.from_type(a.name)


def sequence_set(sset) -> SequenceSet:
    """A port SequenceSet with copies of ``sset``'s codes, lens and headers
    and an alphabet of the same type (``sset`` from either package)."""
    return SequenceSet(np.array(sset.codes, np.int8), np.array(sset.lens, np.int32),
                       list(sset.headers), alphabet(sset.alphabet))


def params(p) -> Params:
    """The port's Params with every field of ``p`` (either package's)."""
    return Params(**dataclasses.asdict(p))


def motif(m) -> Motif:
    """A port Motif with the same host state as a reference Motif."""
    return Motif(
        m.W, m.K, [np.array(vk, np.float64) for vk in m.v],
        np.array(m.alphas, np.float64), np.array(m.f_bg, np.float64),
        alphabet(m.alphabet), m.name,
        counts=[np.array(c, np.float64) for c in m.counts] if m.counts is not None else None,
    )


def background(bg) -> BackgroundModel:
    """A port BackgroundModel with the same host state as a reference one."""
    return BackgroundModel(
        bg.order, bg.alpha, [np.array(vk, np.float64) for vk in bg.v],
        counts=[np.array(c, np.float64) for c in bg.counts] if bg.counts is not None else None,
        alphabet=alphabet(bg.alphabet), name=bg.name,
    )
