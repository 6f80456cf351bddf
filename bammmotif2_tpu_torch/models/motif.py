"""Inhomogeneous Bayesian Markov motif model (the BaMM).

Port of ``bammmotif2_tpu.models.motif``.  State per motif position
j = 0..W-1 and order k = 0..K:

    v[k] : conditional probs, shape [|A|^(k+1), W]   (lexicographic k-mers,
           oldest base most significant, matching ops.encode)
    alphas : pseudo-count strengths, shape [K+1, W]

The interpolated pseudo-count estimator (SURVEY.md 2.9):

    v_j^(k)(y) = ( n_j^(k)(y) + alpha_k(j) * v_j^(k-1)(y') )
               / ( ctx_j^(k)(x) + alpha_k(j) )

with base case v_j^(0)(a) = (n_j^(0)(a) + alpha_0 * f_bg(a)) / (N_j + alpha_0).

The device math is float32 torch and batch-generic: every function takes
optional leading (seed) dimensions, so a seed-stacked group updates in one
call.  The host ``Motif`` class wraps state and the ``.ihbcp`` / ``.ihbp``
text formats.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from bammmotif2_tpu.utils.alphabet import Alphabet
from bammmotif2_tpu_torch.ops import encode

_FLOAT_FMT = "%.4e"


# ---------------------------------------------------------------------- #
# device-side model math (float32 tensors, optional leading batch dims)
# ---------------------------------------------------------------------- #


def counts_from_combined(C: torch.Tensor, A: int, K: int) -> tuple:
    """Split combined count rows [..., R(+1), W] into per-order counts.

    Order-k totals = direct counts at truncated positions of exactly order k
    + marginalization over the oldest base of order-(k+1) counts.
    """
    off = encode.order_offsets(A, K)
    W = C.shape[-1]
    lead = C.shape[:-2]
    direct = [C[..., off[k] : off[k + 1], :] for k in range(K + 1)]
    out = [None] * (K + 1)
    out[K] = direct[K]
    for k in range(K - 1, -1, -1):
        out[k] = direct[k] + out[k + 1].reshape(*lead, A, -1, W).sum(dim=-3)
    return tuple(out)


def update_v(counts: tuple, alphas: torch.Tensor, f_bg: torch.Tensor) -> tuple:
    """The interpolated pseudo-count estimator, all orders (calculateV).

    counts[k] [..., A^(k+1), W], alphas [..., K+1, W], f_bg [A].

    The repeats are broadcasts, not index gathers, so the gradient that the
    Gibbs alpha step takes through this function sums without atomics and
    is reproducible on a GPU.
    """
    K = len(counts) - 1
    A = f_bg.shape[0]
    n0 = counts[0]
    a0 = alphas[..., 0:1, :]
    N_j = n0.sum(dim=-2, keepdim=True)
    v = [(n0 + a0 * f_bg[:, None]) / (N_j + a0)]
    for k in range(1, K + 1):
        nk = counts[k]
        ak = alphas[..., k : k + 1, :]
        ctx = nk.reshape(*nk.shape[:-2], -1, A, nk.shape[-1]).sum(dim=-2)  # [..., A^k, W]
        # denom[y] = ctx[y // A] + a_k; lower[y] = v^(k-1)[y % A^k]
        denom = repeat_rows(ctx, A) + ak
        v.append((nk + ak * tile_rows(v[k - 1], A)) / denom)
    return tuple(v)


def repeat_rows(x: torch.Tensor, A: int) -> torch.Tensor:
    """[..., n, W] -> [..., n*A, W], each row A times in a row."""
    *lead, n, W = x.shape
    return x.unsqueeze(-2).expand(*lead, n, A, W).reshape(*lead, n * A, W)


def tile_rows(x: torch.Tensor, A: int) -> torch.Tensor:
    """[..., n, W] -> [..., A*n, W], the whole block A times."""
    *lead, n, W = x.shape
    return x.unsqueeze(-3).expand(*lead, A, n, W).reshape(*lead, A * n, W)


def combined_v(v: tuple) -> torch.Tensor:
    """Stack per-order conditionals into the combined LUT [..., R, W]."""
    return torch.cat(v, dim=-2)


def log_odds_lut(v: tuple, bg_flat: torch.Tensor) -> torch.Tensor:
    """s_flat [..., R+1, W]: log(v / v_bg) per combined row + zero sentinel.

    bg_flat: [R] background conditional per combined row
    (``BackgroundModel.conditional_flat``).
    """
    s = torch.log(combined_v(v)) - torch.log(bg_flat)[:, None]
    sentinel = torch.zeros((*s.shape[:-2], 1, s.shape[-1]), dtype=s.dtype, device=s.device)
    return torch.cat([s, sentinel], dim=-2)


def update_v_from_combined(C, alphas, f_bg, *, A: int, K: int) -> tuple:
    """calculateV directly from M-step output C [..., R+1, W] (sentinel last)."""
    R = encode.num_rows(A, K)
    return update_v(counts_from_combined(C[..., :R, :], A, K), alphas, f_bg)


# ---------------------------------------------------------------------- #
# host-side Motif
# ---------------------------------------------------------------------- #


class Motif:
    def __init__(
        self,
        W: int,
        K: int,
        v: list,
        alphas: np.ndarray,
        f_bg: np.ndarray,
        alphabet: Alphabet | None = None,
        name: str = "motif",
        counts: list | None = None,
    ):
        self.W = int(W)
        self.K = int(K)
        self.alphabet = alphabet or Alphabet.standard()
        A = self.alphabet.size
        self.v = [np.asarray(vk, np.float64).reshape(A ** (k + 1), W) for k, vk in enumerate(v)]
        self.alphas = np.asarray(alphas, np.float64).reshape(K + 1, W)
        self.f_bg = np.asarray(f_bg, np.float64).reshape(A)
        self.name = name
        self.counts = counts

    @property
    def A(self) -> int:
        return self.alphabet.size

    def copy(self) -> "Motif":
        return Motif(
            self.W,
            self.K,
            [vk.copy() for vk in self.v],
            self.alphas.copy(),
            self.f_bg.copy(),
            self.alphabet,
            self.name,
            counts=[c.copy() for c in self.counts] if self.counts is not None else None,
        )

    @staticmethod
    def default_alphas(K: int, W: int, alpha0: float = 1.0, beta: float = 7.0, gamma: float = 3.0) -> np.ndarray:
        """alpha_0 = alpha0; alpha_k = beta * gamma^(k-1) (SURVEY.md 2.9)."""
        rows = [np.full(W, alpha0 if k == 0 else beta * gamma ** (k - 1)) for k in range(K + 1)]
        return np.stack(rows)

    def set_v_from_counts(self, counts: list) -> None:
        """Apply calculateV to host counts, in float32 on the CPU."""
        v = update_v(
            tuple(torch.as_tensor(np.asarray(c), dtype=torch.float32) for c in counts),
            torch.as_tensor(self.alphas, dtype=torch.float32),
            torch.as_tensor(self.f_bg, dtype=torch.float32),
        )
        self.v = [vk.numpy().astype(np.float64) for vk in v]
        self.counts = [np.asarray(c, np.float64) for c in counts]

    def pwm(self) -> np.ndarray:
        """Order-0 view [W, A] (rows = positions)."""
        return self.v[0].T.copy()

    def full_probs(self) -> list:
        """p^(k)[y, j] for .ihbp: chain rule within the motif window.

        p^(0) = v^(0); for k >= 1 and j >= 1:
        p^(k)[y, j] = v^(k)[y, j] * p^(k-1)[y div A, j-1]; at j = 0 the
        left context is taken uniform: p^(k)[y, 0] = v^(k)[y, 0] / A^k.
        """
        A = self.A
        p = [self.v[0].copy()]
        for k in range(1, self.K + 1):
            vk = self.v[k]
            pk = np.empty_like(vk)
            pk[:, 0] = vk[:, 0] / (A ** k)
            prefix = np.repeat(p[k - 1][:, :-1], A, axis=0)  # p^(k-1)[y div A, j-1]
            pk[:, 1:] = vk[:, 1:] * prefix
            p.append(pk)
        return p

    # file IO: .ihbcp (conditionals) / .ihbp (full probs)

    def write(self, outdir: str, basename: str | None = None) -> tuple:
        """Write .ihbcp + .ihbp.  Blocks = positions (blank-line separated);
        each block has K+1 lines, line k holding |A|^(k+1) probabilities in
        lexicographic k-mer order, after '#' header lines carrying
        order/width/alphabet metadata."""
        base = basename or self.name
        os.makedirs(outdir, exist_ok=True)
        header = [
            f"# W = {self.W}",
            f"# K = {self.K}",
            f"# alphabet = {self.alphabet.name}",
        ]
        p_cond = os.path.join(outdir, base + ".ihbcp")
        p_full = os.path.join(outdir, base + ".ihbp")
        _write_position_blocks(p_cond, self.v, self.W, header)
        _write_position_blocks(p_full, self.full_probs(), self.W, header)
        return p_cond, p_full

    @staticmethod
    def read(
        path: str,
        f_bg: np.ndarray | None = None,
        alphas: np.ndarray | None = None,
        alphabet: Alphabet | None = None,
    ) -> "Motif":
        """Init from a saved BaMM (.ihbcp); the '# alphabet =' header is
        honored when no explicit ``alphabet`` is passed."""
        if alphabet is None:
            with open(path) as fh:
                for line in fh:
                    s = line.strip()
                    if not s.startswith("#"):
                        break
                    body = s.lstrip("#").strip()
                    if "=" in body:
                        key, val = (t.strip() for t in body.split("=", 1))
                        if key.lower() == "alphabet":
                            alphabet = Alphabet.from_type(val)
        alphabet = alphabet or Alphabet.standard()
        A = alphabet.size
        blocks = _read_position_blocks(path)
        W = len(blocks)
        if W == 0:
            raise ValueError(f"{path}: no position blocks found")
        K = len(blocks[0]) - 1
        v = []
        for k in range(K + 1):
            rows = []
            for j, block in enumerate(blocks):
                if len(block) != K + 1:
                    raise ValueError(f"{path}: position {j} has {len(block)} orders, want {K + 1}")
                if block[k].size != A ** (k + 1):
                    raise ValueError(
                        f"{path}: position {j} order {k} has {block[k].size} values"
                    )
                rows.append(block[k])
            v.append(np.stack(rows, axis=1))  # [A^(k+1), W]
        if alphas is None:
            alphas = Motif.default_alphas(K, W)
        if f_bg is None:
            f_bg = np.full(A, 1.0 / A)
        name = os.path.basename(path)
        if name.endswith(".ihbcp"):
            name = name[: -len(".ihbcp")]
        return Motif(W, K, v, alphas, f_bg, alphabet, name=name)


def _write_position_blocks(
    path: str, tables: list, W: int, header: list | None = None
) -> None:
    with open(path, "w") as fh:
        for line in header or ():
            fh.write(line + "\n")
        if header:
            fh.write("\n")
        for j in range(W):
            for tab in tables:
                fh.write(" ".join(_FLOAT_FMT % x for x in tab[:, j]) + "\n")
            fh.write("\n")


def _read_position_blocks(path: str) -> list:
    blocks, cur = [], []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith("#"):
                continue
            if not line:
                if cur:
                    blocks.append(cur)
                    cur = []
                continue
            cur.append(np.array([float(x) for x in line.split()]))
    if cur:
        blocks.append(cur)
    return blocks
