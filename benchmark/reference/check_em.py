"""The comparison that decides ``correct`` for ``--EM`` jobs: every seed's
refined model, its iterations, ll and q, as the job wrote them, against
the plain EM of ``reference.bamm`` (float64) on the same input.

The reference follows each seed to the iteration count the job reports
and compares the model, ll and q there, and whether the stop rule allowed
stopping there.  Numbers, the largest over the job's seeds:

  model_dp  |p_job - p_ref| over every conditional of every order and
            position (the job's ``.ihbcp``, written to 5 digits);
  ll_rel    |ll_job - ll_ref| / |ll_ref|;
  q_abs     |q_job - q_ref|;
  stop_dll  at the job's last iteration n (below the cap), the reference's
            min(v_diff / eps, |ll(n) - ll(n-1)| / max(eps, the float32
            spacing of ll(n))): the stop rule fires under 1, and float32
            sums of some 10^4 terms move ll by a few spacings.

The count itself is not compared: where |dll| falls under the float32
spacing of ll (0.0078 at ll ~ 7 x 10^4, against eps 10^-3) the float32
stop fires when two iterations round to one value, which happens at any
of some hundreds of iterations of a slowly converging seed.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from reference import bamm, files, flags

NUMBERS = ("model_dp", "ll_rel", "q_abs", "stop_dll")


def seeds(meme: str, opts: dict) -> list:
    """The seeds a job refines: the MEME file's PWMs, at most --maxPWM,
    named motif_1, motif_2, ... in file order."""
    pwms = files.read_meme(meme)
    if "--maxPWM" in opts:
        pwms = pwms[: int(opts["--maxPWM"])]
    return [(f"motif_{i + 1}", pwm, nsites) for i, (_n, pwm, nsites) in enumerate(pwms)]


def models(codes: torch.Tensor, meme: str, opts: dict) -> tuple:
    """(groups, f_bg, bg rows, strand rows, K): the seeds lifted to order K
    and grouped by width as the job groups them, {W: ([seed index], v0 a
    order [M, A^(k+1), W], alphas)}."""
    K = int(opts["-k"])
    f_bg = bamm.base_freqs(codes)
    bgr = bamm.bg_rows(bamm.background(codes, int(opts["-K"]), float(opts["-A"])), K)
    groups: dict = {}
    for i, (_name, pwm, nsites) in enumerate(seeds(meme, opts)):
        groups.setdefault(pwm.shape[0], []).append((i, pwm, nsites))
    out = {}
    for W, members in groups.items():
        al = bamm.default_alphas(K, W, float(opts["-a"]), float(opts["-b"]),
                                 float(opts["-r"])).to(codes.device)
        lifted = [bamm.lift_pwm(pwm, K, f_bg, al, nsites) for _i, pwm, nsites in members]
        out[W] = ([i for i, _p, _n in members],
                  [torch.stack(x) for x in zip(*lifted)], al)
    return out, f_bg, bgr, bamm.strand_rows(codes, K), K


def run(codes: torch.Tensor, meme: str, argv: list, follow: dict | None = None,
        dtype=torch.float64, acc=torch.float64, stop_dtype=torch.float32) -> dict:
    """The reference's EM of every seed: {seed index: {"own": ..., "at":
    ...}} (``bamm.em``), following the iteration counts ``follow`` {seed
    index: iterations} where given."""
    opts = flags.parse(argv)
    groups, f_bg, bgr, rows, K = models(codes, meme, opts)
    out = {}
    for W, (idx, v0, al) in groups.items():
        r = bamm.em(v0, float(opts["-q"]), rows, bgr, al, f_bg, K=K, W=W,
                    eps=float(opts["-e"]), max_iters=int(opts["--maxEMIterations"]),
                    dtype=dtype, acc=acc, stop_dtype=stop_dtype,
                    follow=[follow[i] for i in idx] if follow else None)
        for m, i in enumerate(idx):
            out[i] = {"own": r["own"][m], "at": r["at"][m]}
    return out


def judge(job: dict, device) -> dict:
    """The numbers of one job: ``job`` holds its ``codes`` (the input's
    int8 [N, L]), ``meme``, ``argv`` and ``outdir`` (its files, with
    ``<basename>.metrics.jsonl``)."""
    base = os.path.splitext(os.path.basename(job["argv"][1]))[0]
    ev = files.read_events(os.path.join(job["outdir"], f"{base}.metrics.jsonl"))
    done = {e["motif"]: e for e in ev.get("em_done", [])}
    names = [n for n, _p, _s in seeds(job["meme"], flags.parse(job["argv"]))]
    if sorted(done) != sorted(names):
        return dict.fromkeys(NUMBERS, float("inf"))
    codes = torch.as_tensor(job["codes"], device=device)
    ref = run(codes, job["meme"], job["argv"],
              follow={i: int(done[n]["iterations"]) for i, n in enumerate(names)})
    opts = flags.parse(job["argv"])
    eps, cap = float(opts["-e"]), int(opts["--maxEMIterations"])
    out = dict.fromkeys(NUMBERS, 0.0)
    for i, n in enumerate(names):
        at, e = ref[i]["at"], done[n]
        v = files.read_ihbcp(os.path.join(job["outdir"], f"{base}_{n}.ihbcp"))
        dp = max(float(np.abs(a - b.numpy()).max()) for a, b in zip(v, at["v"], strict=True))
        out["model_dp"] = max(out["model_dp"], dp)
        out["ll_rel"] = max(out["ll_rel"], abs(float(e["ll"]) - at["ll"]) / abs(at["ll"]))
        out["q_abs"] = max(out["q_abs"], abs(float(e["q"]) - at["q"]))
        if int(e["iterations"]) < cap:
            spacing = float(np.spacing(np.float32(abs(at["ll"]))))
            gap = min(at["vdiff"] / eps, abs(at["dll"]) / max(eps, spacing))
            out["stop_dll"] = max(out["stop_dll"], gap)
    return out
