"""Command-line driver of the reference pipeline.

Port of ``bammmotif2_tpu.cli``.  It parses the same flags (every reference
command line still parses), loads the sequence sets, builds or loads the
background model, fans out seeds, refines them with ZOOPS EM (``--EM``)
and/or collapsed Gibbs sampling (``--CGS``, after EM when both are given;
all seeds of a group in one batched loop), writes the model files, scans
the positives for occurrences (``--scoreSeqset``) and evaluates the seeds
by cross-validated FDR (``--FDR``, refining each fold by CGS under
``--CGS``, else by EM):

    python -m bammmotif2_tpu_torch.cli OUTDIR pos.fasta --PWMFile seeds.meme \
        --EM --FDR --scoreSeqset -k 2 -K 2 -q 0.9 --mFold 10 --cvFold 5

``--profile DIR`` records the run with ``torch.profiler`` and writes a
Chrome trace into DIR.

Under a multi-process launch (``torchrun --nproc-per-node N -m
bammmotif2_tpu_torch.cli ...``) every rank joins the process group
(``parallel.distributed``) and EM and CGS shard over a mesh of the ranks:
rows over its data axis, EM's seeds over its seed axis.  Scanning and FDR
run whole on every rank, as in the reference.  Only rank 0 writes files
and prints; the other ranks compute the same models.  ``--single-device``
runs each process on its own and joins nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from bammmotif2_tpu_torch.utils.alphabet import Alphabet
from bammmotif2_tpu_torch.utils.config import Params
from bammmotif2_tpu_torch.utils.fasta import read_fasta
from bammmotif2_tpu_torch.utils.metrics import MetricsLogger, span, tracing
from bammmotif2_tpu_torch.evaluation.fdr import evaluate_motifs
from bammmotif2_tpu_torch.evaluation.prcurve import average_recall
from bammmotif2_tpu_torch.generator import seqgen
from bammmotif2_tpu_torch.models.background import BackgroundModel
from bammmotif2_tpu_torch.models.motifset import load_motifs
from bammmotif2_tpu_torch.parallel import distributed
from bammmotif2_tpu_torch.refinement.em import run_em
from bammmotif2_tpu_torch.refinement.gibbs import run_gibbs_multi
from bammmotif2_tpu_torch.refinement.multi import run_em_multi
from bammmotif2_tpu_torch.scoring import scan
from bammmotif2_tpu_torch.utils.device import resolve


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bammmotif2-tpu-torch",
        description="Bayesian Markov Model motif discovery "
        "(BaMMmotif2-compatible), PyTorch/CUDA port",
    )
    p.add_argument("outputDirectory")
    p.add_argument("posSequenceFile")
    # sequence options
    p.add_argument("--negSeqFile", dest="negSequenceFile", default=None)
    p.add_argument("--alphabet", dest="alphabetType", default="STANDARD")
    p.add_argument("--ss", action="store_true")
    # init
    p.add_argument("--bindingSiteFile", default=None)
    p.add_argument("--PWMFile", default=None)
    p.add_argument("--BaMMFile", default=None)
    p.add_argument("--baseBgModelFile", default=None, metavar="HBCP",
                   help="background model (.hbcp) paired with --BaMMFile: "
                        "its mono-nucleotide frequencies seed the order-0 "
                        "interpolation base instead of the positive set's")
    p.add_argument("--pattern", default=None,
                   help="IUPAC seed pattern(s), ';'-separated (e.g. TGASTCA)")
    p.add_argument("--maxPWM", type=int, default=None)
    # model
    p.add_argument("-k", "--order", dest="modelOrder", type=int, default=2)
    p.add_argument("-a", "--alpha", dest="modelAlpha", type=float, default=1.0)
    p.add_argument("-b", "--beta", dest="modelBeta", type=float, default=7.0)
    p.add_argument("-r", "--gamma", dest="modelGamma", type=float, default=3.0)
    p.add_argument("--extend", nargs=2, type=int, default=[0, 0], metavar=("L", "R"))
    # background
    p.add_argument("-K", "--Order", dest="bgModelOrder", type=int, default=2)
    p.add_argument("-A", "--Alpha", dest="bgModelAlpha", type=float, default=10.0)
    p.add_argument("--bgModelFile", default=None)
    # EM
    p.add_argument("--EM", action="store_true")
    p.add_argument("-e", "--epsilon", dest="epsilon", type=float, default=1e-3)
    p.add_argument("--maxEMIterations", type=int, default=1000)
    p.add_argument("-q", dest="q", type=float, default=0.9)
    p.add_argument("--optimizeQ", action="store_true")
    # CGS
    p.add_argument("--CGS", action="store_true")
    p.add_argument("--maxCGSIterations", type=int, default=100)
    p.add_argument("--noAlphaOptimization", action="store_true")
    p.add_argument("--noZSampling", action="store_true")
    p.add_argument("--noQSampling", action="store_true")
    p.add_argument("--cgsBurnIn", type=int, default=0, metavar="N",
                   help="discard the first N CGS sweeps and estimate the "
                        "model from counts averaged over the rest "
                        "(0 = final-sweep behavior)")
    # FDR
    p.add_argument("--FDR", action="store_true")
    p.add_argument("-m", "--mFold", dest="mFold", type=int, default=10)
    p.add_argument("-n", "--cvFold", dest="cvFold", type=int, default=5)
    p.add_argument("-s", "--sOrder", dest="sOrder", type=int, default=2)
    # scanning
    p.add_argument("--scoreSeqset", action="store_true")
    p.add_argument("--pvalCutoff", type=float, default=1e-4)
    # output
    p.add_argument("--basename", default=None)
    p.add_argument("--saveBaMMs", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--saveInitialBaMMs", action="store_true")
    p.add_argument("--savePRs", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--savePvalues", action="store_true")
    p.add_argument("--saveLogOdds", action="store_true")
    p.add_argument("--verbose", action="store_true")
    # extensions of the JAX package, same names
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no-pallas", dest="use_pallas", action="store_false", default=True,
                   help="use the plain PyTorch versions instead of the CUDA kernels")
    p.add_argument(
        "--single-device", dest="multiDevice", action="store_false", default=True
    )
    p.add_argument("--jsonl", action="store_true",
                   help="write structured metrics to BASENAME.metrics.jsonl")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a profiler trace of the run into DIR")
    p.add_argument("--checkpointEvery", type=int, default=0, metavar="N",
                   help="write the model file every N EM iterations "
                        "(a saved BaMM is a valid --BaMMFile resume point)")
    return p


def params_from_args(argv: list) -> Params:
    d = vars(build_parser().parse_args(argv))
    d["extend"] = tuple(d["extend"])
    return Params(**{k: v for k, v in d.items() if k in Params.__dataclass_fields__})


def run_pipeline(params: Params, device, mesh=None, graphs: bool = True) -> dict:
    """Execute the pipeline; returns a dict of produced artifacts.

    ``graphs``: False runs the EM and CGS loops eagerly on a CUDA device
    too (``refinement.graphs``); the tools and tests compare the two.

    ``mesh`` (``parallel.mesh.Mesh``): shard EM and CGS over the ranks; on
    ranks other than 0 nothing is written or printed and ``files`` stays
    empty.  With ``params.profile`` set, the whole run is recorded by
    ``torch.profiler`` (CPU, and CUDA on a CUDA device) and its Chrome
    trace written into that directory (``<host>_<pid>.<time>.pt.trace.json``,
    readable by TensorBoard or chrome://tracing); with ``params.jsonl``
    every stage appends one event to ``BASENAME.metrics.jsonl``.

    The run is traced (``utils.metrics``): its spans, rooted at ``run``,
    and counters are returned as ``out["trace"]`` (``{"spans": [...],
    "counts": {...}}``) and, under ``params.jsonl``, written as one
    ``span`` event a span and one ``counts`` event before ``run_done``.
    """
    if params.profile and distributed.is_main():
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(params.profile),
        ):
            return _run_pipeline(params, device, mesh, graphs)
    return _run_pipeline(params, device, mesh, graphs)


def _run_pipeline(params: Params, device, mesh, graphs: bool) -> dict:
    # on the spans' clock (utils.metrics.span), so that the run's seconds
    # hold its ``run`` span and compare with its stages'
    t_start = time.time_ns()
    writer = distributed.is_main()
    if writer:
        os.makedirs(params.outputDirectory, exist_ok=True)
    alphabet = Alphabet.from_type(params.alphabetType)
    basename = params.basename or os.path.splitext(
        os.path.basename(params.posSequenceFile)
    )[0]
    metrics = MetricsLogger(
        os.path.join(params.outputDirectory, f"{basename}.metrics.jsonl")
        if params.jsonl and writer
        else None
    )
    try:
        with tracing() as trace:
            with span("run"):
                out = _pipeline_stages(params, device, mesh, writer, metrics, alphabet,
                                       basename, graphs)
        out["runtime_seconds"] = (time.time_ns() - t_start) / 1e9
        out["trace"] = trace.export()
        for rec in out["trace"]["spans"]:
            metrics.event("span", **rec)
        metrics.event("counts", run=trace.run, counts=out["trace"]["counts"])
        metrics.event("run_done", runtime_seconds=round(out["runtime_seconds"], 3))
        if params.verbose and writer:
            print(f"Runtime: {out['runtime_seconds']:.2f}s")
        return out
    finally:
        metrics.close()


def _pipeline_stages(params, device, mesh, writer, metrics, alphabet, basename,
                     graphs) -> dict:
    """The stages; ``writer``: this process writes files and prints."""
    out: dict = {"motifs": [], "files": []}
    verbose = params.verbose and writer
    metrics.event("run_start", params={
        # identity checks: an explicitly-set falsy override (-q 0) must log
        k: v for k, v in dataclasses.asdict(params).items()
        if v is not None and v is not False
    })

    with span("read"):
        pos_set = read_fasta(params.posSequenceFile, alphabet)
        neg_set = (
            read_fasta(params.negSequenceFile, alphabet)
            if params.negSequenceFile
            else None
        )
    metrics.event(
        "sequences_loaded", n=pos_set.n,
        min_len=pos_set.min_len, max_len=pos_set.max_len,
    )
    if verbose:
        print(
            f"Loaded {pos_set.n} positive sequences "
            f"(len {pos_set.min_len}..{pos_set.max_len})"
        )

    # background model: loaded, or fit on negatives if given, else positives
    with span("background"):
        if params.bgModelFile:
            bg = BackgroundModel.read(params.bgModelFile, alphabet)
        else:
            bg = BackgroundModel.from_sequence_set(
                neg_set if neg_set is not None else pos_set,
                order=params.bgModelOrder,
                alpha=params.bgModelAlpha,
                ss=params.ss,
                device=device,
            )
    if writer:
        with span("write", what="background"):
            out["files"] += list(bg.write(params.outputDirectory, basename))
    out["bg"] = bg

    with span("seeds"):
        motifs = load_motifs(params, pos_set.base_frequencies(), alphabet)
    out["motifs"] = motifs

    if params.saveInitialBaMMs and writer:
        with span("write", what="initial models"):
            for m in motifs:
                out["files"] += list(
                    m.write(params.outputDirectory, f"{basename}_init_{m.name}")
                )

    if params.EM:
        with span("em"):
            if params.checkpointEvery > 0:
                # restartable path: per-motif EM, model file rewritten every
                # N iterations (a saved BaMM is a valid --BaMMFile resume point)
                results = []
                for m in motifs:
                    def _ckpt(motif=None, iteration=0, _m=m):
                        if writer:
                            with span("write", what="checkpoint"):
                                (_m if motif is None else motif).write(
                                    params.outputDirectory, f"{basename}_{_m.name}"
                                )
                        metrics.event("em_checkpoint", motif=_m.name, iteration=iteration)

                    results.append(
                        run_em(m, bg, pos_set, params, checkpoint_fn=_ckpt, device=device,
                               mesh=mesh, graphs=graphs)
                    )
            else:
                results = run_em_multi(motifs, bg, pos_set, params, device=device, mesh=mesh,
                                       graphs=graphs)
            out["em_results"] = results
            for m, r in zip(motifs, results):
                metrics.event(
                    "em_done", motif=m.name, iterations=r.iterations,
                    ll=r.ll, q=r.q, converged=r.converged,
                    windows_per_sec=round(r.windows_per_sec),
                    seconds=round(r.seconds, 3),
                )
                if verbose:
                    print(
                        f"EM {m.name}: {r.iterations} iters, ll={r.ll:.2f}, "
                        f"q={r.q:.3f}, {r.windows_per_sec:,.0f} windows/s"
                    )

    if params.CGS:
        # an independent stage, not an alternative to EM: --EM --CGS
        # Gibbs-refines the EM-refined models; all seeds of a (W, K) group
        # sweep together.  cgs_done carries this seed's share of its group's
        # seconds (as em_done does).
        with span("cgs"):
            out["cgs_results"] = run_gibbs_multi(motifs, bg, pos_set, params, device=device,
                                                 mesh=mesh, graphs=graphs)
            for m, r in zip(motifs, out["cgs_results"]):
                metrics.event(
                    "cgs_done", motif=m.name, iterations=r.iterations, q=r.q,
                    seconds=round(r.seconds, 3),
                )

    if params.saveBaMMs and writer:
        with span("write", what="models"):
            for m in motifs:
                out["files"] += list(
                    m.write(params.outputDirectory, f"{basename}_{m.name}")
                )

    if params.scoreSeqset:
        with span("scan"):
            _scan_stage(params, device, writer, metrics, out, pos_set, neg_set, bg, motifs,
                        basename)
    if params.FDR:
        with span("fdr"):
            _fdr_stage(params, device, writer, metrics, out, pos_set, neg_set, bg, alphabet,
                       basename, graphs)
    return out


def _scan_stage(params, device, writer, metrics, out, pos_set, neg_set, bg, motifs,
                basename) -> None:
    """--scoreSeqset: per-window occurrence p-values against the negatives'
    per-window scores (user negatives when given, else sampled from a
    background fit to the positives), one .occurrence file per motif.  Each
    scan_done event carries the seconds since the stage began."""
    t0 = time.perf_counter()
    with span("scan.negatives"):
        if neg_set is not None:
            neg_sample = neg_set
        else:
            bg_fit = BackgroundModel.from_sequence_set(
                pos_set, order=params.sOrder, alpha=params.bgModelAlpha, ss=params.ss,
                device=device,
            )
            neg_sample = seqgen.generate_neg_set(
                bg_fit, pos_set.lens, m_fold=max(params.mFold, 1), seed=params.seed,
                device=device,
            )
    # motifs of equal (W, K) scan in one seed-stacked pass per chunk
    groups: dict = {}
    for m in motifs:
        groups.setdefault((m.W, m.K), []).append(m)
    kw = dict(ss=params.ss, device=device, use_pallas=params.use_pallas)
    pairs: list = []
    with span("scan.score"):
        for group in groups.values():
            pairs += list(zip(group, scan.score_set_multi(group, bg, pos_set, **kw),
                              scan.score_set_multi(group, bg, neg_sample, **kw)))
    with span("scan.occurrences"):
        for m, res, neg_res in pairs:
            # passing the negatives' ScanResult keeps their pool on the device
            occs = scan.find_occurrences(res, pos_set, neg_res, params.pvalCutoff)
            if writer:
                path = os.path.join(params.outputDirectory, f"{basename}_{m.name}.occurrence")
                with span("write", what="occurrences"):
                    scan.write_occurrences(path, occs)
                out["files"].append(path)
            metrics.event(
                "scan_done", motif=m.name, hits=len(occs),
                windows=int(np.sum(np.maximum(pos_set.lens - m.W + 1, 0)))
                * (1 if params.ss else 2),
                seconds=round(time.perf_counter() - t0, 3),
            )
            if params.saveLogOdds and writer:
                lo_path = os.path.join(params.outputDirectory, f"{basename}_{m.name}.logOdds")
                with span("write", what="log odds"):
                    scan.write_logodds(lo_path, res, pos_set)
                out["files"].append(lo_path)


def _fdr_stage(params, device, writer, metrics, out, pos_set, neg_set, bg, alphabet,
               basename, graphs) -> None:
    """--FDR: cross-validated evaluation of the (unrefined) seeds; the seeds
    of a (W, K) group are refined (by CGS under --CGS, else EM) and scored
    together in every fold."""
    seed_motifs = load_motifs(params, pos_set.base_frequencies(), alphabet)
    fdr_list = evaluate_motifs(seed_motifs, bg, pos_set, params, neg_set=neg_set, device=device,
                               graphs=graphs)
    for m, res in zip(seed_motifs, fdr_list):
        if params.savePRs and writer:
            with span("write", what="PR curves"):
                out["files"] += res.write(params.outputDirectory, f"{basename}_{m.name}")
        if params.savePvalues and writer:
            pv_path = os.path.join(params.outputDirectory, f"{basename}_{m.name}.pvalues")
            with span("write", what="p-values"):
                np.savetxt(pv_path, res.pos_pvalues, fmt="%.4e")
            out["files"].append(pv_path)
        out.setdefault("fdr_results", []).append(res)
        metrics.event(
            "fdr_done", motif=m.name,
            avrec_zoops=round(average_recall(res.zoops), 4),
            avrec_mops=round(average_recall(res.mops), 4),
            W=m.W, K=m.K, group_seconds=round(res.group_seconds, 3),
        )


def _estimate_n_seeds(params: Params) -> int:
    """Cheap seed-count estimate for the mesh's seed-axis width: the MOTIF
    lines of --PWMFile or the --pattern list, capped by --maxPWM (a copy of
    the reference's rule)."""
    n = 1
    try:
        if params.PWMFile:
            with open(params.PWMFile) as fh:
                n = sum(1 for line in fh if line.startswith("MOTIF"))
        elif params.pattern:
            n = len([p for p in params.pattern.split(";") if p.strip()])
    except OSError:
        pass  # an unreadable file errors meaningfully later, in load_motifs
    if params.maxPWM:
        n = min(n, params.maxPWM)
    return max(n, 1)


def main(argv=None, device=None, graphs: bool = True) -> int:
    """Run the CLI on ``device`` (default: the current CUDA device; raises
    when CUDA is absent — pass ``device="cpu"`` to run the plain path on the
    CPU).  Under a launcher's environment it joins the process group first
    (unless --single-device) and shards over a mesh of the ranks.
    ``graphs``: see ``run_pipeline``."""
    params = params_from_args(sys.argv[1:] if argv is None else argv)
    mesh = None
    if params.multiDevice and distributed.initialize(device=device):
        mesh = distributed.auto_mesh(n_seeds=_estimate_n_seeds(params))
        if params.verbose and mesh is not None and distributed.is_main():
            world = torch.distributed.get_world_size()
            hosts = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
            print(f"mesh {mesh.shape} over {world} devices ({hosts} hosts)")
    run_pipeline(params, resolve(device), mesh, graphs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
