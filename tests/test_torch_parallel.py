"""The port's multi-process path over gloo on the CPU: ``parallel/`` and the
mesh through ``run_em``, ``run_em_multi``, ``run_gibbs_multi`` and the CLI,
against the port's single process and the JAX package's sharded runs.

The ranks are this file run as a script, each with torchrun's variables:

    python tests/test_torch_parallel.py SCENARIO RANK WORLD PORT DIR

Scenario ``two`` (2 ranks) runs sharded EM, EM of three seeds on a (1, 2)
mesh, CGS steps and runs in both sampling modes and the CLI; ``four`` (4
ranks) runs EM of three seeds on a (2, 2) mesh; ``env`` (one process)
checks ``--single-device``, a forced one-rank group and a failed bring-up.
Each rank saves its results in DIR; the module fixture starts all of them,
computes the single-process and JAX references meanwhile, and kills any
worker that outlives WORKER_TIMEOUT.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from bammmotif2_tpu_torch import cli
from bammmotif2_tpu_torch.models import seeds
from bammmotif2_tpu_torch.models.background import BackgroundModel
from bammmotif2_tpu_torch.ops import encode
from bammmotif2_tpu_torch.parallel import distributed
from bammmotif2_tpu_torch.parallel import mesh as mesh_mod
from bammmotif2_tpu_torch.refinement import em, gibbs, multi
from bammmotif2_tpu_torch.utils.alphabet import Alphabet
from bammmotif2_tpu_torch.utils.config import Params
from bammmotif2_tpu_torch.utils.fasta import SequenceSet

torch.set_num_threads(1)

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS_DIR)
POS = os.path.join(REPO, "examples", "positives.fasta")
MEME = os.path.join(REPO, "examples", "seed.meme")
MOTIF = "TGACTCAG"
N_SEQS, SEQ_LEN = 301, 80  # 301 rows: no data axis here divides them
SOFTS = (0.55, 0.65, 0.75)  # three seeds: the seed axis of 2 pads one
EM_PARAMS = Params(EM=True, q=0.5, maxEMIterations=10, optimizeQ=True, use_pallas=False)
CGS_SWEEPS = 12
CLI_ARGS = ["--PWMFile", MEME, "--EM", "--CGS", "--verbose"]
WORKER_TIMEOUT = 240  # seconds for all workers together
SCENARIOS = {"two": 2, "four": 4, "env": 1}


# ---- the cases, run by the workers on a mesh and by the fixture without ----

def _seed(psset: SequenceSet, soft: float = 0.6):
    return seeds.motif_from_pwm(seeds.iupac_to_pwm(MOTIF, soft=soft), 2, psset.base_frequencies())


def _cgs_params(sample: bool) -> Params:
    return Params(CGS=True, maxCGSIterations=CGS_SWEEPS, noZSampling=not sample,
                  noQSampling=not sample, seed=5)


def em_case(psset, bg, mesh) -> dict:
    m = _seed(psset)
    r = multi.run_em(m, bg, psset, EM_PARAMS, device="cpu", mesh=mesh)
    return {"em_iterations": r.iterations, "em_ll": r.ll, "em_q": r.q,
            **{f"em_v{k}": vk for k, vk in enumerate(m.v)}}


def multi_case(psset, bg, mesh) -> dict:
    ms = [_seed(psset, s) for s in SOFTS]
    rs = multi.run_em_multi(ms, bg, psset, EM_PARAMS, device="cpu", mesh=mesh)
    return {"multi_iterations": [r.iterations for r in rs], "multi_ll": [r.ll for r in rs],
            "multi_q": [r.q for r in rs],
            **{f"multi_v{k}": np.stack([m.v[k] for m in ms]) for k in range(3)}}


def gibbs_case(psset, bg, mesh, sample: bool) -> dict:
    """One sweep's counts and occupied rows, then a whole run of two
    stacked chains."""
    tag = "sampled" if sample else "argmax"
    params = _cgs_params(sample)
    ms = [_seed(psset, s) for s in SOFTS[:2]]
    data = em.prepare_data(psset, bg, 2, False, "cpu")
    if mesh is not None:
        data = mesh_mod.shard_em_data(mesh, data, encode.num_rows(4, 2))
    f32 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32)  # noqa: E731
    v = tuple(f32(np.stack([m.v[k] for m in ms])) for k in range(3))
    alphas = f32(np.stack([m.alphas for m in ms]))
    step = gibbs.gibbs_step_multi(
        v, torch.full((2,), params.q), torch.log(alphas), gibbs.input_keys(5, [0, 1], "cpu"),
        data, f32(ms[0].f_bg), alphas, float(psset.n), A=4, K=2, W=8, sample_z=sample,
        sample_q=sample, learn_alpha=True, mesh=mesh)
    rs = gibbs.run_gibbs_multi(ms, bg, psset, params, device="cpu", mesh=mesh)
    out = {f"{tag}_step_nocc": step[4].numpy(), f"{tag}_q": [r.q for r in rs],
           f"{tag}_ll": [r.ll for r in rs], f"{tag}_alphas": np.stack([r.alphas for r in rs])}
    for k in range(3):
        out[f"{tag}_step_counts{k}"] = step[5][k].numpy()
        out[f"{tag}_v{k}"] = np.stack([m.v[k] for m in ms])
    return out


def cli_case(outdir: str) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main([outdir, POS, *CLI_ARGS], device="cpu")
    return {"cli_stdout": buf.getvalue()}


def _inputs(d: str) -> tuple:
    """The planted set the fixture saved in ``d``, and its background."""
    z = np.load(os.path.join(d, "inputs.npz"))
    psset = SequenceSet(z["codes"], z["lens"], [f"s{i}" for i in range(len(z["lens"]))],
                        Alphabet.standard())
    return psset, BackgroundModel.from_sequence_set(psset, order=2)


# ---- the workers ----

def _env_checks(port: int, d: str) -> dict:
    """One process: --single-device under a launcher's environment joins
    nothing; force brings up a one-rank group; an unreachable master
    raises."""
    out = {}
    launch = dict(WORLD_SIZE="2", RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    os.environ.update(launch)
    outdir = os.path.join(d, "single_device")
    cli.main([outdir, POS, "--PWMFile", MEME, "--single-device"], device="cpu")
    out["single_device_initialized"] = dist.is_initialized()
    out["single_device_files"] = sorted(os.listdir(outdir))
    for k in launch:
        del os.environ[k]
    out["force"] = distributed.initialize(force=True, device="cpu")
    out["force_backend"] = dist.get_backend()
    out["force_world"] = dist.get_world_size()
    m = mesh_mod.make_mesh(1, 1)
    out["mesh_1x1"] = [m.n_data, m.n_seed, m.data_index, m.seed_index]
    t = torch.tensor([1.5, 2.5], dtype=torch.float64)
    out["reduce_1x1"] = mesh_mod.all_reduce(t.clone(), m.data_group).tolist()
    out["gather_1x1"] = mesh_mod.all_gather_seeds(m, t)[0].tolist()
    try:
        mesh_mod.make_mesh(2, 1)
        out["bad_mesh"] = "accepted"
    except ValueError as e:
        out["bad_mesh"] = str(e)
    distributed.shutdown()
    out["after_shutdown"] = dist.is_initialized()
    os.environ.update(launch, RANK="1")
    t0 = time.perf_counter()
    try:
        distributed.initialize(device="cpu", timeout=datetime.timedelta(seconds=3))
        out["unreachable"] = "joined"
    except RuntimeError as e:
        out["unreachable"] = str(e)
    out["unreachable_seconds"] = time.perf_counter() - t0
    out["unreachable_initialized"] = dist.is_initialized()
    return out


def _worker(scenario: str, rank: int, world: int, port: int, d: str) -> None:
    if scenario == "env":
        with open(os.path.join(d, "env.json"), "w") as fh:
            json.dump(_env_checks(port, d), fh)
        return
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    assert distributed.initialize(device="cpu")
    assert dist.get_backend() == "gloo" and dist.get_world_size() == world
    psset, bg = _inputs(d)
    res = {}
    if scenario == "two":
        mesh = distributed.auto_mesh(1)
        assert mesh.shape == {"data": 2, "seed": 1}, mesh.shape
        res.update(em_case(psset, bg, mesh))
        res.update(gibbs_case(psset, bg, mesh, sample=True))
        res.update(gibbs_case(psset, bg, mesh, sample=False))
        res.update(cli_case(os.path.join(d, f"cli_rank{rank}")))
    mesh = distributed.auto_mesh(len(SOFTS))
    res["multi_mesh"] = [mesh.n_data, mesh.n_seed]
    res.update(multi_case(psset, bg, mesh))
    np.savez(os.path.join(d, f"{scenario}_{rank}.npz"), **res)


# ---- the fixture ----

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_workers(d: str) -> list:
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = REPO
    procs = []
    for scenario, world in SCENARIOS.items():
        port = _free_port()
        procs += [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), scenario, str(r), str(world), str(port), d],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ) for r in range(world)]
    return procs


def _wait(procs: list) -> list:
    deadline = time.monotonic() + WORKER_TIMEOUT
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail("a parallel worker timed out")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker {p.args[2:4]} failed:\n{log[-4000:]}"
    return logs


def _jax_refs(sset) -> dict:
    """The JAX package's runs: single and on an 8-way data mesh for EM, on a
    (4, 2) mesh for the three seeds."""
    from bammmotif2_tpu.models import background as jbackground
    from bammmotif2_tpu.models import seeds as jseeds
    from bammmotif2_tpu.parallel import mesh as jmesh
    from bammmotif2_tpu.refinement import em as jem
    from bammmotif2_tpu.refinement import multi as jmulti
    from bammmotif2_tpu.utils.config import Params as JParams

    jbg = jbackground.BackgroundModel.from_sequence_set(sset, order=2)
    params = JParams(EM=True, q=0.5, maxEMIterations=10, optimizeQ=True, use_pallas=False)

    def seed(soft=0.6):
        return jseeds.motif_from_pwm(jseeds.iupac_to_pwm(MOTIF, soft=soft), 2,
                                     sset.base_frequencies())

    out = {}
    for name, mesh in (("single", None), ("sharded", jmesh.make_mesh(n_data=8, n_seed=1))):
        m = seed()
        r = jem.run_em(m, jbg, sset, params, mesh=mesh)
        out[name] = {"em_iterations": r.iterations, "em_ll": r.ll, "em_q": r.q,
                     **{f"em_v{k}": np.asarray(vk) for k, vk in enumerate(m.v)}}
    ms = [seed(s) for s in SOFTS]
    rs = jmulti.run_em_multi(ms, jbg, sset, params, mesh=jmesh.make_mesh(n_data=4, n_seed=2))
    out["multi_mesh"] = {"multi_iterations": [r.iterations for r in rs],
                         "multi_ll": [r.ll for r in rs], "multi_q": [r.q for r in rs],
                         **{f"multi_v{k}": np.stack([np.asarray(m.v[k]) for m in ms])
                            for k in range(3)}}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from bammmotif2_tpu_torch import convert
    from tests.test_em import planted_set

    d = str(tmp_path_factory.mktemp("parallel"))
    sset = planted_set(n=N_SEQS, l=SEQ_LEN, motif=MOTIF, q=0.8, noise=0.1)
    psset = convert.sequence_set(sset)
    np.savez(os.path.join(d, "inputs.npz"), codes=psset.codes, lens=psset.lens)
    procs = _start_workers(d)
    try:
        psset, bg = _inputs(d)
        single = {**em_case(psset, bg, None), **multi_case(psset, bg, None),
                  **gibbs_case(psset, bg, None, True), **gibbs_case(psset, bg, None, False)}
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main([os.path.join(d, "cli_single"), POS, *CLI_ARGS], device="cpu")
        jax_refs = _jax_refs(sset)
    finally:
        _wait(procs)
    ranks = {(s, r): dict(np.load(os.path.join(d, f"{s}_{r}.npz")))
             for s, w in SCENARIOS.items() if s != "env" for r in range(w)}
    with open(os.path.join(d, "env.json")) as fh:
        env = json.load(fh)
    return {"dir": d, "single": single, "jax": jax_refs, "ranks": ranks, "env": env}


def _assert_em(got: dict, ref: dict, prefix: str, rtol: float, atol: float) -> None:
    np.testing.assert_array_equal(got[f"{prefix}_iterations"], ref[f"{prefix}_iterations"])
    for key in ("ll", "q"):
        np.testing.assert_allclose(got[f"{prefix}_{key}"], ref[f"{prefix}_{key}"], rtol=rtol)
    for k in range(3):
        np.testing.assert_allclose(got[f"{prefix}_v{k}"], ref[f"{prefix}_v{k}"], atol=atol)


# ---- layout ----

@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("n_seeds", [1, 2, 3, 10])
def test_mesh_shape_follows_the_reference_rule(monkeypatch, world, n_seeds):
    """The reference's auto_mesh, with its device count set to ``world`` and
    its mesh constructor reporting the shape it is asked for."""
    import jax

    from bammmotif2_tpu.parallel import distributed as jdist
    from bammmotif2_tpu.parallel import mesh as jmesh

    monkeypatch.setattr(jax, "device_count", lambda: world)
    monkeypatch.setattr(jmesh, "make_mesh", lambda n_data, n_seed: (n_data, n_seed))
    want = jdist.auto_mesh(n_seeds)
    if world == 1:
        assert want is None and distributed.auto_mesh(n_seeds) is None
        assert distributed.mesh_shape(1, n_seeds) == (1, 1)
    else:
        assert distributed.mesh_shape(world, n_seeds) == want


@pytest.mark.parametrize("n_seeds", [1, 2, 3, 10])
def test_mesh_shape_matches_jax_on_eight_devices(n_seeds):
    from bammmotif2_tpu.parallel import distributed as jdist

    n_data, n_seed = distributed.mesh_shape(8, n_seeds)
    assert dict(jdist.auto_mesh(n_seeds).shape) == {"data": n_data, "seed": n_seed}


@pytest.mark.parametrize("n_data", [2, 4, 8])
def test_shard_em_data_blocks_concatenate_to_the_reference_padding(n_data):
    """N = 301 rows over n_data ranks: the ranks' blocks, in rank order,
    are the reference's padded cidx and lens."""
    from bammmotif2_tpu.models import background as jbackground
    from bammmotif2_tpu.ops import encode as jencode
    from bammmotif2_tpu.parallel import mesh as jmesh
    from bammmotif2_tpu.refinement import em as jem
    from bammmotif2_tpu_torch import convert
    from tests.test_em import planted_set

    sset = planted_set(n=N_SEQS, l=SEQ_LEN, motif=MOTIF, q=0.8, noise=0.1)
    jdata = jem.prepare_data(sset, jbackground.BackgroundModel.from_sequence_set(sset, order=2),
                             2, False)
    sentinel = jencode.num_rows(4, 2)
    want = jmesh.shard_em_data(jmesh.make_mesh(n_data, 8 // n_data), jdata, sentinel)
    data = convert.em_data(jdata["cidx"], jdata["lens"], jdata["bg_flat"], "cpu")
    blocks = [mesh_mod.shard_em_data(mesh_mod.Mesh(n_data, 1, i, 0), data, sentinel)
              for i in range(n_data)]
    n_pad = -(-N_SEQS // n_data) * n_data
    assert [(b["row0"], b["n_global"], b["n_padded"]) for b in blocks] == [
        (i * n_pad // n_data, N_SEQS, n_pad) for i in range(n_data)]
    np.testing.assert_array_equal(torch.cat([b["cidx"] for b in blocks], dim=1).numpy(),
                                  np.asarray(want["cidx"]))
    np.testing.assert_array_equal(torch.cat([b["lens"] for b in blocks]).numpy(),
                                  np.asarray(want["lens"]))
    assert all(torch.equal(b["bg_flat"], data["bg_flat"]) for b in blocks)


@pytest.mark.parametrize("n,multiple,axis", [(5, 4, 0), (8, 4, 0), (7, 3, 1)])
def test_pad_to_multiple_matches_reference(n, multiple, axis):
    from bammmotif2_tpu.parallel import mesh as jmesh

    x = np.arange(2 * n).reshape((n, 2) if axis == 0 else (2, n)).astype(np.int32)
    got = mesh_mod.pad_to_multiple(torch.from_numpy(x), multiple, axis, -7)
    np.testing.assert_array_equal(got.numpy(), jmesh.pad_to_multiple(x, multiple, axis, -7))


# ---- EM ----

def test_sharded_em_matches_single_process(runs):
    r0, r1 = runs["ranks"][("two", 0)], runs["ranks"][("two", 1)]
    _assert_em(r0, runs["single"], "em", rtol=1e-5, atol=1e-5)
    for key in r0:
        if key.startswith("em_"):
            np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)


@pytest.mark.parametrize("ref", ["single", "sharded"])
def test_sharded_em_matches_jax(runs, ref):
    """The JAX suite's own bars (tests/test_parallel.py)."""
    _assert_em(runs["ranks"][("two", 0)], runs["jax"][ref], "em", rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("world,shape", [(2, [1, 2]), (4, [2, 2])])
def test_em_multi_on_a_seed_axis_matches_single_process(runs, world, shape):
    """Three seeds over a seed axis of 2 (one pad member), at 2 ranks alone
    and at 4 ranks beside a data axis of 2; every rank ends with all three."""
    scenario = {2: "two", 4: "four"}[world]
    ranks = [runs["ranks"][(scenario, r)] for r in range(world)]
    for got in ranks:
        assert list(got["multi_mesh"]) == shape
        _assert_em(got, runs["single"], "multi", rtol=1e-5, atol=1e-5)
    for got in ranks[1:]:
        for key in got:
            if key.startswith("multi_"):
                np.testing.assert_array_equal(got[key], ranks[0][key], err_msg=key)


@pytest.mark.parametrize("world", [2, 4])
def test_em_multi_matches_jax_mesh(runs, world):
    scenario = {2: "two", 4: "four"}[world]
    _assert_em(runs["ranks"][(scenario, 0)], runs["jax"]["multi_mesh"], "multi",
               rtol=1e-4, atol=2e-4)


# ---- CGS ----

@pytest.mark.parametrize("tag", ["sampled", "argmax"])
def test_sharded_gibbs_step_counts_equal_single_process(runs, tag):
    for r in range(2):
        got = runs["ranks"][("two", r)]
        np.testing.assert_array_equal(got[f"{tag}_step_nocc"], runs["single"][f"{tag}_step_nocc"])
        for k in range(3):
            np.testing.assert_array_equal(got[f"{tag}_step_counts{k}"],
                                          runs["single"][f"{tag}_step_counts{k}"])


@pytest.mark.parametrize("tag", ["sampled", "argmax"])
def test_sharded_gibbs_matches_single_process(runs, tag):
    """The same draws on every layout: models, q and alphas equal; ll sums
    in another order."""
    single = runs["single"]
    for r in range(2):
        got = runs["ranks"][("two", r)]
        for key in [f"{tag}_q", f"{tag}_alphas"] + [f"{tag}_v{k}" for k in range(3)]:
            np.testing.assert_array_equal(got[key], single[key], err_msg=key)
        np.testing.assert_allclose(got[f"{tag}_ll"], single[f"{tag}_ll"], rtol=1e-5)


# ---- CLI ----

def test_cli_rank0_writes_the_single_process_files(runs):
    from tests import torch_outputs

    d = runs["dir"]
    cmp = torch_outputs.compare_dirs(os.path.join(d, "cli_rank0"), os.path.join(d, "cli_single"),
                                     refined=True)
    assert cmp["files"] >= 4
    assert not os.path.exists(os.path.join(d, "cli_rank1"))


def test_cli_prints_on_rank0_only(runs):
    out0 = str(runs["ranks"][("two", 0)]["cli_stdout"])
    assert "mesh {'data': 2, 'seed': 1} over 2 devices (1 hosts)" in out0
    assert "Runtime" in out0
    assert str(runs["ranks"][("two", 1)]["cli_stdout"]) == ""


def test_single_device_joins_nothing(runs):
    env = runs["env"]
    assert env["single_device_initialized"] is False
    assert any(f.endswith(".ihbcp") for f in env["single_device_files"])


# ---- bring-up ----

def test_initialize_without_environment_touches_nothing(monkeypatch):
    for k in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    assert not dist.is_initialized()
    assert distributed.auto_mesh(4) is None and distributed.is_main()


def test_initialize_force_brings_up_one_rank_group(runs):
    env = runs["env"]
    assert env["force"] is True and env["force_backend"] == "gloo" and env["force_world"] == 1
    assert env["mesh_1x1"] == [1, 1, 0, 0]
    assert env["reduce_1x1"] == [1.5, 2.5] and env["gather_1x1"] == [1.5, 2.5]
    assert env["bad_mesh"] == "mesh 2x1 != 1 ranks"
    assert env["after_shutdown"] is False


def test_initialize_raises_on_unreachable_master(runs):
    env = runs["env"]
    assert env["unreachable"].startswith("torch.distributed bring-up failed"), env["unreachable"]
    assert env["unreachable_initialized"] is False
    assert env["unreachable_seconds"] < 60


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
