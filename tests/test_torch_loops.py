"""The device-resident loops (``refinement/graphs.py``) on the CPU, where
their body runs eagerly: the chunked, masked EM loop and the in-place CGS
sweep loop against per-iteration stepping (bit-equal: the same body in the
same order) and the EM loops against the JAX package's (within
tests/test_torch_em.py's bars), the rules that decide between a CUDA
graph and the eager loop and between the loop on the device and the
chunked one, and the stop test against the reference's ``cond``.  The
graphed loops on the card: ``check_loops`` in tests/test_torch_cuda.py."""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bammmotif2_tpu.models import background as jbackground
from bammmotif2_tpu.models import seeds as jseeds
from bammmotif2_tpu.refinement import em as jem
from bammmotif2_tpu.refinement import multi as jmulti
from bammmotif2_tpu.utils.config import Params
from bammmotif2_tpu_torch import convert
from bammmotif2_tpu_torch.models.background import BackgroundModel
from bammmotif2_tpu_torch.parallel.mesh import Mesh
from bammmotif2_tpu_torch.refinement import em, gibbs, graphs, multi

from tests.test_em import planted_set

torch.set_num_threads(1)

MOTIF = "TGACTCAG"
# three width-8 seeds that freeze at different iterations on the planted set
SEEDS = [(MOTIF, 0.8), ("TGASTCAG", 0.5), ("TGACTCAT", 0.6)]
# SYNC_EVERY values; "past_cap" is max_iters + 5: one chunk for the whole run
SYNCS = [1, 2, 3, 8, "past_cap"]


@pytest.fixture(scope="module")
def planted():
    """(JAX set, JAX background, port background, the port's copy of the set)."""
    sset = planted_set(n=80, l=60, motif=MOTIF, q=0.8, seed=3)
    psset = convert.sequence_set(sset)
    return sset, jbackground.BackgroundModel.from_sequence_set(sset, order=2), \
        BackgroundModel.from_sequence_set(psset, order=2), psset


def _seed(sset, pattern, soft, K=2):
    return jseeds.motif_from_pwm(jseeds.iupac_to_pwm(pattern, soft=soft), K, sset.base_frequencies())


def _sync(monkeypatch, sync, max_iters):
    monkeypatch.setattr(multi, "SYNC_EVERY", max_iters + 5 if sync == "past_cap" else sync)


def per_iteration_loop(step, v0, q0, epsilon, max_iters, n_hist_slots=0, hist_stride=1,
                       ll0=None):
    """The batched EM loop as the port stepped it before its loops stayed on
    the device: the stop test read on the host before every iteration."""
    M = q0.shape[0]
    v, q = v0, q0
    lls = torch.full((M,), float("-inf")) if ll0 is None else ll0.clone()
    vds = torch.full((M,), float("inf"))
    its = torch.zeros((M,), dtype=torch.int32)
    hist = torch.full((max(n_hist_slots, 1), M), float("nan"))
    seeds = torch.arange(M)
    while bool((its.max() < max_iters) & (vds.max() >= epsilon)):
        active = vds >= epsilon
        v2, q2, ll2, vd2 = step(v, q)
        vd_eff = torch.minimum(vd2, (ll2 - lls).abs())
        v = tuple(torch.where(active[:, None, None], a, b) for a, b in zip(v2, v))
        if n_hist_slots > 0:
            slot = torch.clamp(its // hist_stride, max=n_hist_slots - 1).long()
            hist[slot, seeds] = torch.where(active, ll2, hist[slot, seeds])
        q = torch.where(active, q2, q)
        lls = torch.where(active, ll2, lls)
        vds = torch.where(active, vd_eff, vds)
        its = its + active.to(torch.int32)
    return v, q, lls, vds, its, hist


def _assert_equal(got, ref):
    for a, b in zip(got, ref):
        if isinstance(a, tuple):
            _assert_equal(a, b)
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.numpy(), b.numpy())  # NaN-aware, bit-equal


def _group(planted, max_iters):
    """A three-seed group on the planted set: (jms, step, inputs, key, v0,
    q0, eps, hist slots, hist stride)."""
    sset, _jbg, bg, psset = planted
    jms = [_seed(sset, p, soft) for p, soft in SEEDS]
    data = em.prepare_data(psset, bg, 2, False, "cpu")
    v0 = tuple(torch.as_tensor(np.stack([m.v[k] for m in jms]), dtype=torch.float32)
               for k in range(3))
    alphas = torch.as_tensor(np.stack([m.alphas for m in jms]), dtype=torch.float32)
    f_bg = torch.as_tensor(jms[0].f_bg, dtype=torch.float32)
    step, inputs, key = multi.group_step(data, alphas, f_bg, psset.n, A=4, K=2, W=8,
                                         optimize_q=True, path="plain")
    stride = max(1, -(-max_iters // multi.HIST_CAP))
    slots = -(-max_iters // stride)
    q0 = torch.full((3,), 0.9)
    return jms, step, inputs, key, v0, q0, torch.tensor(1e-3), slots, stride


@pytest.mark.parametrize("max_iters", [600, 10], ids=["freeze", "cap"])
@pytest.mark.parametrize("sync", SYNCS)
def test_batched_loop_chunks_equal_per_iteration(planted, monkeypatch, sync, max_iters):
    """Seeds that freeze at different iterations (mid-chunk), and a cap that
    lands inside a chunk, give the per-iteration loop's results bit for bit."""
    _jms, step, inputs, key, v0, q0, eps, slots, stride = _group(planted, max_iters)
    ref = per_iteration_loop(step, v0, q0, eps, max_iters, slots, stride)
    _sync(monkeypatch, sync, max_iters)
    got = multi.batched_while_loop(step, v0, q0, eps, max_iters, slots, stride,
                                   inputs=inputs, key=key)
    _assert_equal(got, ref)
    its = got[4].tolist()
    if max_iters == 10:
        assert its == [10, 10, 10]
    else:
        assert len(set(its)) == 3 and max(its) < max_iters, its


@pytest.mark.parametrize("sync", [1, 3, 8])
def test_batched_loop_matches_jax(planted, monkeypatch, sync):
    """The chunked loop against the reference's ``lax.while_loop`` on the
    gather path, within tests/test_torch_em.py's bars."""
    max_iters = 600
    jms, step, inputs, key, v0, q0, eps, slots, stride = _group(planted, max_iters)
    sset, jbg, _bg, _psset = planted
    jdata = jem.prepare_data(sset, jbg, 2, False)
    jout = jmulti.batched_while_loop(
        jmulti.make_batched_step(4, 2, 8, True, "gather"),
        tuple(jnp.asarray(vk.numpy()) for vk in v0), jnp.asarray(q0.numpy()), jdata,
        jnp.asarray(np.stack([m.alphas for m in jms]), jnp.float32),
        jnp.asarray(jms[0].f_bg, jnp.float32), jnp.float32(sset.n), jnp.float32(1e-3),
        max_iters, n_hist_slots=slots, hist_stride=stride)
    _sync(monkeypatch, sync, max_iters)
    v, q, lls, _vds, its, hist = multi.batched_while_loop(step, v0, q0, eps, max_iters, slots,
                                                          stride, inputs=inputs, key=key)
    assert its.tolist() == np.asarray(jout[4]).tolist()
    np.testing.assert_allclose(lls.numpy(), np.asarray(jout[2]), rtol=1e-5)
    np.testing.assert_allclose(q.numpy(), np.asarray(jout[1]), rtol=1e-5)
    np.testing.assert_allclose(hist.numpy(), np.asarray(jout[5]), rtol=1e-5)
    for a, b in zip(v, jout[0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def _single(planted, ll0):
    sset, jbg, bg, psset = planted
    jm = _seed(sset, MOTIF, 0.6)
    data = em.prepare_data(psset, bg, 2, False, "cpu")
    v, alphas, f_bg = convert.motif_state(jm, "cpu")
    args = (v, torch.tensor(0.8), data, alphas, f_bg, psset.n, torch.tensor(1e-3),
            torch.tensor(ll0, dtype=torch.float32))
    statics = dict(A=4, K=2, W=jm.W, optimize_q=True, path="plain")
    return jm, args, statics


def per_iteration_em(v, q, data, alphas, f_bg, n_real, epsilon, ll0, *, max_iters, **statics):
    """``em_optimize`` as the port stepped it before: one host sync per
    iteration."""
    ll, vd, it = ll0, torch.tensor(float("inf")), 0
    while it < max_iters and bool(vd >= epsilon):
        v, q, ll_new, vd2 = em.em_step(v, q, data, alphas, f_bg, n_real, **statics)
        vd = torch.minimum(vd2, (ll_new - ll).abs())
        ll = ll_new
        it += 1
    return v, q, ll, vd, it


@pytest.mark.parametrize("ll0", [float("-inf"), -300.0], ids=["fresh", "carried_ll"])
@pytest.mark.parametrize("max_iters", [300, 7], ids=["converged", "cap"])
@pytest.mark.parametrize("sync", SYNCS)
def test_em_optimize_chunks_equal_per_iteration(planted, monkeypatch, sync, max_iters, ll0):
    _jm, args, statics = _single(planted, ll0)
    ref = per_iteration_em(*args, max_iters=max_iters, **statics)
    _sync(monkeypatch, sync, max_iters)
    got = em.em_optimize(*args, max_iters=max_iters, **statics)
    assert got[4] == ref[4] and (got[4] == max_iters) == (max_iters == 7)
    _assert_equal(got[:4], ref[:4])


@pytest.mark.parametrize("sync", [1, 8])
def test_em_optimize_matches_jax(planted, monkeypatch, sync):
    sset, jbg, _bg, _psset = planted
    jm, args, statics = _single(planted, float("-inf"))
    jdata = jem.prepare_data(sset, jbg, 2, False)
    jout = jem.em_optimize(tuple(jnp.asarray(vk, jnp.float32) for vk in jm.v), jnp.float32(0.8),
                           jdata, jnp.asarray(jm.alphas, jnp.float32),
                           jnp.asarray(jm.f_bg, jnp.float32), jnp.float32(sset.n),
                           jnp.float32(1e-3), jnp.float32(-jnp.inf), max_iters=300,
                           **{**statics, "path": "gather"})
    _sync(monkeypatch, sync, 300)
    v, q, ll, _vd, it = em.em_optimize(*args, max_iters=300, **statics)
    assert it == int(jout[4])
    np.testing.assert_allclose(float(ll), float(jout[2]), rtol=1e-5)
    np.testing.assert_allclose(float(q), float(jout[1]), rtol=1e-5)
    for a, b in zip(v, jout[0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("sync,every", [(3, 5), (8, 5), (8, 3), (4, 10), (8, 16)])
def test_checkpoint_chunks_stay_exact(planted, monkeypatch, sync, every):
    """--checkpointEvery chunks that are not multiples of SYNC_EVERY give
    the run of SYNC_EVERY = 1 (per-iteration stepping) bit for bit: the
    same callbacks, iterations, likelihoods and models."""
    sset, _jbg, bg, psset = planted
    params = convert.params(Params(EM=True, modelOrder=2, optimizeQ=True, q=0.8,
                                   checkpointEvery=every))
    runs = []
    for s in (1, sync):
        monkeypatch.setattr(multi, "SYNC_EVERY", s)
        m = convert.motif(_seed(sset, MOTIF, 0.6))
        calls = []
        res = em.run_em(m, bg, psset, params, device="cpu",
                        checkpoint_fn=lambda motif, iteration: calls.append(iteration))
        runs.append((res, m, calls))
    (r1, m1, c1), (r2, m2, c2) = runs
    assert c1 == c2 and len(c1) > 1
    assert (r1.iterations, r1.ll, r1.q, r1.v_diff, r1.converged, r1.ll_history) == \
        (r2.iterations, r2.ll, r2.q, r2.v_diff, r2.converged, r2.ll_history)
    for a, b in zip(m1.v, m2.v):
        np.testing.assert_array_equal(a, b)


def per_sweep_loop(v, q, log_alphas, keys, data, f_bg, default_alphas, n_real, *, A, K, W,
                   n_iters, burn_in, **statics):
    """``gibbs_optimize`` as the port stepped it before: a Python loop with a
    host-side branch on the sweep index for the burn-in mean, the chains'
    keys carried from sweep to sweep by the host's loop."""
    M = q.shape[0]
    keys = None if keys is None else keys.clone()
    acc = tuple(torch.zeros((M, A ** (k + 1), W)) for k in range(K + 1))
    lls, n_occs = [], []
    for i in range(n_iters):
        v, q, log_alphas, ll, n_occ, counts = gibbs.gibbs_step_multi(
            v, q, log_alphas, keys, data, f_bg, default_alphas, n_real, A=A, K=K, W=W,
            **statics)
        if i >= burn_in:
            acc = tuple(a + c for a, c in zip(acc, counts))
        lls.append(ll)
        n_occs.append(n_occ)
    n_avg = max(n_iters - burn_in, 1)
    return v, q, log_alphas, torch.stack(lls), torch.stack(n_occs), tuple(a / n_avg for a in acc)


@pytest.mark.parametrize("sampled", [True, False], ids=["sampled", "deterministic"])
@pytest.mark.parametrize("burn_in", [0, 3])
def test_gibbs_loop_equals_python_loop(planted, burn_in, sampled):
    """Three stacked chains: the draws from the keys carried in the loop's
    state, the histories the sweep counter indexes and the burn-in mean by ``counts * (i >=
    burn_in)`` equal the Python loop's bit for bit."""
    sset, _jbg, bg, psset = planted
    jms = [_seed(sset, p, soft) for p, soft in SEEDS]
    data = em.prepare_data(psset, bg, 2, False, "cpu")
    v = tuple(torch.as_tensor(np.stack([m.v[k] for m in jms]), dtype=torch.float32)
              for k in range(3))
    alphas = torch.as_tensor(np.stack([m.alphas for m in jms]), dtype=torch.float32)
    args = (v, torch.full((3,), 0.9), torch.log(alphas))
    rest = (data, torch.as_tensor(jms[0].f_bg, dtype=torch.float32), alphas, float(psset.n))
    kw = dict(A=4, K=2, W=8, sample_z=sampled, sample_q=sampled, learn_alpha=True,
              path="plain", n_iters=9, burn_in=burn_in)
    keys = gibbs.input_keys(7, [0, 1, 2], "cpu")
    ref = per_sweep_loop(*args, keys, *rest, **kw)
    got = gibbs.gibbs_optimize(*args, keys, *rest, **kw)
    _assert_equal(got, ref)
    assert got[3].shape == (9, 3)


def test_gibbs_loop_of_no_sweeps(planted):
    _sset, _jbg, bg, psset = planted
    data = em.prepare_data(psset, bg, 0, False, "cpu")
    v = (torch.full((2, 4, 6), 0.25),)
    out = gibbs.gibbs_optimize(v, torch.full((2,), 0.9), torch.zeros((2, 1, 6)),
                               gibbs.input_keys(0, [0, 1], "cpu"), data,
                               torch.full((4,), 0.25), torch.ones((2, 1, 6)), float(psset.n),
                               A=4, K=0, W=6, sample_z=True, sample_q=True, learn_alpha=True,
                               path="plain", n_iters=0)
    assert out[3].shape == out[4].shape == (0, 2)
    assert torch.equal(out[0][0], v[0]) and torch.equal(out[5][0], torch.zeros((2, 4, 6)))


@pytest.mark.parametrize("n_iters", [1, 2, 5])
def test_gibbs_takes_the_device_loop_and_stops_at_n_iters(planted, monkeypatch, n_iters):
    """On a CUDA device with no mesh (here ``graphs.enabled`` patched to
    say so, and ``run_while`` to run the loop graph's semantics on the
    CPU: the eager first sweep and its test, then the body while
    ``running`` holds), CGS asks for the device loop, and its stop test
    stops it after exactly n_iters sweeps: the sweep counters at n_iters,
    ``running`` false, results equal to the per-sweep loop's bit for bit,
    with --cgsBurnIn at n_iters - 1."""
    sset, _jbg, bg, psset = planted
    jms = [_seed(sset, p, soft) for p, soft in SEEDS[:2]]
    data = em.prepare_data(psset, bg, 2, False, "cpu")
    v = tuple(torch.as_tensor(np.stack([m.v[k] for m in jms]), dtype=torch.float32)
              for k in range(3))
    alphas = torch.as_tensor(np.stack([m.alphas for m in jms]), dtype=torch.float32)
    args = (v, torch.full((2,), 0.9), torch.log(alphas), gibbs.input_keys(3, [0, 1], "cpu"),
            data, torch.as_tensor(jms[0].f_bg, dtype=torch.float32), alphas, float(psset.n))
    kw = dict(A=4, K=2, W=8, sample_z=True, sample_q=True, learn_alpha=True, path="plain",
              n_iters=n_iters, burn_in=n_iters - 1)
    ref = per_sweep_loop(*args, **kw)
    loops = []

    def run_while(loop):
        assert loop.on_device
        loops.append(loop)
        loop._step(loop.state, loop.gens)  # the warm-up sweep and its test
        while bool(loop.state["running"]):  # the WHILE node
            loop._step(loop.state, loop.gens)

    monkeypatch.setattr(graphs, "enabled", lambda device, mesh=None: True)
    monkeypatch.setattr(graphs.Loop, "run_while", run_while)
    got = gibbs.gibbs_optimize(*args, **kw)
    _assert_equal(got, ref)
    (loop,) = loops
    s = loop.state
    assert loop._until == multi.UNTIL and not loop.gens
    assert s["its"].tolist() == [n_iters] * 2 and s["i"].tolist() == [n_iters]
    assert int(s["cap"]) == n_iters and not bool(s["running"])


@pytest.mark.parametrize("device,backend,graphed", [
    ("cpu", None, False), ("cpu", "gloo", False), ("cuda", None, True),
    ("cuda", "gloo", False), ("cuda", "nccl", True),
], ids=["cpu", "cpu_gloo_mesh", "cuda", "cuda_gloo_mesh", "cuda_nccl_mesh"])
def test_graph_or_eager_rule(monkeypatch, device, backend, graphed):
    """Graphs iff the device is CUDA and there is no mesh or its data group
    runs NCCL (gloo stages through host memory and cannot be captured)."""
    mesh = None
    if backend is not None:
        group = object()
        mesh = Mesh(1, 1, 0, 0, data_group=group, seed_group=object())
        monkeypatch.setattr(torch.distributed, "get_backend",
                            lambda g=None: backend if g is group else "other")
    assert graphs.enabled(torch.device(device), mesh) is graphed


def test_cpu_loop_runs_the_body_eagerly_on_its_state():
    """On the CPU the loop runs the body on the caller's tensors, caches
    nothing and leaves the inputs and the generators as they are."""
    state = {"q": torch.zeros(2), "v": (torch.ones(3),)}
    inputs = {"x": torch.full((2,), 2.0)}
    gens = [torch.Generator().manual_seed(1)]
    before = len(graphs.stats())

    def body(s, g):
        s["q"].add_(inputs["x"] + torch.rand(2, generator=g[0]))
        s["v"][0].mul_(2)

    with graphs.Loop("test loop", ("k",), state, inputs, body, gens=gens) as loop:
        loop.run(3)
        assert not loop.graphed and loop.state is state and loop.gens[0] is gens[0]
    ref, g = torch.zeros(2), torch.Generator().manual_seed(1)
    for _ in range(3):
        ref.add_(torch.full((2,), 2.0) + torch.rand(2, generator=g))
    assert torch.equal(state["q"], ref) and torch.equal(gens[0].get_state(), g.get_state())
    assert state["v"][0].tolist() == [8.0] * 3 and len(graphs.stats()) == before


def test_cpu_loop_makes_its_outputs():
    """A step's outputs (the FDR fold tail's) are made beside the state,
    fresh each loop on the CPU, and the body writes them; without outputs
    the state is the caller's dict."""
    state = {"x": torch.arange(3.0)}
    made = []

    def make():
        made.append(torch.empty(3))
        return made[-1]

    def body(s, _g):
        s["y"].copy_(s["x"] * 2)

    for n in (1, 2):
        loop = graphs.Loop("test step", ("k",), dict(state), {}, body, outputs={"y": make})
        loop.run(1)
        assert len(made) == n and loop.state["y"] is made[-1]
        assert loop.state["y"].tolist() == [0.0, 2.0, 4.0] and loop.state["x"] is state["x"]


@pytest.mark.parametrize("n_gens", [0, 1], ids=["no_gens", "gens"])
@pytest.mark.parametrize("backend", [None, "nccl", "gloo"], ids=["no_mesh", "nccl", "gloo"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_device_loop_rule(monkeypatch, device, backend, n_gens):
    """A loop that holds its stop test runs to its end on the device iff it
    is graphed, has no mesh and registers no generators."""
    mesh = None
    if backend is not None:
        group = object()
        mesh = Mesh(1, 1, 0, 0, data_group=group, seed_group=object())
        monkeypatch.setattr(torch.distributed, "get_backend",
                            lambda g=None: backend if g is group else "other")
    want = device == "cuda" and backend is None and n_gens == 0
    assert graphs.device_loop(torch.device(device), mesh, n_gens) is want
    if want:
        assert graphs.enabled(torch.device(device), mesh)


def test_loop_with_generators_asking_for_the_device_loop_raises():
    """A body that draws cannot loop on the device (a replay advances its
    generators' offsets from the host): asking raises before anything
    runs, and nothing falls back."""
    state = {"running": torch.tensor(True), "its": torch.zeros(2, dtype=torch.int32),
             "vds": torch.full((2,), float("inf")), "cap": torch.tensor(3, dtype=torch.int32),
             "eps": torch.tensor(0.0)}
    ran = []
    with pytest.raises(graphs.CaptureError, match="generators"):
        graphs.Loop("test loop", ("k",), state, {}, lambda s, g: ran.append(1),
                    gens=[torch.Generator().manual_seed(0)], until=multi.UNTIL)
    assert not ran


def test_cpu_loop_with_its_stop_test_runs_in_chunks():
    """On the CPU a loop with ``until`` is not on the device: ``run`` takes
    the body and the plain test, ``run_while`` refuses."""
    state = {"running": torch.tensor(True), "its": torch.zeros(2, dtype=torch.int32),
             "vds": torch.full((2,), float("inf")), "cap": torch.tensor(3, dtype=torch.int32),
             "eps": torch.tensor(0.0)}

    def body(s, _g):
        s["its"].add_(1)

    loop = graphs.Loop("test loop", ("k",), state, {}, body, until=multi.UNTIL)
    assert not loop.on_device and not loop.graphed
    loop.run(2)
    assert state["its"].tolist() == [2, 2] and bool(state["running"])
    loop.run(1)
    assert not bool(state["running"])
    with pytest.raises(RuntimeError, match="run\\(n\\)"):
        loop.run_while()


@pytest.mark.parametrize("traced", [True, False], ids=["traced", "untraced"])
def test_settle_counts_loop_iterations_and_operations(monkeypatch, traced):
    """``settle`` reads each device loop launched since the last settle
    once: the iterations since then go to its replays, to the launch
    counters and, under an active trace, to ``graph.loop_ops`` (iterations
    times the body's kernel, memcpy and memset nodes and the stop test's
    kernel: what a CUDA profiler records inside WHILE nodes).  Fakes stand in for the loop graphs: each loop's
    device counter is a CPU tensor."""
    from bammmotif2_tpu_torch.ops import cuda_while
    from bammmotif2_tpu_torch.utils import metrics

    class Wrapper:
        launches = 0

    em_body = {"kernel": 68, "memcpy": 5}
    cgs_body = {"kernel": 322, "memcpy": 4, "memset": 2, "event_record": 1}
    assert (graphs.body_ops(em_body), graphs.body_ops(cgs_body)) == (74, 329)
    entries = []
    for name, body, total, settled in (("EM loop", em_body, 30, 10),
                                       ("CGS sweep loop", cgs_body, 7, 0)):
        e = graphs._Captured(name, {}, {}, [], None)
        e.body_nodes = body
        e.count, e.settled, e.replays = torch.tensor(total), settled, settled
        e.per_iteration = {Wrapper: 2}
        entries.append(e)
    monkeypatch.setattr(graphs, "_UNSETTLED", {id(e): e for e in entries})
    monkeypatch.setattr(cuda_while.condition, "launches", 0)
    monkeypatch.setattr(Wrapper, "launches", 0)
    with metrics.tracing() if traced else contextlib.nullcontext() as trace:
        graphs.settle()
        graphs.settle()  # nothing left to read
    assert [(e.replays, e.settled) for e in entries] == [(30, 30), (7, 7)]
    assert (Wrapper.launches, cuda_while.condition.launches) == (2 * 27, 27)
    assert not graphs._UNSETTLED
    if traced:
        assert trace.counts == {"graph.loop_ops": 20 * 74 + 7 * 329}


def _scripted(table, xp):
    """A batched step whose v is an iteration counter [M, 1, 1]: iteration
    i returns vd = table[i - 1] ([M]) and ll = 10 i, so |dll| = 10."""
    def step(v, q, *_rest):
        c = v[0] + 1
        i = c[:, 0, 0].astype(xp.int32) if xp is jnp else c[:, 0, 0].long()
        rows = xp.asarray(table) if xp is jnp else torch.as_tensor(table)
        vd = rows[i - 1, xp.arange(len(i))] if xp is jnp else rows[i - 1, torch.arange(len(i))]
        return (c,), q, 10.0 * c[:, 0, 0], vd
    return step


NAN = float("nan")
# name -> (per-iteration vd [iterations, M], cap): the reference's cond on
# the states these reach
COND_CASES = {
    "cap_reached": ([[1.0, 1.0]] * 6, 3),
    "all_frozen": ([[1.0, 1.0], [0.0, 1.0], [1.0, 1.0], [1.0, 0.0], [1.0, 1.0]], 5),
    "nan_vds": ([[1.0, 1.0], [NAN, 1.0], [1.0, 1.0], [1.0, 1.0]], 4),
    "frozen_at_first": ([[0.0, 0.0], [1.0, 1.0]], 2),
    "cap_one": ([[1.0, 1.0]] * 2, 1),
}


@pytest.mark.parametrize("case", list(COND_CASES))
def test_running_matches_reference_cond(case):
    """``multi._running`` (the plain version of the condition kernel) stops
    the port's loop where the reference's ``cond`` stops its
    ``lax.while_loop``: the cap reached, every seed frozen, a NaN v_diff
    (its max is NaN and compares false), a loop stopped by its first
    iteration.  The same its and vds; the final state's test is False and
    ``cuda_while.condition`` on CPU tensors agrees."""
    from bammmotif2_tpu_torch.ops import cuda_while

    table, cap = COND_CASES[case]
    table = np.asarray(table, np.float32)
    M, eps = table.shape[1], 1e-3
    jout = jmulti.batched_while_loop(
        _scripted(table, jnp), (jnp.zeros((M, 1, 1), jnp.float32),), jnp.full((M,), 0.5),
        None, None, None, None, jnp.float32(eps), cap)
    v, _q, lls, vds, its, _h = multi.batched_while_loop(
        _scripted(table, torch), (torch.zeros((M, 1, 1)),), torch.full((M,), 0.5),
        torch.tensor(eps), cap)
    assert its.tolist() == np.asarray(jout[4]).tolist()
    np.testing.assert_array_equal(vds.numpy(), np.asarray(jout[3]))
    np.testing.assert_array_equal(lls.numpy(), np.asarray(jout[2]))
    np.testing.assert_array_equal(v[0].numpy(), np.asarray(jout[0][0]))
    state = {"its": its, "vds": vds, "cap": torch.tensor(cap, dtype=torch.int32),
             "eps": torch.tensor(eps)}
    assert not bool(multi._running(state))
    running = torch.tensor(True)
    cuda_while.condition(state["its"], state["vds"], state["cap"], state["eps"], running)
    assert not bool(running)
    if case == "nan_vds":
        assert np.isnan(vds[0].item()) and its.tolist() == [2, 2]
    # one iteration fewer: the reference ran another, so the test held
    if int(its.max()) > 1:
        table2, cap2 = table[: int(its.max()) - 1], int(its.max()) - 1
        _v, _q, _l, vds2, its2, _h = multi.batched_while_loop(
            _scripted(table2, torch), (torch.zeros((M, 1, 1)),), torch.full((M,), 0.5),
            torch.tensor(eps), cap2)
        state2 = {"its": its2, "vds": vds2, "cap": torch.tensor(cap, dtype=torch.int32),
                  "eps": torch.tensor(eps)}
        assert bool(multi._running(state2))


def test_cuda_while_imports_without_a_toolkit():
    """``ops/cuda_while.py`` imports, and its test runs on CPU tensors, in
    a process with no CUDA toolkit to find: it builds nothing until a CUDA
    tensor reaches it."""
    import os
    import subprocess
    import sys

    code = ("import torch; from bammmotif2_tpu_torch.ops import cuda_while, _build; "
            "r = torch.tensor(True); "
            "cuda_while.condition(torch.tensor([3, 1], dtype=torch.int32), "
            "torch.tensor([1.0, 0.0]), torch.tensor(3, dtype=torch.int32), torch.tensor(1e-3), r); "
            "assert not bool(r) and cuda_while.condition.launches == 0; "
            "assert _build.load.cache_info().currsize == 0; print('ok')")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env.update(PATH="/nonexistent", PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          cwd=root, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]


def test_while_loop_source_joins_the_build_hash(monkeypatch, tmp_path):
    """``csrc/while_loop.cu`` builds like the other sources: its library's
    name hashes it, the shared headers and the flags, so an edit rebuilds."""
    import shutil

    from bammmotif2_tpu_torch.ops import _build

    for name in ("while_loop.cu", "common.cuh"):
        shutil.copy(f"{_build.CSRC}/{name}", tmp_path / name)
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    base = _build.digest("while_loop")
    assert len(base) == 12
    (tmp_path / "while_loop.cu").write_text((tmp_path / "while_loop.cu").read_text() + "\n// x\n")
    edited = _build.digest("while_loop")
    (tmp_path / "common.cuh").write_text("// y\n")
    assert len({base, edited, _build.digest("while_loop")}) == 3
