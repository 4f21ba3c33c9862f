"""The port's tree step and ``Plan.train`` on tree fleets, against the
JAX package's.

* The E=1 tree step is bitwise the star step, under both wires (join key
  ``(m, 0, i)``, one concatenation per same-cut group, against the star's
  ``(m, i, i)``, every stream on an edge of its own and concatenated
  alone; concatenation is arithmetic-free).
* Random E=2 tree schedules (same-cut streams on different edges, so
  distinct merge groups) are exact batch-B SGD against the port's
  vanilla step, at the rtol 2e-5 / atol 2e-6 of tests/test_tree.py.
* The step matches JAX's ``tree_hybrid_step_from_schedule`` at the
  ``NONE_TOL`` / ``INT8_TOL`` of tests/test_torch_hybrid_step.py, and on
  ``oracle-zamba`` in f32 (nested param dicts through the merge) at the
  LM end-to-end tolerances of tests/test_torch_lm.py;
  ``tree_stream_edges`` is ``==``.
* The wire codec runs once per stream that carries samples, before the
  edge's merge: the merged block is never quantized.
* ``Plan.train`` on a tree: history, schedules and walls ``==`` to
  ``repro.api`` (straggler on, re-solves on), E=1 bitwise the star, kill
  and resume bitwise, resume from a checkpoint ``repro`` wrote (which
  must rebuild a ``TreeProfile``), ``replay`` ``==`` the loop, and churn
  refused with the reference's message.
* ``cloud_mesh``'s guards: ``ValueError`` on a star, on a mesh with no
  data-parallel axis and on one whose dp size does not divide the batch
  (the sharded tail itself: tests/test_torch_distrib.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro.core import cost_model as jcm
from repro.core import hybrid_step as jhs
from repro.data.pipeline import SyntheticImages as JImages
from repro_torch.convert import params_from_numpy
from repro_torch.core import hybrid_step as ths
from repro_torch.core.cost_model import (MultiSchedule, TreeNetwork,
                                         TreeProfile)
from repro_torch.core.profiler import multi_analytic_profile
from repro_torch.data.pipeline import SyntheticImages
from repro_torch.kernels import ops as kops
from repro_torch.models import cnn as tcnn
from repro_torch.train import loop
from tests.test_torch_cnn import batch, jax_params, model_pair, to_jax
from tests.test_torch_hybrid_step import (INT8_LOSS, INT8_TOL, NONE_TOL,
                                          assert_params_close,
                                          assert_params_equal)
from tests.test_torch_train_loop import (assert_plans_equal, changes,
                                         jax_init, models, port_plan,
                                         same_params, slowdown)
from tests.test_torch_train_loop import \
    assert_params_close as assert_train_params_close
from tests.test_torch_serve import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

jax.config.update("jax_platform_name", "cpu")

MBPS = 1e6 / 8.0

# An E=2 tree schedule over fig_tree's M=4 worker names: cut-1 streams on
# edges 0 and 1 and a cut-2 pair on edge 0 (two members, one merge), a
# b=0 stream at cut 2 that joins no group, and a TASK-L stream.
TREE_SCHED = dict(worker_o="cloud", worker_l="device_3",
                  s_workers=("device_0", "device_1", "device_2", "edge_0",
                             "edge_1"),
                  m_s=(1, 2, 1, 2, 2), m_l=3, b_o=2, b_s=(2, 3, 1, 2, 0),
                  b_l=2)
TREE_EDGES = (0, 0, 1, 0, 1)


def tiny_tree(m: int = 4, e: int = 2, seed: int = 0):
    """The port's tiny-MLP tree of tests/test_tree.py (``_tree``)."""
    _, model = model_pair("tiny_mlp")
    prof = multi_analytic_profile(
        model, device_slowdowns=tuple(1.0 + 0.3 * i for i in range(m)))
    rng = np.random.default_rng(seed)
    net = TreeNetwork(bw_de=rng.uniform(2.0, 5.0, m) * MBPS,
                      bw_ec=np.full(e, 2.0) * MBPS,
                      edge_of=tuple(i * e // m for i in range(m)))
    return model, TreeProfile.from_multi(prof, n_edges=e), net


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wire", ["none", "int8"])
def test_e1_tree_step_equals_star_bitwise(wire):
    jm, tm = model_pair("alexnet_narrow")
    params = params_from_numpy(jax_params(jm, 21))
    x, y = (torch.from_numpy(a) for a in batch(jm, 12, 22))
    for m_s, m_l, b in (((1, 1, 2), 3, (2, 3, 1, 2, 4)),
                        ((2, 1, 2), 4, (3, 2, 2, 3, 2)),
                        ((0, 3, 3), 3, (5, 0, 4, 3, 0))):
        sched = MultiSchedule(worker_o="cloud", worker_l="edge",
                              s_workers=("device_0", "device_1",
                                         "device_2"),
                              m_s=m_s, m_l=m_l, b_o=b[0], b_s=b[1:4],
                              b_l=b[4])
        ps, ls = ths.multi_hybrid_step_from_schedule(tm, params, x, y,
                                                     sched, 0.05, wire=wire)
        pd, ld = ths.tree_hybrid_step_from_schedule(
            tm, params, x, y, sched, 0.05, wire=wire,
            stream_edge=(0, 1, 2))
        pt, lt = ths.tree_hybrid_step_from_schedule(
            tm, params, x, y, sched, 0.05, wire=wire,
            stream_edge=(0, 0, 0))
        assert torch.equal(ls, ld) and torch.equal(ls, lt)
        assert_params_equal(ps, pd)
        assert_params_equal(ps, pt)


def random_tree_schedule(seed: int, B: int = 16):
    rng = np.random.default_rng(seed)
    _, tprof, tnet = tiny_tree(seed=seed % 7)
    N = tprof.num_layers
    S = tprof.num_streams
    names = tprof.worker_names
    m_l = int(rng.integers(0, N + 1))
    m_s = tuple(int(rng.integers(0, m_l + 1)) for _ in range(S))
    splits = rng.multinomial(B, np.ones(S + 2) / (S + 2))
    b_s = [int(v) if m_s[i] > 0 else 0
           for i, v in enumerate(splits[1:1 + S])]
    b_l = int(splits[1 + S]) if m_l > 0 else 0
    order = rng.permutation(S + 2)
    sched = MultiSchedule(
        worker_o=names[order[0]], worker_l=names[order[1]],
        s_workers=tuple(names[i] for i in order[2:]), m_s=m_s, m_l=m_l,
        b_o=B - sum(b_s) - b_l, b_s=tuple(b_s), b_l=b_l)
    return tprof, tnet, sched


@pytest.mark.parametrize("seed", range(12))
def test_tree_step_equals_reference_sgd(seed):
    """Random E=2 schedules, as tests/test_tree.py draws them."""
    tprof, tnet, sched = random_tree_schedule(seed)
    jm, model = model_pair("tiny_mlp")
    params = params_from_numpy(jax_params(jm, seed))
    x, y = (torch.from_numpy(a) for a in batch(model, 16, seed))
    ref, ref_loss = ths.reference_sgd_step(model, params, x, y, 0.05)
    hyb, hyb_loss = ths.tree_hybrid_step_from_schedule(
        model, params, x, y, sched, 0.05,
        stream_edge=ths.tree_stream_edges(tprof, tnet, sched))
    assert float(hyb_loss) == pytest.approx(float(ref_loss), rel=1e-5)
    for pr, ph in zip(ref, hyb):
        for k in ("w", "b"):
            np.testing.assert_allclose(pr[k].numpy(), ph[k].numpy(),
                                       rtol=2e-5, atol=2e-6)


def test_random_schedules_merge_same_cut_streams_on_different_edges():
    """The seeds above include streams that share a cut but not an edge
    (two merge groups at one cut) and multi-member groups."""
    split = multi = 0
    for seed in range(12):
        tprof, tnet, s = random_tree_schedule(seed)
        edges = ths.tree_stream_edges(tprof, tnet, s)
        live = [(m, e) for m, e, b in zip(s.m_s, edges, s.b_s) if b]
        split += any(m == n and e != f for m, e in live for n, f in live)
        multi += len(set(live)) < len(live)
    assert split and multi


@pytest.mark.parametrize("wire", ["none", "int8"])
@pytest.mark.parametrize("name", ["lenet5", "alexnet_narrow"])
def test_tree_step_matches_jax(name, wire):
    jm, tm = model_pair(name)
    p_np = jax_params(jm, 23)
    x, y = batch(jm, 12, 24)
    jsched, tsched = jcm.MultiSchedule(**TREE_SCHED), \
        MultiSchedule(**TREE_SCHED)
    jp, jl = jax.jit(lambda p, a, b: jhs.tree_hybrid_step_from_schedule(
        jm, p, a, b, jsched, 0.05, wire=wire, stream_edge=TREE_EDGES))(
        to_jax(p_np), jnp.asarray(x), jnp.asarray(y))
    tp, tl = ths.tree_hybrid_step_from_schedule(
        tm, params_from_numpy(p_np), torch.from_numpy(x),
        torch.from_numpy(y), tsched, 0.05, wire=wire,
        stream_edge=TREE_EDGES)
    if wire == "none":
        assert float(tl) == pytest.approx(float(jl), rel=1e-5)
        assert_params_close(tp, jp, **NONE_TOL)
    else:
        assert abs(float(tl) - float(jl)) <= INT8_LOSS
        assert_params_close(tp, jp, **INT8_TOL)


def test_oracle_zamba_tree_step_matches_jax():
    """Nested LM param dicts through the per-edge merges (f32)."""
    from repro.models.lm.layerstack import lm_layerstack as jax_lm_stack
    from tests.test_torch_lm import (E2E, E2E_LOSS_RTOL, np_params, stacks,
                                     tokens)
    from tests.test_torch_lm import assert_params_close as lm_params_close
    from tests.test_torch_lm import to_jax as lm_to_jax
    js, ts = stacks("cuda")
    js = jax_lm_stack(js.cfg.variant(use_flash=False, use_gla_kernel=False),
                      js.seq_len, "ref")
    p = np_params(js, 25)
    x, y = tokens(ts, 12, 26)
    # cut-2 streams: two on edge 0 (one merge of nested blocks), one on
    # edge 1, and a TASK-L stream at the same cut
    sched = dict(TREE_SCHED, m_s=(2, 2, 2, 0, 0), m_l=2, b_o=3,
                 b_s=(2, 3, 2, 0, 0), b_l=2)
    jp, jl = jax.jit(lambda q, a, b: jhs.tree_hybrid_step_from_schedule(
        js, q, a, b, jcm.MultiSchedule(**sched), 0.05,
        stream_edge=TREE_EDGES))(lm_to_jax(p), jnp.asarray(x),
                                 jnp.asarray(y))
    tp, tl = ths.tree_hybrid_step_from_schedule(
        ts, params_from_numpy(p), torch.from_numpy(x), torch.from_numpy(y),
        MultiSchedule(**sched), 0.05, stream_edge=TREE_EDGES)
    np.testing.assert_allclose(float(tl), float(jl), rtol=E2E_LOSS_RTOL)
    lm_params_close(tp, jp, **E2E)


def test_codec_runs_once_per_stream_before_the_merge(monkeypatch):
    """Each stream that carries samples past a cut > 0 is quantized on
    its own (two kernel calls a crossing: forward and cotangent); the
    edge's merged block is not quantized again."""
    jm, tm = model_pair("lenet5")
    params = params_from_numpy(jax_params(jm, 27))
    x, y = (torch.from_numpy(a) for a in batch(jm, 12, 28))
    rows = []
    real = kops.wire_qdq_int8

    def counting(t):
        rows.append(int(t.shape[0]))
        return real(t)
    monkeypatch.setattr(kops, "wire_qdq_int8", counting)
    ths.tree_hybrid_step_from_schedule(
        tm, params, x, y, MultiSchedule(**TREE_SCHED), 0.05, wire="int8",
        stream_edge=TREE_EDGES)
    s = TREE_SCHED
    want = sorted([b for m, b in zip(s["m_s"], s["b_s"]) if m and b]
                  + [s["b_l"]])
    assert sorted(rows[:len(want)]) == want
    assert sorted(rows) == sorted(want * 2)


def test_tree_stream_edges_equal_jax():
    from repro.core.hybrid_step import tree_stream_edges as jedges
    from tests.test_tree import _tree as jax_tree
    for seed in range(6):
        tprof, tnet, sched = random_tree_schedule(seed)
        _, jprof, jnet = jax_tree(m=4, e=2, seed=seed % 7)
        assert tprof.worker_names == jprof.worker_names
        assert tnet.edge_of == jnet.edge_of
        np.testing.assert_array_equal(tnet.bw_de, jnet.bw_de)
        jsched = jcm.MultiSchedule(**{f: getattr(sched, f) for f in (
            "worker_o", "worker_l", "s_workers", "m_s", "m_l", "b_o", "b_s",
            "b_l")})
        assert ths.tree_stream_edges(tprof, tnet, sched) == \
            jedges(jprof, jnet, jsched)
    for e in (1, 2):
        jp = japi.plan(model_pair("lenet5")[0], japi.Fleet.from_table2(
            "lenet5", m=4, topology="tree", n_edges=e), 64)
        tp = tapi.plan(tcnn.lenet5(), tapi.Fleet.from_table2(
            "lenet5", m=4, topology="tree", n_edges=e), 64)
        assert tp.stream_edges() == jp.stream_edges()
        assert e > 1 or set(tp.stream_edges()) <= {0}


def test_cloud_mesh_raises():
    """``cloud_mesh`` is a tree option (a star plan raises), and a mesh
    with no data-parallel axis or whose dp size does not divide the batch
    raises before any collective.  The sharded tail itself is held to the
    single-rank step on gloo in tests/test_torch_distrib.py."""
    from repro_torch.distrib import MeshShape
    _, tm = model_pair("lenet5")
    tree = tapi.plan(tm, tapi.Fleet.from_table2("lenet5", m=2, n_edges=2),
                     16)
    star = tapi.plan(tm, tapi.Fleet.from_table2("lenet5", m=2), 16)
    with pytest.raises(ValueError, match="tree"):
        star.step_fn(cloud_mesh=object(), device="cpu")
    params = tree.init_params(device="cpu")
    x, y = (torch.from_numpy(a) for a in batch(tm, 16, 1))
    no_dp = MeshShape((2,), ("model",))
    with pytest.raises(ValueError, match="data-parallel axes"):
        tree.step_fn(cloud_mesh=no_dp, device="cpu")(params, x, y)
    with pytest.raises(ValueError, match="data-parallel axes"):
        ths.tree_hybrid_step_from_schedule(
            tm, params, x, y, tree.schedule, 0.05, cloud_mesh=no_dp)
    with pytest.raises(ValueError, match="divisible"):
        tree.step_fn(cloud_mesh=MeshShape((3, 1), ("data", "model")),
                     device="cpu")(params, x, y)


def test_tree_step_fn_runs_the_tree_engine():
    """``Plan.step_fn`` on a tree plan is the tree step with the plan's
    stream→edge map (bitwise)."""
    _, tm = model_pair("lenet5")
    p = tapi.plan(tm, tapi.Fleet.from_table2("lenet5", m=4, n_edges=2,
                                             wire="int8"), 16)
    params = p.init_params(seed=2, device="cpu")
    x, y = (torch.from_numpy(a) for a in batch(tm, 16, 3))
    new, loss = p.step_fn(lr=0.05, device="cpu")(params, x, y)
    want, wloss = ths.tree_hybrid_step_from_schedule(
        tm, params, x, y, p.schedule, 0.05, wire="int8",
        stream_edge=p.stream_edges())
    assert torch.equal(loss, wloss)
    assert_params_equal(new, want)


# ---------------------------------------------------------------------------
# Plan.train on a tree
# ---------------------------------------------------------------------------

B = 24


@functools.lru_cache(maxsize=None)
def tree_fleets(m: int, e: int, wire: str = "none"):
    return (japi.Fleet.from_table2("lenet5", m=m, n_edges=e,
                                   topology="tree", wire=wire),
            tapi.Fleet.from_table2("lenet5", m=m, n_edges=e,
                                   topology="tree", wire=wire))


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("m,e", [(2, 2), (4, 2)])
def test_tree_train_matches_jax(monkeypatch, m, e, depth):
    jm, tm = models("tiny_mlp")
    jfleet, tfleet = tree_fleets(m, e)
    jp = japi.plan(jm, jfleet, B, pipeline_depth=depth)
    tp = port_plan(monkeypatch, tapi.plan(tm, tfleet, B,
                                          pipeline_depth=depth),
                   jax_init("tiny_mlp", 3))
    assert repr(tp.schedule) == repr(jp.schedule)
    args = (tm.input_shape, tm.num_classes, B, 0)
    kw = dict(steps=12, lr=0.05, resched_every=4, ema=0.8, seed=3,
              worker_slowdown=slowdown(tp.schedule.worker_o))
    want = jp.train(JImages(*args), **kw)
    got = tp.train(SyntheticImages(*args), device="cpu", **kw)
    assert changes(got) >= 1, "the straggler never moved the schedule"
    assert_plans_equal(got, want)
    for a, b in zip(got["history"], want["history"]):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
    assert_train_params_close(got["params"], want["params"], **NONE_TOL)


@pytest.mark.parametrize("wire", ["none", "int8"])
def test_e1_tree_train_equals_star_bitwise(wire):
    _, tm = models("tiny_mlp")
    star = tapi.Fleet.from_table2("lenet5", m=3, topology="star", wire=wire)
    tree = tapi.Fleet.from_table2("lenet5", m=3, topology="tree",
                                  n_edges=1, wire=wire)
    data = SyntheticImages(tm.input_shape, tm.num_classes, B, seed=0)
    ps, pt = tapi.plan(tm, star, B), tapi.plan(tm, tree, B)
    assert ps.multi_schedule == pt.multi_schedule
    kw = dict(steps=8, seed=3, resched_every=3, ema=0.8, device="cpu",
              worker_slowdown=slowdown(ps.schedule.worker_o, 30.0, (2, 6)))
    out_s, out_t = ps.train(data, **kw), pt.train(data, **kw)
    assert changes(out_t) >= 1
    assert out_s["wall"] == out_t["wall"]
    for ha, hb in zip(out_s["history"], out_t["history"]):
        assert ha["loss"] == hb["loss"] and ha["sched"] == hb["sched"]
    assert same_params(out_s["params"], out_t["params"])


def _tree_resume_kw(tp):
    return dict(steps=14, lr=0.05, resched_every=4, ema=0.8, seed=3,
                worker_slowdown=slowdown(tp.schedule.worker_o, 30.0,
                                         (2, 12)))


@pytest.mark.parametrize("fail_at", [4, 10])
def test_tree_kill_resume_bitwise(tmp_path, fail_at):
    _, tm = models("tiny_mlp")
    _, fleet = tree_fleets(4, 2, "int8")
    data = SyntheticImages(tm.input_shape, tm.num_classes, B, seed=0)
    kw = dict(_tree_resume_kw(tapi.plan(tm, fleet, B)), device="cpu")
    ref = tapi.plan(tm, fleet, B).train(data, **kw)
    assert changes(ref) >= 1
    with pytest.raises(loop.InjectedFailure):
        tapi.plan(tm, fleet, B).train(data, ckpt_dir=str(tmp_path),
                                      ckpt_every=3, fail_at=fail_at, **kw)
    out = tapi.plan(tm, fleet, B).train(data, ckpt_dir=str(tmp_path),
                                        ckpt_every=3, **kw)
    resume = (fail_at // 3) * 3
    assert out["resumed_from"] == resume
    assert same_params(ref["params"], out["params"])
    tail = [h for h in ref["history"] if h["step"] > resume]
    assert len(tail) == len(out["history"]) > 0
    for ha, hb in zip(tail, out["history"]):
        assert ha["loss"] == hb["loss"] and ha["wall"] == hb["wall"]
        assert ha["sched"] == hb["sched"]
    assert ref["wall"] == out["wall"]


def test_tree_resume_rebuilds_a_tree_profile(tmp_path):
    """The restore goes through ``_profile_from_arrays``: a tree template
    gives a ``TreeProfile`` (a ``MultiProfile`` would re-solve a star)."""
    _, tm = models("tiny_mlp")
    _, fleet = tree_fleets(4, 2)
    p = tapi.plan(tm, fleet, B)
    cfg = loop.HierLoopConfig(total_steps=4, batch=B)
    planner = loop._Planner(cfg, None, p.profile, p.network,
                            topology="tree", initial_schedule=p.schedule)
    tree, extra = planner.state()
    planner.restore(tree, extra)
    assert type(planner.prof) is TreeProfile
    assert planner.prof.n_edges == p.profile.n_edges == 2
    assert planner.prof.cloud_speedup == p.profile.cloud_speedup
    assert planner.prof.worker_names == p.profile.worker_names
    assert repr(planner.ops["solve"](planner.prof).schedule) == \
        repr(p.schedule)


def test_tree_resume_from_a_jax_checkpoint(tmp_path, monkeypatch):
    """JAX dies after step 7 mid-straggle, having checkpointed step 6; the
    port resumes from that checkpoint and continues as JAX's
    uninterrupted run does."""
    jm, tm = models("tiny_mlp")
    jfleet, tfleet = tree_fleets(4, 2)
    kw = _tree_resume_kw(tapi.plan(tm, tfleet, B))
    args = (tm.input_shape, tm.num_classes, B, 0)
    want = japi.plan(jm, jfleet, B).train(JImages(*args), **kw)
    with pytest.raises(Exception, match="injected failure"):
        japi.plan(jm, jfleet, B).train(JImages(*args),
                                       ckpt_dir=str(tmp_path), ckpt_every=3,
                                       fail_at=7, **kw)
    tp = port_plan(monkeypatch, tapi.plan(tm, tfleet, B),
                   jax_init("tiny_mlp", 3))
    got = tp.train(SyntheticImages(*args), ckpt_dir=str(tmp_path),
                   ckpt_every=3, device="cpu", **kw)
    assert got["resumed_from"] == 6
    tail = [h for h in want["history"] if h["step"] > 6]
    assert [(repr(h["sched"]), h["wall"]) for h in got["history"]] == \
        [(repr(h["sched"]), h["wall"]) for h in tail]
    assert changes(want) >= 1
    assert got["wall"] == want["wall"]
    assert repr(got["final_schedule"]) == repr(want["final_schedule"])
    for a, c in zip(got["history"], tail):
        assert a["loss"] == pytest.approx(c["loss"], rel=1e-5)
    assert_train_params_close(got["params"], want["params"], **NONE_TOL)


def test_tree_replay_equals_the_loop():
    _, tm = models("tiny_mlp")
    _, fleet = tree_fleets(4, 2)
    p = tapi.plan(tm, fleet, B, pipeline_depth=3)
    kw = _tree_resume_kw(p)
    out = p.train(SyntheticImages(tm.input_shape, tm.num_classes, B),
                  device="cpu", **kw)
    cfg = loop.HierLoopConfig(total_steps=kw["steps"], batch=B,
                              resched_every=4, ema=0.8, seed=3,
                              pipeline_depth=3, objective=p.objective)
    got = loop.replay(cfg, p.profile, p.network, kw["worker_slowdown"],
                      topology="tree", initial_schedule=p.schedule)
    assert changes(out) >= 1
    assert [(h["step"], h["wall"], h["sched"]) for h in out["history"]] == \
        [(r["step"], r["wall"], r["sched"]) for r in got]


def test_churn_refused_on_a_tree_names_the_topology():
    from repro.core.churn import ChurnTrace as JTrace
    from repro.core.churn import DeviceLeave as JLeave
    from repro_torch.core.churn import ChurnTrace, DeviceLeave
    jm, tm = models("tiny_mlp")
    jfleet, tfleet = tree_fleets(4, 2)
    with pytest.raises(NotImplementedError, match="tree") as want:
        japi.plan(jm, jfleet, 16).train(
            JImages(jm.input_shape, jm.num_classes, 16), steps=2,
            churn=JTrace((JLeave(0, "device_0"),)))
    with pytest.raises(NotImplementedError, match="tree") as got:
        tapi.plan(tm, tfleet, 16).train(
            SyntheticImages(tm.input_shape, tm.num_classes, 16), steps=2,
            churn=ChurnTrace((DeviceLeave(0, "device_0"),)), device="cpu")
    assert str(got.value) == str(want.value)
