"""The port's evaluators, metrics, WeightedAverage, dot drawing and
install check held against the JAX package on the CPU.

* ChunkEvaluator and EditDistance: the same program through both packages
  (to_dict()), three batches accumulated, eval() equal, reset() to zero;
  the port's eval() and reset() take the scope (the port has no global
  scope). EditDistance runs on the padded sequences, as the JAX package's
  evaluator does (it passes no lengths).
* metrics.py and average.py (numpy copies) on the same streams.
* program_to_dot and net_drawer's text equal the JAX package's.
* install_check.run_check on the CPU, and its refusal without a device.
"""
import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from torch_parity import J, T, build


def _chunk_program(pkg):
    L = pkg["L"]
    i = L.data(name="i", shape=[10], dtype="int64")
    lab = L.data(name="l", shape=[10], dtype="int64")
    return pkg["pt"].evaluator.ChunkEvaluator(i, lab, "IOB", 3,
                                              excluded_chunk_types=[2])


def _edit_program(pkg):
    L = pkg["L"]
    h = L.data(name="h", shape=[6], dtype="int64")
    r = L.data(name="r", shape=[4], dtype="int64")
    return pkg["pt"].evaluator.EditDistance(h, r, ignored_tokens=[0])


def _accumulate(make, feeds):
    """Both packages' evaluator programs over `feeds`: (JAX eval() after
    all, port eval() after all, the two eval()s after reset())."""
    jmain, jstart, jev = build(J, make)
    tmain, tstart, tev = build(T, make)
    assert tmain.to_dict() == jmain.to_dict()
    assert tstart.to_dict() == jstart.to_dict()
    jexe, jscope = jpt.Executor(), jpt.Scope()
    texe, tscope = tpt.Executor(place="cpu"), tpt.Scope()
    with jpt.scope_guard(jscope):
        jexe.run(jstart)
        for feed in feeds:
            jexe.run(jmain, feed=feed, fetch_list=jev.metrics)
        jgot = jev.eval(jexe)
        jev.reset(jexe)
        jzero = jev.eval(jexe)
    texe.run(tstart, scope=tscope)
    for feed in feeds:
        texe.run(tmain, feed=feed, fetch_list=tev.metrics, scope=tscope)
    tgot = tev.eval(texe, scope=tscope)
    tev.reset(texe, scope=tscope)
    tzero = tev.eval(texe, scope=tscope)
    return jgot, tgot, jzero, tzero


def test_chunk_evaluator_matches_jax_over_three_batches():
    rng = np.random.default_rng(0)
    feeds = [{"i": rng.integers(0, 7, (4, 10)), "l": rng.integers(0, 7, (4, 10))}
             for _ in range(3)]
    jgot, tgot, jzero, tzero = _accumulate(_chunk_program, feeds)
    for j, t in zip(jgot, tgot):
        np.testing.assert_array_equal(t, j)
    assert 0 < float(tgot[2][0]) < 1
    for z in (jzero, tzero):
        assert all(float(v[0]) == 0.0 for v in z)


def test_edit_distance_evaluator_matches_jax_over_three_batches():
    rng = np.random.default_rng(1)
    feeds = [{"h": rng.integers(0, 4, (5, 6)), "r": rng.integers(0, 4, (5, 4))}
             for _ in range(3)]
    jgot, tgot, jzero, tzero = _accumulate(_edit_program, feeds)
    for j, t in zip(jgot, tgot):
        np.testing.assert_allclose(t, j, rtol=1e-6)
    assert float(tgot[0][0]) > 0 and 0 < float(tgot[1][0]) <= 1
    for z in (jzero, tzero):
        assert all(float(v[0]) == 0.0 for v in z)


def test_chunk_evaluator_known_counts():
    """tests/test_misc_tail.py:27 on the port: per batch 2 inferred chunks,
    3 labelled, 1 correct, accumulated over two batches."""
    inf = np.array([[0, 1, 4, 2, 3, 4]], np.int64)
    lab = np.array([[0, 1, 4, 2, 1, 4]], np.int64)

    def make(pkg):
        L = pkg["L"]
        return pkg["pt"].evaluator.ChunkEvaluator(
            L.data(name="i", shape=[6], dtype="int64"),
            L.data(name="l", shape=[6], dtype="int64"), "IOB", 2)

    main, startup, ev = build(T, make)
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    exe.run(startup, scope=scope)
    for _ in range(2):
        exe.run(main, feed={"i": inf, "l": lab}, fetch_list=ev.metrics, scope=scope)
    p, r, f1 = ev.eval(exe, scope=scope)
    np.testing.assert_allclose([p[0], r[0], f1[0]], [0.5, 1 / 3, 0.4], atol=1e-6)


def test_edit_distance_evaluator_rates():
    """tests/test_misc_tail.py:50 on the port: one substitution in three,
    then an exact match."""
    def make(pkg):
        L = pkg["L"]
        return pkg["pt"].evaluator.EditDistance(
            L.data(name="h", shape=[3], dtype="int64"),
            L.data(name="r", shape=[3], dtype="int64"))

    main, startup, ev = build(T, make)
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    exe.run(startup, scope=scope)
    for r in ([1, 2, 4], [1, 2, 3]):
        exe.run(main, feed={"h": np.array([[1, 2, 3]]), "r": np.array([r])},
                fetch_list=ev.metrics, scope=scope)
    avg, err = ev.eval(exe, scope=scope)
    np.testing.assert_allclose([avg[0], err[0]], [1 / 6, 0.5], atol=1e-6)
    with pytest.raises(TypeError):
        ev.eval(exe)


def test_metrics_match_jax():
    import paddle_tpu.metrics as JM
    import paddle_tpu_torch.metrics as TM

    rng = np.random.default_rng(2)
    batches = [(rng.random((16, 2)).astype(np.float32), rng.integers(0, 2, (16, 1)))
               for _ in range(3)]

    def stream(mod):
        comp = mod.CompositeMetric()
        comp.add_metric(mod.Precision())
        comp.add_metric(mod.Recall())
        auc, acc, ed = mod.Auc(num_thresholds=255), mod.Accuracy(), mod.EditDistance()
        for prob, lab in batches:
            comp.update(prob[:, 1:] > 0.5, lab)
            auc.update(prob, lab)
            acc.update(float(np.mean((prob[:, 1] > 0.5) == lab[:, 0])), 16)
            ed.update(np.abs(prob[:, :1] - 0.5), 16)
        return [*comp.eval(), auc.eval(), acc.eval(), *ed.eval()]

    assert stream(TM) == stream(JM)
    with pytest.raises(ValueError):
        TM.Accuracy().eval()


def test_weighted_average_matches_jax():
    """tests/test_misc_tail.py:13 on the port, beside the JAX class."""
    from paddle_tpu.average import WeightedAverage as JW
    from paddle_tpu_torch.average import WeightedAverage as TW

    vals = []
    for cls in (JW, TW):
        wa = cls()
        with pytest.raises(ValueError):
            wa.eval()
        wa.add(2.0, 1.0)
        wa.add(np.array([4.0, 8.0]), 3.0)
        vals.append(wa.eval())
        wa.reset()
        with pytest.raises(ValueError):
            wa.eval()
        with pytest.raises(ValueError):
            wa.add("nan", 1.0)
    assert vals[0] == vals[1] == (2.0 * 1 + 6.0 * 3) / 4.0


def _dot_program(pkg):
    L = pkg["L"]
    x = L.data(name="x", shape=[5, 4], dtype="float32")
    y = L.data(name="y", shape=[5], dtype="int64")
    em = L.fc(x, size=3, num_flatten_dims=2)
    loss = L.mean(L.linear_chain_crf(em, y, param_attr=pkg["pt"].ParamAttr(
        name="crfw")))
    pkg["pt"].optimizer.SGD(0.1).minimize(loss)
    return loss


def test_program_to_dot_matches_jax(tmp_path):
    jmain, jstart, jloss = build(J, _dot_program)
    tmain, tstart, tloss = build(T, _dot_program)
    for hl in ((), ("crfw", jloss.name)):
        got = tpt.debugger.program_to_dot(tmain, highlights=hl, name="crf")
        assert got == jpt.debugger.program_to_dot(jmain, highlights=hl, name="crf")
    assert got.startswith('digraph "crf"') and "linear_chain_crf_grad" in got
    paths = [tmp_path / f"{w}.dot" for w in ("j", "t", "js", "ts")]
    jdot = jpt.net_drawer.draw_graph(jstart, jmain, str(paths[0]), str(paths[2]))
    tdot = tpt.net_drawer.draw_graph(tstart, tmain, str(paths[1]), str(paths[3]))
    assert tdot == jdot == paths[1].read_text()
    assert paths[3].read_text() == paths[2].read_text()
    assert tpt.debugger.draw_block_graphviz(tmain.global_block) == tdot


def test_install_check_on_the_cpu(capsys, monkeypatch):
    tpt.install_check.run_check(device="cpu")
    out = capsys.readouterr().out
    assert "works well on SINGLE device" in out and "installed successfully" in out
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpt.install_check.run_check()
