"""The port's RNN and sequence ops, beam search and the attention seq2seq
(ops/rnn_ops.py, ops/sequence_ops.py, layers/sequence.py,
models/seq2seq.py) held against the JAX package's on the CPU.

* gru_unit (both gate modes), gru (forward and reverse, with and without
  H0), lstm_unit, lstm and each ported sequence op: outputs and the
  gradients of every floating input through both packages' `gradients`
  sweeps and executors on the same numpy inputs and cotangents, within
  2e-5 of each grad's max-abs (fp32 sums in another order). The port's
  loops replay under autograd; the JAX package's scans differentiate by vjp.
* The four beam-search cases of tests/test_seq2seq.py through both
  packages (the implicit end_id candidate, the frozen beam).
* train_model at VOCAB=20, word_dim = hidden_dim = 32: the main and startup
  programs equal through to_dict(), 3 Adam steps from the JAX startup's
  weights with losses within 1e-5.
* infer_model at beam 3 (a While over 8 steps): the programs equal, and
  the decoded tokens equal the JAX package's, scores within 1e-5, from
  the same weights.
"""
import numpy as np
import pytest

from torch_parity import J, T, build, op_outputs_and_grads, run_both

BOS, EOS = 0, 1
VOCAB, S, TT = 20, 6, 8


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


B, H, TS = 3, 4, 5
LENS = np.array([5, 2, 3], np.int64)

OPS = [
    ("gru_unit", {"Input": {"x": _rand((B, 3 * H), 1)},
                  "HiddenPrev": {"h": _rand((B, H), 2)},
                  "Weight": {"w": _rand((H, 3 * H), 3, 0.5)},
                  "Bias": {"b": _rand((1, 3 * H), 4)}},
     {"Hidden": ["o_h"], "ResetHiddenPrev": ["o_r"], "Gate": ["o_g"]},
     {"activation": "tanh", "gate_activation": "sigmoid"}),
    ("gru_unit", {"Input": {"x": _rand((B, 3 * H), 1)},
                  "HiddenPrev": {"h": _rand((B, H), 2)},
                  "Weight": {"w": _rand((H, 3 * H), 3, 0.5)}},
     {"Hidden": ["o_h"], "ResetHiddenPrev": ["o_r"], "Gate": ["o_g"]},
     {"activation": "relu", "gate_activation": "sigmoid",
      "origin_mode": True}),
    ("gru", {"Input": {"x": _rand((B, TS, 3 * H), 5)},
             "Weight": {"w": _rand((H, 3 * H), 6, 0.5)},
             "Bias": {"b": _rand((1, 3 * H), 7)}},
     {"Hidden": ["o"]}, {"is_reverse": False}),
    ("gru", {"Input": {"x": _rand((B, TS, 3 * H), 5)},
             "Weight": {"w": _rand((H, 3 * H), 6, 0.5)},
             "Bias": {"b": _rand((1, 3 * H), 7)},
             "H0": {"h0": _rand((B, H), 8)}},
     {"Hidden": ["o"]}, {"is_reverse": True, "origin_mode": True}),
    ("lstm_unit", {"X": {"x": _rand((B, 4 * H), 9)},
                   "C_prev": {"c": _rand((B, H), 10)}},
     {"C": ["o_c"], "H": ["o_h"]}, {"forget_bias": 1.0}),
    ("lstm", {"Input": {"x": _rand((B, TS, 4 * H), 11)},
              "Weight": {"w": _rand((H, 4 * H), 12, 0.5)},
              "Bias": {"b": _rand((1, 4 * H), 13)},
              "H0": {"h0": _rand((B, H), 14)}, "C0": {"c0": _rand((B, H), 15)}},
     {"Hidden": ["o_h"], "Cell": ["o_c"]}, {"is_reverse": True}),
    ("sequence_pad", {"X": {"x": _rand((B, TS, H), 16)},
                      "PadValue": {"pad": np.array([0.5], np.float32)},
                      "Length": {"len": LENS}},
     {"Out": ["o"], "Length": ["o_len"]}, {"padded_length": 7}),
    ("sequence_unpad", {"X": {"x": _rand((B, TS, H), 17)},
                        "Length": {"len": LENS}}, {"Out": ["o"]}, {}),
    *[("sequence_pool", {"X": {"x": _rand((B, TS, H), 18)},
                         "Length": {"len": LENS}}, {"Out": ["o"]},
       {"pooltype": t})
      for t in ("SUM", "AVERAGE", "SQRT", "MAX", "LAST", "FIRST")],
    ("sequence_reverse", {"X": {"x": _rand((B, TS, H), 19)},
                          "Length": {"len": LENS}}, {"Y": ["o"]}, {}),
    ("sequence_expand", {"X": {"x": _rand((B, H), 20)}}, {"Out": ["o"]},
     {"times": 3}),
    ("sequence_softmax", {"X": {"x": _rand((B, TS), 21)},
                          "Length": {"len": LENS}}, {"Out": ["o"]}, {}),
    ("sequence_concat", {"X": {"x": _rand((B, TS, H), 22),
                               "y": _rand((B, 2, H), 23)}}, {"Out": ["o"]}, {}),
    ("sequence_mask", {"X": {"len": LENS}}, {"Y": ["o"]},
     {"maxlen": 7, "out_dtype": "int64"}),
]


def _op_id(case):
    op, _, _, attrs = case
    extra = attrs.get("pooltype") or ("rev" if attrs.get("is_reverse") else "")
    extra = extra or ("origin" if attrs.get("origin_mode") else "")
    return op + ("-" + extra if extra else "")


@pytest.mark.parametrize("case", OPS, ids=[_op_id(c) for c in OPS])
def test_op_matches_jax_forward_and_grad(case):
    op_type, ins, outs, attrs = case
    floating = [n for ns in outs.values() for n in ns
                if op_type != "sequence_mask" and not n.endswith("_len")]
    jout, _, _ = op_outputs_and_grads(J, op_type, ins, outs, attrs, {})
    cots = {n: _rand(jout[n].shape, 100 + i) for i, n in enumerate(floating)}
    jout, jgrad, _ = op_outputs_and_grads(J, op_type, ins, outs, attrs, cots)
    tout, tgrad, _ = op_outputs_and_grads(T, op_type, ins, outs, attrs, cots)
    for n in jout:
        assert tout[n].shape == jout[n].shape, n
        np.testing.assert_allclose(tout[n], jout[n], rtol=1e-5, atol=1e-5,
                                   err_msg=n)
    assert sorted(tgrad) == sorted(jgrad)
    assert jgrad or not cots
    for n in jgrad:
        scale = max(float(np.abs(jgrad[n]).max()), 1.0)
        np.testing.assert_allclose(tgrad[n], jgrad[n], rtol=2e-5,
                                   atol=2e-5 * scale, err_msg=n)


# the four beam-search cases of tests/test_seq2seq.py
BEAM_CASES = {
    "step_math": (2, np.array([[3], [4]]), np.array([[-1.0], [-2.0]]),
                  np.array([[5, 6, 7], [8, 9, 10]]),
                  np.log(np.array([[0.5, 0.3, 0.2], [0.6, 0.3, 0.1]])),
                  [5, 6], [-1 + np.log(0.5), -1 + np.log(0.3)], [0, 0]),
    "frozen_beam_keeps_score": (
        2, np.array([[EOS], [3]]), np.array([[-0.5], [-3.0]]),
        np.array([[EOS, 5], [6, 7]]), np.array([[-0.1, -0.2], [-0.3, -0.4]]),
        [EOS, 6], [-0.5, -3.3], [0, 1]),
    "frozen_beam_survives_without_eos_candidate": (
        2, np.array([[EOS], [5]]), np.array([[-1.0], [-5.0]]),
        np.array([[7, 8], [9, 10]]), np.array([[-0.5, -0.7], [-0.5, -0.7]]),
        [EOS, 9], [-1.0, -5.5], [0, 1]),
}


@pytest.mark.parametrize("name", sorted(BEAM_CASES))
def test_beam_search_matches_jax(name):
    beam, pid, psc, cid, csc, w_ids, w_sc, w_par = BEAM_CASES[name]
    K = cid.shape[1]

    def fn(pkg):
        L = pkg["L"]
        p_ids = L.data(name="pid", shape=[1], dtype="int64")
        p_sc = L.data(name="psc", shape=[1], dtype="float32")
        c_ids = L.data(name="cid", shape=[K], dtype="int64")
        c_sc = L.data(name="csc", shape=[K], dtype="float32")
        return list(L.beam_search(p_ids, p_sc, c_ids, c_sc, beam_size=beam,
                                  end_id=EOS))

    jm, js, jf = build(J, fn)
    tm, ts, tf = build(T, fn)
    assert tm.to_dict() == jm.to_dict()
    feed = {"pid": pid.astype(np.int64), "psc": psc.astype(np.float32),
            "cid": cid.astype(np.int64), "csc": csc.astype(np.float32)}
    (jo,), (to,), _, _ = run_both((jm, js), (tm, ts), [feed], jf, tf)
    for got in (jo, to):
        np.testing.assert_array_equal(got[0].reshape(-1), w_ids)
        np.testing.assert_allclose(got[1].reshape(-1), w_sc, rtol=1e-5)
        np.testing.assert_array_equal(got[2], w_par)


def test_beam_search_decode_matches_jax():
    ids = np.array([[7, 8], [9, 10], [11, 12]], np.int64)
    parents = np.array([[0, 0], [0, 0], [0, 1]], np.int32)
    scores = np.array([[0.0, 0.0], [0.0, 0.0], [-1.0, -2.0]], np.float32)

    def fn(pkg):
        L = pkg["L"]
        i = L.data(name="i", shape=[3, 2], dtype="int64")
        i.shape = (3, 2)
        p = L.data(name="p", shape=[3, 2], dtype="int32")
        p.shape = (3, 2)
        s = L.data(name="s", shape=[3, 2], dtype="float32")
        s.shape = (3, 2)
        return list(L.beam_search_decode(i, p, s, end_id=EOS))

    jm, js, jf = build(J, fn)
    tm, ts, tf = build(T, fn)
    assert tm.to_dict() == jm.to_dict()
    (jo,), (to,), _, _ = run_both((jm, js), (tm, ts),
                                  [{"i": ids, "p": parents, "s": scores}],
                                  jf, tf)
    for got in (jo, to):
        np.testing.assert_array_equal(got[0][0], [7, 9, 11])
        np.testing.assert_array_equal(got[0][1], [7, 10, 12])
        np.testing.assert_allclose(got[1], [-1.0, -2.0])


def _batch(rng, batch):
    """The copy task of tests/test_seq2seq.py: tgt = src."""
    lens = rng.integers(2, S + 1, batch)
    src = rng.integers(2, VOCAB, (batch, S))
    for i, ln in enumerate(lens):
        src[i, ln:] = EOS
    tgt_out = np.full((batch, TT), EOS)
    tgt_out[:, :S] = src
    tgt_in = np.roll(tgt_out, 1, axis=1)
    tgt_in[:, 0] = BOS
    return {"src": src.astype(np.int64), "slen": lens.astype(np.int64),
            "tin": tgt_in.astype(np.int64), "tout": tgt_out.astype(np.int64),
            "tlen": (lens + 1).astype(np.int64)}


def _train(pkg):
    L = pkg["L"]
    from importlib import import_module

    seq2seq = import_module(pkg["pt"].__name__ + ".models.seq2seq")
    src = L.data(name="src", shape=[S], dtype="int64")
    slen = L.data(name="slen", shape=[], dtype="int64")
    tin = L.data(name="tin", shape=[TT], dtype="int64")
    tout = L.data(name="tout", shape=[TT], dtype="int64")
    tlen = L.data(name="tlen", shape=[], dtype="int64")
    loss = seq2seq.train_model(src, slen, tin, tout, tlen, VOCAB,
                               word_dim=32, hidden_dim=32)
    pkg["pt"].optimizer.Adam(learning_rate=0.01).minimize(loss)
    return [loss]


def test_train_model_matches_jax_over_three_adam_steps():
    jm, js, jf = build(J, _train)
    tm, ts, tf = build(T, _train)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    rng = np.random.default_rng(0)
    feeds = [_batch(rng, 16) for _ in range(3)]
    jout, tout, jscope, tscope = run_both((jm, js), (tm, ts), feeds, jf, tf)
    jl = [float(o[0]) for o in jout]
    tl = [float(o[0]) for o in tout]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[2] < tl[0]
    for p in jm.all_parameters():
        np.testing.assert_allclose(tscope.find_var(p.name).numpy(),
                                   np.asarray(jscope.find_var(p.name)),
                                   rtol=1e-4, atol=3 * 2 * 0.01, err_msg=p.name)


def _infer(pkg):
    L = pkg["L"]
    from importlib import import_module

    seq2seq = import_module(pkg["pt"].__name__ + ".models.seq2seq")
    src = L.data(name="src", shape=[S], dtype="int64")
    src.shape = (4, S)
    slen = L.data(name="slen", shape=[], dtype="int64")
    return list(seq2seq.infer_model(src, slen, VOCAB, word_dim=32,
                                    hidden_dim=32, beam_size=3, max_len=TT,
                                    bos_id=BOS, eos_id=EOS))


def test_infer_model_decodes_the_jax_tokens():
    """infer_model's program reads the training program's parameters (its
    own build cannot size the decoder's: shape inference inside the While
    body sees no batch), so each package decodes with the scope of a
    training program's startup, the port's loaded from the JAX one's."""
    jm, js, jf = build(J, _infer)
    tm, ts, tf = build(T, _infer)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    assert any(op.type == "while" for op in tm.global_block.ops)
    jtm, jts, _ = build(J, _train)
    ttm, tts, _ = build(T, _train)
    feed = _batch(np.random.default_rng(3), 4)
    feed = {"src": feed["src"], "slen": feed["slen"]}
    (jo,), (to,), _, _ = run_both((jm, jts), (tm, tts), [feed], jf, tf,
                                  params_of=(jtm, ttm))
    assert to[0].shape == (12, TT)
    np.testing.assert_array_equal(to[0], jo[0])
    np.testing.assert_allclose(to[1], jo[1], rtol=1e-5, atol=1e-5)
