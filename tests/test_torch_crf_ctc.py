"""The port's crf and ctc ops and layers held against the JAX package on the
CPU.

* The six ops as one-op programs through both packages on the same inputs
  (numpy seeds): float outputs within 1e-5, integer outputs bit for bit;
  the grads of linear_chain_crf and warpctc through each package's own
  grad op (the port's replay, the JAX op's vjp) within 1e-5, with
  sequences of length 0 and of the full padded length, and a label longer
  than its frames allow. The port's grads are finite everywhere.
* The JAX warpctc's gradient is NaN at the early frames of any label of 3
  or more tokens (its log-sum-exp over unreachable slots differentiates
  log(0) in the branch where() drops), so there its grads are compared
  where they are finite, and the port's whole gradient is held against an
  oracle independent of both packages: torch's F.ctc_loss with autograd.
* chunk_eval in all four schemes with an excluded type; the two ops the
  layers reach that earlier slices ported (sequence_erase, arg_max on the
  last axis) on the inputs these layers give them.
* The six layers build the JAX package's programs (to_dict()); the JAX
  package's own cases of these layers (tests/test_crf.py,
  tests/test_losses_and_quant.py, tests/test_layers_tail_r4.py) on the
  port.
"""
import itertools

import numpy as np
import pytest
import torch

from torch_parity import J, T, build, close, op_outputs_and_grads


def _r(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _i(shape, seed, lo, hi, dtype=np.int64):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(dtype)


def _padded(labels, lengths, fill=-1):
    out = labels.copy()
    for b, n in enumerate(lengths):
        out[b, n:] = fill
    return out


# warpctc: four rows of every kind. Row 0 full (repeated labels, so a skip
# is barred), row 1 a short label, row 2 a label longer than its 3 frames
# allow, row 3 an empty label; the second batch has a zero-length row.
CTC_LG = np.array([8, 8, 3, 8], np.int32)
CTC_LB = np.array([4, 2, 4, 0], np.int32)
CTC_LABEL = _padded(np.array([[2, 2, 3, 1], [4, 1, 5, 5], [1, 2, 3, 4],
                              [3, 3, 3, 3]], np.int32), CTC_LB)
CRF_LEN = np.array([6, 3, 0], np.int64)
CRF_LABEL = _padded(_i((3, 6), 3, 0, 4), CRF_LEN)


def _ctc(logits, label, lg=None, lb=None):
    ins = {"Logits": {"lg": logits}, "Label": {"lab": label}}
    if lg is not None:
        ins["LogitsLength"] = {"lgl": lg}
    if lb is not None:
        ins["LabelLength"] = {"lbl": lb}
    return ins


# case -> (op, inputs, outputs, attrs, cotangents)
CASES = {
    "crf": ("linear_chain_crf",
            {"Emission": {"em": _r((3, 6, 4), 1)},
             "Transition": {"w": _r((6, 4), 2, 0.5)},
             "Label": {"lab": CRF_LABEL}, "Length": {"ln": CRF_LEN}},
            {"LogLikelihood": ["nll"]}, {}, {"nll": _r((3, 1), 4)}),
    "crf_no_length": ("linear_chain_crf",
                      {"Emission": {"em": _r((2, 5, 3), 5)},
                       "Transition": {"w": _r((5, 3), 6, 0.5)},
                       "Label": {"lab": _i((2, 5, 1), 7, 0, 3)}},
                      {"LogLikelihood": ["nll"]}, {}, {"nll": _r((2, 1), 8)}),
    "crf_one_frame": ("linear_chain_crf",
                      {"Emission": {"em": _r((2, 1, 3), 9)},
                       "Transition": {"w": _r((5, 3), 10, 0.5)},
                       "Label": {"lab": _i((2, 1), 11, 0, 3)}},
                      {"LogLikelihood": ["nll"]}, {}, {"nll": _r((2, 1), 12)}),
    "viterbi": ("crf_decoding",
                {"Emission": {"em": _r((4, 7, 5), 13)},
                 "Transition": {"w": _r((7, 5), 14, 0.5)},
                 "Length": {"ln": np.array([7, 4, 1, 0], np.int64)}},
                {"ViterbiPath": ["path"]}, {}, {}),
    "viterbi_label": ("crf_decoding",
                      {"Emission": {"em": _r((4, 7, 5), 13)},
                       "Transition": {"w": _r((7, 5), 14, 0.5)},
                       "Label": {"lab": _i((4, 7, 1), 15, 0, 5)},
                       "Length": {"ln": np.array([7, 4, 1, 0], np.int64)}},
                      {"ViterbiPath": ["path"]}, {}, {}),
    "viterbi_no_length": ("crf_decoding",
                          {"Emission": {"em": _r((2, 6, 3), 16)},
                           "Transition": {"w": _r((5, 3), 17, 0.5)}},
                          {"ViterbiPath": ["path"]}, {}, {}),
    "ctc": ("warpctc", _ctc(_r((4, 8, 6), 18), CTC_LABEL, CTC_LG, CTC_LB),
            {"Loss": ["loss"]}, {"blank": 0}, {"loss": _r((4, 1), 19)}),
    "ctc_norm_by_times": ("warpctc",
                          _ctc(_r((4, 8, 6), 20), CTC_LABEL, CTC_LG, CTC_LB),
                          {"Loss": ["loss"]}, {"blank": 0, "norm_by_times": True},
                          {"loss": _r((4, 1), 21)}),
    "ctc_zero_frames": ("warpctc",
                        _ctc(_r((3, 5, 4), 22),
                             np.array([[3, 1], [2, -1], [1, 2]], np.int32),
                             np.array([0, 5, 4], np.int32),
                             np.array([2, 1, 2], np.int32)),
                        {"Loss": ["loss"]}, {"blank": 0}, {"loss": _r((3, 1), 23)}),
    "ctc_last_blank": ("warpctc", _ctc(_r((2, 6, 5), 24), _i((2, 2), 25, 0, 4,
                                                             np.int32)),
                       {"Loss": ["loss"]}, {"blank": 4}, {"loss": _r((2, 1), 26)}),
    "align": ("ctc_align",
              {"Input": {"x": _i((3, 9), 27, 0, 4)},
               "InputLength": {"ln": np.array([9, 4, 0], np.int64)}},
              {"Output": ["o"], "OutputLength": ["ol"]}, {"blank": 0}, {}),
    "align_no_length": ("ctc_align", {"Input": {"x": _i((2, 7, 1), 28, 0, 3)}},
                        {"Output": ["o"], "OutputLength": ["ol"]},
                        {"blank": 2, "padding_value": 0}, {}),
    "edit": ("edit_distance",
             {"Hyps": {"h": _i((4, 7), 29, 0, 3)}, "Refs": {"r": _i((4, 5), 30, 0, 3)},
              "HypsLength": {"hl": np.array([7, 3, 0, 5], np.int64)},
              "RefsLength": {"rl": np.array([5, 0, 2, 5], np.int64)}},
             {"Out": ["d"], "SequenceNum": ["n"]}, {"normalized": True}, {}),
    "edit_raw": ("edit_distance",
                 {"Hyps": {"h": _i((3, 6, 1), 31, 0, 4)},
                  "Refs": {"r": _i((3, 8, 1), 32, 0, 4)}},
                 {"Out": ["d"], "SequenceNum": ["n"]}, {"normalized": False}, {}),
    # the two ops the layers reach that earlier slices ported
    "erase": ("sequence_erase",
              {"X": {"x": _i((3, 8), 33, -2, 4)},
               "Length": {"ln": np.array([8, 5, 0], np.int64)}},
              {"Out": ["o"], "OutLength": ["ol"]}, {"tokens": [0, 2]}, {}),
    "arg_max_ties": ("arg_max",
                     {"X": {"x": np.round(_r((4, 6, 5), 34), 0)}},
                     {"Out": ["o"]}, {"axis": -1}, {}),
}
for _scheme, _tags in (("IOB", 2), ("IOE", 2), ("IOBES", 4), ("plain", 1)):
    CASES[f"chunk_{_scheme}"] = (
        "chunk_eval",
        {"Inference": {"i": _i((5, 12), 40 + _tags, 0, 3 * _tags + 1)},
         "Label": {"l": _i((5, 12), 50 + _tags, 0, 3 * _tags + 1)},
         "SeqLength": {"ln": np.array([12, 7, 1, 0, 12], np.int64)}},
        {"Precision": ["p"], "Recall": ["r"], "F1-Score": ["f"],
         "NumInferChunks": ["ni"], "NumLabelChunks": ["nl"],
         "NumCorrectChunks": ["nc"]},
        {"chunk_scheme": _scheme, "num_chunk_types": 3,
         "excluded_chunk_types": [1]}, {})


def _both(case):
    op, ins, outs, attrs, cots = CASES[case]
    jo, jg, _ = op_outputs_and_grads(J, op, ins, outs, attrs, cots)
    to, tg, _ = op_outputs_and_grads(T, op, ins, outs, attrs, cots)
    return jo, jg, to, tg


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax(case):
    jo, jg, to, tg = _both(case)
    assert set(to) == set(jo) and set(tg) == set(jg)
    for n in jo:
        assert to[n].shape == jo[n].shape, (n, to[n].shape, jo[n].shape)
        if jo[n].dtype.kind in "iub":
            np.testing.assert_array_equal(to[n], jo[n], err_msg=n)
        else:
            close([to[n]], [jo[n]], what=f"{case} {n}")
    for n in jg:
        assert np.isfinite(tg[n]).all(), f"{case} d{n} is not finite"
        finite = np.isfinite(jg[n])
        close([tg[n][finite]], [jg[n][finite]], what=f"{case} d{n}")
    assert bool(tg) == bool(CASES[case][4]), case


def test_chunk_eval_counts_are_not_trivial():
    """Each scheme's case finds chunks on both sides and some of them
    match, so the exact comparison above compares counts that mean
    something."""
    for scheme in ("IOB", "IOE", "IOBES", "plain"):
        _, _, to, _ = _both(f"chunk_{scheme}")
        assert to["ni"][0] > 0 and to["nl"][0] > 0 and to["nc"][0] > 0, scheme


def test_impossible_alignment_is_the_jax_constant_and_its_grad_zero():
    """Row 2 of the ctc case (4 labels, 3 frames): the loss is -_NEG =
    1e30 in both packages, and the port's gradient of that row is 0."""
    jo, jg, to, tg = _both("ctc")
    assert to["loss"][2, 0] == jo["loss"][2, 0] == np.float32(1e30)
    assert np.all(tg["lg"][2] == 0)
    # the JAX op's gradient is NaN at the early frames of this 4-token case
    assert np.isnan(jg["lg"]).any()


def _ctc_oracle(logits, label, lg, lb, blank, norm, cot):
    """Loss and d loss / d logits by F.ctc_loss (reduction "none") and
    autograd, independent of both packages."""
    x = torch.tensor(logits, dtype=torch.float64, requires_grad=True)
    logp = torch.log_softmax(x, -1).transpose(0, 1)
    loss = torch.nn.functional.ctc_loss(
        logp, torch.tensor(np.where(label < 0, 0, label), dtype=torch.long),
        torch.tensor(lg, dtype=torch.long), torch.tensor(lb, dtype=torch.long),
        blank=blank, reduction="none")
    if norm:
        loss = loss / torch.tensor(np.maximum(lg, 1), dtype=torch.float64)
    loss.backward(torch.tensor(cot[:, 0], dtype=torch.float64))
    return loss.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("case,rows", [("ctc", [0, 1, 3]),
                                       ("ctc_norm_by_times", [0, 1, 3]),
                                       ("ctc_last_blank", [0, 1])])
def test_warpctc_against_torch_ctc_loss(case, rows):
    """The rows whose alignment is possible (not the ctc cases' row 2): the
    port's loss and whole gradient against F.ctc_loss in float64."""
    op, ins, outs, attrs, cots = CASES[case]
    _, _, to, tg = _both(case)
    logits, label = ins["Logits"]["lg"], ins["Label"]["lab"]
    B, Tn = logits.shape[:2]
    lg = ins.get("LogitsLength", {}).get("lgl", np.full(B, Tn, np.int32))
    lb = ins.get("LabelLength", {}).get("lbl", np.full(B, label.shape[1], np.int32))
    loss, grad = _ctc_oracle(logits[rows], label[rows], lg[rows], lb[rows],
                             attrs["blank"], attrs.get("norm_by_times", False),
                             cots["loss"][rows])
    close([to["loss"][rows, 0]], [loss], what=f"{case} loss")
    close([tg["lg"][rows]], [grad], what=f"{case} dlogits")


# -- the layers --------------------------------------------------------------


def _layer_vars(L):
    class V:
        pass

    v = V()
    v.em = L.data(name="em", shape=[6, 4], dtype="float32")
    v.lab = L.data(name="lab", shape=[6], dtype="int64")
    v.ln = L.data(name="ln", shape=[], dtype="int64")
    v.lg = L.data(name="lg", shape=[8, 6], dtype="float32")
    v.clab = L.data(name="clab", shape=[3], dtype="int32")
    v.h = L.data(name="h", shape=[7], dtype="int64")
    v.r = L.data(name="r", shape=[5], dtype="int64")
    return v


def _decode_after_crf(pt, L, v):
    L.linear_chain_crf(v.em, v.lab, param_attr=pt.ParamAttr(name="crfw"))
    return L.crf_decoding(v.em, pt.ParamAttr(name="crfw"), label=v.lab,
                          length=v.ln)


LAYERS = {
    "linear_chain_crf": lambda pt, L, v: L.linear_chain_crf(
        v.em, v.lab, param_attr=pt.ParamAttr(name="crfw"), length=v.ln),
    "crf_decoding": lambda pt, L, v: _decode_after_crf(pt, L, v),
    "warpctc": lambda pt, L, v: L.warpctc(v.lg, v.clab, blank=5,
                                          norm_by_times=True, input_length=v.ln,
                                          label_length=v.ln),
    "ctc_greedy_decoder": lambda pt, L, v: L.ctc_greedy_decoder(
        L.softmax(v.lg), blank=5, input_length=v.ln)[0],
    "edit_distance": lambda pt, L, v: L.edit_distance(
        v.h, v.r, ignored_tokens=[0, 3], input_length=v.ln)[0],
    "chunk_eval": lambda pt, L, v: L.chunk_eval(v.h, v.h, "IOBES", 2,
                                                excluded_chunk_types=[0],
                                                seq_length=v.ln)[2],
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_builds_the_jax_program(name):
    def make(pkg):
        return LAYERS[name](pkg["pt"], pkg["L"], _layer_vars(pkg["L"]))

    jp, tp = build(J, make), build(T, make)
    assert tp[0].to_dict() == jp[0].to_dict()
    assert tp[1].to_dict() == jp[1].to_dict()


def _run_port(build_fn, feed, startup_too=True):
    import paddle_tpu_torch as pt

    main, startup, outs = build(T, lambda p: build_fn(p["pt"], p["L"]))
    exe, scope = pt.Executor(place="cpu"), pt.Scope()
    exe.run(startup, scope=scope)
    return exe.run(main, feed=feed, fetch_list=[o.name for o in outs],
                   scope=scope), scope


def test_crf_decoding_matches_bruteforce():
    """tests/test_crf.py:54 on the port: the Viterbi path of every sequence
    is the best of all N^T paths."""
    rng = np.random.default_rng(1)
    B, Tn, N = 3, 4, 3
    em = rng.standard_normal((B, Tn, N)).astype(np.float32)
    w = (rng.standard_normal((N + 2, N)) * 0.5).astype(np.float32)

    def net(pt, L):
        blk = pt.default_main_program().global_block
        blk.create_var(name="em", shape=em.shape, dtype="float32", is_data=True)
        blk.create_var(name="w", shape=w.shape, dtype="float32", is_data=True)
        path = blk.create_var(name="path", shape=(), dtype="int64")
        blk.append_op("crf_decoding", {"Emission": ["em"], "Transition": ["w"]},
                      {"ViterbiPath": ["path"]}, {})
        return [path]

    (path,), _ = _run_port(net, {"em": em, "w": w})
    start, stop, trans = w[0], w[1], w[2:]
    for b in range(B):
        best, best_s = None, -np.inf
        for p in itertools.product(range(N), repeat=Tn):
            s = start[p[0]] + em[b, 0, p[0]] + stop[p[-1]]
            s += sum(trans[p[t - 1], p[t]] + em[b, t, p[t]] for t in range(1, Tn))
            if s > best_s:
                best, best_s = p, s
        np.testing.assert_array_equal(path[b], best)


def test_crf_tagging_end_to_end():
    """tests/test_crf.py:87 on the port: tags that alternate with
    probability 0.9; CRF training with lengths learns the +1 transitions."""
    import paddle_tpu_torch as pt

    rng = np.random.default_rng(2)
    B, Tn, N, D = 64, 6, 2, 5
    tags = np.zeros((B, Tn), np.int64)
    for b in range(B):
        tags[b, 0] = rng.integers(0, N)
        for t in range(1, Tn):
            tags[b, t] = ((tags[b, t - 1] + 1) % N if rng.random() < 0.9
                          else tags[b, t - 1])
    obs = (np.eye(N)[tags] @ rng.standard_normal((N, D)) * 0.3
           + rng.standard_normal((B, Tn, D)) * 0.5).astype(np.float32)
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 7
    with pt.program_guard(main, startup), pt.unique_name.guard():
        L = pt.layers
        x = L.data(name="x", shape=[Tn, D], dtype="float32")
        y = L.data(name="y", shape=[Tn], dtype="int64")
        ln = L.data(name="ln", shape=[1], dtype="int64")
        em = L.fc(x, size=N, num_flatten_dims=2)
        loss = L.mean(L.linear_chain_crf(em, y, param_attr=pt.ParamAttr(
            name="crfw"), length=ln))
        pt.optimizer.Adam(0.05).minimize(loss)
    exe, scope = pt.Executor(place="cpu"), pt.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": obs, "y": tags, "ln": np.full((B, 1), Tn, np.int64)}
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0])
              for _ in range(60)]
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])
    trans = scope.find_var("crfw").numpy()[2:]
    assert trans[0, 1] > trans[0, 0] and trans[1, 0] > trans[1, 1], trans


def test_warpctc_matches_bruteforce():
    """tests/test_losses_and_quant.py:12 on the port: the alpha recursion
    equals the log-sum over every path that collapses to the label."""
    Tn, V, blank, label = 4, 3, 0, [1, 2]
    logits = np.random.default_rng(0).standard_normal((1, Tn, V)).astype(np.float32)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    total = -np.inf
    for path in itertools.product(range(V), repeat=Tn):
        out, prev = [], None
        for p in path:
            if p != blank and p != prev:
                out.append(p)
            prev = p
        if out == label:
            total = np.logaddexp(total, sum(logp[0, t, c] for t, c in enumerate(path)))

    def net(pt, L):
        lg = L.data(name="lg", shape=[Tn, V], dtype="float32")
        lab = L.data(name="lab", shape=[len(label)], dtype="int64")
        return [L.warpctc(lg, lab, blank=blank)]

    (got,), _ = _run_port(net, {"lg": logits, "lab": np.array([label], np.int64)})
    np.testing.assert_allclose(float(got.reshape(-1)[0]), -total, rtol=1e-4)


def test_ctc_greedy_decoder_merges_and_drops():
    """tests/test_layers_tail_r4.py:426 on the port."""
    Tn, V = 7, 4
    probs = np.zeros((1, Tn, V), np.float32)
    for t, tok in enumerate([1, 1, 0, 2, 2, 0, 3]):
        probs[0, t, tok] = 1.0

    def net(pt, L):
        p = L.data(name="p", shape=[Tn, V], dtype="float32")
        ln = L.data(name="ln", shape=[], dtype="int64")
        return list(L.ctc_greedy_decoder(p, blank=0, input_length=ln))

    (out, out_len), _ = _run_port(net, {"p": probs, "ln": np.array([Tn], np.int64)})
    assert out_len[0] == 3
    np.testing.assert_array_equal(out[0, :3], [1, 2, 3])
    assert (out[0, 3:] == -1).all()


def test_edit_distance_known_cases():
    """tests/test_layers_tail_r4.py:447 on the port: kitten -> sitting."""
    def enc(s, n=8):
        v = np.zeros(n, np.int64)
        v[:len(s)] = [ord(c) for c in s]
        return v, len(s)

    h, hl = enc("kitten")
    r, rl = enc("sitting")

    def net(pt, L):
        hv = L.data(name="h", shape=[8], dtype="int64")
        rv = L.data(name="r", shape=[8], dtype="int64")
        hlv = L.data(name="hl", shape=[], dtype="int64")
        rlv = L.data(name="rl", shape=[], dtype="int64")
        return list(L.edit_distance(hv, rv, normalized=False, input_length=hlv,
                                    label_length=rlv))

    (d, n), _ = _run_port(net, {"h": h[None], "r": r[None],
                                "hl": np.array([hl], np.int64),
                                "rl": np.array([rl], np.int64)})
    assert float(d[0, 0]) == 3.0 and int(n[0]) == 1


def test_chunk_eval_iob():
    """tests/test_layers_tail_r4.py:474 on the port."""
    inf = np.array([[0, 1, 4, 2, 3, 4]], np.int64)
    lab = np.array([[0, 1, 4, 2, 1, 4]], np.int64)

    def net(pt, L):
        iv = L.data(name="i", shape=[6], dtype="int64")
        lv = L.data(name="l", shape=[6], dtype="int64")
        return list(L.chunk_eval(iv, lv, "IOB", 2))[:3]

    (p, r, f1), _ = _run_port(net, {"i": inf, "l": lab})
    assert abs(float(p[0]) - 0.5) < 1e-6
    assert abs(float(r[0]) - 1.0 / 3.0) < 1e-6
    assert abs(float(f1[0]) - 0.4) < 1e-6
