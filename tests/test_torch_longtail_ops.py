"""The op long tail of the port held against the JAX package on the CPU:
the activation, math, tensor, nn and sampling ops and their grad entries.

* One parametrised test over the 86 registry entries. A deterministic op
  runs as a one-op program through both packages, forward and the grads of
  its floating inputs (the port's by replay or its registered grad, the
  JAX op's through jax.vjp or its grad maker's op) on the same inputs and
  cotangents: within 1e-5, integer outputs bit for bit. A grad entry runs
  its forward's case and must appear in the program.
* The random ops by distribution (range, mean and standard deviation
  within stated sigmas; the log-uniform sampler's first-id frequencies),
  and nce / sample_logits by replay: the rest of the op and its grad on
  the port's saved draws against the JAX functions on those draws.
* The host ops against the JAX ops (unique's encounter order and hash's
  buckets bit for bit, print's lines), and the stateful outputs
  (center_loss's centers, spectral_norm's U and V) after two runs.
* The scope: the JAX registry entries the port lacks are exactly the
  distributed entries and recompute_grad (the vision, detection, crf,
  ctc, quant and collective entries and ring_attention are ported).
* tests/test_ops_coverage.py's group_norm, instance_norm, gather_nd and
  strided_slice cases on the port against their numpy oracles.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import J, T, close, op_outputs_and_grads


def _r(shape, seed, scale=1.0, shift=0.0):
    return (shift + scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _u(shape, seed, lo, hi):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _i(a, dtype=np.int32):
    return np.asarray(a, dtype)


X = _r((2, 3, 4), 1, 2.0)      # activations: no value on a kink
CX = {"o": _r((2, 3, 4), 2)}


def _act(attrs=None, x=X, grad=True):
    return ({"X": {"x": x}}, {"Out": ["o"]}, attrs or {}, CX if grad else {})


# op -> (inputs {slot: {name: array}}, outputs {slot: [name]}, attrs,
#        cotangents {output: array}, floating inputs that take no grad)
OPS = {
    # -- activation_ops ------------------------------------------------------
    "abs": _act(), "logsigmoid": _act(), "round": _act(grad=False),
    "rsqrt": _act(x=_u((2, 3, 4), 3, 0.2, 3.0)), "sin": _act(),
    "softplus": _act(), "softsign": _act(), "square": _act(),
    "relu6": _act({"threshold": 2.5}), "leaky_relu": _act({"alpha": 0.1}),
    "elu": _act({"alpha": 0.7}), "hard_sigmoid": _act({"slope": 0.25}),
    "swish": _act({"beta": 1.5}), "brelu": _act({"t_min": -1.0, "t_max": 2.0}),
    "soft_relu": _act({"threshold": 2.0}),
    "thresholded_relu": _act({"threshold": 0.5}), "hard_swish": _act(),
    "stanh": _act(), "selu": _act(),
    # -- math_ops --------------------------------------------------------------
    "elementwise_floordiv": ({"X": {"x": _i([[7, -7, 5], [-9, 4, 0]])},
                              "Y": {"y": _i([[2, 2, -3], [4, -3, 5]])}},
                             {"Out": ["o"]}, {}, {}),
    "elementwise_mod": ({"X": {"x": _i([[7, -7, 5], [-9, 4, 0]])},
                         "Y": {"y": _i([[2, 2, -3], [4, -3, 5]])}},
                        {"Out": ["o"]}, {}, {}),
    "reduce_max": ({"X": {"x": _r((3, 4, 5), 4)}}, {"Out": ["o"]},
                   {"dim": [1], "keep_dim": True}, {"o": _r((3, 1, 5), 5)}),
    "reduce_min": ({"X": {"x": _r((3, 4, 5), 6)}}, {"Out": ["o"]},
                   {"dim": [0, 2]}, {"o": _r((4,), 7)}),
    "reduce_prod": ({"X": {"x": _u((3, 4, 2), 8, 0.5, 1.5)}}, {"Out": ["o"]},
                    {"dim": [0, 2]}, {"o": _r((4,), 9)}),
    "reduce_all": ({"X": {"x": np.array([[True, False], [True, True]])}},
                   {"Out": ["o"]}, {"dim": [1]}, {}),
    "reduce_any": ({"X": {"x": np.array([[True, False], [False, False]])}},
                   {"Out": ["o"]}, {"reduce_all": True}, {}),
    "dot": ({"X": {"x": _r((4, 6), 10)}, "Y": {"y": _r((4, 6), 11)}},
            {"Out": ["o"]}, {}, {"o": _r((4, 1), 12)}),
    "norm": ({"X": {"x": _r((3, 5), 13)}}, {"Out": ["o"], "Norm": ["n"]},
             {"axis": 1, "epsilon": 1e-6},
             {"o": _r((3, 5), 14), "n": _r((3, 1), 15)}),
    "cos_sim": ({"X": {"x": _r((4, 6), 16)}, "Y": {"y": _r((4, 6), 17)}},
                {"Out": ["o"], "XNorm": ["xn"], "YNorm": ["yn"]}, {},
                {"o": _r((4, 1), 18)}),
    "isfinite": ({"X": {"x": np.array([[1.0, np.inf], [0.0, 2.0]], np.float32)}},
                 {"Out": ["o"]}, {}, {}),
    "mean_iou": ({"Predictions": {"p": _i([0, 1, 2, 2, 1, 3])},
                  "Labels": {"l": _i([0, 2, 2, 1, 1, 3])}},
                 {"OutMeanIou": ["m"], "OutWrong": ["w"], "OutCorrect": ["c"]},
                 {"num_classes": 5}, {}),
    "log_loss": ({"Predicted": {"p": _u((5, 1), 19, 0.1, 0.9)},
                  "Labels": {"l": _u((5, 1), 20, 0.0, 1.0)}},
                 {"Loss": ["o"]}, {"epsilon": 1e-4}, {"o": _r((5, 1), 21)}),
    "huber_loss": ({"X": {"x": _r((6, 1), 22)}, "Y": {"y": _r((6, 1), 23)}},
                   {"Out": ["o"], "Residual": ["r"]}, {"delta": 0.7},
                   {"o": _r((6, 1), 24)}),
    "kldiv_loss": ({"X": {"x": np.log(_u((4, 3), 25, 0.1, 1.0))},
                    "Target": {"t": _u((4, 3), 26, 0.05, 1.0)}},
                   {"Loss": ["o"]}, {"reduction": "batchmean"},
                   {"o": np.array(0.7, np.float32)}),
    "rank_loss": ({"Label": {"l": _u((5, 1), 27, 0, 1)},
                   "Left": {"a": _r((5, 1), 28)}, "Right": {"b": _r((5, 1), 29)}},
                  {"Out": ["o"]}, {}, {"o": _r((5, 1), 30)}),
    "margin_rank_loss": ({"Label": {"l": np.array([[1.], [-1.], [1.], [-1.]],
                                                  np.float32)},
                          "X1": {"a": _r((4, 1), 31)}, "X2": {"b": _r((4, 1), 32)}},
                         {"Out": ["o"], "Activated": ["act"]}, {"margin": 0.3},
                         {"o": _r((4, 1), 33)}),
    "bpr_loss": ({"X": {"x": _r((4, 5), 34)}, "Label": {"l": _i([[1], [0], [4], [2]])}},
                 {"Y": ["o"]}, {}, {"o": _r((4, 1), 35)}),
    "center_loss": ({"X": {"x": _r((5, 3), 36)}, "Label": {"l": _i([[1], [0], [1], [3], [1]])},
                     "Centers": {"c": _r((4, 3), 37)},
                     "CenterUpdateRate": {"a": np.array([0.3], np.float32)}},
                    {"Loss": ["o"], "SampleCenterDiff": ["d"], "CentersOut": ["co"]},
                    {"need_update": True},
                    {"o": _r((5, 1), 38), "d": _r((5, 3), 39)}, ("c", "a")),
    "teacher_student_sigmoid_loss": (
        {"X": {"x": np.array([[0.3], [-2.0], [20.0], [1.1], [-0.4], [-16.0]],
                             np.float32)},
         "Label": {"l": np.array([[-2.], [-1.], [0.4], [1.7], [0.0], [1.2]],
                                 np.float32)}},
        {"Y": ["o"]}, {}, {"o": _r((6, 1), 40)}, ("l",)),
    # -- tensor_ops ----------------------------------------------------------
    "fill_zeros_like": ({"X": {"x": _r((2, 3), 41)}}, {"Out": ["o"]}, {}, {}),
    "shape": ({"X": {"x": _r((2, 3, 5), 42)}}, {"Out": ["o"]}, {}, {}),
    "flatten2": ({"X": {"x": _r((2, 3, 4), 43)}}, {"Out": ["o"]}, {"axis": 2},
                 {"o": _r((6, 4), 44)}),
    # tests/test_ops_coverage.py:113's case, a negative stride included
    "strided_slice": ({"Input": {"x": _r((4, 8), 45)}}, {"Out": ["o"]},
                      {"axes": [0, 1], "starts": [1, 6], "ends": [4, 0],
                       "strides": [2, -2]}, {"o": _r((2, 3), 46)}),
    "stack": ({"X": {"a": _r((2, 3), 47), "b": _r((2, 3), 48)}}, {"Y": ["o"]},
              {"axis": 1}, {"o": _r((2, 2, 3), 49)}),
    "unstack": ({"X": {"x": _r((2, 3, 4), 50)}}, {"Y": ["o0", "o1", "o2"]},
                {"axis": 1}, {"o0": _r((2, 4), 51), "o2": _r((2, 4), 52)}),
    "expand": ({"X": {"x": _r((2, 3), 53)}}, {"Out": ["o"]},
               {"expand_times": [2, 1, 3]}, {"o": _r((2, 2, 9), 54)}),
    # tests/test_ops_coverage.py:100's case
    "gather_nd": ({"X": {"x": _r((3, 4, 5), 55)}, "Index": {"i": _i([[0, 1], [2, 3], [0, 1]])}},
                  {"Out": ["o"]}, {}, {"o": _r((3, 5), 56)}),
    "cum": ({"X": {"x": _r((3, 4), 57)}}, {"Out": ["o"]},
            {"axis": 1, "exclusive": True, "reverse": True}, {"o": _r((3, 4), 58)}),
    "arg_min": ({"X": {"x": np.array([[3., 1., 1., 2.], [0., 5., -1., -1.]],
                                     np.float32)}}, {"Out": ["o"]}, {"axis": 1}, {}),
    "pad2d": ({"X": {"x": _r((2, 2, 3, 4), 59)}}, {"Out": ["o"]},
              {"paddings": [1, 2, 2, 1], "mode": "reflect"},
              {"o": _r((2, 2, 6, 7), 60)}),
    "pad": ({"X": {"x": _r((2, 3), 61)}}, {"Out": ["o"]},
            {"paddings": [1, 0, 2, 3], "pad_value": 0.5}, {"o": _r((3, 8), 62)}),
    "argsort": ({"X": {"x": np.array([[3., 1., 2., 1.], [0., 0., 5., -1.]],
                                     np.float32)}},
                {"Out": ["o"], "Indices": ["i"]}, {"axis": 1}, {}),
    "linspace": ({}, {"Out": ["o"]},
                 {"start": -1.5, "stop": 2.0, "num": 7, "dtype": "float32"}, {}),
    "assign_value": ({}, {"Out": ["o"]},
                     {"shape": [2, 3], "dtype": "float32",
                      "values": [0.5, -1.0, 2.0, 3.5, 0.0, 7.25]}, {}),
    "fill_constant_batch_size_like": (
        {"Input": {"x": _r((3, 4), 63)}}, {"Out": ["o"]},
        {"shape": [-1, 5], "dtype": "float32", "value": 2.5,
         "input_dim_idx": 0, "output_dim_idx": 0}, {}),
    "scatter_nd_add": ({"X": {"x": _r((3, 4, 5), 64)},
                        "Index": {"i": _i([[0, 1], [2, 3], [0, 1], [1, 0]])},
                        "Updates": {"u": _r((4, 5), 65)}},
                       {"Out": ["o"]}, {}, {"o": _r((3, 4, 5), 66)}),
    "scatter_nd": ({"Index": {"i": _i([[2], [0], [2]])},
                    "Updates": {"u": _r((3, 5), 67)}},
                   {"Out": ["o"]}, {"shape": [4, 5]}, {}),
    # ids past 2^31 hash by their low 32 bits in both packages
    "hash": ({"X": {"x": np.array([[1, 2], [2, 1], [2 ** 31 + 5, 7],
                                   [2 ** 33 + 9, -3], [123456789, 0]], np.int64)}},
             {"Out": ["o"]}, {"num_hash": 3, "mod_by": 10_000_000}, {}),
    "cvm": ({"X": {"x": _u((4, 5), 68, 0.0, 3.0)}, "CVM": {"c": _u((4, 2), 69, 0, 2)}},
            {"Y": ["o"]}, {"use_cvm": True}, {"o": _r((4, 5), 70)}, ("c",)),
    # -- nn_ops ----------------------------------------------------------------
    "log_softmax": ({"X": {"x": _r((3, 7), 71, 2.0)}}, {"Out": ["o"]}, {},
                    {"o": _r((3, 7), 72)}),
    "smooth_l1_loss": ({"X": {"x": _r((4, 3), 73)}, "Y": {"y": _r((4, 3), 74)},
                        "InsideWeight": {"iw": _u((4, 3), 75, 0.5, 1.5)},
                        "OutsideWeight": {"ow": _u((4, 3), 76, 0.5, 1.5)}},
                       {"Out": ["o"], "Diff": ["d"]}, {"sigma": 1.5},
                       {"o": _r((4, 1), 77)}),
    # tests/test_ops_coverage.py:43's shape
    "group_norm": ({"X": {"x": _r((2, 6, 3, 3), 78)}, "Scale": {"s": _r((6,), 79)},
                    "Bias": {"b": _r((6,), 80)}},
                   {"Y": ["o"], "Mean": ["m"], "Variance": ["v"]},
                   {"groups": 3, "epsilon": 1e-5}, {"o": _r((2, 6, 3, 3), 81)}),
    "instance_norm": ({"X": {"x": _r((2, 4, 5, 5), 82)}, "Scale": {"s": _r((4,), 83)},
                       "Bias": {"b": _r((4,), 84)}},
                      {"Y": ["o"]}, {"epsilon": 1e-5}, {"o": _r((2, 4, 5, 5), 85)}),
    "lookup_table_v2": ({"W": {"w": _r((7, 4), 86)}, "Ids": {"i": _i([[1, 3, 1], [6, 0, 3]])}},
                        {"Out": ["o"]}, {"padding_idx": 3}, {"o": _r((2, 3, 4), 87)}),
    "prelu": ({"X": {"x": _r((2, 3, 2, 2), 88)}, "Alpha": {"a": _u((3,), 89, 0.1, 0.4)}},
              {"Out": ["o"]}, {"mode": "channel"}, {"o": _r((2, 3, 2, 2), 90)}),
    "data_norm": ({"X": {"x": _r((5, 3), 91)},
                   "BatchSize": {"bs": _u((3,), 92, 1e3, 1e4)},
                   "BatchSum": {"bm": _r((3,), 93, 10.0)},
                   "BatchSquareSum": {"bq": _u((3,), 94, 1e3, 1e4)}},
                  {"Y": ["o"], "Means": ["m"], "Scales": ["s"]},
                  {"epsilon": 1e-4}, {"o": _r((5, 3), 95)}),
    "spectral_norm": ({"Weight": {"w": _r((4, 3, 2), 96)}, "U": {"u": _r((3,), 97)},
                       "V": {"v": _r((8,), 98)}},
                      {"Out": ["o"], "UOut": ["uo"], "VOut": ["vo"]},
                      {"dim": 1, "power_iters": 2}, {"o": _r((4, 3, 2), 99)},
                      ("u", "v")),
    "tree_conv": ({"NodesVector": {"n": _r((2, 5, 3), 100)},
                   "EdgeSet": {"e": _i([[[1, 2], [1, 3], [2, 4], [2, 5]],
                                        [[1, 2], [2, 3], [0, 0], [0, 0]]])},
                   "Filter": {"f": _r((3, 3, 2, 2), 101)}},
                  {"Out": ["o"]}, {"max_depth": 2}, {"o": _r((2, 5, 2, 2), 102)}),
    # -- sampling_ops ------------------------------------------------------------
    "hierarchical_sigmoid": ({"X": {"x": _r((4, 3), 103)}, "W": {"w": _r((5, 3), 104)},
                              "Bias": {"b": _r((5,), 105)},
                              "Label": {"l": _i([[0], [5], [3], [2]])}},
                             {"Out": ["o"], "PreOut": ["p"]}, {"num_classes": 6},
                             {"o": _r((4, 1), 106), "p": _r((4, 4), 107)}),
}
# a few second cases of ops whose attrs change the path
VARIANTS = {
    "elementwise_mod:float": ("elementwise_mod", (
        {"X": {"x": np.array([[7.5, -7.5], [5.0, -1.25]], np.float32)},
         "Y": {"y": np.array([[2.0, 2.0], [-3.0, 0.5]], np.float32)}},
        {"Out": ["o"]}, {}, {})),
    "pad2d:edge": ("pad2d", ({"X": {"x": _r((1, 2, 3, 3), 108)}}, {"Out": ["o"]},
                             {"paddings": [2, 0, 1, 1], "mode": "edge"},
                             {"o": _r((1, 2, 5, 5), 109)})),
    "prelu:element": ("prelu", ({"X": {"x": _r((2, 3, 2), 110)},
                                 "Alpha": {"a": _u((3, 2), 111, 0.1, 0.4)}},
                                {"Out": ["o"]}, {"mode": "element"},
                                {"o": _r((2, 3, 2), 112)})),
    "kldiv_loss:none": ("kldiv_loss", (
        {"X": {"x": np.log(_u((4, 3), 113, 0.1, 1.0))},
         "Target": {"t": _u((4, 3), 114, 0.05, 1.0)}},
        {"Loss": ["o"]}, {"reduction": "none"}, {"o": _r((4, 3), 115)})),
    "cvm:strip": ("cvm", ({"X": {"x": _u((3, 4), 116, 0.0, 3.0)},
                           "CVM": {"c": _u((3, 2), 117, 0, 2)}},
                          {"Y": ["o"]}, {"use_cvm": False}, {"o": _r((3, 2), 118)},
                          ("c",))),
}
GRADS = {"cvm_grad": "cvm", "data_norm_grad": "data_norm",
         "lookup_table_v2_grad": "lookup_table_v2"}
RANDOM = ("truncated_gaussian_random", "uniform_random_batch_size_like",
          "gaussian_random_batch_size_like", "nce", "nce_grad",
          "sample_logits", "sample_logits_grad")
HOST = ("print", "print_grad", "unique", "unique_with_counts",
        "filter_by_instag", "py_func", "py_func_grad")


def _case(case):
    c = OPS[case] if case in OPS else VARIANTS[case][1]
    ins, outs, attrs, cots = c[:4]
    return (VARIANTS[case][0] if case in VARIANTS else case, ins, outs,
            attrs, cots, c[4] if len(c) > 4 else ())


def _hold(op, jo, jg, to, tg):
    assert to.keys() == jo.keys()
    for k in jo:
        if jo[k].dtype.kind in "iub":
            assert to[k].dtype.kind == jo[k].dtype.kind, (op, k, to[k].dtype)
            np.testing.assert_array_equal(to[k], jo[k], err_msg=f"{op} {k}")
        else:
            assert to[k].shape == jo[k].shape, (op, k)
            close([to[k]], [jo[k]], what=f"{op} {k}")
    assert tg.keys() == jg.keys(), (op, tg.keys(), jg.keys())
    for k in jg:
        close([tg[k]], [jg[k]], what=f"{op} d{k}")


@pytest.mark.parametrize("case", sorted(OPS) + sorted(VARIANTS) + sorted(GRADS))
def test_op_and_its_grads_match_jax(case):
    fwd = GRADS.get(case, case)
    op, ins, outs, attrs, cots, nograd = _case(fwd)
    jo, jg, jm = op_outputs_and_grads(J, op, ins, outs, attrs, cots, nograd)
    to, tg, tm = op_outputs_and_grads(T, op, ins, outs, attrs, cots, nograd)
    _hold(op, jo, jg, to, tg)
    assert bool(cots) == bool(tg)       # a grad for every differentiable op
    if case in GRADS:
        for m in (jm, tm):
            assert case in [o.type for o in m.global_block.ops]
    assert tm.to_dict() == jm.to_dict()


# -- the random ops, by distribution -----------------------------------------

N_DRAWS = 40_000
SIGMAS = 5.0


def _run_port(op, ins, outs, attrs, cots=None, nograd=(), seed=0):
    """The port's one-op program at program seed `seed`: ({name: value},
    {input: grad})."""
    from paddle_tpu_torch import framework

    orig = framework.Program.__init__

    def seeded(self, *a, **k):
        orig(self, *a, **k)
        self.random_seed = seed

    framework.Program.__init__ = seeded
    try:
        return op_outputs_and_grads(T, op, ins, outs, attrs, cots or {},
                                    nograd)[:2]
    finally:
        framework.Program.__init__ = orig


def _moments(a, mean, std, what):
    a = np.asarray(a, np.float64).reshape(-1)
    n = a.size
    assert abs(a.mean() - mean) <= SIGMAS * std / math.sqrt(n), (what, a.mean())
    # the sample variance's standard error is ~ sqrt(2 / n) of the variance
    # for a normal, ~ sqrt(0.8 / n) for a uniform: 2 / n bounds both
    assert abs(a.var() - std ** 2) <= SIGMAS * std ** 2 * math.sqrt(2.0 / n), (
        what, a.std())


def _truncated_std():
    a = 2.0
    pdf = math.exp(-a * a / 2) / math.sqrt(2 * math.pi)
    z = math.erf(a / math.sqrt(2))
    return math.sqrt(1 - 2 * a * pdf / z)


def _random_case(op):
    x = np.zeros((N_DRAWS // 4, 3), np.float32)
    if op == "truncated_gaussian_random":
        return ({}, {"shape": [N_DRAWS], "mean": 1.0, "std": 2.0},
                1.0, 2.0 * _truncated_std(), (-3.0, 5.0))
    if op == "uniform_random_batch_size_like":
        return ({"Input": {"x": x}}, {"shape": [-1, 4], "min": -2.0, "max": 3.0},
                0.5, 5.0 / math.sqrt(12.0), (-2.0, 3.0))
    return ({"Input": {"x": x}}, {"shape": [-1, 4], "mean": -1.0, "std": 0.5},
            -1.0, 0.5, None)


@pytest.mark.parametrize("op", ["truncated_gaussian_random",
                                "uniform_random_batch_size_like",
                                "gaussian_random_batch_size_like"])
def test_random_op_distribution(op):
    ins, attrs, mean, std, rng = _random_case(op)
    for pkg in (J, T):
        got = op_outputs_and_grads(pkg, op, ins, {"Out": ["o"]}, attrs, {})[0]["o"]
        assert got.shape == (N_DRAWS // 4, 4) if ins else got.shape == (N_DRAWS,)
        assert got.dtype == np.float32
        if rng:
            assert got.min() >= rng[0] and got.max() <= rng[1], (pkg["name"], op)
        _moments(got, mean, std, (pkg["name"], op))
    a, b = (_run_port(op, ins, {"Out": ["o"]}, attrs, seed=s)[0]["o"]
            for s in (1, 2))
    assert not np.array_equal(a, b)             # the seed moves the stream


def _nce_case(sampler, B=6, D=4, C=11, k=5):
    return ({"Input": {"x": _r((B, D), 120)},
             "Label": {"l": _i(np.arange(B)[:, None] % C)},
             "Weight": {"w": _r((C, D), 121, 0.5)}, "Bias": {"b": _r((C,), 122)}},
            {"Cost": ["o"], "SampleLabels": ["s"]},
            {"num_total_classes": C, "num_neg_samples": k, "sampler": sampler},
            {"o": _r((B, 1), 123)})


@pytest.mark.parametrize("case", ["nce", "nce_grad"])
@pytest.mark.parametrize("sampler", [0, 1])
def test_nce_replays_its_saved_draws_as_jax(case, sampler):
    """The port's Cost and grads on its own SampleLabels equal the JAX
    objective's and jax.vjp's on those samples."""
    from paddle_tpu.ops import sampling_ops as js

    ins, outs, attrs, cots = _nce_case(sampler)
    to, tg = _run_port("nce", ins, outs, attrs, cots)
    s = to["s"]
    assert s.dtype == np.int32 and s.shape == (6, 5)
    assert s.min() >= 0 and s.max() < 11
    x, w, b = ins["Input"]["x"], ins["Weight"]["w"], ins["Bias"]["b"]
    label = jnp.asarray(ins["Label"]["l"])

    def f(x_, w_, b_):
        return js._nce_loss(x_, label, w_, b_, jnp.asarray(s), 11, 5, sampler)

    cost, vjp = jax.vjp(f, x, w, b)
    close([to["o"]], [np.asarray(cost)], what="Cost")
    if case == "nce_grad":
        for n, g in zip(("x", "w", "b"), vjp(jnp.asarray(cots["o"]))):
            close([tg[n]], [np.asarray(g)], what=f"d{n}")


def test_nce_log_uniform_draws_follow_zipf():
    """The first ids' frequencies over 40,000 draws against P(c) =
    log((c+2)/(c+1)) / log(C+1), within SIGMAS binomial sigmas."""
    C, B, k = 1000, 800, 50
    ins = {"Input": {"x": np.zeros((B, 2), np.float32)},
           "Label": {"l": np.zeros((B, 1), np.int32)},
           "Weight": {"w": np.zeros((C, 2), np.float32)}}
    s = _run_port("nce", ins, {"Cost": ["o"], "SampleLabels": ["s"]},
                  {"num_total_classes": C, "num_neg_samples": k,
                   "sampler": 1})[0]["s"].reshape(-1)
    n = s.size
    for c in range(4):
        p = math.log((c + 2) / (c + 1)) / math.log(C + 1)
        f = np.mean(s == c)
        assert abs(f - p) <= SIGMAS * math.sqrt(p * (1 - p) / n), (c, f, p)


@pytest.mark.parametrize("case", ["sample_logits", "sample_logits_grad"])
def test_sample_logits_replays_its_saved_draws_as_jax(case):
    from paddle_tpu.ops import registry as jreg
    from paddle_tpu.ops import sampling_ops as js

    B, V, S = 4, 50, 12
    logits = _r((B, V), 130)
    labels = _i([[3], [0], [49], [7]])
    ins = {"Logits": {"x": logits}, "Labels": {"l": labels}}
    outs = {"Samples": ["s"], "SampledLogits": ["o"], "SampledLabel": ["sl"],
            "Probabilities": ["p"]}
    cot = _r((B, 1 + S), 131)
    to, tg = _run_port("sample_logits", ins, outs,
                       {"num_samples": S, "remove_accidental_hits": True},
                       {"o": cot})
    s = to["s"]
    assert s.dtype == np.int32 and s.shape == (B, 1 + S)
    np.testing.assert_array_equal(s[:, :1], labels)
    np.testing.assert_array_equal(to["sl"], np.zeros((B, 1), np.int32))
    q = np.asarray(js._log_uniform_prob(jnp.asarray(s), V))
    want = np.take_along_axis(logits, s, 1) - np.log(q + 1e-20)
    hit = np.concatenate([np.zeros((B, 1), bool), s[:, 1:] == labels], 1)
    want = np.where(hit, want - 1e20, want)
    close([to["o"], to["p"]], [want, q], what="SampledLogits, Probabilities")
    if case == "sample_logits_grad":

        class _Op:
            inputs = {"Logits": ["x"], "Samples": ["s"],
                      "SampledLogits@GRAD": ["g"]}
            outputs = {"Logits@GRAD": ["dx"]}
            attrs = {}

        ctx = jreg.ExecContext(_Op, {"x": jnp.asarray(logits),
                                     "s": jnp.asarray(s), "g": jnp.asarray(cot)})
        want = jreg.get_op_def("sample_logits_grad").compute(ctx)["Logits@GRAD"]
        close([tg["x"]], [np.asarray(want)], what="dLogits")


# -- the host ops --------------------------------------------------------------

IDS = np.array([[5, 3, 5], [9, 3, 2], [2, 5, 7], [-4, 9, 5]], np.int64)


@pytest.mark.parametrize("op", ["unique", "unique_with_counts"])
@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_unique_keeps_encounter_order_as_jax(op, dtype):
    outs = {"Out": ["o"], "Index": ["i"]}
    if op == "unique_with_counts":
        outs["Count"] = ["c"]
    ins = {"X": {"x": IDS}}
    jo = op_outputs_and_grads(J, op, ins, outs, {"dtype": dtype}, {})[0]
    to = op_outputs_and_grads(T, op, ins, outs, {"dtype": dtype}, {})[0]
    _hold(op, jo, {}, to, {})
    np.testing.assert_array_equal(to["o"], [5, 3, 9, 2, 7, -4])


def test_filter_by_instag_matches_jax():
    ins = {"Ins": {"x": _r((5, 3), 140)},
           "Ins_tag": {"t": _i([[1, -1], [4, 2], [3, -1], [2, 2], [7, 8]], np.int64)},
           "Filter_tag": {"f": _i([2, 8], np.int64)}}
    outs = {"Out": ["o"], "LossWeight": ["w"], "IndexMap": ["m"]}
    jo = op_outputs_and_grads(J, "filter_by_instag", ins, outs, {}, {})[0]
    to = op_outputs_and_grads(T, "filter_by_instag", ins, outs, {}, {})[0]
    _hold("filter_by_instag", jo, {}, to, {})
    np.testing.assert_array_equal(to["m"][:, 1], [1, 3, 4])
    none = dict(ins, Filter_tag={"f": _i([99], np.int64)})
    to = op_outputs_and_grads(T, "filter_by_instag", none, outs, {}, {})[0]
    assert to["o"].shape == (1, 3) and not to["w"].any()


def _print_program(pkg, phase):
    """fc -> Print -> mean, minimized by SGD."""
    L = pkg["L"]
    x = L.data(name="x", shape=[3], dtype="float32")
    h = L.Print(L.fc(x, size=2, param_attr=pkg["pt"].ParamAttr(name="w")),
                message="dbg", first_n=3, summarize=4, print_phase=phase)
    loss = L.mean(h)
    pkg["pt"].optimizer.SGD(0.1).minimize(loss)
    return loss


@pytest.mark.parametrize("case", ["print", "print_grad"])
def test_print_lines_and_grad_match_jax(case, capsys):
    """Print's lines (first_n counted on the op, the backward phase
    tagged) and its pass-through grad, as the JAX op prints and passes."""
    from torch_parity import build, run_both

    phase = "forward" if case == "print" else "both"
    jp = build(J, lambda p: _print_program(p, phase))
    tp = build(T, lambda p: _print_program(p, phase))
    assert tp[0].to_dict() == jp[0].to_dict()
    feeds = [{"x": _r((2, 3), 150 + i)} for i in range(4)]
    capsys.readouterr()
    jout, tout, jscope, tscope = run_both(jp[:2], tp[:2], feeds[:1], [jp[2]],
                                          [tp[2]])
    first = [l for l in capsys.readouterr().out.splitlines() if "dbg" in l]
    half = len(first) // 2                  # the JAX run's lines, then the port's
    assert half == (1 if phase == "forward" else 2)
    assert first[half:] == first[:half]
    close(tout[0], jout[0], what="loss")
    close([np.asarray(tscope.find_var("w"))], [np.asarray(jscope.find_var("w"))])
    texe, tm = T["exe"](), tp[0]
    for f in feeds[1:]:
        texe.run(tm, feed=f, fetch_list=[tp[2].name], scope=tscope)
    tlines = first[half:] + [l for l in capsys.readouterr().out.splitlines()
                             if "dbg" in l]
    assert len(tlines) == (3 if phase == "forward" else 3 + 3)
    if case == "print_grad":
        assert sum("[backward]" in l for l in tlines) == 3
        assert "print_grad" in [o.type for o in tm.global_block.ops]


def _py_program(pkg):
    L = pkg["L"]
    x = L.data(name="x", shape=[3], dtype="float32", stop_gradient=False)
    y = pkg["pt"].default_main_program().current_block().create_var(
        name="y", shape=[-1, 3], dtype="float32")
    L.py_func(lambda a: np.tanh(a) * 2.0, x, y,
              backward_func=lambda a, o, g: g * 2.0 * (1.0 - np.tanh(a) ** 2))
    loss = L.mean(y)
    pkg["bw"].gradients([loss], [x])
    # a host op is never inferred, so gradients() finds no x@GRAD var to
    # return (in both packages): the grad is fetched by name
    return loss, "x@GRAD"


@pytest.mark.parametrize("case", ["py_func", "py_func_grad"])
def test_py_func_and_its_grad_match_jax(case):
    from torch_parity import build, run_both

    jp, tp = build(J, _py_program), build(T, _py_program)
    assert tp[0].to_dict() == jp[0].to_dict()
    assert "py_func_grad" in [o.type for o in tp[0].global_block.ops]
    feed = {"x": _r((4, 3), 160)}
    fetch = [0] if case == "py_func" else [0, 1]
    jout, tout, _, _ = run_both(jp[:2], tp[:2], [feed],
                                [jp[2][i] for i in fetch],
                                [tp[2][i] for i in fetch])
    close(tout[0], jout[0], what=case)


# -- the stateful outputs --------------------------------------------------------


def _stateful(pkg):
    L = pkg["L"]
    x = L.data(name="x", shape=[3], dtype="float32")
    lbl = L.data(name="l", shape=[1], dtype="int64")
    w = L.data(name="w", shape=[4, 3, 3], dtype="float32",
               append_batch_size=False)
    loss = L.center_loss(x, lbl, num_classes=4, alpha=0.25,
                         param_attr=pkg["pt"].ParamAttr(name="centers"))
    sn = L.spectral_norm(w, dim=0, power_iters=1, name="sn")
    return [L.mean(loss), L.reduce_sum(sn)]


def test_center_loss_and_spectral_norm_state_after_two_runs():
    """Each run advances the centers and spectral_norm's U and V once, as
    in the JAX package."""
    from torch_parity import build, run_both

    jp, tp = build(J, _stateful), build(T, _stateful)
    assert tp[0].to_dict() == jp[0].to_dict()
    feeds = [{"x": _r((6, 3), 170 + i), "l": _i([[0], [1], [1], [3], [0], [1]], np.int64),
              "w": _r((4, 3, 3), 172)} for i in range(2)]
    jout, tout, jscope, tscope = run_both(jp[:2], tp[:2], feeds, jp[2], tp[2])
    for j, t in zip(jout, tout):
        close(t, j, what="losses")
    c0 = None
    for n in ("centers", "sn.u", "sn.v"):
        close([np.asarray(tscope.find_var(n))], [np.asarray(jscope.find_var(n))],
              what=n)
    c0 = np.asarray(tscope.find_var("centers"))
    assert np.isfinite(c0).all()


def test_scope_of_the_ops_is_the_listed_remainder():
    """The JAX registry entries the port lacks: exactly the parameter-
    server (distributed) entries and recompute_grad; the vision,
    detection, crf, ctc, quant and the 16 collective entries and
    ring_attention are all ported."""
    import paddle_tpu.ops  # noqa: F401
    import paddle_tpu_torch.ops  # noqa: F401
    from paddle_tpu.ops.registry import _REGISTRY as JR
    from paddle_tpu_torch.ops.registry import _REGISTRY as TR

    vision = {"adaptive_pool2d", "adaptive_pool3d", "affine_channel",
              "affine_grid", "bilinear_interp", "bilinear_tensor_product",
              "conv3d", "conv3d_transpose", "crop", "deformable_conv",
              "grid_sampler", "im2sequence", "lrn", "maxout", "multiplex",
              "nearest_interp", "pad_constant_like", "pixel_shuffle", "pool3d",
              "random_crop", "sampling_id", "shard_index", "shuffle_channel",
              "temporal_shift", "trilinear_interp", "unfold"}
    detection = {"anchor_generator", "bipartite_match", "box_coder",
                 "density_prior_box", "generate_proposals", "iou_similarity",
                 "multiclass_nms", "prior_box", "psroi_pool", "roi_align",
                 "roi_pool", "ssd_loss", "yolo_box", "yolov3_loss"}
    crf_ctc = {"linear_chain_crf", "crf_decoding", "chunk_eval",
               "ctc_align", "edit_distance", "warpctc"}
    quant = {"dequantize_abs_max", "fake_quantize_dequantize_abs_max",
             "fake_quantize_dequantize_abs_max_grad",
             "fake_quantize_dequantize_moving_average_abs_max",
             "fake_quantize_dequantize_moving_average_abs_max_grad",
             "fake_quantize_dequantize_static",
             "fake_quantize_dequantize_static_grad"}
    collective = {"allreduce", "c_allgather", "c_allreduce_coalesced",
                  "c_allreduce_max", "c_allreduce_min", "c_allreduce_prod",
                  "c_allreduce_sum", "c_broadcast", "c_collective_permute",
                  "c_comm_init_all", "c_gen_nccl_id", "c_reducescatter",
                  "c_sync_calc_stream", "c_sync_comm_stream", "local_sgd_sync",
                  "zero1_shard"}
    distributed = {"fetch_barrier", "listen_and_serv", "prefetch", "recv",
                   "send", "send_barrier"}
    rest = distributed | {"recompute_grad"}
    assert (len(vision), len(detection), len(crf_ctc | quant), len(collective),
            len(rest)) == (26, 14, 13, 16, 7)
    assert vision | detection | crf_ctc | quant | collective <= set(TR)
    assert set(JR) - set(TR) == rest
    assert {c.split(":")[0] for c in OPS} | set(GRADS) | set(RANDOM) | set(HOST) \
        <= set(TR)
    assert len(set(OPS) | set(GRADS) | set(RANDOM) | set(HOST)) == 86


def _coverage_cases():
    """tests/test_ops_coverage.py:43, :64, :100 and :113's cases with their
    numpy oracles."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 3, 3)).astype(np.float32)
    sc, b = rng.standard_normal(6).astype(np.float32), rng.standard_normal(6).astype(np.float32)
    xr = x.reshape(2, 3, 2, 3, 3)
    gn = ((xr - xr.mean(axis=(2, 3, 4), keepdims=True))
          / np.sqrt(xr.var(axis=(2, 3, 4), keepdims=True) + 1e-5)).reshape(x.shape)
    gn = gn * sc[None, :, None, None] + b[None, :, None, None]
    xi = np.random.default_rng(2).standard_normal((2, 4, 5, 5)).astype(np.float32)
    si = np.abs(np.random.default_rng(3).standard_normal(4)).astype(np.float32)
    bi = np.random.default_rng(4).standard_normal(4).astype(np.float32)
    inn = ((xi - xi.mean(axis=(2, 3), keepdims=True))
           / np.sqrt(xi.var(axis=(2, 3), keepdims=True) + 1e-5)
           * si[None, :, None, None] + bi[None, :, None, None])
    xg = np.random.default_rng(3).standard_normal((3, 4, 5)).astype(np.float32)
    idx = np.array([[0, 1], [2, 3]], np.int64)
    xs = np.random.default_rng(4).standard_normal((4, 8)).astype(np.float32)
    return {
        "group_norm": ({"X": {"x": x}, "Scale": {"s": sc}, "Bias": {"b": b}},
                       {"Y": ["o"], "Mean": ["m"], "Variance": ["v"]},
                       {"groups": 3, "epsilon": 1e-5}, gn),
        "instance_norm": ({"X": {"x": xi}, "Scale": {"s": si}, "Bias": {"b": bi}},
                          {"Y": ["o"]}, {"epsilon": 1e-5}, inn),
        "gather_nd": ({"X": {"x": xg}, "Index": {"i": idx}}, {"Out": ["o"]}, {},
                      xg[idx[:, 0], idx[:, 1]]),
        "strided_slice": ({"Input": {"x": xs}}, {"Out": ["o"]},
                          {"axes": [0, 1], "starts": [1, 6], "ends": [4, 0],
                           "strides": [2, -2]}, xs[1:4:2, 6:0:-2]),
    }


@pytest.mark.parametrize("op", ["group_norm", "instance_norm", "gather_nd",
                                "strided_slice"])
def test_op_matches_its_numpy_oracle(op):
    """tests/test_ops_coverage.py's group_norm, instance_norm, gather_nd and
    strided_slice cases on the port, against their numpy oracles."""
    ins, outs, attrs, expect = _coverage_cases()[op]
    got = op_outputs_and_grads(T, op, ins, outs, attrs, {})[0]["o"]
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-4)
