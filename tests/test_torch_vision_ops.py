"""The port's vision ops held against the JAX package on the CPU.

* One parametrised test over the deterministic ops: each runs as a one-op
  program through both packages, forward and the grads of its floating
  inputs (the port's by replay, the JAX op's through jax.vjp) on the same
  inputs and cotangents, within 1e-5 (integer outputs bit for bit). The
  resizes run in every convention: align_corners on and off, align_mode 0
  and 1, up and down, at ratios that are not whole numbers, in 2-D and 3-D.
* The resizes' gathers repeat their grads bit for bit (a fixed-order sum,
  no atomics).
* The adaptive pools raise on extents that do not divide, as the JAX ops
  do; the layers' shape rules (shard_index's and sampling_id's int32).
* The random ops by their laws: sampling_id's category frequencies within
  SIGMAS binomial sigmas of the probabilities, random_crop's offsets
  uniform over the valid starts and each crop a window of its sample.
* The 44 vision and detection layers build the JAX package's programs
  (main and startup by to_dict()).
"""
import math

import numpy as np
import pytest

from torch_parity import J, T, close, op_outputs_and_grads

SIGMAS = 6.0


def _r(shape, seed, scale=1.0, shift=0.0):
    return (shift + scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _u(shape, seed, lo, hi):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _resize(op, x, attrs, out):
    return ({"X": {"x": x}}, {"Out": ["o"]}, attrs, {"o": _r(out, 99)}, ())


X4 = _r((2, 3, 5, 7), 1)
X5 = _r((2, 2, 3, 4, 5), 2)

# case -> (op, inputs {slot: {name: array}}, outputs, attrs, cotangents,
#          floating inputs that take no grad)
CASES = {
    # -- the resizes in every convention ----------------------------------
    "nearest_ac_up": ("nearest_interp", *_resize(
        "nearest_interp", X4, {"out_h": 11, "out_w": 13, "align_corners": True},
        (2, 3, 11, 13))),
    "nearest_ac_2x": ("nearest_interp", *_resize(
        "nearest_interp", X4, {"scale": 2.0, "align_corners": True},
        (2, 3, 10, 14))),
    "nearest_up": ("nearest_interp", *_resize(
        "nearest_interp", X4, {"out_h": 8, "out_w": 10, "align_corners": False},
        (2, 3, 8, 10))),
    "nearest_down": ("nearest_interp", *_resize(
        "nearest_interp", X4, {"out_h": 3, "out_w": 4, "align_corners": False},
        (2, 3, 3, 4))),
    "bilinear_ac_up": ("bilinear_interp", *_resize(
        "bilinear_interp", X4, {"out_h": 9, "out_w": 12, "align_corners": True},
        (2, 3, 9, 12))),
    "bilinear_ac_down": ("bilinear_interp", *_resize(
        "bilinear_interp", X4, {"out_h": 3, "out_w": 4, "align_corners": True},
        (2, 3, 3, 4))),
    "bilinear_mode1_up": ("bilinear_interp", *_resize(
        "bilinear_interp", X4, {"out_h": 8, "out_w": 11, "align_corners": False,
                                "align_mode": 1}, (2, 3, 8, 11))),
    "bilinear_mode1_down": ("bilinear_interp", *_resize(
        "bilinear_interp", X4, {"out_h": 3, "out_w": 5, "align_corners": False,
                                "align_mode": 1}, (2, 3, 3, 5))),
    "bilinear_mode0_up": ("bilinear_interp", *_resize(
        "bilinear_interp", X4, {"out_h": 8, "out_w": 11, "align_corners": False,
                                "align_mode": 0}, (2, 3, 8, 11))),
    "bilinear_mode0_down": ("bilinear_interp", *_resize(
        "bilinear_interp", X4, {"out_h": 3, "out_w": 5, "align_corners": False,
                                "align_mode": 0}, (2, 3, 3, 5))),
    "bilinear_mode0_one_axis": ("bilinear_interp", *_resize(
        "bilinear_interp", X4, {"out_h": 5, "out_w": 3, "align_corners": False,
                                "align_mode": 0}, (2, 3, 5, 3))),
    "trilinear_ac": ("trilinear_interp", *_resize(
        "trilinear_interp", X5, {"out_d": 5, "out_h": 3, "out_w": 7,
                                 "align_corners": True}, (2, 2, 5, 3, 7))),
    "trilinear_mode0": ("trilinear_interp", *_resize(
        "trilinear_interp", X5, {"out_d": 4, "out_h": 7, "out_w": 3,
                                 "align_corners": False, "align_mode": 0},
        (2, 2, 4, 7, 3))),
    "trilinear_mode1": ("trilinear_interp", *_resize(
        "trilinear_interp", X5, {"scale": 1.5, "align_corners": False,
                                 "align_mode": 1}, (2, 2, 4, 6, 7))),
    # -- pooling and convolution ------------------------------------------
    "pool3d_max": ("pool3d", {"X": {"x": _r((2, 3, 5, 6, 6), 3)}},
                   {"Out": ["o"]},
                   {"ksize": [2, 3, 3], "strides": [1, 2, 2],
                    "paddings": [1, 1, 1], "pooling_type": "max"},
                   {"o": _r((2, 3, 6, 3, 3), 4)}, ()),
    "pool3d_avg_exclusive": ("pool3d", {"X": {"x": _r((2, 3, 5, 6, 6), 5)}},
                             {"Out": ["o"]},
                             {"ksize": [3, 3, 3], "strides": [2, 2, 2],
                              "paddings": [1, 1, 1], "pooling_type": "avg"},
                             {"o": _r((2, 3, 3, 3, 3), 6)}, ()),
    "pool3d_avg_inclusive": ("pool3d", {"X": {"x": _r((2, 3, 5, 6, 6), 7)}},
                             {"Out": ["o"]},
                             {"ksize": [3, 3, 3], "strides": [2, 2, 2],
                              "paddings": [1, 1, 1], "pooling_type": "avg",
                              "exclusive": False},
                             {"o": _r((2, 3, 3, 3, 3), 8)}, ()),
    "pool3d_global": ("pool3d", {"X": {"x": _r((2, 3, 4, 5, 6), 9)}},
                      {"Out": ["o"]},
                      {"ksize": [1, 1, 1], "global_pooling": True,
                       "pooling_type": "avg"}, {"o": _r((2, 3, 1, 1, 1), 10)},
                      ()),
    "conv3d": ("conv3d", {"Input": {"x": _r((2, 4, 5, 6, 6), 11)},
                          "Filter": {"w": _r((6, 2, 3, 3, 3), 12, 0.3)}},
               {"Output": ["o"]},
               {"strides": [1, 2, 2], "paddings": [1, 1, 1],
                "dilations": [1, 1, 1], "groups": 2},
               {"o": _r((2, 6, 5, 3, 3), 13)}, ()),
    "conv3d_transpose": ("conv3d_transpose",
                         {"Input": {"x": _r((2, 4, 3, 4, 4), 14)},
                          "Filter": {"w": _r((4, 3, 3, 3, 3), 15, 0.3)}},
                         {"Output": ["o"]},
                         {"strides": [2, 2, 2], "paddings": [1, 1, 1],
                          "dilations": [1, 1, 1]},
                         {"o": _r((2, 3, 5, 7, 7), 16)}, ()),
    "adaptive_pool2d_avg": ("adaptive_pool2d", {"X": {"x": _r((2, 3, 6, 8), 17)}},
                            {"Out": ["o"]},
                            {"pooled_size": [3, 2], "pooling_type": "avg"},
                            {"o": _r((2, 3, 3, 2), 18)}, ()),
    "adaptive_pool2d_max": ("adaptive_pool2d", {"X": {"x": _r((2, 3, 6, 8), 19)}},
                            {"Out": ["o"]},
                            {"pooled_size": [2, 4], "pooling_type": "max"},
                            {"o": _r((2, 3, 2, 4), 20)}, ()),
    "adaptive_pool3d_max": ("adaptive_pool3d",
                            {"X": {"x": _r((2, 3, 4, 6, 4), 21)}},
                            {"Out": ["o"]},
                            {"pooled_size": [2, 3, 1], "pooling_type": "max"},
                            {"o": _r((2, 3, 2, 3, 1), 22)}, ()),
    "adaptive_pool3d_avg": ("adaptive_pool3d",
                            {"X": {"x": _r((2, 3, 4, 6, 4), 23)}},
                            {"Out": ["o"]},
                            {"pooled_size": [1, 2, 2], "pooling_type": "avg"},
                            {"o": _r((2, 3, 1, 2, 2), 24)}, ()),
    # -- layout ops --------------------------------------------------------
    "pixel_shuffle": ("pixel_shuffle", {"X": {"x": _r((2, 8, 3, 4), 25)}},
                      {"Out": ["o"]}, {"upscale_factor": 2},
                      {"o": _r((2, 2, 6, 8), 26)}, ()),
    "shuffle_channel": ("shuffle_channel", {"X": {"x": _r((2, 6, 3, 4), 27)}},
                        {"Out": ["o"]}, {"group": 3},
                        {"o": _r((2, 6, 3, 4), 28)}, ()),
    "space_to_depth": ("space_to_depth", {"X": {"x": _r((2, 3, 4, 6), 29)}},
                       {"Out": ["o"]}, {"blocksize": 2},
                       {"o": _r((2, 12, 2, 3), 30)}, ()),
    "temporal_shift": ("temporal_shift", {"X": {"x": _r((6, 8, 3, 3), 31)}},
                       {"Out": ["o"]}, {"seg_num": 3, "shift_ratio": 0.25},
                       {"o": _r((6, 8, 3, 3), 32)}, ()),
    "maxout": ("maxout", {"X": {"x": _r((2, 6, 3, 4), 33)}}, {"Out": ["o"]},
               {"groups": 3}, {"o": _r((2, 2, 3, 4), 34)}, ()),
    "lrn": ("lrn", {"X": {"x": _r((2, 7, 3, 4), 35)}},
            {"Out": ["o"], "MidOut": ["m"]},
            {"n": 5, "k": 2.0, "alpha": 0.1, "beta": 0.75},
            {"o": _r((2, 7, 3, 4), 36)}, ()),
    "affine_channel": ("affine_channel",
                       {"X": {"x": _r((2, 4, 3, 5), 37)},
                        "Scale": {"s": _r((4,), 38)}, "Bias": {"b": _r((4,), 39)}},
                       {"Out": ["o"]}, {}, {"o": _r((2, 4, 3, 5), 40)}, ()),
    "multiplex": ("multiplex",
                  {"X": {"a": _r((4, 5), 41), "b": _r((4, 5), 42),
                         "c": _r((4, 5), 43)},
                   "Ids": {"i": np.array([[2], [0], [1], [2]], np.int32)}},
                  {"Out": ["o"]}, {}, {"o": _r((4, 5), 44)}, ()),
    "crop": ("crop", {"X": {"x": _r((3, 5, 6), 45)}}, {"Out": ["o"]},
             {"shape": [2, 3, 4], "offsets": [1, 1, 2]},
             {"o": _r((2, 3, 4), 46)}, ()),
    "pad_constant_like": ("pad_constant_like",
                          {"X": {"x": _r((4, 5, 6), 47)},
                           "Y": {"y": _r((2, 3, 6), 48)}},
                          {"Out": ["o"]}, {"pad_value": 1.5},
                          {"o": _r((4, 5, 6), 49)}, ()),
    "unfold": ("unfold", {"X": {"x": _r((2, 3, 6, 7), 50)}}, {"Y": ["o"]},
               {"kernel_sizes": [3, 2], "strides": [2, 1], "paddings": [1, 0],
                "dilations": [1, 2]}, {"o": _r((2, 18, 15), 51)}, ()),
    "grid_sampler": ("grid_sampler",
                     {"X": {"x": _r((2, 3, 5, 6), 52)},
                      "Grid": {"g": _u((2, 4, 3, 2), 53, -1.15, 1.15)}},
                     {"Output": ["o"]}, {}, {"o": _r((2, 3, 4, 3), 54)}, ()),
    "bilinear_tensor_product": ("bilinear_tensor_product",
                                {"X": {"x": _r((4, 3), 55)},
                                 "Y": {"y": _r((4, 5), 56)},
                                 "Weight": {"w": _r((2, 3, 5), 57)},
                                 "Bias": {"b": _r((1, 2), 58)}},
                                {"Out": ["o"]}, {}, {"o": _r((4, 2), 59)}, ()),
    "shard_index": ("shard_index",
                    {"X": {"x": np.array([[1], [6], [12], [19], [0]], np.int32)}},
                    {"Out": ["o"]},
                    {"index_num": 20, "nshards": 3, "shard_id": 1,
                     "ignore_value": -1}, {}, ()),
    "affine_grid": ("affine_grid", {"Theta": {"t": _r((2, 2, 3), 60)}},
                    {"Output": ["o"]}, {"output_shape": [2, 3, 4, 5]},
                    {"o": _r((2, 4, 5, 2), 61)}, ()),
    "im2sequence": ("im2sequence", {"X": {"x": _r((2, 3, 5, 6), 62)}},
                    {"Out": ["o"]},
                    {"kernels": [2, 3], "strides": [1, 2],
                     "paddings": [1, 0, 0, 1]}, {}, ()),
    "deformable_conv": ("deformable_conv",
                        {"Input": {"x": _r((2, 4, 5, 6), 63)},
                         "Offset": {"off": _r((2, 2 * 2 * 9, 5, 6), 64, 0.7)},
                         "Mask": {"m": _u((2, 2 * 9, 5, 6), 65, 0.1, 1.0)},
                         "Filter": {"w": _r((6, 2, 3, 3), 66, 0.3)}},
                        {"Output": ["o"]},
                        {"strides": [1, 1], "paddings": [1, 1],
                         "dilations": [1, 1], "groups": 2,
                         "deformable_groups": 2},
                        {"o": _r((2, 6, 5, 6), 67)}, ()),
    "deformable_conv_stride": ("deformable_conv",
                               {"Input": {"x": _r((1, 3, 7, 7), 68)},
                                "Offset": {"off": _r((1, 2 * 4, 3, 3), 69, 1.3)},
                                "Mask": {"m": _u((1, 4, 3, 3), 70, 0.1, 1.0)},
                                "Filter": {"w": _r((4, 3, 2, 2), 71, 0.3)}},
                               {"Output": ["o"]},
                               {"strides": [2, 2], "paddings": [0, 0],
                                "dilations": [2, 2], "groups": 1,
                                "deformable_groups": 1},
                               {"o": _r((1, 4, 3, 3), 72)}, ()),
}


def _both(case):
    op, ins, outs, attrs, cots, nograd = CASES[case]
    jo, jg, _ = op_outputs_and_grads(J, op, ins, outs, attrs, cots, nograd)
    to, tg, _ = op_outputs_and_grads(T, op, ins, outs, attrs, cots, nograd)
    return jo, jg, to, tg


@pytest.mark.parametrize("case", sorted(CASES))
def test_vision_op_matches_jax(case):
    jo, jg, to, tg = _both(case)
    assert set(to) == set(jo) and set(tg) == set(jg)
    for n in jo:
        assert to[n].shape == jo[n].shape, (n, to[n].shape, jo[n].shape)
        if jo[n].dtype.kind in "iub":
            assert to[n].dtype == jo[n].dtype, (n, to[n].dtype, jo[n].dtype)
            np.testing.assert_array_equal(to[n], jo[n], err_msg=n)
        else:
            close([to[n]], [jo[n]], what=f"{case} {n}")
    for n in jg:
        close([tg[n]], [jg[n]], what=f"{case} d{n}")
    if CASES[case][4]:
        assert tg, case


@pytest.mark.parametrize("case", ["nearest_ac_2x", "bilinear_ac_up",
                                  "trilinear_mode1"])
def test_resize_grads_repeat_bit_for_bit(case):
    op, ins, outs, attrs, cots, nograd = CASES[case]
    a = op_outputs_and_grads(T, op, ins, outs, attrs, cots, nograd)[1]
    b = op_outputs_and_grads(T, op, ins, outs, attrs, cots, nograd)[1]
    assert a and all(np.array_equal(a[n], b[n]) for n in a)


def test_resize_nearest_align_corners_sources():
    """The reference's align_corners=True source of output d is
    floor(d*(in-1)/(out-1) + 0.5). At exactly 2x (YOLOv3's 19 -> 38) that
    is a 2x repeat: d/2 - d/(2(2n-1)) + 0.5 floors to floor(d/2). At 7 ->
    11 it is neither a repeat nor F.interpolate's floor(d*in/out)."""
    def sources(n, out):
        x = np.arange(n, dtype=np.float32).reshape(1, 1, 1, n)
        return op_outputs_and_grads(T, "nearest_interp", {"X": {"x": x}},
                                    {"Out": ["o"]}, {"out_h": 1, "out_w": out,
                                                     "align_corners": True},
                                    {})[0]["o"][0, 0, 0]

    np.testing.assert_array_equal(sources(19, 38), np.repeat(np.arange(19), 2))
    got = sources(7, 11)
    want = np.floor(np.arange(11, dtype=np.float32) * np.float32(6 / 10) + 0.5)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, np.floor(np.arange(11) * 7 / 11))


@pytest.mark.parametrize("op,shape,pooled", [
    ("adaptive_pool2d", (1, 2, 5, 6), [2, 3]),
    ("adaptive_pool3d", (1, 2, 4, 6, 5), [2, 3, 2])])
def test_adaptive_pool_raises_on_uneven_bins(op, shape, pooled):
    for pkg in (J, T):
        with pytest.raises(Exception, match="not divisible"):
            op_outputs_and_grads(pkg, op, {"X": {"x": np.zeros(shape, np.float32)}},
                                 {"Out": ["o"]}, {"pooled_size": pooled}, {})


def _layer_out(pkg, build, feed):
    from torch_parity import build as mk

    main, startup, out = mk(pkg, lambda p: build(p["L"]))
    exe, scope = pkg["exe"](), pkg["scope"]()
    exe.run(startup, scope=scope)
    return out, exe.run(main, feed=feed, fetch_list=[out.name], scope=scope)[0]


def test_sampling_id_follows_its_probabilities():
    """2,000 rows of one 5-way distribution: each category's frequency
    within SIGMAS binomial sigmas; the output int32 [rows]."""
    p = np.array([0.05, 0.4, 0.1, 0.3, 0.15], np.float32)
    feed = {"p": np.tile(p, (2000, 1))}

    def build(L):
        return L.sampling_id(L.data(name="p", shape=[5], dtype="float32"))

    var, got = _layer_out(T, build, feed)
    got = np.asarray(got)
    assert got.dtype == np.int32 and got.shape == (2000,)
    n = got.size
    for c, pc in enumerate(p):
        f = np.mean(got == c)
        assert abs(f - pc) <= SIGMAS * math.sqrt(pc * (1 - pc) / n), (c, f, pc)


def test_random_crop_windows_and_offsets():
    """Each of 400 crops of a 1 x 6 x 7 ramp is the window of its sample at
    its offsets; the offsets cover the valid starts with uniform
    frequencies (within SIGMAS sigmas)."""
    B, H, W, th, tw = 400, 6, 7, 4, 3
    x = np.arange(H * W, dtype=np.float32).reshape(1, 1, H, W)
    x = np.tile(x, (B, 1, 1, 1)) + 1000 * np.arange(B, dtype=np.float32)[:, None, None, None]

    def build(L):
        return L.random_crop(L.data(name="x", shape=[1, H, W], dtype="float32"),
                             shape=[th, tw])

    _, got = _layer_out(T, build, {"x": x})
    got = np.asarray(got)
    assert got.shape == (B, 1, th, tw)
    starts = []
    for b in range(B):
        v = got[b, 0] - 1000 * b
        y0, x0 = int(v[0, 0]) // W, int(v[0, 0]) % W
        np.testing.assert_array_equal(v, x[0, 0, y0:y0 + th, x0:x0 + tw])
        starts.append((y0, x0))
    ys = np.array([s[0] for s in starts])
    xs = np.array([s[1] for s in starts])
    for vals, n in ((ys, H - th + 1), (xs, W - tw + 1)):
        assert vals.min() >= 0 and vals.max() <= n - 1
        for v in range(n):
            f, pv = np.mean(vals == v), 1.0 / n
            assert abs(f - pv) <= SIGMAS * math.sqrt(pv * (1 - pv) / B), (v, f)


# -- the 44 layers: each builds the JAX package's programs -----------------


def _layer_vars(L):
    d = lambda n, s, t="float32", **k: L.data(name=n, shape=s, dtype=t, **k)  # noqa: E731
    return type("V", (), dict(
        img=d("img", [4, 8, 8]), vol=d("vol", [2, 4, 6, 6]),
        seq=d("seq", [6, 4, 4]), ids=d("ids", [1], "int64"),
        rows=d("rows", [5]), rows2=d("rows2", [5]), vec=d("vec", [3]),
        vec2=d("vec2", [4]), prob=d("prob", [6]),
        theta=d("theta", [2, 3]), grid=d("grid", [8, 8, 2]),
        scale=d("scale", [4], append_batch_size=False),
        bias=d("bias", [4], append_batch_size=False),
        offset=d("offset", [18, 8, 8]), mask=d("mask", [9, 8, 8]),
        rois=d("rois", [4], append_batch_size=False),
        rbid=d("rbid", [1], "int32", append_batch_size=False),
        image=d("image", [3, 64, 64]), boxes=d("boxes", [12, 4]),
        scores=d("scores", [3, 12]), priors=d("priors", [12, 4], append_batch_size=False),
        pvar=d("pvar", [12, 4], append_batch_size=False),
        loc=d("loc", [12, 4]), conf=d("conf", [12, 3]),
        gtb=d("gtb", [2, 4]), gtl=d("gtl", [2, 1], "int64"),
        gtc=d("gtc", [], "int64"), dist=d("dist", [3, 12]),
        yolo=d("yolo", [14, 4, 4]), imsz=d("imsz", [2], "int32"),
        gt=d("gt", [3, 4]), gtlab=d("gtlab", [3], "int32"),
        gts=d("gts", [3]), rpn=d("rpn", [3, 4, 4]),
        deltas=d("deltas", [12, 4, 4]), info=d("info", [3]),
        ps=d("ps", [8, 8, 8])))


LAYERS = {
    # layers/nn.py's vision layers
    "adaptive_pool2d": lambda L, v: L.adaptive_pool2d(v.img, [2, 4], "avg"),
    "adaptive_pool3d": lambda L, v: L.adaptive_pool3d(v.vol, [1, 2, 3]),
    "affine_channel": lambda L, v: L.affine_channel(v.img, v.scale, v.bias,
                                                    act="relu"),
    "affine_grid": lambda L, v: L.affine_grid(v.theta, [2, 4, 8, 8]),
    "bilinear_tensor_product": lambda L, v: L.bilinear_tensor_product(
        v.vec, v.vec2, 3, act="tanh"),
    "conv3d": lambda L, v: L.conv3d(v.vol, 3, 3, padding=1, act="relu"),
    "conv3d_transpose": lambda L, v: L.conv3d_transpose(v.vol, 3, filter_size=2,
                                                        stride=2),
    "crop": lambda L, v: L.crop(v.img, shape=[-1, 2, 4, 4], offsets=[0, 1, 2, 2]),
    "deformable_conv": lambda L, v: L.deformable_conv(
        v.img, v.offset, v.mask, 6, 3, padding=1, bias_attr="dcn.b"),
    "grid_sampler": lambda L, v: L.grid_sampler(v.img, v.grid),
    "im2sequence": lambda L, v: L.im2sequence(v.img, filter_size=[2, 3],
                                              stride=[1, 2], padding=1),
    "image_resize": lambda L, v: L.image_resize(v.img, out_shape=[5, 7],
                                                resample="NEAREST"),
    "image_resize_short": lambda L, v: L.image_resize_short(v.img, 5),
    "lrn": lambda L, v: L.lrn(v.img, n=3),
    "maxout": lambda L, v: L.maxout(v.img, groups=2),
    "multiplex": lambda L, v: L.multiplex([v.rows, v.rows2], v.ids),
    "pad_constant_like": lambda L, v: L.pad_constant_like(v.img, v.img, 1.0),
    "pixel_shuffle": lambda L, v: L.pixel_shuffle(v.img, 2),
    "pool3d": lambda L, v: L.pool3d(v.vol, 2, "avg", 2),
    "random_crop": lambda L, v: L.random_crop(v.img, [5, 5]),
    "resize_bilinear": lambda L, v: L.resize_bilinear(v.img, [11, 5],
                                                      align_corners=False,
                                                      align_mode=0),
    "resize_nearest": lambda L, v: L.resize_nearest(v.img, scale=2),
    "resize_trilinear": lambda L, v: L.resize_trilinear(v.vol, [3, 9, 4]),
    "sampling_id": lambda L, v: L.sampling_id(v.prob),
    "shard_index": lambda L, v: L.shard_index(v.ids, 20, 4, 1),
    "shuffle_channel": lambda L, v: L.shuffle_channel(v.img, 2),
    "temporal_shift": lambda L, v: L.temporal_shift(v.img, 2),
    "unfold": lambda L, v: L.unfold(v.img, [2, 3], 1, 1),
    "roi_align": lambda L, v: L.roi_align(v.img, v.rois, 2, 2, 0.5, 2,
                                          rois_batch_id=v.rbid),
    "roi_pool": lambda L, v: L.roi_pool(v.img, v.rois, 2, 3, 0.5),
    # layers/detection.py
    "prior_box": lambda L, v: L.prior_box(v.img, v.image, [8.0], [16.0], [2.0],
                                          flip=True, clip=True),
    "box_coder": lambda L, v: L.box_coder(v.priors, v.pvar, v.loc,
                                          code_type="decode_center_size"),
    "iou_similarity": lambda L, v: L.iou_similarity(v.priors, v.pvar),
    "multiclass_nms": lambda L, v: L.multiclass_nms(v.boxes, v.scores, 0.05,
                                                    8, 5, 0.4),
    "detection_output": lambda L, v: L.detection_output(v.loc, v.scores,
                                                        v.priors, v.pvar),
    "ssd_loss": lambda L, v: L.ssd_loss(v.loc, v.conf, v.gtb, v.gtl, v.priors,
                                        v.pvar, gt_count=v.gtc),
    "bipartite_match": lambda L, v: L.bipartite_match(v.dist),
    "yolo_box": lambda L, v: L.yolo_box(v.yolo, v.imsz, [10, 13, 16, 30], 2,
                                        0.01, 16),
    "yolov3_loss": lambda L, v: L.yolov3_loss(
        v.yolo, v.gt, v.gtlab, [10, 13, 16, 30, 33, 23], [0, 1], 2, 0.7, 16,
        gt_score=v.gts),
    "anchor_generator": lambda L, v: L.anchor_generator(v.img, [32.0, 64.0],
                                                        [0.5, 1.0],
                                                        stride=[8.0, 8.0]),
    "density_prior_box": lambda L, v: L.density_prior_box(
        v.img, v.image, [2, 1], [16.0, 32.0], [1.0], clip=True),
    "generate_proposals": lambda L, v: L.generate_proposals(
        v.rpn, v.deltas, v.info, *L.anchor_generator(v.rpn, [16.0], [0.5, 1.0, 2.0],
                                                     stride=[16.0, 16.0]),
        pre_nms_top_n=20, post_nms_top_n=6),
    "psroi_pool": lambda L, v: L.psroi_pool(v.ps, v.rois, 2, 0.5, 2, 2,
                                            rois_batch=v.rbid),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_builds_the_jax_program(name):
    from torch_parity import build

    def make(pkg):
        out = LAYERS[name](pkg["L"], _layer_vars(pkg["L"]))
        return out

    jp, tp = build(J, make), build(T, make)
    assert tp[0].to_dict() == jp[0].to_dict()
    assert tp[1].to_dict() == jp[1].to_dict()


def test_the_44_layers_are_all_exported():
    import paddle_tpu_torch.layers as TL

    names = set(LAYERS) | {"detection"}
    assert len(names) == 44 and names <= set(dir(TL))
    assert set(TL.detection.__all__) <= set(LAYERS)
