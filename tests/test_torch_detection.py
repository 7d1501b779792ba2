"""The port's detection ops and layers/detection.py held against the JAX
package on the CPU.

* One parametrised test over the 14 ops: each runs as a one-op program
  through both packages, forward and, for the differentiable ones
  (ssd_loss, roi_align, roi_pool, psroi_pool, yolov3_loss), the grads of
  their floating inputs (the port's by replay, the JAX op's through
  jax.vjp) on the same inputs and cotangents: floats within 1e-5,
  integers bit for bit. multiclass_nms also with tied scores, padding
  rows and a background class; yolov3_loss also with two gts in one cell
  and anchor (the later gt's score is the objectness target) and a gt
  whose best anchor is outside the mask.
* tests/test_detection.py's 11 tests on the port, with their numpy
  oracles.
"""
import numpy as np
import pytest

from torch_parity import J, T, build, close, op_outputs_and_grads


def _r(shape, seed, scale=1.0, shift=0.0):
    return (shift + scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _u(shape, seed, lo, hi):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _boxes(shape, seed, lo=0.0, hi=1.0, min_wh=0.02):
    """Random (x1, y1, x2, y2) boxes inside [lo, hi]."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, hi, shape[:-1] + (2,))
    b = rng.uniform(lo, hi, shape[:-1] + (2,))
    p1, p2 = np.minimum(a, b), np.maximum(a, b) + min_wh
    return np.concatenate([p1[..., :1], p1[..., 1:], p2[..., :1], p2[..., 1:]],
                          -1).astype(np.float32)


def _nms_inputs():
    """Two images, 3 classes (0 background), 12 boxes: class 1's scores
    tied in pairs, a cluster of overlapping boxes, and few enough
    survivors that padding rows follow."""
    bx = _boxes((2, 12, 4), 1)
    bx[:, 3:6] = bx[:, 2:3] + np.float32(0.01) * np.arange(1, 4,
                                                           dtype=np.float32)[:, None]
    sc = _u((2, 3, 12), 2, 0.0, 1.0)
    sc[:, 1, 0::2] = sc[:, 1, 1::2]                  # tied pairs
    sc[:, 2, :6] = np.float32(0.5)                   # a run of equal scores
    sc[:, 2, 9:] = 0.0
    return bx, sc


def _yolo_inputs(N=2, H=4, W=4, cls=3, mask=(0, 1)):
    x = _r((N, len(mask) * (5 + cls), H, W), 10)
    gt = np.zeros((N, 5, 4), np.float32)
    gt[0, 0] = [0.3, 0.4, 0.125, 0.23]
    gt[0, 1] = [0.32, 0.41, 0.13, 0.24]    # the same cell and anchor as gt 0
    gt[0, 2] = [0.7, 0.2, 0.1, 0.1]
    gt[0, 3] = [0.6, 0.8, 0.9, 0.9]        # best anchor outside the mask
    gt[1, 0] = [0.5, 0.5, 0.4, 0.5]
    gt[1, 1] = [0.12, 0.88, 0.05, 0.08]
    label = np.array([[1, 2, 0, 1, 0], [2, 0, 0, 0, 0]], np.int32)
    score = _u((N, 5), 11, 0.5, 1.0)
    return x, gt, label, score


NMS_BX, NMS_SC = _nms_inputs()
YX, YGT, YLBL, YSC = _yolo_inputs()
PRIORS = _boxes((30, 4), 20, 0.0, 0.9, 0.05)
ROIS = np.concatenate([_boxes((6, 4), 30, 0.0, 14.0, 1.0)], 0)
RBID = np.array([0, 1, 1, 0, 1, 0], np.int32)

# case -> (op, inputs, outputs, attrs, cotangents, floating inputs with no grad)
CASES = {
    "prior_box": ("prior_box", {"Input": {"f": np.zeros((1, 4, 3, 5), np.float32)},
                                "Image": {"i": np.zeros((1, 3, 30, 50), np.float32)}},
                  {"Boxes": ["b"], "Variances": ["v"]},
                  {"min_sizes": [8.0, 16.0], "max_sizes": [16.0, 30.0],
                   "aspect_ratios": [2.0, 3.0], "flip": True, "clip": True},
                  {}, ("f", "i")),
    "box_coder_encode": ("box_coder", {"PriorBox": {"p": PRIORS},
                                       "PriorBoxVar": {"pv": _u((30, 4), 21, 0.1, 0.3)},
                                       "TargetBox": {"t": _boxes((7, 4), 22)}},
                         {"OutputBox": ["o"]}, {"code_type": "encode_center_size"},
                         {}, ("p", "pv", "t")),
    "box_coder_decode_pixels": ("box_coder",
                                {"PriorBox": {"p": 40 * PRIORS},
                                 "TargetBox": {"t": _r((3, 30, 4), 23, 0.3)}},
                                {"OutputBox": ["o"]},
                                {"code_type": "decode_center_size",
                                 "box_normalized": False}, {}, ("p", "t")),
    "iou_similarity": ("iou_similarity", {"X": {"x": _boxes((5, 4), 24)},
                                          "Y": {"y": _boxes((7, 4), 25)}},
                       {"Out": ["o"]}, {}, {}, ("x", "y")),
    "multiclass_nms": ("multiclass_nms", {"BBoxes": {"b": NMS_BX},
                                          "Scores": {"s": NMS_SC}},
                       {"Out": ["o"]},
                       {"score_threshold": 0.1, "nms_threshold": 0.4,
                        "nms_top_k": 8, "keep_top_k": 30,
                        "background_label": 0}, {}, ("b", "s")),
    "multiclass_nms_all_classes": ("multiclass_nms",
                                   {"BBoxes": {"b": 50 * NMS_BX},
                                    "Scores": {"s": NMS_SC}},
                                   {"Out": ["o"]},
                                   {"score_threshold": 0.3, "nms_threshold": 0.3,
                                    "nms_top_k": -1, "keep_top_k": 10,
                                    "background_label": -1, "normalized": False},
                                   {}, ("b", "s")),
    "multiclass_nms_keep_all": ("multiclass_nms",
                                {"BBoxes": {"b": NMS_BX[:, :4]},
                                 "Scores": {"s": NMS_SC[:, :, :4]}},
                                {"Out": ["o"]},
                                {"score_threshold": 0.05, "nms_threshold": 0.5,
                                 "nms_top_k": 3, "keep_top_k": -1}, {}, ("b", "s")),
    "ssd_loss": ("ssd_loss", {"Loc": {"l": _r((2, 30, 4), 26, 0.5)},
                              "Conf": {"c": _r((2, 30, 4), 27)},
                              "GTBox": {"g": _boxes((2, 3, 4), 28, 0.0, 0.8, 0.1)},
                              "GTLabel": {"gl": np.array([[[1], [3], [2]], [[2], [1], [0]]],
                                                         np.int32)},
                              "GTCount": {"gc": np.array([3, 2], np.int32)},
                              "PriorBox": {"p": PRIORS},
                              "PriorBoxVar": {"pv": np.tile(np.array(
                                  [0.1, 0.1, 0.2, 0.2], np.float32), (30, 1))}},
                 {"Loss": ["o"]}, {"overlap_threshold": 0.3, "neg_overlap": 0.3},
                 {"o": _r((2, 1), 29)}, ("g", "p", "pv")),
    "roi_align": ("roi_align", {"X": {"x": _r((2, 3, 8, 9), 31)},
                                "ROIs": {"r": ROIS},
                                "RoisBatchId": {"b": RBID}},
                  {"Out": ["o"]},
                  {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 0.5,
                   "sampling_ratio": 2}, {"o": _r((6, 3, 3, 2), 32)}, ("r",)),
    "roi_align_default_ratio": ("roi_align", {"X": {"x": _r((1, 2, 6, 7), 33)},
                                              "ROIs": {"r": ROIS[:3] / 2}},
                                {"Out": ["o"]},
                                {"pooled_height": 2, "pooled_width": 2},
                                {"o": _r((3, 2, 2, 2), 34)}, ("r",)),
    "roi_pool": ("roi_pool", {"X": {"x": _r((2, 3, 8, 9), 35)},
                              "ROIs": {"r": ROIS}, "RoisBatchId": {"b": RBID}},
                 {"Out": ["o"]},
                 {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 0.5},
                 {"o": _r((6, 3, 3, 2), 36)}, ("r",)),
    # RoIs whose extents are exact multiples of the bins: a bound's floor
    # or ceil then depends on how the division rounds (XLA: a reciprocal
    # multiply, and a fused multiply-add)
    "roi_pool_exact_bins": ("roi_pool", {"X": {"x": _r((1, 2, 16, 24), 45)},
                                         "ROIs": {"r": np.array([[0, 0, 20, 13],
                                                                 [2, 1, 22, 14]],
                                                                np.float32)}},
                            {"Out": ["o"]},
                            {"pooled_height": 7, "pooled_width": 7,
                             "spatial_scale": 1.0}, {"o": _r((2, 2, 7, 7), 46)},
                            ("r",)),
    "psroi_pool_exact_bins": ("psroi_pool",
                              {"X": {"x": _r((1, 2 * 49, 30, 30), 47)},
                               "ROIs": {"r": np.array([[47.28, 375.72, 360.77, 440.13]],
                                                      np.float32)}},
                              {"Out": ["o"]},
                              {"output_channels": 2, "pooled_height": 7,
                               "pooled_width": 7, "spatial_scale": 1 / 16},
                              {"o": _r((1, 2, 7, 7), 48)}, ("r",)),
    "yolo_box": ("yolo_box", {"X": {"x": _r((2, 2 * 8, 3, 4), 37)},
                              "ImgSize": {"s": np.array([[96, 128], [80, 120]],
                                                        np.int32)}},
                 {"Boxes": ["b"], "Scores": ["s_"]},
                 {"anchors": [10, 13, 16, 30], "class_num": 3,
                  "conf_thresh": 0.4, "downsample_ratio": 32}, {}, ("x",)),
    "anchor_generator": ("anchor_generator",
                         {"Input": {"f": np.zeros((1, 4, 3, 5), np.float32)}},
                         {"Anchors": ["a"], "Variances": ["v"]},
                         {"anchor_sizes": [32.0, 64.0],
                          "aspect_ratios": [0.5, 1.0, 2.0],
                          "stride": [16.0, 16.0]}, {}, ("f",)),
    "bipartite_match": ("bipartite_match",
                        {"DistMat": {"d": np.round(_u((2, 4, 7), 38, 0.0, 1.0), 1)}},
                        {"ColToRowMatchIndices": ["i"], "ColToRowMatchDist": ["d_"]},
                        {}, {}, ("d",)),
    "density_prior_box": ("density_prior_box",
                          {"Input": {"f": np.zeros((1, 4, 3, 4), np.float32)},
                           "Image": {"i": np.zeros((1, 3, 48, 64), np.float32)}},
                          {"Boxes": ["b"], "Variances": ["v"]},
                          {"densities": [2, 1], "fixed_sizes": [16.0, 32.0],
                           "fixed_ratios": [1.0, 2.0], "clip": True}, {},
                          ("f", "i")),
    "generate_proposals": ("generate_proposals",
                           {"Scores": {"s": _r((2, 3, 4, 5), 39)},
                            "BboxDeltas": {"d": _r((2, 12, 4, 5), 40, 0.2)},
                            "ImInfo": {"n": np.array([[64.0, 80.0, 1.0],
                                                      [60.0, 70.0, 1.0]], np.float32)},
                            "Anchors": {"a": np.tile(np.array(
                                [-8.0, -8.0, 23.0, 23.0], np.float32), (4, 5, 3, 1))
                                + np.concatenate([np.stack(np.meshgrid(
                                    16 * np.arange(5), 16 * np.arange(4)), -1)] * 2,
                                    -1)[:, :, None].astype(np.float32)},
                            "Variances": {"v": np.ones((4, 5, 3, 4), np.float32)}},
                           {"RpnRois": ["r"], "RpnRoiProbs": ["p"]},
                           {"pre_nms_topN": 40, "post_nms_topN": 12,
                            "nms_thresh": 0.5, "min_size": 2.0}, {},
                           ("s", "d", "n", "a", "v")),
    "yolov3_loss": ("yolov3_loss", {"X": {"x": YX}, "GTBox": {"g": YGT},
                                    "GTLabel": {"l": YLBL}, "GTScore": {"gs": YSC}},
                    {"Loss": ["o"], "ObjectnessMask": ["m"], "GTMatchMask": ["k"]},
                    {"anchors": [10, 13, 16, 30, 33, 23, 30, 61, 62, 45],
                     "anchor_mask": [0, 1], "class_num": 3, "ignore_thresh": 0.5,
                     "downsample_ratio": 32, "use_label_smooth": True},
                    {"o": _r((2,), 41)}, ()),
    "yolov3_loss_no_score": ("yolov3_loss", {"X": {"x": YX}, "GTBox": {"g": YGT},
                                             "GTLabel": {"l": YLBL}},
                             {"Loss": ["o"], "ObjectnessMask": ["m"],
                              "GTMatchMask": ["k"]},
                             {"anchors": [10, 13, 16, 30, 33, 23],
                              "anchor_mask": [1, 2], "class_num": 3,
                              "ignore_thresh": 0.3, "downsample_ratio": 16,
                              "use_label_smooth": False},
                             {"o": _r((2,), 42)}, ("g",)),
    "psroi_pool": ("psroi_pool", {"X": {"x": _r((2, 2 * 2 * 3, 7, 8), 43)},
                                  "ROIs": {"r": ROIS},
                                  "RoisBatch": {"b": RBID}},
                   {"Out": ["o"]},
                   {"output_channels": 2, "pooled_height": 2, "pooled_width": 3,
                    "spatial_scale": 0.5}, {"o": _r((6, 2, 2, 3), 44)}, ("r",)),
}


def _both(case):
    op, ins, outs, attrs, cots, nograd = CASES[case]
    jo, jg, _ = op_outputs_and_grads(J, op, ins, outs, attrs, cots, nograd)
    to, tg, _ = op_outputs_and_grads(T, op, ins, outs, attrs, cots, nograd)
    return jo, jg, to, tg


@pytest.mark.parametrize("case", sorted(CASES))
def test_detection_op_matches_jax(case):
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


def test_multiclass_nms_ties_and_padding_rows():
    """The tie order (lower index first) and the padding rows (label -1,
    score -1, the box JAX's top_k lands on) equal the JAX op's row for
    row; the case keeps fewer than keep_top_k."""
    jo, _, to, _ = _both("multiclass_nms")
    j, t = jo["o"], to["o"]
    np.testing.assert_array_equal(t, j)
    pad = j[..., 0] < 0
    assert pad.any() and (~pad).any()
    assert (t[pad][:, 1] == -1).all()
    scores = t[~pad][:, 1]
    assert len(set(scores.tolist())) < len(scores)   # ties among the kept


def test_yolov3_loss_later_gt_wins_a_shared_cell():
    """gts 0 and 1 of image 0 share a cell and anchor: the objectness
    target there is gt 1's score, and both train location and class."""
    jo, jg, to, tg = _both("yolov3_loss")
    H = W = 4
    gi, gj = int(0.3 * W), int(0.4 * H)
    np.testing.assert_array_equal(to["k"], jo["k"])
    assert to["k"][0, 0] == to["k"][0, 1] >= 0
    assert to["m"][0, to["k"][0, 0], gj, gi] == np.float32(YSC[0, 1])
    assert to["k"][0, 3] == -1                       # its anchor is not masked
    close([tg["gs"]], [jg["gs"]], what="dGTScore")


# -- tests/test_detection.py on the port --------------------------------------


def _run(fn, feed, n_fetch=1):
    main, startup, outs = build(T, lambda p: fn(p["L"]))
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    exe, scope = T["exe"](), T["scope"]()
    exe.run(startup, scope=scope)
    return [np.asarray(v) for v in exe.run(
        main, feed=feed, fetch_list=[o.name for o in outs[:n_fetch]],
        scope=scope)]


def test_prior_box_count_and_geometry():
    def fn(L):
        feat = L.data(name="feat", shape=[8, 2, 2], dtype="float32")
        img = L.data(name="img", shape=[3, 32, 32], dtype="float32")
        return L.prior_box(feat, img, min_sizes=[8.0], max_sizes=[16.0],
                           aspect_ratios=[2.0], flip=True)

    b, v = _run(fn, {"feat": np.zeros((1, 8, 2, 2), np.float32),
                     "img": np.zeros((1, 3, 32, 32), np.float32)}, 2)
    assert b.shape == (2, 2, 4, 4) and v.shape == b.shape
    np.testing.assert_allclose(b[0, 0, 0], [4 / 32, 4 / 32, 12 / 32, 12 / 32],
                               atol=1e-6)
    s = np.sqrt(8.0 * 16.0) / 2
    np.testing.assert_allclose(
        b[0, 0, 1], [(8 - s) / 32, (8 - s) / 32, (8 + s) / 32, (8 + s) / 32],
        atol=1e-5)


def test_box_coder_encode_decode_roundtrip():
    priors = np.array([[0.1, 0.1, 0.4, 0.5], [0.3, 0.2, 0.9, 0.8]], np.float32)
    gts = np.array([[0.15, 0.12, 0.45, 0.47]], np.float32)

    def fn(L):
        pb = L.data(name="pb", shape=[2, 4], dtype="float32",
                    append_batch_size=False)
        gt = L.data(name="gt", shape=[1, 4], dtype="float32",
                    append_batch_size=False)
        enc = L.box_coder(pb, None, gt, code_type="encode_center_size")
        return [enc, L.box_coder(pb, None, enc, code_type="decode_center_size")]

    e, d = _run(fn, {"pb": priors, "gt": gts}, 2)
    assert e.shape == (1, 2, 4)
    np.testing.assert_allclose(d[0, 0], gts[0], atol=1e-5)
    np.testing.assert_allclose(d[0, 1], gts[0], atol=1e-5)


def test_iou_similarity_values():
    a = np.array([[0, 0, 2, 2]], np.float32)
    b = np.array([[0, 0, 2, 2], [1, 1, 3, 3], [5, 5, 6, 6]], np.float32)

    def fn(L):
        x = L.data(name="x", shape=[1, 4], dtype="float32", append_batch_size=False)
        y = L.data(name="y", shape=[3, 4], dtype="float32", append_batch_size=False)
        return L.iou_similarity(x, y)

    (got,) = _run(fn, {"x": a, "y": b})
    np.testing.assert_allclose(got[0], [1.0, 1.0 / 7.0, 0.0], rtol=1e-5)


def test_multiclass_nms_suppresses_overlaps():
    boxes = np.array([[[0.1, 0.1, 0.4, 0.4], [0.11, 0.11, 0.41, 0.41],
                       [0.6, 0.6, 0.9, 0.9]]], np.float32)
    scores = np.array([[[0.0, 0.0, 0.0], [0.9, 0.8, 0.7]]], np.float32)

    def fn(L):
        bb = L.data(name="bb", shape=[3, 4], dtype="float32")
        sc = L.data(name="sc", shape=[2, 3], dtype="float32")
        return L.multiclass_nms(bb, sc, score_threshold=0.1, nms_top_k=10,
                                keep_top_k=3, nms_threshold=0.5)

    (got,) = _run(fn, {"bb": boxes, "sc": scores})
    kept = got[0, :, 0] >= 0
    assert kept.sum() == 2, got[0]
    np.testing.assert_allclose(sorted(got[0, kept, 1].tolist(), reverse=True),
                               [0.9, 0.7], rtol=1e-5)


def test_ssd_loss_trains_toy_detector():
    M, C, G = 8, 3, 2
    priors = np.stack(np.meshgrid(np.linspace(0.1, 0.7, 4), [0.2, 0.6]),
                      -1).reshape(-1, 2)
    priors = np.concatenate([priors, priors + 0.25], 1).astype(np.float32)

    def fn(L):
        pt = T["pt"]
        feat = L.data(name="feat", shape=[16], dtype="float32")
        loc = L.reshape(L.fc(feat, size=M * 4, name="loc"), [-1, M, 4])
        conf = L.reshape(L.fc(feat, size=M * C, name="conf"), [-1, M, C])
        pb = L.data(name="pb", shape=[M, 4], dtype="float32",
                    append_batch_size=False)
        gtb = L.data(name="gtb", shape=[G, 4], dtype="float32")
        gtl = L.data(name="gtl", shape=[G, 1], dtype="int64")
        gtc = L.data(name="gtc", shape=[], dtype="int64")
        loss = L.mean(L.ssd_loss(loc, conf, gtb, gtl, pb, gt_count=gtc))
        pt.optimizer.Adam(0.01).minimize(loss)
        return loss

    main, startup, loss = build(T, lambda p: fn(p["L"]))
    exe, scope = T["exe"](), T["scope"]()
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(40):
        B = 8
        gt = np.tile(priors[0], (B, G, 1)).astype(np.float32)
        gt += rng.uniform(-0.02, 0.02, gt.shape).astype(np.float32)
        (lv,) = exe.run(main, feed={
            "feat": rng.standard_normal((B, 16)).astype(np.float32),
            "pb": priors, "gtb": gt, "gtl": np.full((B, G, 1), 1, np.int64),
            "gtc": np.full((B,), 1, np.int64)}, fetch_list=[loss.name],
            scope=scope)
        losses.append(float(lv))
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0] * 0.8, losses


def _np_yolov3_loss(x, gt_box, gt_label, anchors, mask, class_num,
                    ignore_thresh, downsample, use_smooth=True):
    """tests/test_detection.py's direct numpy port of the reference
    yolov3_loss_op.h."""
    def sce(v, t):
        return max(v, 0.0) - v * t + np.log1p(np.exp(-abs(v)))

    N, _, H, W = x.shape
    an_num = len(anchors) // 2
    mask_num = len(mask)
    B = gt_box.shape[1]
    input_size = downsample * H
    pos_l, neg_l = 1.0, 0.0
    if use_smooth:
        d = min(1.0 / class_num, 1.0 / 40)
        pos_l, neg_l = 1.0 - d, d
    xr = x.reshape(N, mask_num, 5 + class_num, H, W)
    loss = np.zeros(N)
    obj_mask = np.zeros((N, mask_num, H, W))

    def iou(b1, b2):
        ow = min(b1[0] + b1[2] / 2, b2[0] + b2[2] / 2) - \
            max(b1[0] - b1[2] / 2, b2[0] - b2[2] / 2)
        oh = min(b1[1] + b1[3] / 2, b2[1] + b2[3] / 2) - \
            max(b1[1] - b1[3] / 2, b2[1] - b2[3] / 2)
        inter = 0.0 if (ow < 0 or oh < 0) else ow * oh
        return inter / (b1[2] * b1[3] + b2[2] * b2[3] - inter + 1e-10)

    for i in range(N):
        for j in range(mask_num):
            for k in range(H):
                for l in range(W):
                    px = (l + 1 / (1 + np.exp(-xr[i, j, 0, k, l]))) / W
                    py = (k + 1 / (1 + np.exp(-xr[i, j, 1, k, l]))) / H
                    pw = np.exp(xr[i, j, 2, k, l]) * anchors[2 * mask[j]] / input_size
                    ph = np.exp(xr[i, j, 3, k, l]) * anchors[2 * mask[j] + 1] / input_size
                    best = 0.0
                    for t in range(B):
                        if gt_box[i, t, 2] <= 1e-6 or gt_box[i, t, 3] <= 1e-6:
                            continue
                        best = max(best, iou((px, py, pw, ph), gt_box[i, t]))
                    if best > ignore_thresh:
                        obj_mask[i, j, k, l] = -1
        for t in range(B):
            if gt_box[i, t, 2] <= 1e-6 or gt_box[i, t, 3] <= 1e-6:
                continue
            gi = int(gt_box[i, t, 0] * W)
            gj = int(gt_box[i, t, 1] * H)
            best_iou, best_n = 0.0, 0
            for a in range(an_num):
                ab = (0, 0, anchors[2 * a] / input_size,
                      anchors[2 * a + 1] / input_size)
                v = iou(ab, (0, 0, gt_box[i, t, 2], gt_box[i, t, 3]))
                if v > best_iou:
                    best_iou, best_n = v, a
            if best_n not in mask:
                continue
            mj = mask.index(best_n)
            tx = gt_box[i, t, 0] * W - gi
            ty = gt_box[i, t, 1] * H - gj
            tw = np.log(gt_box[i, t, 2] * input_size / anchors[2 * best_n])
            th = np.log(gt_box[i, t, 3] * input_size / anchors[2 * best_n + 1])
            s = 2.0 - gt_box[i, t, 2] * gt_box[i, t, 3]
            loss[i] += (sce(xr[i, mj, 0, gj, gi], tx)
                        + sce(xr[i, mj, 1, gj, gi], ty)
                        + abs(xr[i, mj, 2, gj, gi] - tw)
                        + abs(xr[i, mj, 3, gj, gi] - th)) * s
            obj_mask[i, mj, gj, gi] = 1.0
            for c in range(class_num):
                tgt = pos_l if c == gt_label[i, t] else neg_l
                loss[i] += sce(xr[i, mj, 5 + c, gj, gi], tgt)
        for j in range(mask_num):
            for k in range(H):
                for l in range(W):
                    o = obj_mask[i, j, k, l]
                    if o > 1e-5:
                        loss[i] += sce(xr[i, j, 4, k, l], 1.0) * o
                    elif o > -0.5:
                        loss[i] += sce(xr[i, j, 4, k, l], 0.0)
    return loss


def test_yolov3_loss_matches_reference_port():
    rng = np.random.default_rng(0)
    N, H, W, class_num = 2, 4, 4, 3
    anchors = [10, 13, 16, 30, 33, 23]
    mask = [0, 1]
    x = rng.standard_normal((N, len(mask) * (5 + class_num), H, W)).astype(np.float32)
    gt_box = np.array([[[0.3, 0.4, 0.2, 0.3], [0.7, 0.2, 0.1, 0.1],
                        [0.0, 0.0, 0.0, 0.0]],
                       [[0.5, 0.5, 0.4, 0.5], [0.0, 0.0, 0.0, 0.0],
                        [0.0, 0.0, 0.0, 0.0]]], np.float32)
    gt_label = np.array([[1, 2, 0], [0, 0, 0]], np.int64)

    def fn(L):
        xv = L.data(name="x", shape=list(x.shape[1:]), dtype="float32")
        gb = L.data(name="gb", shape=[3, 4], dtype="float32")
        gl = L.data(name="gl", shape=[3], dtype="int64")
        return L.yolov3_loss(xv, gb, gl, anchors, mask, class_num,
                             ignore_thresh=0.7, downsample_ratio=32)

    (out,) = _run(fn, {"x": x, "gb": gt_box, "gl": gt_label})
    expect = _np_yolov3_loss(x.astype(np.float64), gt_box, gt_label, anchors,
                             mask, class_num, 0.7, 32)
    np.testing.assert_allclose(out, expect, rtol=2e-4, atol=2e-4)


def test_yolov3_loss_trains():
    rng = np.random.default_rng(1)
    anchors, mask, class_num = [10, 13, 16, 30], [0, 1], 2
    img = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    gt_box = np.array([[[0.4, 0.4, 0.3, 0.3]], [[0.6, 0.6, 0.2, 0.4]]], np.float32)

    def fn(L):
        iv = L.data(name="img", shape=[3, 32, 32], dtype="float32")
        gb = L.data(name="gb", shape=[1, 4], dtype="float32")
        gl = L.data(name="gl", shape=[1], dtype="int64")
        feat = L.conv2d(iv, num_filters=len(mask) * (5 + class_num),
                        filter_size=3, stride=32, padding=1, act=None)
        loss = L.reduce_mean(L.yolov3_loss(feat, gb, gl, anchors, mask,
                                           class_num, 0.7, 32))
        T["pt"].optimizer.SGD(0.01).minimize(loss)
        return loss

    main, startup, loss = build(T, lambda p: fn(p["L"]))
    exe, scope = T["exe"](), T["scope"]()
    exe.run(startup, scope=scope)
    feed = {"img": img, "gb": gt_box, "gl": np.zeros((2, 1), np.int64)}
    first = float(exe.run(main, feed=feed, fetch_list=[loss.name], scope=scope)[0])
    for _ in range(10):
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss.name], scope=scope)
    assert float(lv) < first


def test_yolo_box_decodes_center_box():
    N, H, W, cls = 1, 2, 2, 1
    x = np.zeros((N, 5 + cls, H, W), np.float32)
    x[0, 4] = 5.0
    x[0, 5] = 5.0

    def fn(L):
        xv = L.data(name="x", shape=[5 + cls, H, W], dtype="float32")
        sz = L.data(name="sz", shape=[2], dtype="int64")
        return list(L.yolo_box(xv, sz, [32, 32], cls, 0.01, 32))

    boxes, scores = _run(fn, {"x": x, "sz": np.array([[64, 64]], np.int64)}, 2)
    np.testing.assert_allclose(boxes[0, 0], [0.0, 0.0, 31.0, 31.0], atol=1.5)
    assert scores[0, 0, 0] > 0.9


def test_psroi_pool_average_bins():
    O, ph, pw = 2, 2, 2
    x = np.zeros((1, O * ph * pw, 4, 4), np.float32)
    for c in range(O * ph * pw):
        x[0, c] = c

    def fn(L):
        xv = L.data(name="x", shape=[O * ph * pw, 4, 4], dtype="float32")
        rv = L.data(name="r", shape=[4], dtype="float32", append_batch_size=False)
        return L.psroi_pool(xv, rv, O, 1.0, ph, pw)

    (out,) = _run(fn, {"x": x, "r": np.array([[0.0, 0.0, 3.0, 3.0]], np.float32)})
    assert out.shape == (1, O, ph, pw)
    for o in range(O):
        for i in range(ph):
            for j in range(pw):
                assert out[0, o, i, j] == o * 4 + i * 2 + j


def test_anchor_generator_and_density_prior_box_run():
    def fn(L):
        f = L.data(name="f", shape=[8, 4, 4], dtype="float32")
        img = L.data(name="img", shape=[3, 64, 64], dtype="float32")
        a, _ = L.anchor_generator(f, anchor_sizes=[64.0], aspect_ratios=[1.0],
                                  stride=[16.0, 16.0])
        b, _ = L.density_prior_box(f, img, densities=[2], fixed_sizes=[32.0],
                                   fixed_ratios=[1.0])
        return [a, b]

    a, b = _run(fn, {"f": np.zeros((1, 8, 4, 4), np.float32),
                     "img": np.zeros((1, 3, 64, 64), np.float32)}, 2)
    assert a.shape == (4, 4, 1, 4)
    assert b.shape[:2] == (4, 4) and b.shape[-1] == 4
    np.testing.assert_allclose(a[0, 0, 0], [-24.0, -24.0, 39.0, 39.0], atol=1e-4)


def test_generate_proposals_runs():
    rng = np.random.default_rng(2)
    N, A, H, W = 1, 3, 4, 4

    def fn(L):
        s = L.data(name="s", shape=[A, H, W], dtype="float32")
        d = L.data(name="d", shape=[A * 4, H, W], dtype="float32")
        info = L.data(name="info", shape=[3], dtype="float32")
        f = L.data(name="f", shape=[8, H, W], dtype="float32")
        anc, var = L.anchor_generator(f, anchor_sizes=[32.0],
                                      aspect_ratios=[0.5, 1.0, 2.0],
                                      stride=[16.0, 16.0])
        return list(L.generate_proposals(s, d, info, anc, var, pre_nms_top_n=12,
                                         post_nms_top_n=5, nms_thresh=0.7,
                                         min_size=4.0))

    rois, probs = _run(fn, {
        "s": rng.standard_normal((N, A, H, W)).astype(np.float32),
        "d": 0.1 * rng.standard_normal((N, A * 4, H, W)).astype(np.float32),
        "info": np.array([[64.0, 64.0, 1.0]], np.float32),
        "f": np.zeros((N, 8, H, W), np.float32)}, 2)
    assert rois.shape[-1] == 4
    assert np.isfinite(rois).all() and np.isfinite(probs).all()
