"""Detection ops (the JAX package's detection_ops.py): SSD and density
priors, RPN anchors, center-size box coding, IoU, bipartite matching, the
SSD loss, RoI align / max / position-sensitive pooling, RPN proposals, and
YOLOv3's box decoding and loss, with the multiclass NMS after them.

Every op is fixed-shape, as in the JAX package: NMS returns
[N, keep_top_k, 6] rows padded with label -1, proposals [N, post_nms_topN,
4] padded with zeros. No op reads the device from the host: the greedy
suppressions (multiclass_nms, generate_proposals, bipartite_match) run as
a fixed number of device steps, batched over every image (and class).
Sorts are stable, so ties resolve to the lower index, as jnp.argsort and
lax.top_k do. Grads are derived by replay (ops/registry.py)."""
from __future__ import annotations

import math

import numpy as np
import torch

from .registry import ExecContext, register_op


def _f32(ctx, name, values):
    """A float32 table from the attrs on the op's device (made once)."""
    return ctx.const(name, np.asarray(values, np.float32).tolist())


@register_op("prior_box", grad="none")
def prior_box(ctx: ExecContext):
    """SSD prior boxes: one box per (min_size, aspect_ratio) plus the
    sqrt(min*max) box, centred on each feature cell, normalized to the
    image. Boxes and Variances [H, W, P, 4]."""
    feat, img = ctx.input("Input"), ctx.input("Image")
    H, W = feat.shape[2], feat.shape[3]
    IH, IW = img.shape[2], img.shape[3]
    min_sizes = [float(s) for s in ctx.attr("min_sizes")]
    max_sizes = [float(s) for s in ctx.attr("max_sizes", []) or []]
    ars = [float(a) for a in ctx.attr("aspect_ratios", [1.0]) or [1.0]]
    flip = bool(ctx.attr("flip", False))
    clip = bool(ctx.attr("clip", False))
    variances = [float(v) for v in ctx.attr("variances", [0.1, 0.1, 0.2, 0.2])]
    step_w = float(ctx.attr("step_w", 0.0)) or IW / W
    step_h = float(ctx.attr("step_h", 0.0)) or IH / H
    offset = float(ctx.attr("offset", 0.5))
    # ExpandAspectRatios: 1.0 first, then each ratio (and its flip), deduped
    ratios = [1.0]
    for ar in ars:
        if all(abs(ar - r) > 1e-6 for r in ratios):
            ratios.append(ar)
            if flip:
                ratios.append(1.0 / ar)
    whs = []
    for k, ms in enumerate(min_sizes):
        for ar in ratios:
            whs.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
            if abs(ar - 1.0) < 1e-6 and max_sizes:
                big = np.sqrt(ms * max_sizes[k])
                whs.append((big, big))
    P = len(whs)
    wh = _f32(ctx, "wh", whs)                                # [P, 2]
    dev = wh.device
    cx = (torch.arange(W, dtype=torch.float32, device=dev) + offset) * step_w
    cy = (torch.arange(H, dtype=torch.float32, device=dev) + offset) * step_h
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")         # [H, W]
    cxg, cyg = cxg[..., None], cyg[..., None]
    half_w = wh[None, None, :, 0] / 2
    half_h = wh[None, None, :, 1] / 2
    boxes = torch.stack([(cxg - half_w) / IW, (cyg - half_h) / IH,
                         (cxg + half_w) / IW, (cyg + half_h) / IH], dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = _f32(ctx, "var", variances).expand(H, W, P, 4)
    return {"Boxes": boxes, "Variances": var}


@register_op("box_coder", grad="none")
def box_coder(ctx: ExecContext):
    """Center-size box encode/decode. PriorBox [M, 4], PriorBoxVar [M, 4]
    or none, TargetBox [N, 4] to encode, [N, M, 4] to decode."""
    prior = ctx.input("PriorBox")
    pvar = ctx.input("PriorBoxVar")
    target = ctx.input("TargetBox")
    code_type = str(ctx.attr("code_type", "encode_center_size"))
    eps = 0.0 if bool(ctx.attr("box_normalized", True)) else 1.0
    pw = prior[:, 2] - prior[:, 0] + eps
    ph = prior[:, 3] - prior[:, 1] + eps
    pcx = prior[:, 0] + pw / 2
    pcy = prior[:, 1] + ph / 2
    if pvar is None:
        pvar = torch.ones_like(prior)
    if code_type.startswith("encode"):
        tw = target[:, 2] - target[:, 0] + eps
        th = target[:, 3] - target[:, 1] + eps
        tcx = target[:, 0] + tw / 2
        tcy = target[:, 1] + th / 2
        ox = (tcx[:, None] - pcx[None, :]) / pw[None, :] / pvar[None, :, 0]
        oy = (tcy[:, None] - pcy[None, :]) / ph[None, :] / pvar[None, :, 1]
        ow = torch.log(tw[:, None] / pw[None, :]) / pvar[None, :, 2]
        oh = torch.log(th[:, None] / ph[None, :]) / pvar[None, :, 3]
        return {"OutputBox": torch.stack([ox, oy, ow, oh], dim=-1)}
    ox = target[..., 0] * pvar[None, :, 0] * pw[None, :] + pcx[None, :]
    oy = target[..., 1] * pvar[None, :, 1] * ph[None, :] + pcy[None, :]
    ow = torch.exp(target[..., 2] * pvar[None, :, 2]) * pw[None, :]
    oh = torch.exp(target[..., 3] * pvar[None, :, 3]) * ph[None, :]
    return {"OutputBox": torch.stack(
        [ox - ow / 2, oy - oh / 2, ox + ow / 2 - eps, oy + oh / 2 - eps],
        dim=-1)}


def _encode_center_size(prior, pvar, boxes, eps=0.0):
    """box_coder's encode of boxes [..., M, 4] matched a prior each."""
    pw = prior[:, 2] - prior[:, 0] + eps
    ph = prior[:, 3] - prior[:, 1] + eps
    pcx = prior[:, 0] + pw / 2
    pcy = prior[:, 1] + ph / 2
    gw = boxes[..., 2] - boxes[..., 0] + eps
    gh = boxes[..., 3] - boxes[..., 1] + eps
    gcx = boxes[..., 0] + gw / 2
    gcy = boxes[..., 1] + gh / 2
    tx = (gcx - pcx) / pw / pvar[:, 0]
    ty = (gcy - pcy) / ph / pvar[:, 1]
    tw = torch.log(torch.clamp_min(gw / pw, 1e-8)) / pvar[:, 2]
    th = torch.log(torch.clamp_min(gh / ph, 1e-8)) / pvar[:, 3]
    return torch.stack([tx, ty, tw, th], dim=-1)


def _iou(a, b, eps=0.0):
    """Pairwise IoU of a [..., N, 4] and b [..., M, 4] -> [..., N, M];
    eps=1.0 is the reference's +1 convention for pixel boxes."""
    x1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    y1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    x2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    y2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = torch.clamp_min(x2 - x1 + eps, 0) * torch.clamp_min(y2 - y1 + eps, 0)
    area_a = (torch.clamp_min(a[..., 2] - a[..., 0] + eps, 0)
              * torch.clamp_min(a[..., 3] - a[..., 1] + eps, 0))
    area_b = (torch.clamp_min(b[..., 2] - b[..., 0] + eps, 0)
              * torch.clamp_min(b[..., 3] - b[..., 1] + eps, 0))
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


@register_op("iou_similarity", grad="none")
def iou_similarity(ctx: ExecContext):
    """X [N, 4], Y [M, 4] -> [N, M]."""
    return {"Out": _iou(ctx.input("X"), ctx.input("Y"))}


def _nms_pools(scores, boxes, score_thr, nms_thr, top_k, eps):
    """Greedy NMS over every pool at once: scores [P, M], boxes [P, M, 4]
    (P = images x classes) -> keep [P, M] bool. A pool is the top_k
    candidates by score (a stable sort: ties to the lower index), its IoU
    [P, k, k] computed on the pool alone; then k device steps, step i
    keeping candidate i when its score passes score_thr and no kept
    candidate before it overlaps it beyond nms_thr."""
    P, M = scores.shape
    k = min(int(top_k), M) if top_k > 0 else M
    ss, order = torch.sort(scores, dim=1, descending=True, stable=True)
    ss, order = ss[:, :k], order[:, :k]
    pool = boxes.gather(1, order[..., None].expand(P, k, 4))
    over = _iou(pool, pool, eps) > nms_thr                  # [P, k, k]
    valid = ss > score_thr
    kept = torch.zeros((P, k), dtype=torch.bool, device=scores.device)
    if not scores.is_meta:
        for i in range(k):
            sup = (kept & over[:, i]).any(dim=1)
            kept[:, i] = valid[:, i] & ~sup
    full = torch.zeros((P, M), dtype=torch.bool, device=scores.device)
    return full.scatter(1, order, kept)


@register_op("multiclass_nms", grad="none")
def multiclass_nms(ctx: ExecContext):
    """BBoxes [N, M, 4], Scores [N, C, M]: a score threshold and greedy
    IoU suppression a class (nms_top_k candidates), then the keep_top_k
    best over the classes. Out [N, keep_top_k, 6] rows of (label, score,
    x1, y1, x2, y2), label -1 marking padding; a padding row carries the
    box of the candidate the JAX op's top_k lands on there."""
    bboxes, scores = ctx.input("BBoxes"), ctx.input("Scores")
    score_thr = float(ctx.attr("score_threshold", 0.0))
    nms_thr = float(ctx.attr("nms_threshold", 0.3))
    nms_top_k = int(ctx.attr("nms_top_k", 400))
    keep_top_k = int(ctx.attr("keep_top_k", 200))
    bg = int(ctx.attr("background_label", 0))
    eps = 0.0 if bool(ctx.attr("normalized", True)) else 1.0
    N, C, M = scores.shape
    if keep_top_k < 0:
        keep_top_k = C * M
    classes = [c for c in range(C) if c != bg]
    Cn = len(classes)
    sc = (scores if Cn == C else scores.index_select(
        1, ctx.const("classes", classes, torch.long)))
    keep = _nms_pools(sc.reshape(N * Cn, M),
                      bboxes[:, None].expand(N, Cn, M, 4).reshape(N * Cn, M, 4),
                      score_thr, nms_thr, nms_top_k, eps).reshape(N, Cn * M)
    fs = torch.where(keep, sc.reshape(N, Cn * M), torch.full_like(keep, -1.0,
                                                                 dtype=sc.dtype))
    k = min(keep_top_k, Cn * M)
    top_s, top_i = torch.sort(fs, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :k], top_i[:, :k]
    label = ctx.const("labels", [float(c) for c in classes]
                      ).index_select(0, (top_i // M).reshape(-1)).reshape(N, k)
    box = bboxes.gather(1, (top_i % M)[..., None].expand(N, k, 4))
    rows = torch.cat([torch.where(top_s > score_thr, label,
                                  torch.full_like(label, -1.0))[..., None],
                      top_s[..., None], box.to(top_s.dtype)], dim=2)
    if k < keep_top_k:
        rows = torch.cat([rows, torch.full((N, keep_top_k - k, 6), -1.0,
                                           dtype=rows.dtype,
                                           device=rows.device)], dim=1)
    return {"Out": rows}


@register_op("ssd_loss")
def ssd_loss(ctx: ExecContext):
    """The SSD multibox loss in one fixed-shape op. Loc [N, M, 4], Conf
    [N, M, C] logits, GTBox [N, G, 4], GTLabel [N, G, 1], GTCount [N]
    valid rows, PriorBox [M, 4], PriorBoxVar [M, 4] or none. Each prior
    takes its best gt at IoU >= overlap_threshold, each valid gt claims its
    best prior (a later gt wins a shared prior), then max-negative hard
    mining at neg_pos_ratio among the priors below neg_overlap. Loss
    [N, 1]."""
    loc, conf = ctx.input("Loc"), ctx.input("Conf")
    gt_box = ctx.input("GTBox")
    gt_label = ctx.input("GTLabel").reshape(gt_box.shape[0], -1)
    gt_count = ctx.input("GTCount")
    prior, pvar = ctx.input("PriorBox"), ctx.input("PriorBoxVar")
    bg = int(ctx.attr("background_label", 0))
    overlap_thr = float(ctx.attr("overlap_threshold", 0.5))
    neg_overlap = float(ctx.attr("neg_overlap", 0.5))
    neg_ratio = float(ctx.attr("neg_pos_ratio", 3.0))
    loc_w = float(ctx.attr("loc_loss_weight", 1.0))
    conf_w = float(ctx.attr("conf_loss_weight", 1.0))
    normalize = bool(ctx.attr("normalize", True))
    N, M, C = conf.shape
    G = gt_box.shape[1]
    dev = conf.device
    ar_g = torch.arange(G, device=dev)
    if gt_count is None:
        valid_gt = torch.ones((N, G), dtype=torch.bool, device=dev)
    else:
        valid_gt = ar_g[None, :] < gt_count.reshape(-1, 1).to(torch.int32)
    if pvar is None:
        pvar = torch.ones_like(prior)
    iou = _iou(gt_box, prior[None].expand(N, M, 4))         # [N, G, M]
    iou = torch.where(valid_gt[..., None], iou, torch.full_like(iou, -1.0))
    best_prior_per_gt = iou.argmax(dim=2)                   # [N, G]
    best_iou_per_prior = iou.amax(dim=1)                    # [N, M]
    best_gt_per_prior = iou.argmax(dim=1)
    matched = torch.where(best_iou_per_prior >= overlap_thr, best_gt_per_prior,
                          torch.full_like(best_gt_per_prior, -1))
    # the bipartite seeds: the last valid gt naming a prior wins it
    seed = torch.where(valid_gt, best_prior_per_gt, torch.full_like(
        best_prior_per_gt, M))
    winner = torch.full((N, M + 1), -1, dtype=torch.long, device=dev)
    winner = winner.scatter_reduce(1, seed, ar_g[None].expand(N, G),
                                   reduce="amax")[:, :M]
    matched = torch.where(winner >= 0, winner, matched)
    is_pos = matched >= 0
    safe = torch.clamp(matched, 0, G - 1)
    mb = gt_box.gather(1, safe[..., None].expand(N, M, 4))
    d = loc - _encode_center_size(prior, pvar, mb)
    ad = d.abs()
    sl1 = torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5).sum(dim=2)
    loc_loss = torch.where(is_pos, sl1, torch.zeros_like(sl1)).sum(dim=1)
    tgt = torch.where(is_pos, gt_label.gather(1, safe).long(),
                      torch.full_like(safe, bg))
    xent = -torch.log_softmax(conf, dim=-1).gather(2, tgt[..., None])[..., 0]
    n_pos = is_pos.to(torch.int32).sum(dim=1)
    n_neg = torch.minimum((neg_ratio * n_pos.to(torch.float32)).to(torch.int32),
                          M - n_pos)
    cand = (~is_pos) & (best_iou_per_prior < neg_overlap)
    neg_loss = torch.where(cand, xent.detach(), torch.full_like(xent, -math.inf))
    order = torch.sort(neg_loss, dim=1, descending=True, stable=True)[1]
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(M, device=dev)[None].expand(N, M))
    is_neg = cand & (rank < n_neg[:, None])
    conf_loss = torch.where(is_pos | is_neg, xent, torch.zeros_like(xent)).sum(1)
    total = conf_w * conf_loss + loc_w * loc_loss
    if normalize:
        total = total / torch.clamp_min(n_pos.to(conf.dtype), 1.0)
    return {"Loss": total[:, None].to(conf.dtype)}


def _inv(n):
    """1/n in float32, as a Python float: a division by a constant
    compiles to a multiply by this reciprocal in XLA (and in torch's CUDA
    division by a scalar), not in torch on the CPU. A bin's floor or ceil
    at an exact multiple depends on which, so the pools multiply by it on
    every device."""
    return float(np.float32(1.0) / np.float32(n))


def _fma(a, b, c):
    """a + b * c rounded once to float32, as XLA contracts it into a fused
    multiply-add (torch rounds the product first): float64 holds the
    product of two float32s exactly. A bin bound's floor or ceil at an
    exact multiple depends on which."""
    return (a.double() + b.double() * c.double()).float()


def _batch_ids(ctx, slot, R):
    if ctx.has_input(slot):
        return ctx.input(slot).reshape(-1).long()
    return torch.zeros((R,), dtype=torch.long, device=ctx.input("ROIs").device)


@register_op("roi_align")
def roi_align(ctx: ExecContext):
    """RoI Align: the mean of sampling_ratio^2 bilinear samples a bin,
    samples outside [-1, H] x [-1, W] counting zero. ROIs [R, 4] (x1, y1,
    x2, y2) in image coordinates, RoisBatchId [R]. sampling_ratio <= 0
    takes 2 samples a bin axis (the JAX op's static departure from the
    reference's adaptive count)."""
    x, rois = ctx.input("X"), ctx.input("ROIs")
    R = rois.shape[0]
    bid = _batch_ids(ctx, "RoisBatchId", R)
    scale = float(ctx.attr("spatial_scale", 1.0))
    ph = int(ctx.attr("pooled_height", 1))
    pw = int(ctx.attr("pooled_width", 1))
    sr = int(ctx.attr("sampling_ratio", -1))
    sr = sr if sr > 0 else 2
    N, C, H, W = x.shape
    dev = x.device
    r = rois.to(torch.float32) * scale
    x1, y1, x2, y2 = r[:, 0], r[:, 1], r[:, 2], r[:, 3]
    bin_w = torch.clamp_min(x2 - x1, 1.0) * _inv(pw)
    bin_h = torch.clamp_min(y2 - y1, 1.0) * _inv(ph)
    i_s = (torch.arange(sr, dtype=torch.float32, device=dev) + 0.5) * _inv(sr)
    ys = _fma(y1[:, None, None], torch.arange(ph, dtype=torch.float32, device=dev)
              [None, :, None] + i_s[None, None, :], bin_h[:, None, None])
    xs = _fma(x1[:, None, None], torch.arange(pw, dtype=torch.float32, device=dev)
              [None, :, None] + i_s[None, None, :], bin_w[:, None, None])
    val_y = (ys >= -1.0) & (ys <= H)                         # [R, ph, sr]
    val_x = (xs >= -1.0) & (xs <= W)
    ysc, xsc = torch.clamp(ys, 0.0, H - 1), torch.clamp(xs, 0.0, W - 1)
    y0, x0 = torch.floor(ysc), torch.floor(xsc)
    wy, wx = ysc - y0, xsc - x0
    yi0, xi0 = y0.long(), x0.long()
    yi1, xi1 = torch.clamp(yi0 + 1, 0, H - 1), torch.clamp(xi0 + 1, 0, W - 1)
    flat = x.permute(0, 2, 3, 1).reshape(N * H * W, C)

    def g(yy, xx):   # [R, ph, sr, pw, sr, C]
        lin = ((bid[:, None, None, None, None] * H + yy[:, :, :, None, None])
               * W + xx[:, None, None, :, :])
        return flat.index_select(0, lin.reshape(-1)).reshape(
            R, ph, sr, pw, sr, C)

    wy_, wx_ = wy[:, :, :, None, None, None], wx[:, None, None, :, :, None]
    v = (g(yi0, xi0) * ((1 - wy_) * (1 - wx_)) + g(yi1, xi0) * (wy_ * (1 - wx_))
         + g(yi0, xi1) * ((1 - wy_) * wx_) + g(yi1, xi1) * (wy_ * wx_))
    valid = val_y[:, :, :, None, None, None] & val_x[:, None, None, :, :, None]
    v = torch.where(valid, v, torch.zeros_like(v))
    out = v.mean(dim=(2, 4)).permute(0, 3, 1, 2)             # [R, C, ph, pw]
    return {"Out": out.to(x.dtype)}


def _bin_argmax(vals, member):
    """vals [..., L] (the candidates along L), member [..., L] bool: the
    max over the members and its first position, (-1e30, 0) where none."""
    v = torch.where(member, vals, torch.full_like(vals, -1e30))
    best, at = v.max(dim=-1)
    return best, at


@register_op("roi_pool")
def roi_pool(ctx: ExecContext):
    """RoI max pooling over integer bins (the reference's floor / ceil
    bounds on rounded RoIs); an empty bin gives 0. The max's position is
    found without autograd, then gathered, so the gradient reaches the
    bin's maximum element."""
    x, rois = ctx.input("X"), ctx.input("ROIs")
    R = rois.shape[0]
    bid = _batch_ids(ctx, "RoisBatchId", R)
    scale = float(ctx.attr("spatial_scale", 1.0))
    ph = int(ctx.attr("pooled_height", 1))
    pw = int(ctx.attr("pooled_width", 1))
    N, C, H, W = x.shape
    dev = x.device
    r = torch.round(rois.to(torch.float32) * scale)
    x1, y1, x2, y2 = r[:, 0], r[:, 1], r[:, 2], r[:, 3]
    roi_w = torch.clamp_min(x2 - x1 + 1, 1.0)
    roi_h = torch.clamp_min(y2 - y1 + 1, 1.0)
    hs = torch.arange(H, dtype=torch.float32, device=dev)
    ws = torch.arange(W, dtype=torch.float32, device=dev)
    pyi = torch.arange(ph, dtype=torch.float32, device=dev)
    pxi = torch.arange(pw, dtype=torch.float32, device=dev)
    hstart = torch.floor(pyi[None, :] * roi_h[:, None] * _inv(ph)) + y1[:, None]
    hend = torch.ceil((pyi[None, :] + 1) * roi_h[:, None] * _inv(ph)) + y1[:, None]
    wstart = torch.floor(pxi[None, :] * roi_w[:, None] * _inv(pw)) + x1[:, None]
    wend = torch.ceil((pxi[None, :] + 1) * roi_w[:, None] * _inv(pw)) + x1[:, None]
    in_h = (hs >= hstart[..., None]) & (hs < hend[..., None])   # [R, ph, H]
    in_w = (ws >= wstart[..., None]) & (ws < wend[..., None])   # [R, pw, W]
    xf = x.to(torch.float32)
    with torch.no_grad():
        # over w per (roi, c, h, j), then over h per (roi, c, i, j); one
        # image row of every roi at a time keeps the peak at [R, C, pw, W]
        best_w = torch.empty((R, C, H, pw), dtype=torch.float32, device=dev)
        at_w = torch.empty((R, C, H, pw), dtype=torch.long, device=dev)
        for h in range(H):
            rows = xf[:, :, h].index_select(0, bid)              # [R, C, W]
            b, a = _bin_argmax(rows[:, :, None, :], in_w[:, None])
            best_w[:, :, h], at_w[:, :, h] = b, a
        b, ah = _bin_argmax(best_w.permute(0, 1, 3, 2)[:, :, None],
                            in_h[:, None, :, None])           # [R, C, ph, pw]
        aw = at_w.permute(0, 1, 3, 2)[:, :, None].expand(
            R, C, ph, pw, H).gather(4, ah[..., None])[..., 0]
        empty = b <= -1e30 / 2
        lin = (((bid[:, None, None, None] * C
                 + torch.arange(C, device=dev)[None, :, None, None]) * H + ah)
               * W + aw)
    out = xf.reshape(-1).index_select(0, lin.reshape(-1)).reshape(R, C, ph, pw)
    out = torch.where(empty, torch.zeros_like(out), out)
    return {"Out": out.to(x.dtype)}


@register_op("yolo_box", grad="none")
def yolo_box(ctx: ExecContext):
    """YOLOv3 box decoding: X [N, an*(5+cls), H, W], ImgSize [N, 2] (h, w)
    -> Boxes [N, an*H*W, 4] in image pixels (clipped), Scores [N, an*H*W,
    cls] = sigmoid(conf) * sigmoid(class), zeroed where sigmoid(conf) is
    below conf_thresh."""
    x = ctx.input("X")
    img_size = ctx.input("ImgSize").to(torch.float32)
    anchors = [int(a) for a in ctx.attr("anchors")]
    class_num = int(ctx.attr("class_num"))
    conf_thresh = float(ctx.attr("conf_thresh", 0.01))
    downsample = int(ctx.attr("downsample_ratio", 32))
    an = len(anchors) // 2
    N, _, H, W = x.shape
    x = x.reshape(N, an, 5 + class_num, H, W).to(torch.float32)
    dev = x.device
    grid_x = torch.arange(W, dtype=torch.float32, device=dev)[None, None, None, :]
    grid_y = torch.arange(H, dtype=torch.float32, device=dev)[None, None, :, None]
    aw = _f32(ctx, "aw", anchors[0::2])[None, :, None, None]
    ah = _f32(ctx, "ah", anchors[1::2])[None, :, None, None]
    in_h, in_w = H * downsample, W * downsample
    cx = (torch.sigmoid(x[:, :, 0]) + grid_x) / W
    cy = (torch.sigmoid(x[:, :, 1]) + grid_y) / H
    bw = torch.exp(x[:, :, 2]) * aw / in_w
    bh = torch.exp(x[:, :, 3]) * ah / in_h
    conf = torch.sigmoid(x[:, :, 4])
    probs = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None]
    probs = torch.where(conf[:, :, None] < conf_thresh, torch.zeros_like(probs),
                        probs)
    ih = img_size[:, 0][:, None, None, None]
    iw = img_size[:, 1][:, None, None, None]
    x1 = torch.minimum(torch.clamp_min((cx - bw / 2) * iw, 0), iw - 1)
    y1 = torch.minimum(torch.clamp_min((cy - bh / 2) * ih, 0), ih - 1)
    x2 = torch.minimum(torch.clamp_min((cx + bw / 2) * iw, 0), iw - 1)
    y2 = torch.minimum(torch.clamp_min((cy + bh / 2) * ih, 0), ih - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).reshape(N, an * H * W, 4)
    scores = probs.permute(0, 1, 3, 4, 2).reshape(N, an * H * W, class_num)
    return {"Boxes": boxes, "Scores": scores}


@register_op("anchor_generator", grad="none")
def anchor_generator(ctx: ExecContext):
    """RPN anchors: one a (size, ratio) a feature cell, Anchors and
    Variances [H, W, A, 4] (the reference's rounded ratio bases, centres
    at idx*stride + offset*(stride-1), inclusive pixel corners)."""
    feat = ctx.input("Input")
    sizes = [float(s) for s in ctx.attr("anchor_sizes")]
    ratios = [float(r) for r in ctx.attr("aspect_ratios", [1.0]) or [1.0]]
    variances = [float(v) for v in ctx.attr("variances", [0.1, 0.1, 0.2, 0.2])]
    stride = [float(s) for s in ctx.attr("stride")]
    offset = float(ctx.attr("offset", 0.5))
    H, W = feat.shape[2], feat.shape[3]
    base = []
    area = stride[0] * stride[1]
    for r in ratios:
        base_w = round(np.sqrt(area / r))
        base_h = round(base_w * r)
        for s in sizes:
            w = s / stride[0] * base_w
            h = s / stride[1] * base_h
            base.append((-0.5 * (w - 1), -0.5 * (h - 1),
                         0.5 * (w - 1), 0.5 * (h - 1)))
    base = _f32(ctx, "base", base)                           # [A, 4]
    dev = base.device
    cx = (torch.arange(W, dtype=torch.float32, device=dev) * stride[0]
          + offset * (stride[0] - 1))
    cy = (torch.arange(H, dtype=torch.float32, device=dev) * stride[1]
          + offset * (stride[1] - 1))
    gy, gx = torch.meshgrid(cy, cx, indexing="ij")
    ctr = torch.stack([gx, gy, gx, gy], dim=-1)              # [H, W, 4]
    anchors = ctr[:, :, None, :] + base[None, None, :, :]
    var = _f32(ctx, "var", variances).expand(anchors.shape)
    return {"Anchors": anchors, "Variances": var}


@register_op("bipartite_match", grad="none")
def bipartite_match(ctx: ExecContext):
    """Greedy bipartite matching of DistMat [B, R, C] (rows gt, columns
    priors): min(R, C) device steps, each pairing the globally largest
    entry of unused rows and columns (the first in row-major order on a
    tie) when it exceeds 1e-6. ColToRowMatchIndices [B, C] int32 (-1
    unmatched) and ColToRowMatchDist [B, C]."""
    dist = ctx.input("DistMat").to(torch.float32)
    if dist.dim() == 2:
        dist = dist[None]
    B, R, C = dist.shape
    dev = dist.device
    row_used = torch.zeros((B, R), dtype=torch.bool, device=dev)
    col_used = torch.zeros((B, C), dtype=torch.bool, device=dev)
    idx = torch.full((B, C), -1, dtype=torch.int32, device=dev)
    d = torch.zeros((B, C), dtype=torch.float32, device=dev)
    ar_r = torch.arange(R, device=dev)[None]
    ar_c = torch.arange(C, device=dev)[None]
    neg = torch.full_like(dist, -math.inf)
    for _ in range(0 if dist.is_meta else min(R, C)):
        masked = torch.where(row_used[:, :, None] | col_used[:, None, :], neg,
                             dist).reshape(B, R * C)
        flat = masked.argmax(dim=1, keepdim=True)
        val = masked.gather(1, flat)
        r, c = flat // C, flat % C
        valid = val > 1e-6
        hit_c = valid & (ar_c == c)
        idx = torch.where(hit_c, r.to(torch.int32), idx)
        d = torch.where(hit_c, val, d)
        row_used = row_used | (valid & (ar_r == r))
        col_used = col_used | hit_c
    return {"ColToRowMatchIndices": idx, "ColToRowMatchDist": d}


@register_op("density_prior_box", grad="none")
def density_prior_box(ctx: ExecContext):
    """Density prior boxes: for each (fixed_size, density), a density x
    density grid of shifted boxes a cell at each fixed_ratio."""
    feat, img = ctx.input("Input"), ctx.input("Image")
    H, W = feat.shape[2], feat.shape[3]
    IH, IW = img.shape[2], img.shape[3]
    fixed_sizes = [float(s) for s in ctx.attr("fixed_sizes")]
    fixed_ratios = [float(r) for r in ctx.attr("fixed_ratios", [1.0]) or [1.0]]
    densities = [int(d) for d in ctx.attr("densities")]
    variances = [float(v) for v in ctx.attr("variances", [0.1, 0.1, 0.2, 0.2])]
    step_w = float(ctx.attr("step_w", 0.0)) or IW / W
    step_h = float(ctx.attr("step_h", 0.0)) or IH / H
    offset = float(ctx.attr("offset", 0.5))
    clip = bool(ctx.attr("clip", False))
    dev = feat.device
    cx = (torch.arange(W, dtype=torch.float32, device=dev) + offset) * step_w
    cy = (torch.arange(H, dtype=torch.float32, device=dev) + offset) * step_h
    out = []
    for size, density in zip(fixed_sizes, densities):
        for ratio in fixed_ratios:
            bw = size * np.sqrt(ratio)
            bh = size / np.sqrt(ratio)
            shift = size / density
            for di in range(density):
                for dj in range(density):
                    sx = -size / 2.0 + shift / 2.0 + dj * shift
                    sy = -size / 2.0 + shift / 2.0 + di * shift
                    bx = (cx + sx)[None, :].expand(H, W)
                    by = (cy + sy)[:, None].expand(H, W)
                    out.append(torch.stack(
                        [(bx - bw / 2) / IW, (by - bh / 2) / IH,
                         (bx + bw / 2) / IW, (by + bh / 2) / IH], dim=-1))
    boxes = torch.stack(out, dim=2)                          # [H, W, A, 4]
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = _f32(ctx, "var", variances).expand(boxes.shape)
    return {"Boxes": boxes, "Variances": var}


@register_op("generate_proposals", grad="none")
def generate_proposals(ctx: ExecContext):
    """RPN proposals: anchors decoded by the deltas, clipped to the image,
    boxes under min_size (floored at 1 pixel) or centred outside the
    image dropped, the pre_nms_topN best kept (stable), then greedy NMS at
    nms_thresh over them in pre_nms_topN device steps, batched over the
    images; the first post_nms_topN kept, in score order. RpnRois [N,
    post_n, 4] and RpnRoiProbs [N, post_n, 1], zero past the kept ones;
    RpnRoisNum [N] int32."""
    scores = ctx.input("Scores")                              # [N, A, H, W]
    deltas = ctx.input("BboxDeltas")                          # [N, A*4, H, W]
    info = ctx.input("ImInfo").to(torch.float32)              # [N, 3]
    anchors = ctx.input("Anchors").reshape(-1, 4).to(torch.float32)
    var = ctx.input("Variances").reshape(-1, 4).to(torch.float32)
    pre_n = int(ctx.attr("pre_nms_topN", 6000))
    post_n = int(ctx.attr("post_nms_topN", 1000))
    nms_thresh = float(ctx.attr("nms_thresh", 0.5))
    min_size = max(float(ctx.attr("min_size", 0.1)), 1.0)
    bbox_clip = float(np.log(1000.0 / 16.0))
    N, A, H, W = scores.shape
    K = A * H * W
    dev = scores.device
    sc = scores.permute(0, 2, 3, 1).reshape(N, K).to(torch.float32)
    dl = deltas.reshape(N, A, 4, H, W).permute(0, 3, 4, 1, 2).reshape(N, K, 4)
    aw = anchors[:, 2] - anchors[:, 0] + 1
    ah = anchors[:, 3] - anchors[:, 1] + 1
    acx = anchors[:, 0] + aw / 2
    acy = anchors[:, 1] + ah / 2
    cx = var[:, 0] * dl[..., 0] * aw + acx
    cy = var[:, 1] * dl[..., 1] * ah + acy
    w = torch.exp(torch.clamp_max(var[:, 2] * dl[..., 2], bbox_clip)) * aw
    h = torch.exp(torch.clamp_max(var[:, 3] * dl[..., 3], bbox_clip)) * ah
    ih, iw, isc = info[:, 0:1], info[:, 1:2], info[:, 2:3]
    x1 = torch.minimum(torch.clamp_min(cx - w / 2, 0), iw - 1)
    y1 = torch.minimum(torch.clamp_min(cy - h / 2, 0), ih - 1)
    x2 = torch.minimum(torch.clamp_min(cx + w / 2, 0), iw - 1)
    y2 = torch.minimum(torch.clamp_min(cy + h / 2, 0), ih - 1)
    ctr_x = x1 + (x2 - x1 + 1) / 2
    ctr_y = y1 + (y2 - y1 + 1) / 2
    keep = ((x2 - x1 + 1 >= min_size * isc) & (y2 - y1 + 1 >= min_size * isc)
            & (ctr_x < iw) & (ctr_y < ih))
    s = torch.where(keep, sc, torch.full_like(sc, -math.inf))
    k = min(pre_n, K)
    top_s, top_i = torch.sort(s, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :k], top_i[:, :k]
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).gather(
        1, top_i[..., None].expand(N, k, 4))                 # [N, k, 4]
    bx1, by1, bx2, by2 = (boxes[..., i] for i in range(4))
    xx1 = torch.maximum(bx1[:, :, None], bx1[:, None, :])
    yy1 = torch.maximum(by1[:, :, None], by1[:, None, :])
    xx2 = torch.minimum(bx2[:, :, None], bx2[:, None, :])
    yy2 = torch.minimum(by2[:, :, None], by2[:, None, :])
    inter = (torch.clamp_min(xx2 - xx1 + 1, 0) * torch.clamp_min(yy2 - yy1 + 1, 0))
    area = (bx2 - bx1 + 1) * (by2 - by1 + 1)
    over = inter / torch.clamp_min(area[:, :, None] + area[:, None, :] - inter,
                                   1e-10) > nms_thresh      # [N, k, k]
    del xx1, yy1, xx2, yy2, inter
    alive = torch.ones((N, k), dtype=torch.bool, device=dev)
    ok_all = torch.zeros((N, k), dtype=torch.bool, device=dev)
    n_kept = torch.zeros((N,), dtype=torch.int32, device=dev)
    finite = top_s > -math.inf
    for i in range(0 if scores.is_meta else k):
        ok = alive[:, i] & finite[:, i] & (n_kept < post_n)
        ok_all[:, i] = ok
        alive = alive & ~(ok[:, None] & over[:, i])
        n_kept = n_kept + ok.to(torch.int32)
    # the kept, in order, into the first n_kept slots; the rest to a dump
    pos = torch.where(ok_all, torch.cumsum(ok_all.to(torch.int64), 1) - 1,
                      torch.full((N, k), post_n, dtype=torch.int64, device=dev))
    rois = torch.zeros((N, post_n + 1, 4), dtype=torch.float32, device=dev)
    rois = rois.scatter(1, pos[..., None].expand(N, k, 4), boxes)[:, :post_n]
    probs = torch.zeros((N, post_n + 1), dtype=torch.float32, device=dev)
    probs = probs.scatter(1, pos, torch.where(ok_all, top_s, torch.zeros_like(
        top_s)))[:, :post_n]
    return {"RpnRois": rois, "RpnRoiProbs": probs[..., None],
            "RpnRoisNum": n_kept}


def _sce(x, t):
    """The sigmoid cross entropy as yolov3_loss_op.h writes it."""
    return torch.maximum(x, torch.zeros_like(x)) - x * t + torch.log1p(
        torch.exp(-torch.abs(x)))


def _yolo_iou(cx1, cy1, w1, h1, cx2, cy2, w2, h2):
    ow = (torch.minimum(cx1 + w1 / 2, cx2 + w2 / 2)
          - torch.maximum(cx1 - w1 / 2, cx2 - w2 / 2))
    oh = (torch.minimum(cy1 + h1 / 2, cy2 + h2 / 2)
          - torch.maximum(cy1 - h1 / 2, cy2 - h2 / 2))
    inter = torch.where((ow < 0) | (oh < 0), torch.zeros_like(ow), ow * oh)
    return inter / (w1 * h1 + w2 * h2 - inter + 1e-10)


def yolo_ignore(best_iou, ignore_thresh):
    """The ignore decision of yolov3_loss: a prediction whose best IoU with
    a gt exceeds ignore_thresh trains neither as object nor background.
    A module function, so a check that holds one device's loss against
    another's can put the near-threshold elements on one side."""
    return best_iou > ignore_thresh


@register_op("yolov3_loss")
def yolov3_loss(ctx: ExecContext):
    """The YOLOv3 training loss. X [N, mask*(5+cls), H, W]; GTBox [N, B, 4]
    (cx, cy, w, h normalized to the input); GTLabel [N, B]; GTScore [N, B]
    (mixup) or ones. Loss [N], ObjectnessMask [N, mask, H, W] (-1
    ignored, 0 background, a gt's score at its cell), GTMatchMask [N, B]
    int32. Each valid gt takes the best anchor over the full list; when
    that anchor is in the mask its cell trains location (sce of the
    offsets, l1 of the log sizes, scaled by 2 - w*h) and classes (label
    smoothing); on a cell two gts share, the later gt's score is the
    objectness target (an amax of the gt index over the cell, then a
    gather: no write order on the card decides it)."""
    x = ctx.input("X").to(torch.float32)
    gt_box = ctx.input("GTBox").to(torch.float32)
    gt_label = ctx.input("GTLabel")
    if gt_label.dim() == 3:
        gt_label = gt_label.reshape(gt_label.shape[:2])
    anchors = [int(a) for a in ctx.attr("anchors")]
    mask = [int(m) for m in ctx.attr("anchor_mask")]
    class_num = int(ctx.attr("class_num"))
    ignore_thresh = float(ctx.attr("ignore_thresh", 0.7))
    downsample = int(ctx.attr("downsample_ratio", 32))
    use_smooth = bool(ctx.attr("use_label_smooth", True))
    N, _, H, W = x.shape
    an_num, mask_num = len(anchors) // 2, len(mask)
    B = gt_box.shape[1]
    input_size = downsample * H
    dev = x.device
    if ctx.has_input("GTScore"):
        gt_score = ctx.input("GTScore").to(torch.float32).reshape(N, B)
    else:
        gt_score = torch.ones((N, B), dtype=torch.float32, device=dev)
    label_pos, label_neg = 1.0, 0.0
    if use_smooth:
        delta = min(1.0 / class_num, 1.0 / 40)
        label_pos, label_neg = 1.0 - delta, delta
    xr = x.reshape(N, mask_num, 5 + class_num, H, W)
    valid = (gt_box[:, :, 2] > 1e-6) & (gt_box[:, :, 3] > 1e-6)   # [N, B]

    # the ignore pass: each prediction's best IoU with a valid gt (no grad)
    with torch.no_grad():
        grid_x = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
        grid_y = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
        aw = _f32(ctx, "mask_aw", [anchors[2 * m] for m in mask])[:, None, None]
        ah = _f32(ctx, "mask_ah", [anchors[2 * m + 1] for m in mask])[:, None, None]
        xd = xr.detach()
        px = (torch.sigmoid(xd[:, :, 0]) + grid_x) / W
        py = (torch.sigmoid(xd[:, :, 1]) + grid_y) / H
        pw = torch.exp(xd[:, :, 2]) * aw[None] / input_size
        ph = torch.exp(xd[:, :, 3]) * ah[None] / input_size
        g = gt_box.detach()[:, :, None, None, None, :]
        ious = _yolo_iou(px[:, None], py[:, None], pw[:, None], ph[:, None],
                         g[..., 0], g[..., 1], g[..., 2], g[..., 3])
        ious = torch.where(valid[:, :, None, None, None], ious,
                           torch.zeros_like(ious))
        best_iou = ious.amax(dim=1)                           # [N, mask, H, W]
        del ious
        ignore = torch.where(yolo_ignore(best_iou, ignore_thresh),
                             torch.full_like(best_iou, -1.0),
                             torch.zeros_like(best_iou))

    # the positive pass: each gt's best anchor over the full list
    all_aw = _f32(ctx, "all_aw", anchors[0::2]) / input_size
    all_ah = _f32(ctx, "all_ah", anchors[1::2]) / input_size
    gw = gt_box[:, :, 2][:, :, None]
    gh = gt_box[:, :, 3][:, :, None]
    with torch.no_grad():
        z = torch.zeros_like(gw)
        an_iou = _yolo_iou(z, z, gw.detach(), gh.detach(), 0.0, 0.0,
                           all_aw[None, None], all_ah[None, None])
        best_n = an_iou.argmax(dim=2)                         # [N, B]
    lookup = [-1] * an_num
    for mi, m in enumerate(mask):
        lookup[m] = mi
    mask_idx = ctx.const("lookup", lookup, torch.long).index_select(
        0, best_n.reshape(-1)).reshape(N, B)
    gt_match = torch.where(valid, mask_idx, torch.full_like(mask_idx, -1))
    gi = torch.clamp((gt_box[:, :, 0] * W).detach().to(torch.int32), 0, W - 1).long()
    gj = torch.clamp((gt_box[:, :, 1] * H).detach().to(torch.int32), 0, H - 1).long()
    pos = valid & (mask_idx >= 0)
    m_safe = torch.clamp_min(mask_idx, 0)
    # the responsible cell of each gt: [N, B, 5+cls]
    cell_at = ((torch.arange(N, device=dev)[:, None] * mask_num + m_safe) * H
               + gj) * W + gi                                 # [N, B]
    cells = xr.permute(0, 1, 3, 4, 2).reshape(N * mask_num * H * W, 5 + class_num)
    cell = cells.index_select(0, cell_at.reshape(-1)).reshape(N, B, 5 + class_num)
    tx = gt_box[:, :, 0] * W - gi.to(torch.float32)
    ty = gt_box[:, :, 1] * H - gj.to(torch.float32)
    aw_best = _f32(ctx, "aw_best", anchors[0::2]).index_select(
        0, best_n.reshape(-1)).reshape(N, B)
    ah_best = _f32(ctx, "ah_best", anchors[1::2]).index_select(
        0, best_n.reshape(-1)).reshape(N, B)
    tw = torch.log(torch.clamp_min(gt_box[:, :, 2] * input_size, 1e-9) / aw_best)
    th = torch.log(torch.clamp_min(gt_box[:, :, 3] * input_size, 1e-9) / ah_best)
    scale = (2.0 - gt_box[:, :, 2] * gt_box[:, :, 3]) * gt_score
    loc = (_sce(cell[:, :, 0], tx) + _sce(cell[:, :, 1], ty)
           + torch.abs(cell[:, :, 2] - tw) + torch.abs(cell[:, :, 3] - th))
    zero = torch.zeros_like(loc)
    loc_loss = torch.where(pos, loc * scale, zero).sum(dim=1)
    hot = (torch.arange(class_num, device=dev)[None, None, :]
           == gt_label.reshape(N, B, 1).long())
    cls_t = torch.where(hot, torch.full(hot.shape, label_pos, device=dev),
                        torch.full(hot.shape, label_neg, device=dev))
    cls = _sce(cell[:, :, 5:], cls_t).sum(dim=2)
    cls_loss = torch.where(pos, cls * gt_score, zero).sum(dim=1)

    # objectness: a positive cell's target is the score of the last gt on it
    HW = mask_num * H * W
    local = (m_safe * H + gj) * W + gi                        # [N, B]
    t_idx = torch.where(pos, torch.arange(B, device=dev)[None].expand(N, B),
                        torch.full((N, B), -1, dtype=torch.long, device=dev))
    winner = torch.full((N, HW + 1), -1, dtype=torch.long, device=dev).scatter_reduce(
        1, torch.where(pos, local, torch.full_like(local, HW)), t_idx,
        reduce="amax")[:, :HW]
    won = gt_score.gather(1, torch.clamp_min(winner, 0))      # [N, HW]
    obj_mask = torch.where(winner >= 0, won, ignore.reshape(N, HW)).reshape(
        N, mask_num, H, W)
    obj_logit = xr[:, :, 4]
    obj_pos = torch.where(obj_mask > 1e-5, _sce(obj_logit, 1.0) * obj_mask,
                          torch.zeros_like(obj_logit))
    obj_neg = torch.where((obj_mask <= 1e-5) & (obj_mask > -0.5),
                          _sce(obj_logit, 0.0), torch.zeros_like(obj_logit))
    obj_loss = (obj_pos + obj_neg).sum(dim=(1, 2, 3))
    loss = loc_loss + cls_loss + obj_loss
    return {"Loss": loss.to(ctx.input("X").dtype),
            "ObjectnessMask": obj_mask.detach(),
            "GTMatchMask": gt_match.to(torch.int32)}


@register_op("psroi_pool")
def psroi_pool(ctx: ExecContext):
    """Position-sensitive RoI average pooling: input channel o*ph*pw +
    i*pw + j feeds output channel o's bin (i, j). X [N, O*ph*pw, H, W],
    ROIs [R, 4], RoisBatch [R] -> Out [R, O, ph, pw]. The bins are
    separable row and column masks, so each image's sums are two
    contractions over all the RoIs, never a per-RoI copy of the map."""
    x = ctx.input("X").to(torch.float32)
    rois = ctx.input("ROIs").to(torch.float32)
    O = int(ctx.attr("output_channels"))
    ph = int(ctx.attr("pooled_height"))
    pw = int(ctx.attr("pooled_width"))
    scale = float(ctx.attr("spatial_scale", 1.0))
    N, C, H, W = x.shape
    R = rois.shape[0]
    dev = x.device
    bid = _batch_ids(ctx, "RoisBatch", R)
    x1 = torch.round(rois[:, 0]) * scale
    y1 = torch.round(rois[:, 1]) * scale
    x2 = (torch.round(rois[:, 2]) + 1.0) * scale
    y2 = (torch.round(rois[:, 3]) + 1.0) * scale
    bw = torch.clamp_min(x2 - x1, 0.1) * _inv(pw)
    bh = torch.clamp_min(y2 - y1, 0.1) * _inv(ph)
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    i = torch.arange(ph, dtype=torch.float32, device=dev)
    j = torch.arange(pw, dtype=torch.float32, device=dev)
    hstart = torch.floor(_fma(y1[:, None], i[None], bh[:, None]))
    hend = torch.ceil(_fma(y1[:, None], i[None] + 1, bh[:, None]))
    wstart = torch.floor(_fma(x1[:, None], j[None], bw[:, None]))
    wend = torch.ceil(_fma(x1[:, None], j[None] + 1, bw[:, None]))
    in_h = ((ys >= torch.clamp(hstart, 0, H)[..., None])
            & (ys < torch.clamp(hend, 0, H)[..., None])).to(torch.float32)
    in_w = ((xs >= torch.clamp(wstart, 0, W)[..., None])
            & (xs < torch.clamp(wend, 0, W)[..., None])).to(torch.float32)
    counts = in_h.sum(dim=2)[:, :, None] * in_w.sum(dim=2)[:, None, :]
    xr = x.reshape(N, O, ph, pw, H, W)
    sums = torch.zeros((R, O, ph, pw), dtype=torch.float32, device=dev)
    for n in range(N):
        t = torch.einsum("oijhw,rjw->roijh", xr[n], in_w)
        s = torch.einsum("roijh,rih->roij", t, in_h)
        sums = sums + torch.where((bid == n)[:, None, None, None], s,
                                  torch.zeros_like(s))
    out = torch.where(counts[:, None] > 0,
                      sums / torch.clamp_min(counts, 1.0)[:, None],
                      torch.zeros_like(sums))
    return {"Out": out.to(ctx.input("X").dtype)}
