"""Detection layers (the JAX package's layers/detection.py): SSD priors,
box coding, IoU, multiclass NMS, SSD's detection_output and loss,
bipartite matching, YOLOv3's box decoding and loss, RPN anchors, density
priors, proposals and position-sensitive RoI pooling, on the padding
contract: NMS output is a fixed [N, keep_top_k, 6] tensor with label -1
padding. Each appends the same ops, slots and attrs as its namesake in the
JAX package, so both packages build op-for-op identical programs.
"""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["prior_box", "box_coder", "iou_similarity", "multiclass_nms",
           "detection_output", "ssd_loss", "bipartite_match",
           "yolo_box", "yolov3_loss", "anchor_generator",
           "density_prior_box", "generate_proposals", "psroi_pool"]


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=None,
              variance=None, flip=False, clip=False, steps=None, offset=0.5,
              name=None):
    """SSD prior boxes -> (boxes [H, W, P, 4], variances)."""
    helper = LayerHelper("prior_box", name=name)
    boxes = helper.create_variable_for_type_inference("float32")
    var = helper.create_variable_for_type_inference("float32")
    steps = steps or [0.0, 0.0]
    helper.append_op(
        "prior_box", {"Input": [input], "Image": [image]},
        {"Boxes": [boxes], "Variances": [var]},
        {"min_sizes": list(min_sizes),
         "max_sizes": list(max_sizes or []),
         "aspect_ratios": list(aspect_ratios or [1.0]),
         "variances": list(variance or [0.1, 0.1, 0.2, 0.2]),
         "flip": flip, "clip": clip,
         "step_w": float(steps[0]), "step_h": float(steps[1]),
         "offset": offset})
    return boxes, var


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              name=None, axis=0):
    """Center-size encode / decode against the priors."""
    if axis != 0:
        raise NotImplementedError(
            "box_coder: only axis=0 (priors broadcast along dim 0) is "
            "supported")
    helper = LayerHelper("box_coder", name=name)
    out = helper.create_variable_for_type_inference("float32")
    ins = {"PriorBox": [prior_box], "TargetBox": [target_box]}
    if prior_box_var is not None:
        ins["PriorBoxVar"] = [prior_box_var]
    helper.append_op("box_coder", ins, {"OutputBox": [out]},
                     {"code_type": code_type,
                      "box_normalized": box_normalized})
    return out


def iou_similarity(x, y, name=None):
    """Pairwise IoU [N, M]."""
    helper = LayerHelper("iou_similarity", name=name)
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op("iou_similarity", {"X": [x], "Y": [y]},
                     {"Out": [out]}, {})
    return out


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                   nms_threshold=0.3, normalized=True, nms_eta=1.0,
                   background_label=0, name=None):
    """Output [N, keep_top_k, 6] rows of (label, score, x1, y1, x2, y2);
    label -1 marks padding."""
    if nms_eta != 1.0:
        raise NotImplementedError(
            "multiclass_nms: adaptive NMS (nms_eta != 1.0) is not supported")
    helper = LayerHelper("multiclass_nms", name=name)
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        "multiclass_nms", {"BBoxes": [bboxes], "Scores": [scores]},
        {"Out": [out]},
        {"score_threshold": float(score_threshold),
         "nms_top_k": int(nms_top_k), "keep_top_k": int(keep_top_k),
         "nms_threshold": float(nms_threshold),
         "normalized": bool(normalized),
         "background_label": int(background_label)})
    return out


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0):
    """Decode SSD locations against the priors, then multiclass NMS. loc
    [N, M, 4] offsets, scores [N, C, M] (softmaxed)."""
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")
    return multiclass_nms(decoded, scores, score_threshold, nms_top_k,
                          keep_top_k, nms_threshold, nms_eta=nms_eta,
                          background_label=background_label)


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True, sample_size=None,
             gt_count=None):
    """The SSD multibox loss on padded ground truth: gt_box [N, G, 4] + gt_label [N, G, 1] + optional gt_count [N]
    valid rows (the LoD walk). Returns per-image loss [N, 1]."""
    if match_type != "per_prediction" or mining_type != "max_negative":
        raise NotImplementedError(
            "ssd_loss supports match_type='per_prediction' with "
            "mining_type='max_negative' (the reference defaults)")
    if sample_size is not None:
        raise NotImplementedError("ssd_loss: sample_size is not supported")
    helper = LayerHelper("ssd_loss")
    out = helper.create_variable_for_type_inference("float32")
    ins = {"Loc": [location], "Conf": [confidence], "GTBox": [gt_box],
           "GTLabel": [gt_label], "PriorBox": [prior_box]}
    if prior_box_var is not None:
        ins["PriorBoxVar"] = [prior_box_var]
    if gt_count is not None:
        ins["GTCount"] = [gt_count]
    helper.append_op(
        "ssd_loss", ins, {"Loss": [out]},
        {"background_label": int(background_label),
         "overlap_threshold": float(overlap_threshold),
         "neg_overlap": float(neg_overlap),
         "neg_pos_ratio": float(neg_pos_ratio),
         "loc_loss_weight": float(loc_loss_weight),
         "conf_loss_weight": float(conf_loss_weight),
         "normalize": bool(normalize)})
    return out


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    name=None):
    """Greedy bipartite matching of a [B, R, C] distance matrix."""
    helper = LayerHelper("bipartite_match", name=name)
    idx = helper.create_variable_for_type_inference("int32")
    d = helper.create_variable_for_type_inference(dist_matrix.dtype)
    helper.append_op(
        "bipartite_match", {"DistMat": [dist_matrix]},
        {"ColToRowMatchIndices": [idx], "ColToRowMatchDist": [d]},
        {"match_type": match_type or "bipartite",
         "dist_threshold": float(dist_threshold or 0.5)})
    return idx, d


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, name=None):
    """YOLOv3 box decoding -> (boxes, scores)."""
    helper = LayerHelper("yolo_box", name=name)
    boxes = helper.create_variable_for_type_inference(x.dtype)
    scores = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "yolo_box", {"X": [x], "ImgSize": [img_size]},
        {"Boxes": [boxes], "Scores": [scores]},
        {"anchors": [int(a) for a in anchors], "class_num": int(class_num),
         "conf_thresh": float(conf_thresh),
         "downsample_ratio": int(downsample_ratio)})
    return boxes, scores


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=True, name=None):
    """The YOLOv3 training loss [N]."""
    helper = LayerHelper("yolov3_loss", name=name)
    loss = helper.create_variable_for_type_inference(x.dtype)
    obj_mask = helper.create_variable_for_type_inference(x.dtype)
    gt_match = helper.create_variable_for_type_inference("int32")
    ins = {"X": [x], "GTBox": [gt_box], "GTLabel": [gt_label]}
    if gt_score is not None:
        ins["GTScore"] = [gt_score]
    helper.append_op(
        "yolov3_loss", ins,
        {"Loss": [loss], "ObjectnessMask": [obj_mask],
         "GTMatchMask": [gt_match]},
        {"anchors": [int(a) for a in anchors],
         "anchor_mask": [int(m) for m in anchor_mask],
         "class_num": int(class_num),
         "ignore_thresh": float(ignore_thresh),
         "downsample_ratio": int(downsample_ratio),
         "use_label_smooth": bool(use_label_smooth)})
    return loss


def anchor_generator(input, anchor_sizes=None, aspect_ratios=None,
                     variance=None, stride=None, offset=0.5, name=None):
    """RPN anchors -> (anchors, variances)."""
    helper = LayerHelper("anchor_generator", name=name)
    anchors = helper.create_variable_for_type_inference(input.dtype)
    variances = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "anchor_generator", {"Input": [input]},
        {"Anchors": [anchors], "Variances": [variances]},
        {"anchor_sizes": [float(s) for s in (anchor_sizes or [64, 128, 256,
                                                              512])],
         "aspect_ratios": [float(r) for r in (aspect_ratios or [0.5, 1.0,
                                                                2.0])],
         "variances": [float(v) for v in (variance or [0.1, 0.1, 0.2, 0.2])],
         "stride": [float(s) for s in (stride or [16.0, 16.0])],
         "offset": float(offset)})
    anchors.stop_gradient = True
    variances.stop_gradient = True
    return anchors, variances


def density_prior_box(input, image, densities=None, fixed_sizes=None,
                      fixed_ratios=None, variance=None, clip=False,
                      steps=None, offset=0.5, flatten_to_2d=False,
                      name=None):
    """Density prior boxes -> (boxes, variances)."""
    helper = LayerHelper("density_prior_box", name=name)
    boxes = helper.create_variable_for_type_inference(input.dtype)
    var = helper.create_variable_for_type_inference(input.dtype)
    steps = steps or [0.0, 0.0]
    helper.append_op(
        "density_prior_box", {"Input": [input], "Image": [image]},
        {"Boxes": [boxes], "Variances": [var]},
        {"densities": [int(d) for d in (densities or [])],
         "fixed_sizes": [float(s) for s in (fixed_sizes or [])],
         "fixed_ratios": [float(r) for r in (fixed_ratios or [])],
         "variances": [float(v) for v in (variance or [0.1, 0.1, 0.2,
                                                       0.2])],
         "clip": bool(clip), "step_w": float(steps[0]),
         "step_h": float(steps[1]), "offset": float(offset),
         "flatten_to_2d": bool(flatten_to_2d)})
    boxes.stop_gradient = True
    var.stop_gradient = True
    return boxes, var


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0, name=None):
    """RPN proposals -> (rois, roi probabilities)."""
    helper = LayerHelper("generate_proposals", name=name)
    rois = helper.create_variable_for_type_inference(scores.dtype)
    roi_probs = helper.create_variable_for_type_inference(scores.dtype)
    helper.append_op(
        "generate_proposals",
        {"Scores": [scores], "BboxDeltas": [bbox_deltas],
         "ImInfo": [im_info], "Anchors": [anchors],
         "Variances": [variances]},
        {"RpnRois": [rois], "RpnRoiProbs": [roi_probs]},
        {"pre_nms_topN": int(pre_nms_top_n),
         "post_nms_topN": int(post_nms_top_n),
         "nms_thresh": float(nms_thresh), "min_size": float(min_size),
         "eta": float(eta)})
    rois.stop_gradient = True
    roi_probs.stop_gradient = True
    return rois, roi_probs


def psroi_pool(input, rois, output_channels, spatial_scale, pooled_height,
               pooled_width, rois_batch=None, name=None):
    """Position-sensitive RoI average pooling."""
    helper = LayerHelper("psroi_pool", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    ins = {"X": [input], "ROIs": [rois]}
    if rois_batch is not None:
        ins["RoisBatch"] = [rois_batch]
    helper.append_op(
        "psroi_pool", ins, {"Out": [out]},
        {"output_channels": int(output_channels),
         "spatial_scale": float(spatial_scale),
         "pooled_height": int(pooled_height),
         "pooled_width": int(pooled_width)})
    return out
