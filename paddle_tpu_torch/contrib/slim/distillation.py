"""Knowledge-distillation losses (the JAX package's
contrib/slim/distillation.py, after the reference's slim/distillation
FSPDistiller, L2Distiller and SoftLabelDistiller): both towers are built in
one program (the teacher frozen with stop_gradient or left out of the
optimizer's parameter_list), and these helpers append the distillation
losses as ordinary layers.
"""
from __future__ import annotations

from ... import layers as L

__all__ = ["soft_label_loss", "l2_distill_loss", "fsp_matrix", "fsp_loss"]


def soft_label_loss(teacher_logits, student_logits,
                    teacher_temperature=1.0, student_temperature=1.0):
    """KL-style soft-label loss (reference distiller.py SoftLabelDistiller):
    mean cross-entropy of softened student predictions against softened
    teacher probabilities."""
    t = L.softmax(L.scale(teacher_logits, scale=1.0 / teacher_temperature))
    t.stop_gradient = True  # the teacher is a fixed target
    s = L.scale(student_logits, scale=1.0 / student_temperature)
    return L.mean(L.cross_entropy(L.softmax(s), t, soft_label=True))


def l2_distill_loss(teacher_feature, student_feature):
    """Feature-map L2 matching (reference distiller.py L2Distiller)."""
    diff = L.elementwise_sub(student_feature, teacher_feature)
    return L.mean(L.elementwise_mul(diff, diff))


def fsp_matrix(a, b):
    """Flow-of-solution-procedure matrix (reference fsp op /
    distiller.py FSPDistiller): a [B, C1, H, W] x b [B, C2, H, W] ->
    [B, C1, C2] = (a_flat @ b_flat^T) / (H*W). Built from existing
    reshape/matmul ops — no bespoke kernel needed."""
    B_, C1, H, W = -1, a.shape[1], a.shape[2], a.shape[3]
    C2 = b.shape[1]
    af = L.reshape(a, [-1, C1, H * W])
    bf = L.reshape(b, [-1, C2, H * W])
    return L.scale(L.matmul(af, bf, transpose_y=True), scale=1.0 / (H * W))


def fsp_loss(teacher_pair, student_pair):
    """L2 between teacher and student FSP matrices; each pair is
    (feature_in, feature_out) of a section with equal spatial dims."""
    tm = fsp_matrix(*teacher_pair)
    tm.stop_gradient = True
    sm = fsp_matrix(*student_pair)
    return l2_distill_loss(tm, sm)
