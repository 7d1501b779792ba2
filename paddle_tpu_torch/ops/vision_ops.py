"""Vision ops (the JAX package's vision_ops.py). Ported: space_to_depth,
the NCHW repack in front of the ResNet space-to-depth stem. Its grad is
derived by replay (ops/registry.py)."""
from __future__ import annotations

from .registry import ExecContext, register_op


@register_op("space_to_depth")
def space_to_depth(ctx: ExecContext):
    """[N, C, H, W] -> [N, C b b, H/b, W/b], output channels ordered
    (phase_h, phase_w, c)."""
    x = ctx.input("X")
    b = int(ctx.attr("blocksize"))
    N, C, H, W = x.shape
    out = x.reshape(N, C, H // b, b, W // b, b).permute(0, 3, 5, 1, 2, 4)
    return {"Out": out.reshape(N, C * b * b, H // b, W // b)}
