"""Vision and layout ops (the JAX package's vision_ops.py): the resizes
(nearest, bilinear and trilinear in the three coordinate conventions),
3-D pooling and convolution, the adaptive pools, pixel and channel
shuffles, space_to_depth, temporal_shift, maxout, lrn, affine_channel,
multiplex, crop, pad_constant_like, unfold, grid_sampler,
bilinear_tensor_product, shard_index, sampling_id, affine_grid,
im2sequence, random_crop and the modulated deformable convolution.

Every op is static-shaped torch and never reads the device from the host.
Grads are derived by replay (ops/registry.py), but pad_constant_like's,
whose X gives only a shape (its gradient zeros, as jax.vjp's). The
resizes gather along one axis at a time through `_AxisTake`, whose
backward sums each source's outputs in a fixed order (a gather per
multiplicity, no atomics), so their grads repeat bit for bit on the card. The random ops draw from the run's
`torch.Generator`: the laws of the JAX ops, not their streams."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.types import torch_feed_dtype
from .registry import ExecContext, register_grad_compute, register_op

# index outputs are int64 in the API and run as int32, as in the JAX
# package with x64 off
_INDEX_DTYPE = torch_feed_dtype("int64")


# -- the resizes -------------------------------------------------------------


class _AxisTake(torch.autograd.Function):
    """x.index_select(axis, idx) whose backward is deterministic: `table`
    [in_len, K] lists, for each source position, the output positions that
    read it (ascending, padded with out_len, which reads a zero slice); the
    gradient is the sum of K gathers in that order."""

    @staticmethod
    def forward(ctx, x, axis, idx, table):
        ctx.axis = axis
        ctx.save_for_backward(table)
        return x.index_select(axis, idx)

    @staticmethod
    def backward(ctx, g):
        (table,) = ctx.saved_tensors
        pad = list(g.shape)
        pad[ctx.axis] = 1
        gp = torch.cat([g, g.new_zeros(pad)], ctx.axis)
        out = gp.index_select(ctx.axis, table[:, 0])
        for k in range(1, table.shape[1]):
            out = out + gp.index_select(ctx.axis, table[:, k])
        return out, None, None, None


def _take(ctx: ExecContext, x, axis: int, idx: np.ndarray, key: str):
    """x's slices along `axis` at the host-known positions `idx` (int
    numpy), through _AxisTake; the index and its inverse table are made
    once per op, device and extent (ExecContext.const)."""
    idx = np.asarray(idx, np.int64)
    n = x.shape[axis]
    key = f"{key}.{n}.{len(idx)}"
    lists = [[] for _ in range(n)]
    for d, s in enumerate(idx.tolist()):
        lists[s].append(d)
    k = max(1, max(len(v) for v in lists))
    table = [v + [len(idx)] * (k - len(v)) for v in lists]
    it = ctx.const(key + ".idx", idx.tolist(), torch.long)
    tt = ctx.const(key + ".table", table, torch.long)
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x.index_select(axis, it)
    return _AxisTake.apply(x, axis, it, tt)


def _resize_dims(ctx, x):
    out_h = int(ctx.attr("out_h", 0))
    out_w = int(ctx.attr("out_w", 0))
    scale = float(ctx.attr("scale", 0.0) or 0.0)
    if out_h <= 0 or out_w <= 0:
        if scale <= 0:
            raise ValueError("resize needs out_h/out_w or scale")
        out_h = int(x.shape[2] * scale)
        out_w = int(x.shape[3] * scale)
    return out_h, out_w


def _src_coords(out_len, in_len, align_corners, align_mode):
    """The source coordinate of each output position, in float32 as the
    JAX op computes it: align_corners d*(in-1)/(out-1); else mode 0
    half-pixel max((d+.5)*r-.5, 0), mode 1 d*r."""
    d = np.arange(out_len, dtype=np.float32)
    if align_corners:
        return d * np.float32((in_len - 1) / max(out_len - 1, 1))
    r = np.float32(in_len / out_len)
    if int(align_mode) == 0:
        return np.maximum((d + np.float32(0.5)) * r - np.float32(0.5),
                          np.float32(0.0))
    return d * r


def _linear_taps(out_len, in_len, align_corners, align_mode):
    """(i0, i1, w) of the linear interpolation along one axis."""
    s = _src_coords(out_len, in_len, align_corners, align_mode)
    i0 = np.clip(np.floor(s).astype(np.int64), 0, in_len - 1)
    i1 = np.minimum(i0 + 1, in_len - 1)
    return i0, i1, (s - i0.astype(np.float32)).astype(np.float32)


def _triangle_weights(in_len, out_len):
    """jax.image.resize's linear weight matrix [in_len, out_len]
    (half-pixel centres, no antialiasing), in float32 as it builds it."""
    f = np.float32
    inv = f(1.0) / f(out_len / in_len)
    sample = (np.arange(out_len, dtype=f) + f(0.5)) * inv - f(0.0) * inv - f(0.5)
    x = np.abs(sample[None, :] - np.arange(in_len, dtype=f)[:, None]) / f(1.0)
    w = np.maximum(f(0.0), f(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f)
    w = np.where(np.abs(total) > f(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f(1.0)), f(0.0))
    inside = (sample >= f(-0.5)) & (sample <= f(in_len - 0.5))
    return np.where(inside[None, :], w, f(0.0)).astype(f)


def _half_pixel_linear(ctx, x, sizes):
    """jax.image.resize(..., "linear", antialias=False) over the trailing
    axes to `sizes`: one weight-matrix contraction per axis that changes."""
    out = x.to(torch.float32)
    nd = x.dim()
    for i, n in enumerate(sizes):
        axis = nd - len(sizes) + i
        m = out.shape[axis]
        if m == n:
            continue
        w = ctx.const(f"resize.w{axis}.{m}.{n}", _triangle_weights(m, n).tolist())
        out = torch.movedim(torch.movedim(out, axis, -1) @ w, -1, axis)
    return out


def _resize(ctx, method):
    x = ctx.input("X")  # [N, C, H, W]
    out_h, out_w = _resize_dims(ctx, x)
    align_corners = bool(ctx.attr("align_corners", False))
    align_mode = int(ctx.attr("align_mode", 1))
    H, W = x.shape[2], x.shape[3]
    if method == "nearest":
        if align_corners:
            # the reference's static_cast<int>(ratio*k + 0.5): round half up
            iy = np.floor(_src_coords(out_h, H, True, 0) + np.float32(0.5))
            ix = np.floor(_src_coords(out_w, W, True, 0) + np.float32(0.5))
        else:
            # floor(k * in/out), not half-pixel
            iy = np.floor(_src_coords(out_h, H, False, 1))
            ix = np.floor(_src_coords(out_w, W, False, 1))
        iy = np.clip(iy, 0, H - 1).astype(np.int64)
        ix = np.clip(ix, 0, W - 1).astype(np.int64)
        return {"Out": _take(ctx, _take(ctx, x, 2, iy, "y"), 3, ix, "x")}
    if not align_corners and align_mode == 0:
        return {"Out": _half_pixel_linear(ctx, x, (out_h, out_w)).to(x.dtype)}
    f = x.to(torch.float32)
    y0, y1, wy = _linear_taps(out_h, H, align_corners, align_mode)
    x0, x1, wx = _linear_taps(out_w, W, align_corners, align_mode)
    wy = ctx.const(f"wy.{H}.{out_h}", wy.tolist()).reshape(1, 1, -1, 1)
    wx = ctx.const(f"wx.{W}.{out_w}", wx.tolist()).reshape(1, 1, 1, -1)
    r0, r1 = _take(ctx, f, 2, y0, "y0"), _take(ctx, f, 2, y1, "y1")
    top = _take(ctx, r0, 3, x0, "x0") * (1 - wx) + _take(ctx, r0, 3, x1, "x1") * wx
    bot = _take(ctx, r1, 3, x0, "x0") * (1 - wx) + _take(ctx, r1, 3, x1, "x1") * wx
    return {"Out": (top * (1 - wy) + bot * wy).to(x.dtype)}


@register_op("bilinear_interp")
def bilinear_interp(ctx: ExecContext):
    """Bilinear resize in the reference's three conventions (align_corners;
    align_mode 0 half-pixel, 1 d*in/out)."""
    return _resize(ctx, "linear")


@register_op("nearest_interp")
def nearest_interp(ctx: ExecContext):
    return _resize(ctx, "nearest")


@register_op("trilinear_interp")
def trilinear_interp(ctx: ExecContext):
    """Trilinear resize of [N, C, D, H, W]: separable linear interpolation
    along each axis, in the 2-D ops' coordinate conventions."""
    x = ctx.input("X")
    out_d = int(ctx.attr("out_d", 0))
    out_h = int(ctx.attr("out_h", 0))
    out_w = int(ctx.attr("out_w", 0))
    scale = float(ctx.attr("scale", 0.0) or 0.0)
    if out_d <= 0 or out_h <= 0 or out_w <= 0:
        if scale <= 0:
            raise ValueError("trilinear resize needs out_d/h/w or scale")
        out_d = int(x.shape[2] * scale)
        out_h = int(x.shape[3] * scale)
        out_w = int(x.shape[4] * scale)
    align_corners = bool(ctx.attr("align_corners", False))
    align_mode = int(ctx.attr("align_mode", 1))
    out = x.to(torch.float32)
    for axis, out_len in ((2, out_d), (3, out_h), (4, out_w)):
        i0, i1, w = _linear_taps(out_len, out.shape[axis], align_corners,
                                 align_mode)
        shape = [1] * out.dim()
        shape[axis] = -1
        w = ctx.const(f"w{axis}.{out.shape[axis]}.{out_len}", w.tolist()
                      ).reshape(shape)
        out = (_take(ctx, out, axis, i0, f"a{axis}") * (1 - w)
               + _take(ctx, out, axis, i1, f"b{axis}") * w)
    return {"Out": out.to(x.dtype)}


# -- pooling and convolution ---------------------------------------------------


def _trip(v):
    v = list(v) if isinstance(v, (list, tuple)) else [v] * 3
    return [int(a) for a in (v if len(v) == 3 else v * 3)]


def _pair2(v):
    v = list(v) if isinstance(v, (list, tuple)) else [v, v]
    return [int(a) for a in (v if len(v) == 2 else v * 2)]


@register_op("pool3d")
def pool3d(ctx: ExecContext):
    x = ctx.input("X")  # [N, C, D, H, W]
    ptype = ctx.attr("pooling_type", "max")
    k = [int(a) for a in ctx.attr("ksize")]
    s = [int(a) for a in ctx.attr("strides", [1, 1, 1])]
    p = [int(a) for a in ctx.attr("paddings", [0, 0, 0])]
    if ctx.attr("global_pooling", False):
        k = list(x.shape[2:])
        s, p = k, [0, 0, 0]
    pads = (p[2], p[2], p[1], p[1], p[0], p[0])
    if ptype == "max":
        out = F.max_pool3d(F.pad(x, pads, value=float("-inf")), k, s)
    elif ctx.attr("exclusive", True) and any(p):
        # exclusive: the padded zeros do not count
        summed = F.avg_pool3d(F.pad(x, pads), k, s, divisor_override=1)
        counts = F.avg_pool3d(F.pad(torch.ones_like(x[:1, :1]), pads), k, s,
                              divisor_override=1)
        out = summed / counts
    else:
        out = F.avg_pool3d(F.pad(x, pads), k, s)
    return {"Out": out.to(x.dtype)}


@register_op("conv3d")
def conv3d(ctx: ExecContext):
    x, w = ctx.input("Input"), ctx.input("Filter")
    return {"Output": F.conv3d(
        x, w, None, _trip(ctx.attr("strides", [1, 1, 1])),
        _trip(ctx.attr("paddings", [0, 0, 0])),
        _trip(ctx.attr("dilations", [1, 1, 1])), int(ctx.attr("groups", 1)))}


@register_op("conv3d_transpose")
def conv3d_transpose(ctx: ExecContext):
    """The transposed 3-D convolution (NCDHW, filter [C_in, C_out, k...]).
    The JAX op passes no group count, and neither does this one."""
    x, w = ctx.input("Input"), ctx.input("Filter")
    return {"Output": F.conv_transpose3d(
        x, w, None, _trip(ctx.attr("strides", [1, 1, 1])),
        _trip(ctx.attr("paddings", [0, 0, 0])), 0, 1,
        _trip(ctx.attr("dilations", [1, 1, 1]))).to(x.dtype)}


def _adaptive(x, out, ptype, what):
    ins = x.shape[2:]
    if any(i % o for i, o in zip(ins, out)):
        raise ValueError(
            f"{what}: input {'x'.join(map(str, ins))} not divisible by output "
            f"{'x'.join(map(str, out))} (uneven adaptive bins are not "
            f"static-shaped)")
    shape = list(x.shape[:2])
    for i, o in zip(ins, out):
        shape += [o, i // o]
    r = x.reshape(shape)
    dims = tuple(range(3, r.dim(), 2))
    out = r.amax(dim=dims) if ptype == "max" else r.mean(dim=dims)
    return out.to(x.dtype)


@register_op("adaptive_pool2d")
def adaptive_pool2d(ctx: ExecContext):
    """Adaptive pooling on evenly dividing bins (raises otherwise, as the
    JAX op does)."""
    return {"Out": _adaptive(ctx.input("X"),
                             [int(v) for v in ctx.attr("pooled_size")],
                             ctx.attr("pooling_type", "avg"),
                             "adaptive_pool2d")}


@register_op("adaptive_pool3d")
def adaptive_pool3d(ctx: ExecContext):
    return {"Out": _adaptive(ctx.input("X"),
                             [int(v) for v in ctx.attr("pooled_size")],
                             ctx.attr("pooling_type", "avg"),
                             "adaptive_pool3d")}


# -- layout ops ----------------------------------------------------------------


@register_op("pixel_shuffle")
def pixel_shuffle(ctx: ExecContext):
    x = ctx.input("X")
    u = int(ctx.attr("upscale_factor"))
    N, C, H, W = x.shape
    out = x.reshape(N, C // (u * u), u, u, H, W).permute(0, 1, 4, 2, 5, 3)
    return {"Out": out.reshape(N, C // (u * u), H * u, W * u)}


@register_op("shuffle_channel")
def shuffle_channel(ctx: ExecContext):
    x = ctx.input("X")
    g = int(ctx.attr("group"))
    N, C, H, W = x.shape
    out = x.reshape(N, g, C // g, H, W).permute(0, 2, 1, 3, 4)
    return {"Out": out.reshape(N, C, H, W)}


@register_op("space_to_depth")
def space_to_depth(ctx: ExecContext):
    """[N, C, H, W] -> [N, C b b, H/b, W/b], output channels ordered
    (phase_h, phase_w, c)."""
    x = ctx.input("X")
    b = int(ctx.attr("blocksize"))
    N, C, H, W = x.shape
    out = x.reshape(N, C, H // b, b, W // b, b).permute(0, 3, 5, 1, 2, 4)
    return {"Out": out.reshape(N, C * b * b, H // b, W // b)}


@register_op("temporal_shift")
def temporal_shift(ctx: ExecContext):
    """[N*T, C, H, W]: the first shift_ratio of the channels one step back
    in time, the next share one step forward, the rest in place."""
    x = ctx.input("X")
    T = int(ctx.attr("seg_num"))
    ratio = float(ctx.attr("shift_ratio", 0.25))
    NT, C, H, W = x.shape
    c1, c2 = int(C * ratio), int(C * 2 * ratio)
    xr = x.reshape(NT // T, T, C, H, W)
    back = torch.cat([xr[:, 1:, :c1], torch.zeros_like(xr[:, :1, :c1])], 1)
    fwd = torch.cat([torch.zeros_like(xr[:, :1, c1:c2]), xr[:, :-1, c1:c2]], 1)
    out = torch.cat([back, fwd, xr[:, :, c2:]], dim=2)
    return {"Out": out.reshape(NT, C, H, W)}


@register_op("maxout")
def maxout(ctx: ExecContext):
    x = ctx.input("X")
    g = int(ctx.attr("groups"))
    N, C, H, W = x.shape
    return {"Out": x.reshape(N, C // g, g, H, W).amax(dim=2)}


@register_op("lrn")
def lrn(ctx: ExecContext):
    """Local response normalization across channels: MidOut = (k + alpha *
    the window's sum of squares) ** beta, Out = X / MidOut."""
    x = ctx.input("X")
    n = int(ctx.attr("n", 5))
    k = float(ctx.attr("k", 1.0))
    alpha = float(ctx.attr("alpha", 1e-4))
    beta = float(ctx.attr("beta", 0.75))
    half = n // 2
    sq = F.pad(torch.square(x), (0, 0, 0, 0, half, n - 1 - half))
    C = x.shape[1]
    acc = sq[:, 0:C]
    for i in range(1, n):
        acc = acc + sq[:, i:i + C]
    mid = (k + alpha * acc) ** beta
    return {"Out": (x / mid).to(x.dtype), "MidOut": mid}


@register_op("affine_channel")
def affine_channel(ctx: ExecContext):
    x = ctx.input("X")
    sh = [1, -1] + [1] * (x.dim() - 2)
    return {"Out": x * ctx.input("Scale").reshape(sh)
            + ctx.input("Bias").reshape(sh)}


@register_op("multiplex")
def multiplex(ctx: ExecContext):
    """Row b of Out is row b of X[Ids[b]]."""
    ids = ctx.input("Ids").reshape(-1).long()
    xs = torch.stack([x for x in ctx.inputs("X") if x is not None])  # [K, B, ...]
    K, B = xs.shape[0], xs.shape[1]
    flat = ids * B + torch.arange(B, device=xs.device)
    out = xs.reshape((K * B,) + tuple(xs.shape[2:])).index_select(0, flat)
    return {"Out": out}


@register_op("crop")
def crop(ctx: ExecContext):
    x = ctx.input("X")
    shape = [int(s) for s in ctx.attr("shape")]
    offsets = [int(o) for o in ctx.attr("offsets", [0] * x.dim())]
    return {"Out": x[tuple(slice(o, o + s) for o, s in zip(offsets, shape))]}


@register_op("pad_constant_like")
def pad_constant_like(ctx: ExecContext):
    x, y = ctx.input("X"), ctx.input("Y")
    pads = []
    for xs, ys in reversed(list(zip(x.shape, y.shape))):
        pads += [0, xs - ys]
    return {"Out": F.pad(y, pads, value=float(ctx.attr("pad_value", 0.0)))}


@register_grad_compute("pad_constant_like")
def pad_constant_like_grad(ctx: ExecContext):
    """dY: Out's gradient over Y's extent; dX: zeros (X gives only the
    shape), as jax.vjp gives them."""
    x, y, g = ctx.input("X"), ctx.input("Y"), ctx.input("Out@GRAD")
    return {"Y@GRAD": g[tuple(slice(0, n) for n in y.shape)],
            "X@GRAD": torch.zeros_like(x)}


@register_op("unfold")
def unfold(ctx: ExecContext):
    """im2col as an op: [N, C, H, W] -> [N, C*kh*kw, L], taps ordered (c,
    ky, kx)."""
    x = ctx.input("X")
    kh, kw = [int(v) for v in ctx.attr("kernel_sizes")]
    sh, sw = [int(v) for v in ctx.attr("strides", [1, 1])]
    ph, pw = [int(v) for v in ctx.attr("paddings", [0, 0])][:2]
    dh, dw = [int(v) for v in ctx.attr("dilations", [1, 1])]
    N, C, H, W = x.shape
    xp = F.pad(x, (pw, pw, ph, ph))
    oh = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    cols = [xp[:, :, i * dh:i * dh + sh * (oh - 1) + 1:sh,
               j * dw:j * dw + sw * (ow - 1) + 1:sw]
            for i in range(kh) for j in range(kw)]
    out = torch.stack(cols, dim=2)  # [N, C, kh*kw, oh, ow]
    return {"Y": out.reshape(N, C * kh * kw, oh * ow)}


@register_op("grid_sampler")
def grid_sampler(ctx: ExecContext):
    """Bilinear sampling of X [N, C, H, W] at Grid [N, Ho, Wo, 2] in
    normalized [-1, 1] coordinates (align_corners); out-of-bound corners
    contribute zero."""
    x = ctx.input("X").to(torch.float32)
    grid = ctx.input("Grid").to(torch.float32)
    return {"Output": F.grid_sample(x, grid, mode="bilinear",
                                    padding_mode="zeros", align_corners=True)}


@register_op("bilinear_tensor_product")
def bilinear_tensor_product(ctx: ExecContext):
    """out[b, k] = x[b] W[k] y[b] (+ bias)."""
    x, y, w = ctx.input("X"), ctx.input("Y"), ctx.input("Weight")
    out = torch.einsum("bi,kij,bj->bk", x, w, y)
    if ctx.has_input("Bias"):
        out = out + ctx.input("Bias")
    return {"Out": out}


@register_op("shard_index", grad="none")
def shard_index(ctx: ExecContext):
    x = ctx.input("X")
    index_num = int(ctx.attr("index_num"))
    nshards = int(ctx.attr("nshards"))
    shard_id = int(ctx.attr("shard_id"))
    ignore = int(ctx.attr("ignore_value", -1))
    per = (index_num + nshards - 1) // nshards
    ok = torch.div(x, per, rounding_mode="floor") == shard_id
    return {"Out": torch.where(ok, x - shard_id * per,
                               torch.full_like(x, ignore))}


@register_op("sampling_id", grad="none", needs_rng=True)
def sampling_id(ctx: ExecContext):
    """One category per row of a probability matrix: the Gumbel-max draw
    jax.random.categorical makes, argmax(log p + Gumbel noise)."""
    p = ctx.input("X")
    if ctx.is_meta:
        return {"Out": torch.empty(p.shape[:-1], dtype=_INDEX_DTYPE,
                                   device="meta")}
    u = ctx.draw(lambda shape: torch.rand(
        shape, generator=ctx.generator, dtype=torch.float32,
        device=p.device), p.shape).clamp_min(torch.finfo(torch.float32).tiny)
    logits = torch.log(torch.clamp_min(p.to(torch.float32), 1e-20))
    return {"Out": torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
            .to(_INDEX_DTYPE)}


@register_op("affine_grid")
def affine_grid(ctx: ExecContext):
    """Theta [N, 2, 3] -> the sampling grid [N, H, W, 2] over the
    align_corners [-1, 1] mesh."""
    theta = ctx.input("Theta")
    shape = [int(v) for v in ctx.attr("output_shape")]
    H, W = shape[2], shape[3]
    dev = theta.device
    ys = torch.linspace(-1.0, 1.0, H, dtype=torch.float32, device=dev)
    xs = torch.linspace(-1.0, 1.0, W, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # [H, W, 3]
    out = torch.einsum("hwk,nck->nhwc", base, theta.to(torch.float32))
    return {"Output": out.to(theta.dtype)}


@register_op("im2sequence", grad="none")
def im2sequence(ctx: ExecContext):
    """Sliding-window im2col: X [B, C, H, W] -> [B, n_windows, C*kh*kw]
    (the batch axis kept, as in the JAX op)."""
    x = ctx.input("X")
    kh, kw = [int(v) for v in ctx.attr("kernels")]
    sh, sw = [int(v) for v in ctx.attr("strides", [1, 1])]
    pads = [int(v) for v in ctx.attr("paddings", [0, 0, 0, 0])]
    x = F.pad(x, (pads[1], pads[3], pads[0], pads[2]))
    return {"Out": F.unfold(x, (kh, kw), stride=(sh, sw)).transpose(1, 2)}


@register_op("random_crop", needs_rng=True, grad="none")
def random_crop(ctx: ExecContext):
    """Each sample cropped to `shape` (its trailing axes) at offsets drawn
    uniformly over the valid starts."""
    x = ctx.input("X")
    shape = [int(v) for v in ctx.attr("shape")]
    lead = x.dim() - len(shape)
    for j, tgt in enumerate(shape):
        if tgt > x.shape[lead + j]:
            raise ValueError(f"random_crop: target {tgt} > extent "
                             f"{x.shape[lead + j]}")
    if ctx.is_meta:
        return {"Out": torch.empty(tuple(x.shape[:lead]) + tuple(shape),
                                   dtype=x.dtype, device="meta")}
    B = x.shape[0]
    out = x
    for j, tgt in enumerate(shape):
        axis = lead + j
        hi = x.shape[axis] - tgt + 1
        start = ctx.draw(lambda shape: torch.randint(
            0, hi, shape, generator=ctx.generator, device=x.device), (B,))
        view = [B] + [1] * (x.dim() - 1)
        view[axis] = tgt
        idx = (start.reshape([B] + [1] * (x.dim() - 1))
               + torch.arange(tgt, device=x.device).reshape(
                   [1] * axis + [tgt] + [1] * (x.dim() - axis - 1)))
        size = list(out.shape)
        size[axis] = tgt
        out = out.gather(axis, idx.expand(size))
    return {"Out": out}


@register_op("deformable_conv")
def deformable_conv(ctx: ExecContext):
    """The modulated deformable convolution (v2): each kernel tap samples
    the input bilinearly at its position plus a learned offset, scaled by
    a learned mask, then a convolution over the taps. X [B, Cin, H, W];
    Offset [B, 2*dg*kh*kw, OH, OW] ((y, x) interleaved a tap); Mask
    [B, dg*kh*kw, OH, OW]; Filter [Cout, Cin/groups, kh, kw]. Builds the
    [B, Cin*kh*kw, OH, OW] column tensor."""
    x = ctx.input("Input")
    offset = ctx.input("Offset")
    mask = ctx.input("Mask")
    w = ctx.input("Filter")
    sh, sw = _pair2(ctx.attr("strides", [1, 1]))
    ph, pw_ = _pair2(ctx.attr("paddings", [0, 0]))
    dh, dw = _pair2(ctx.attr("dilations", [1, 1]))
    groups = int(ctx.attr("groups", 1))
    dg = int(ctx.attr("deformable_groups", 1))
    B, Cin, H, W = x.shape
    Cout, _, kh, kw = w.shape
    OH = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    OW = (W + 2 * pw_ - (dw * (kw - 1) + 1)) // sw + 1
    Cg = Cin // dg
    dev = x.device
    f = x.to(torch.float32).reshape(B, dg, Cg, H * W)
    oy = (torch.arange(OH, device=dev) * sh - ph).to(torch.float32)
    ox = (torch.arange(OW, device=dev) * sw - pw_).to(torch.float32)
    cols = []
    for ky in range(kh):
        for kx in range(kw):
            tap = ky * kw + kx
            off_y = offset[:, 2 * tap::2 * kh * kw]    # [B, dg, OH, OW]
            off_x = offset[:, 2 * tap + 1::2 * kh * kw]
            py = oy[None, None, :, None] + ky * dh + off_y
            px = ox[None, None, None, :] + kx * dw + off_x
            y0, x0 = torch.floor(py), torch.floor(px)
            wy, wx = py - y0, px - x0
            vals = 0.0
            for yy, wyy in ((y0, 1 - wy), (y0 + 1, wy)):
                for xx, wxx in ((x0, 1 - wx), (x0 + 1, wx)):
                    ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
                    yi = torch.clamp(yy, 0, H - 1).long()
                    xi = torch.clamp(xx, 0, W - 1).long()
                    lin = (yi * W + xi).reshape(B, dg, 1, OH * OW)
                    sampled = f.gather(3, lin.expand(B, dg, Cg, OH * OW)
                                       ).reshape(B, dg, Cg, OH, OW)
                    wgt = ok.to(torch.float32) * wyy * wxx
                    vals = vals + wgt[:, :, None] * torch.where(
                        ok[:, :, None], sampled, torch.zeros_like(sampled))
            if mask is not None:
                vals = vals * mask[:, tap::kh * kw][:, :, None]
            cols.append(vals.reshape(B, Cin, OH, OW))
    col = torch.stack(cols, dim=2).reshape(B, Cin * kh * kw, OH, OW)
    if groups == 1:
        wk = w.permute(1, 2, 3, 0).reshape(Cin * kh * kw, Cout)
        out = torch.einsum("bkhw,kc->bchw", col, wk)
    else:
        col_g = col.reshape(B, groups, (Cin // groups) * kh * kw, OH, OW)
        wg = w.reshape(groups, Cout // groups, -1)
        out = torch.einsum("bgkhw,gck->bgchw", col_g, wg).reshape(
            B, Cout, OH, OW)
    return {"Output": out.to(x.dtype)}
