"""Sequence and spatial parallelism: the rewrite of a program over an `sp`
axis, and the halo exchanges its convolutions and pools run.

In the JAX package `with_data_parallel` over a mesh with an `sp` axis is
one GSPMD program: a feed annotated on `sp` (BERT's four feeds under
`use_sp`, an image's H dim) is split along that dim, and XLA's partitioner
carries the split through the network, exchanging halo rows around
convolutions and pools and inserting the sums a reduction over the split
dim needs. The port runs one process a rank, so
`sequence_parallel_rewrite` makes those exchanges and sums explicit on a
private clone, after `append_backward`. It runs after the tensor-parallel
rewrite and before the data-parallel one; each pass treats the
collectives of the pass before it as ops that keep its own sharding, and
each tracks only its own axis.

The rewrite is the tensor-parallel rewrite's value tracker
(parallel/tensor_parallel.py `_Rewrite`) over the `sp` ranks: each value
is replicated, partial (a sum over `sp` still to be taken) or sharded on
one dim, split by GSPMD's ceil rule (`mesh.ceil_range`: ceil(D / sp) rows a
rank, the last ranks the rest). Its rules, its reshapes (`reshape_shard`,
where every rank's share of both dims is equal) and its fallback (an op
with a sharded input and no rule gathers it and runs replicated) are the
tp tracker's; the rules it adds:
  * row-wise ops keep the shard: `lookup_table` on sharded ids,
    `layer_norm` over the dims after it, `softmax_with_cross_entropy` over
    another dim, `dropout` (its mask the global tensor's draw cut to the
    rank's rows, `Operator.sp_draw`);
  * `fused_attention` over Q, K and V sharded on S gathers them, runs the
    kernel at the full S and keeps the rank's rows of Out; its grad
    gathers dOut and keeps the rank's rows of dQ, dK and dV;
  * a convolution or a windowed pool over a sharded H gets its halo rows
    from the ranks that hold them and pads only at the global edges
    (`Operator.sp_halo`, `HaloPlan`); a global pool sums (or maxes) over
    the ranks and divides by the global H x W;
  * a training batch norm takes its statistics over the sharded dim's
    ranks (`Operator.sp_sync`), with the global count, and its grad runs
    K9's split mode, so Scale@GRAD and Bias@GRAD come out global;
  * a mean over a sharded dim is the rank's mean scaled by its share of
    the rows, summed over the ranks (so uneven shards weigh right), and
    its grad scales the cotangent alike; a max, min or product over it
    is reduced over the ranks inside the op (`Operator.global_reduce`),
    whose grad then reaches only the global extremum.
Parameters are replicated over `sp`: a gradient a rank computes from its
rows is partial, summed (never averaged) over `sp` where it is final.
"""
from __future__ import annotations

import torch

from .mesh import SEQ_AXIS, ceil_range
from .tensor_parallel import _P, _Rewrite, _is_shard, reshape_shard

__all__ = ["sequence_parallel_rewrite", "HaloPlan", "ceil_shard",
           "ceil_gather", "SEQ_AXIS"]


def ceil_shard(t, dim, extent, size, index):
    """Rank `index` of `size`'s rows of `t` (global extent `extent` along
    `dim`) under the ceil split, contiguous."""
    start, stop = ceil_range(extent, size, index)
    return t.narrow(dim % t.dim(), start, stop - start).contiguous()


def ceil_gather(g, t, dim, extent, what):
    """The global tensor of the group's ceil shards of `t` along `dim`
    (collective): each shard padded to ceil(extent / size) rows for the
    all-gather, the padding cut after."""
    from ..ops.collective_ops import _all_gather

    dim = dim % t.dim()
    k = -(-int(extent) // g.size)
    pad = k - t.shape[dim]
    if pad:
        shape = list(t.shape)
        shape[dim] = pad
        t = torch.cat([t, t.new_zeros(shape)], dim=dim)
    parts = []
    for i, p in enumerate(_all_gather(g, t.contiguous(), what)):
        start, stop = ceil_range(extent, g.size, i)
        parts.append(p.narrow(dim, 0, stop - start))
    return torch.cat(parts, dim=dim)


def ring_group(ctx, ring, what):
    """The group the run binds `ring` to; raises naming what the op was
    marked to do over it where the run binds none."""
    from ..ops.collective_ops import AXIS_ENV_KEY

    g = (ctx.env.get(AXIS_ENV_KEY) or {}).get(ring)
    if g is None:
        raise RuntimeError(f"{ctx.op.type}: marked to {what} over ring "
                           f"{ring}, which this run binds to no group")
    return g


def _halo_gather(g, slab, what):
    """Every rank's slab of one halo exchange (an all-gather)."""
    from ..ops.collective_ops import _all_gather

    return _all_gather(g, slab, what)


def _overlap(a, b):
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if hi > lo else None


class HaloPlan:
    """The rows of a window op (a conv or pool of kernel `k`, `stride`,
    `dilation` and top padding `pad_top` along the split dim) over an
    input of `extent_in` rows split over `size` ranks, whose output of
    `extent_out` rows is split the same way. For every rank: `own` its
    input rows, `need` the input rows its output rows read (inside the
    input), `pads` (top, bottom) the padding rows outside the global
    input, and the pieces it sends to every other rank. Every rank
    computes every rank's plan from the static extents, so an exchange is
    one all-gather of padded slabs, forward and back."""

    def __init__(self, extent_in, extent_out, size, k, stride, dilation,
                 pad_top):
        self.extent_in, self.size = int(extent_in), int(size)
        self.own = [ceil_range(extent_in, size, i) for i in range(size)]
        self.need, self.pads = [], []
        for i in range(size):
            oa, ob = ceil_range(extent_out, size, i)
            if ob <= oa:
                self.need.append((0, 0))
                self.pads.append((0, 0))
                continue
            lo = oa * stride - pad_top
            hi = (ob - 1) * stride - pad_top + dilation * (k - 1) + 1
            self.need.append((max(lo, 0), min(hi, self.extent_in)))
            self.pads.append((max(0, -lo), max(0, hi - self.extent_in)))
        # piece[i][j]: the rows rank i holds that rank j needs (i != j)
        self.piece = [[_overlap(self.own[i], self.need[j]) if i != j
                       else None for j in range(size)] for i in range(size)]
        # what each rank sends forward: the span of its pieces to lower
        # ranks, then the span of those to higher ranks
        self.send = []
        for i in range(size):
            spans = []
            for js in (range(i), range(i + 1, size)):
                ps = [self.piece[i][j] for j in js if self.piece[i][j]]
                spans.append((min(p[0] for p in ps), max(p[1] for p in ps))
                             if ps else None)
            self.send.append(spans)
        self.slab = max(sum(s[1] - s[0] for s in sp if s)
                        for sp in self.send)
        # what each rank sends back: its pieces' gradients, in rank order
        self.back = max(sum(self.piece[j][i][1] - self.piece[j][i][0]
                            for j in range(size) if self.piece[j][i])
                        for i in range(size))

    @staticmethod
    def _pad(t, dim, rows):
        if t.shape[dim] == rows:
            return t
        shape = list(t.shape)
        shape[dim] = rows - t.shape[dim]
        return torch.cat([t, t.new_zeros(shape)], dim=dim)

    def exchange(self, g, x, dim, what="sp halo"):
        """This rank's input rows `need` (x holds its `own`), from the
        ranks that hold them."""
        i = g.index
        if self.slab == 0:
            a = self.own[i][0]
            lo, hi = self.need[i]
            return x.narrow(dim, lo - a, hi - lo) if hi > lo else \
                x.narrow(dim, 0, 0)
        parts = [x.narrow(dim, s[0] - self.own[i][0], s[1] - s[0])
                 for s in self.send[i] if s]
        slab = self._pad(torch.cat(parts, dim=dim) if parts else
                         x.narrow(dim, 0, 0), dim, self.slab)
        slabs = _halo_gather(g, slab.contiguous(), what)
        out = []
        for j in range(self.size):
            if j == i:
                p = _overlap(self.own[i], self.need[i])
                if p:
                    out.append(x.narrow(dim, p[0] - self.own[i][0],
                                        p[1] - p[0]))
                continue
            p = self.piece[j][i]
            if not p:
                continue
            off = 0
            for s in self.send[j]:
                if s and s[0] <= p[0] and p[1] <= s[1]:
                    out.append(slabs[j].narrow(dim, off + p[0] - s[0],
                                               p[1] - p[0]))
                    break
                off += (s[1] - s[0]) if s else 0
        return torch.cat(out, dim=dim)

    def return_grads(self, g, dneed, dim, what="sp halo grad"):
        """The gradient of `exchange`: dneed (this rank's `need` rows) back
        to their owners, each rank's own rows plus the pieces the others
        return to it."""
        i = g.index
        a, b = self.own[i]
        shape = list(dneed.shape)
        shape[dim] = b - a
        dx = dneed.new_zeros(shape)
        lo = self.need[i][0]
        p = _overlap(self.own[i], self.need[i])
        if p:
            dx.narrow(dim, p[0] - a, p[1] - p[0]).add_(
                dneed.narrow(dim, p[0] - lo, p[1] - p[0]))
        if self.back == 0:
            return dx
        mine = [dneed.narrow(dim, self.piece[j][i][0] - lo,
                             self.piece[j][i][1] - self.piece[j][i][0])
                for j in range(self.size) if j != i and self.piece[j][i]]
        slab = self._pad(torch.cat(mine, dim=dim) if mine else
                         dneed.narrow(dim, 0, 0), dim, self.back)
        slabs = _halo_gather(g, slab.contiguous(), what)
        for j in range(self.size):
            if j == i:
                continue
            off = 0
            for k in range(self.size):
                q = self.piece[k][j]
                if k == j or not q:
                    continue
                if k == i:
                    dx.narrow(dim, q[0] - a, q[1] - q[0]).add_(
                        slabs[j].narrow(dim, off, q[1] - q[0]))
                off += q[1] - q[0]
        return dx


class _HaloFn(torch.autograd.Function):
    """`HaloPlan.exchange` with `return_grads` as its backward: a pool's
    grad replays its forward under autograd."""

    @staticmethod
    def forward(fctx, x, plan, g, dim):
        fctx.plan, fctx.g, fctx.dim = plan, g, dim
        return plan.exchange(g, x, dim)

    @staticmethod
    def backward(fctx, dy):
        return (fctx.plan.return_grads(fctx.g, dy.contiguous(), fctx.dim),
                None, None, None)


def halo_input(ctx, x, k, stride, dilation, pads):
    """(x's needed rows along the op's split dim, (top, bottom) padding)
    for an op the rewrite marked with `sp_halo`; x is NCHW (the split dim
    is 2). Under autograd the exchange is `_HaloFn`."""
    mark = ctx.op.sp_halo
    g = ring_group(ctx, mark["ring"], "exchange halo rows")
    plan = HaloPlan(mark["extent_in"], mark["extent_out"], g.size, k,
                    stride, dilation, pads[0])
    if torch.is_grad_enabled() and x.requires_grad:
        xe = _HaloFn.apply(x, plan, g, 2)
    else:
        xe = plan.exchange(g, x, 2)
    return xe, plan.pads[g.index], plan, g


class _SumOver(torch.autograd.Function):
    """A sum over the ranks of `g` whose output is replicated: the
    gradient of each rank's input is the output's (identity)."""

    @staticmethod
    def forward(fctx, x, g, what):
        from ..ops.collective_ops import _all_reduce

        return _all_reduce(g, x.contiguous(), "sum", what)

    @staticmethod
    def backward(fctx, dy):
        return dy, None, None


def sum_over(g, x, what):
    return _SumOver.apply(x, g, what)


def extreme_over(x, dims, keep, red, groups):
    return _ExtremeOver.apply(x, dims, keep, red, groups)


class _ExtremeOver(torch.autograd.Function):
    """The max (min) over the ranks of `groups` of `x`, this rank's max
    (min) over `dims`: the gradient reaches the elements equal to the
    global one, shared evenly among all ranks' ties (jnp.max's rule)."""

    @staticmethod
    def forward(fctx, x, dims, keep, red, groups):
        from ..ops.collective_ops import _all_reduce

        out = (torch.amax if red == "max" else torch.amin)(
            x, dim=dims, keepdim=True)
        for g in groups:
            out = _all_reduce(g, out.contiguous(), red, f"reduce_{red}")
        hit = (x == out).to(x.dtype)
        count = hit.sum(dim=dims, keepdim=True)
        for g in groups:
            count = _all_reduce(g, count.contiguous(), "sum",
                                f"reduce_{red} ties")
        fctx.save_for_backward(hit / count)
        fctx.dims, fctx.keep = dims, keep
        return out if keep else out.squeeze(dims) if dims else out

    @staticmethod
    def backward(fctx, dy):
        (share,) = fctx.saved_tensors
        if not fctx.keep:
            for d in sorted(fctx.dims):
                dy = dy.unsqueeze(d)
        return dy * share, None, None, None, None


class _ProdOver(torch.autograd.Function):
    """The product over the ranks of `groups` of each rank's product
    (gathered, so zeros and signs are exact): the gradient of a rank's
    factor is the product of the others'."""

    @staticmethod
    def forward(fctx, local, groups):
        from ..ops.collective_ops import _all_gather

        others = torch.ones_like(local)
        out = local
        for g in groups:
            parts = _all_gather(g, out.contiguous(), "reduce_prod")
            rest = torch.ones_like(out)
            for j, p in enumerate(parts):
                if j != g.index:
                    rest = rest * p
            others = others * rest
            out = out * rest
        fctx.save_for_backward(others)
        return out

    @staticmethod
    def backward(fctx, dy):
        (others,) = fctx.saved_tensors
        return dy * others, None


def global_reduce(ctx, x, red, dims, keep, local_fn):
    """reduce_max / _min / _prod of x over `dims` for an op a parallel
    rewrite marked with `global_reduce` (its rings): the reduction over
    the ranks' shards of x."""
    groups = [ring_group(ctx, r, f"reduce its {red}")
              for r in ctx.op.global_reduce]
    if red == "prod":
        return _ProdOver.apply(local_fn(x, dim=dims, keepdim=keep), groups)
    return extreme_over(x, dims, keep, red, groups)


# -- the rewrite ------------------------------------------------------------

_BN_GRADS = ("batch_norm_grad", "conv2d_bn_grad")
# the marks a grad op takes from its forward op (a dropout's grad reads
# the forward's mask, not its draw)
_GRAD_MARKS = ("sp_halo", "sp_sync", "global_reduce")


class _SPRewrite(_Rewrite):
    """The tp tracker over the `sp` ranks (module docstring)."""

    KIND, AXIS = "sequence", SEQ_AXIS

    def __init__(self, program, group, ring, feed_names, in_place,
                 tp_states, tp):
        super().__init__(program, group.size, ring, group, in_place=in_place)
        self.tp_states, self.tp_size = tp_states or {}, tp
        self.means = set()
        for n in feed_names:
            v = self.block.vars.get(n)
            spec = getattr(v, "sharding", None) if v is not None else None
            dims = [d for d, ax in enumerate(spec or ())
                    if ax == SEQ_AXIS and d < len(v.shape)]
            if len(dims) > 1:
                raise NotImplementedError(
                    f"sequence parallelism: feed '{n}' is annotated on "
                    f"'{SEQ_AXIS}' twice")
            if dims:
                self.st[n] = (dims[0], 1)

    # -- what differs from the tp tracker ------------------------------------
    def shape(self, name):
        """The var's shape as this pass sees it: tp-local where the tp
        rewrite left it sharded."""
        s = list(self.var(name).shape)
        ts = self.tp_states.get(name)
        if _is_shard(ts) and s[ts[0]] > 0:
            s[ts[0]] //= self.tp_size
        return s

    def extent(self, name, dim):
        return self.shape(name)[dim]

    def local(self, name, dim):
        a, b = ceil_range(self.extent(name, dim), self.tp, self.group.index)
        return b - a

    def insert(self, type_, ins, outs, attrs):
        if type_ in ("tp_gather", "tp_slice"):
            attrs = dict(attrs, extent=self.extent(ins["X"][0],
                                                   attrs["dim"]))
        super().insert(type_, ins, outs, attrs)

    def decide_layouts(self):
        """Parameters are replicated over sp: no layouts."""

    def even(self, name, dim):
        return self.extent(name, dim) % self.tp == 0

    # -- rules ---------------------------------------------------------------
    def rule_c_allreduce_sum(self, op, ins):
        """The tp rewrite's collectives keep the sp split: a reduction over
        the tp ranks is elementwise here, and its gathers and slices run
        along another dim."""
        s = ins.get(("X", 0))
        if op.type in ("tp_gather", "tp_slice") and \
                s[0] == op.attrs.get("dim"):
            return None
        return {}, {("Out", 0): s}

    rule_c_allreduce_max = rule_c_allreduce_min = rule_c_allreduce_sum
    rule_tp_gather = rule_tp_slice = rule_c_allreduce_sum

    def rule_reshape2(self, op, ins):
        """The tp tracker's `reshape_shard` with groups of 1 (an sp shard is
        one block of rows), where every rank's share of the source and the
        target dim is equal; else the gather. The divisibility is checked
        for two ranks at least: over one rank every dim would map."""
        s = ins.get(("X", 0))
        x, out = op.input("X")[0], op.output("Out")[0]
        shape = list(op.attrs.get("shape", []))
        tgt = reshape_shard(self.shape(x), shape, s[0], 1, max(self.tp, 2))
        if not self.even(x, s[0]) or tgt is None or tgt[1] != 1 or \
                not self.even(out, tgt[0]):
            return None
        t = tgt[0]
        if t < len(shape) and shape[t] > 0:
            shape[t] //= self.tp
            # the grad op, replaying this reshape, takes the same attr
            op.attrs["shape"] = op.tp_attrs = shape
        return {}, self._one_out(op, (t, 1))

    rule_reshape = rule_reshape2

    def rule_softmax_with_cross_entropy(self, op, ins):
        s = ins.get(("Logits", 0))
        rank = len(self.shape(op.input("Logits")[0]))
        if not _is_shard(s) or s[0] == op.attrs.get("axis", -1) % rank:
            return None
        want = {k: s for k, v in ins.items() if k[0] == "Label"}
        return want, {("Softmax", 0): s, ("Loss", 0): s}

    def rule_lookup_table(self, op, ins):
        s = ins.get(("Ids", 0))
        if not _is_shard(s) or _is_shard(ins.get(("W", 0))) or \
                s[0] >= len(self.shape(op.output("Out")[0])) - 1:
            return None
        return {}, {("Out", 0): s}

    rule_lookup_table_v2 = rule_lookup_table

    def rule_layer_norm(self, op, ins):
        s = ins.get(("X", 0))
        if not _is_shard(s) or s[0] >= op.attrs.get("begin_norm_axis", 1):
            return None
        want = {k: None for k, v in ins.items() if k[0] != "X" and
                _is_shard(v)}
        # Mean and Variance are the rank's rows flattened: read by the grad
        # op alone, as they are
        return want, {("Y", 0): s}

    def rule_dropout(self, op, ins):
        s = ins.get(("X", 0))
        marks = None
        if not op.attrs.get("is_test", False):
            marks = {"sp_draw": (self.ring, s[0],
                                 self.extent(op.input("X")[0], s[0]))}
        return {}, {("Out", 0): s, ("Mask", 0): s}, marks

    def rule_fused_attention(self, op, ins):
        """Q, K and V gathered on their sharded S, the kernel at the full
        S, and this rank's rows of Out kept."""
        if ins.get(("Bias", 0)) is not None or any(
                _is_shard(v) and v[0] != 2 for v in ins.values()):
            return None

        def post():
            n = op.outputs["Out"][0]
            full = self.new_var(n, "FULL")
            op.outputs["Out"][0] = full
            self.st[full] = None
            self.coerce(full, (2, 1), into=n)
            self.st[n] = (2, 1)
        op._tp_post = post
        return {k: None for k, v in ins.items() if _is_shard(v)}, {}

    def _hdim(self, op):
        fmt = op.attrs.get("data_format", op.attrs.get("data_layout",
                                                       "NCHW"))
        return 1 if fmt == "NHWC" else 2

    def rule_conv2d(self, op, ins):
        s = ins.get(("Input", 0))
        d = self._hdim(op)
        if not _is_shard(s) or s[0] != d or _is_shard(ins.get(("Filter", 0))):
            return None
        out_slot = "Y" if op.type == "conv2d_bn" else "Output"
        x, y = op.input("Input")[0], op.output(out_slot)[0]
        marks = {"sp_halo": {"ring": self.ring, "extent_in": self.extent(x, d),
                             "extent_out": self.extent(y, d)}}
        want = {k: None for k, v in ins.items()
                if k[0] not in ("Input", "Residual") and _is_shard(v)}
        outs = {(out_slot, 0): s}
        if op.type == "conv2d_bn":
            marks["sp_sync"] = (self.ring, d, self.extent(y, d))
            if op.inputs.get("Residual"):
                want[("Residual", 0)] = s
        return want, outs, marks

    rule_depthwise_conv2d = rule_conv2d
    rule_conv2d_bn = rule_conv2d

    def rule_pool2d(self, op, ins):
        s = ins.get(("X", 0))
        d = self._hdim(op)
        if s[0] != d or op.attrs.get("adaptive", False):
            return None
        x, y = op.input("X")[0], op.output("Out")[0]
        glob = bool(op.attrs.get("global_pooling", False))
        marks = {"sp_halo": {"ring": self.ring, "extent_in": self.extent(x, d),
                             "extent_out": 1 if glob else self.extent(y, d),
                             "global": glob}}
        return {}, {("Out", 0): None if glob else s}, marks

    def rule_batch_norm(self, op, ins):
        s = ins.get(("X", 0))
        cdim = 1 if op.attrs.get("data_layout", "NCHW") == "NCHW" else \
            len(self.shape(op.input("X")[0])) - 1
        if s[0] == cdim:
            return None
        want = {k: None for k, v in ins.items() if k[0] != "X" and
                _is_shard(v)}
        marks = None
        if not op.attrs.get("is_test", False):
            marks = {"sp_sync": (self.ring, s[0],
                                 self.extent(op.input("X")[0], s[0]))}
        return want, {("Y", 0): s}, marks

    def rule_reduce(self, op, ins):
        s = ins.get(("X", 0))
        x = op.input("X")[0]
        rank = len(self.shape(x))
        if op.type in ("mean", "squared_l2_norm") or \
                op.attrs.get("reduce_all", False):
            dims = list(range(rank))
        else:
            dims = op.attrs.get("dim", [0])
            dims = [d % rank for d in (dims if isinstance(dims, (list, tuple))
                                       else [dims])]
        if s[0] not in dims or op.type in ("reduce_sum", "squared_l2_norm"):
            return super().rule_reduce(op, ins)
        out = op.output("Out")[0]
        if op.type in ("mean", "reduce_mean"):
            share = self.local(x, s[0]) / self.extent(x, s[0])
            self.means.add(out)

            def post():
                self.insert("scale", {"X": [out]}, {"Out": [out]},
                            {"scale": share, "bias": 0.0,
                             "bias_after_scale": True})
                self.allreduce(out)
            op._tp_post = post
            return {}, {("Out", 0): None}
        if op.type in ("reduce_max", "reduce_min", "reduce_prod"):
            return {}, {("Out", 0): None}, {
                "global_reduce": tuple(getattr(op, "global_reduce", ()))
                + (self.ring,)}
        return None

    def rule_reduce_prod(self, op, ins):
        return self.rule_reduce(op, ins)

    # -- grad ops ------------------------------------------------------------
    def grad_op(self, op, fwd):
        for m in _GRAD_MARKS:
            if hasattr(fwd, m):
                setattr(op, m, getattr(fwd, m))
        if op.type == "fused_attention_grad" and fwd.outputs["Out"][0] != \
                op.inputs["Out@GRAD"][0][:-len("@GRAD")]:
            g = op.inputs["Out@GRAD"][0]
            if _is_shard(self.st.get(g)):
                op.inputs["Out@GRAD"] = [self.coerce(g, None)]
        if op.type in ("mean_grad", "reduce_mean_grad") and \
                op.input("Out@GRAD")[0].split("@GRAD")[0] in self.means:
            g = op.input("Out@GRAD")[0]
            x = op.input("X")[0]
            s = self.info[id(fwd)][1].get(("X", 0))
            scaled = self.new_var(g, "SCALED")
            self.insert("scale", {"X": [g]}, {"Out": [scaled]},
                        {"scale": self.local(x, s[0]) / self.extent(x, s[0]),
                         "bias": 0.0, "bias_after_scale": True})
            op.inputs["Out@GRAD"] = [scaled]
        super().grad_op(op, fwd)
        if op.type in _BN_GRADS and getattr(op, "sp_sync", None):
            # K9's split mode sums the statistics' sums over the ranks:
            # Scale@GRAD and Bias@GRAD are already the global ones
            for slot in ("Scale@GRAD", "Bias@GRAD"):
                for n in op.outputs.get(slot, []):
                    if n and self.st.get(n) == _P:
                        self.st[n] = None


def sequence_parallel_rewrite(program, group, ring_id: int, feed_names,
                              in_place: bool = False, tp_states=None,
                              tp: int = 1):
    """A clone of `program` (or `program` itself, `in_place`: a clone the
    tensor-parallel rewrite made, whose `tp_states` and degree `tp` give
    its values' tp-local shapes) whose values follow the sequence or
    spatial split of its feeds annotated on `sp` over the ranks of
    `group` (module docstring). Returns (the program, {var: "partial" or
    (dim, global extent)} of the values left partial or sharded, which a
    fetch sums or gathers)."""
    rw = _SPRewrite(program, group, ring_id, feed_names, in_place,
                    tp_states, tp)
    clone = rw.run()
    rw.layouts.clear()
    states = {}
    for n, s in rw.st.items():
        if s == _P:
            states[n] = s
        elif _is_shard(s):
            states[n] = (s[0], rw.extent(n, s[0]))
    return clone, states
