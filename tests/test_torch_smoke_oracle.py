"""chip_smoke.py's ResNet-50 AMP step-1 gate, run on the CPU at a small
size: the port's bf16 step (the kernels' plain versions) against the
script's plain-torch oracles, which take each layer's input from the port;
and its long-context BERT AMP gate (K10/K11) at bert_tiny's widths, which
must refuse a K11 dQ scaled by 1.5 in one layer.

The gate must pass the port as it is and refuse it with a fault planted in
one kernel's plain version: the batch-norm apply (K8) forward output off
by 0.3 at one element in 5000 of one layer, or its backward (K9) dx
scaled by 1.5 in one layer. The sizes are cut to B=4 at 64x64 (the script runs
B=128 at 224x224 on the card); the limits are the script's own.

Its comparison of the cross-entropy backward (K7) is held the same way:
it must pass the plain version's dx moved by a unit of its last place and
refuse dx with the elements of each row's peeled head and tail chunks left
at zero, or with the softmax mass off the label halved.

Its comparison of the fused bottleneck block (#15, `_agree16`) at the unit
input set (`bottleneck.inputs(scale="unit")`, where every stage of the
chain moves the output about as much as the residual) must refuse three
faults planted in the plain version, each a fault a retiling could make: the
3x3 halo dropped at 4-row strip boundaries, the centre tap of w2 zeroed,
y3 scaled by 0.98; and it must accept the tool's own kernel body run
through the Pallas interpreter.

Its data-pipeline phases (DeepFM through train_from_dataset, sparse
word2vec, the sequence/RNN tail) run here at small sizes, and the DeepFM
gates refuse an sgd that keeps one update of repeated ids and an adam
that is not lazy. Its giant-embedding phase runs at a small vocabulary, and
its parity gate refuses a cache install whose evicted rows are read after
the install.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
import paddle_tpu_torch.executor as executor  # noqa: E402
from paddle_tpu_torch.ops.cuda_kernels import bn_apply as k8  # noqa: E402
from paddle_tpu_torch.ops.cuda_kernels import bottleneck as k15  # noqa: E402
from paddle_tpu_torch.ops.cuda_kernels import bn_apply_bwd as k9  # noqa: E402
from paddle_tpu_torch.ops.cuda_kernels import xent_bwd as k7  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401


@pytest.fixture
def cpu_smoke(monkeypatch):
    """chip_smoke's ResNet-50 AMP phase on the CPU: the device calls it
    makes around the step become no-ops, the executor's default device the
    CPU, the launch check the launches the program's ops imply."""
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    resolve = executor.resolve_device
    monkeypatch.setattr(executor, "resolve_device", lambda d=None: torch.device(
        "cpu") if d is None else resolve(d))
    monkeypatch.setattr(chip_smoke, "_check_launches",
                        lambda prog, what: chip_smoke._expected_launches(prog))
    for name, value in (("AMP_B", 4), ("RN_HW", 64), ("RN_STEPS", 2)):
        monkeypatch.setattr(chip_smoke, name, value)
    return monkeypatch


def _plant_k8(monkeypatch):
    plain, seen = k8.bn_apply_act_plain, []

    def faulty(x2, *args, **kw):
        y = plain(x2, *args, **kw)
        if x2.shape[-1] == 512 and not seen:     # the first layer this wide
            seen.append(1)
            y.view(-1)[::5000] += 0.3
        return y
    monkeypatch.setattr(k8, "bn_apply_act_plain", faulty)


def _plant_k9(monkeypatch):
    plain = k9.bn_apply_act_backward_plain

    def faulty(x2, *args, **kw):
        dx, dres, *sums = plain(x2, *args, **kw)
        count = args[8] if len(args) > 8 else kw.get("count")
        if x2.shape[-1] == 2048 and count is not None:    # the training mode
            dx = (1.5 * dx.float()).to(dx.dtype)
        return (dx, dres, *sums)
    monkeypatch.setattr(k9, "bn_apply_act_backward_plain", faulty)


def _plant_k8_scaled(monkeypatch):
    """K8's output scaled by 1.004 in every layer 512 wide: each relu's
    output 4e-3 of its largest and 4e-3 in relative L2 off, under the relu
    band (RELU_NEAR_BF16, 3e-2) and under the earlier 1e-2 in relative L2."""
    plain = k8.bn_apply_act_plain

    def faulty(x2, *args, **kw):
        y = plain(x2, *args, **kw)
        if x2.shape[-1] == 512:
            y = (1.004 * y.float()).to(y.dtype)
        return y
    monkeypatch.setattr(k8, "bn_apply_act_plain", faulty)


@pytest.mark.parametrize("plant", [None, "k8", "k9", "k8_scaled"])
def test_resnet50_amp_gate_holds_the_port_and_refuses_a_planted_fault(
        cpu_smoke, plant):
    if plant == "k8":
        _plant_k8(cpu_smoke)
    elif plant == "k9":
        _plant_k9(cpu_smoke)
    elif plant == "k8_scaled":
        _plant_k8_scaled(cpu_smoke)
    run = lambda: chip_smoke.train_resnet_amp(torch.device("cpu"), "CPU")  # noqa: E731
    if plant is None:
        _, counts = run()
        assert counts["bn_apply_act_backward"] == {"bfloat16": 53}
    else:
        with pytest.raises(RuntimeError, match={
                "k8": "relu outputs against the bf16 oracle",
                "k9": "gradients beyond their limits",
                "k8_scaled": "relu outputs against the bf16 oracle"}[plant]):
            run()


# bert_tiny's widths in place of BERT-base's (vocab 1024, hidden 64, 2
# layers of 4 heads of 16): the script's long-context AMP phase at B=2,
# S=640, through K10/K11's plain versions
BERT_TINY = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
                 ffn_size=128, max_position=512, dropout=0.0, use_tp=False)


def _plant_k11(monkeypatch):
    from paddle_tpu_torch.ops.cuda_kernels import flash_attention_bwd as k11

    plain, seen = k11.flash_attention_backward_plain, []

    def faulty(*args, **kw):
        dq, dk, dv = plain(*args, **kw)
        if not seen:                      # the last layer's backward
            seen.append(1)
            dq = (1.5 * dq.float()).to(dq.dtype)
        return dq, dk, dv
    monkeypatch.setattr(k11, "flash_attention_backward_plain", faulty)


@pytest.mark.parametrize("plant", [None, "k11"])
def test_long_context_amp_gate_holds_the_port_and_refuses_a_planted_fault(
        cpu_smoke, plant):
    """The long-context AMP phase (train_bert_amp with flash) on the CPU:
    the port passes with launches by dtype as the program says (K10 and
    K11 once a layer, bf16), and a K11 whose dQ is scaled by 1.5 in one
    layer is refused by the gradient gate."""
    cpu_smoke.setattr(chip_smoke, "BERT_BASE", BERT_TINY)
    if plant:
        _plant_k11(cpu_smoke)
    run = lambda: chip_smoke.train_bert_amp(  # noqa: E731
        torch.device("cpu"), "CPU", 2, 640, flash=True)
    if plant is None:
        _, counts = run()
        assert counts["flash_attention_fwd"] == {"bfloat16": 2}
        assert counts["flash_attention_backward"] == {"bfloat16": 2}
        assert "causal_prefill_attention" not in counts
    else:
        with pytest.raises(RuntimeError, match="gradients beyond their limits"):
            run()


def _peeled(x):
    """The elements of x [N, V] (a view of a 16-byte-aligned buffer) that
    K7 reads and writes one a thread: those of each row's first and last
    16-byte chunk where the row's start or end cuts the chunk."""
    N, V = x.shape
    E = 16 // x.element_size()
    start = x.storage_offset() + V * torch.arange(N)[:, None]
    idx = start + torch.arange(V)[None, :]
    head = (start % E != 0) & (idx < (start // E + 1) * E)
    end = start + V
    tail = (end % E != 0) & (idx >= end // E * E)
    return head | tail


def _one_unit_off(dx):
    """dx with every other element moved by a unit of its last place."""
    if dx.dtype == torch.bfloat16:
        bits = dx.view(torch.int16).clone()
        bits.view(-1)[::2] += 1
        return bits.view(torch.bfloat16)
    out = dx.clone()
    out.view(-1)[::2] *= 1 + 2 ** -23
    return out


@pytest.mark.parametrize("scale", [1.0, 3.0])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_k7_comparison_refuses_planted_faults(monkeypatch, dt, scale):
    """chip_smoke's K7 comparison at V = 1001 from an element offset of 1
    (rows at every phase of 16 bytes), logits of standard deviation
    `scale` (at 1 no probability is large): the plain dx passes, also a
    unit of its last place off; dx with the peeled elements left at zero,
    or with the probabilities off the label halved, is refused."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    N, V, off = 16, 1001, 1
    rng = np.random.default_rng(12)
    buf = torch.from_numpy((scale * rng.standard_normal(N * V + off)).astype(
        np.float32)).to(dt)
    x = buf[off:].view(N, V)
    lab = torch.from_numpy(rng.integers(0, V, N).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    ref = k7.softmax_xent_bwd_plain(x, lab, g)
    peeled = _peeled(x)
    assert peeled.any(dim=1).all()
    chip_smoke._agree_xent("plain", ref.clone(), ref)
    chip_smoke._agree_xent("a unit off", _one_unit_off(ref), ref)
    onehot = torch.arange(V)[None, :] == lab.long()[:, None]
    faults = {"peeled elements left at zero": ref.masked_fill(peeled, 0),
              "softmax mass off the label halved": torch.where(
                  onehot, ref, (0.5 * ref.float()).to(dt))}
    for name, dx in faults.items():
        with pytest.raises(RuntimeError, match="disagrees"):
            chip_smoke._agree_xent(name, dx, ref)


def _chain(x, w1, w2, w3, fault=None):
    """The bottleneck chain as bottleneck_block_plain computes it, with
    `fault` planted: "halo" (each 4-row strip's 3x3 sees zeros past its
    own rows), "centre" (w2[1, 1] zeroed) or "y3" (y3 scaled by 0.98)."""
    Bx, Hx, Wx, Cx = x.shape
    Mx = w1.shape[1]
    f = lambda t: t.float()  # noqa: E731
    y1 = torch.relu(f(x).reshape(-1, Cx) @ f(w1)).to(x.dtype)
    y1 = y1.reshape(Bx, Hx, Wx, Mx)
    if fault == "centre":
        w2 = w2.clone()
        w2[1, 1] = 0
    strips = range(0, Hx, 4) if fault == "halo" else (0,)
    rows = 4 if fault == "halo" else Hx
    acc = torch.zeros((Bx, Hx, Wx, Mx))
    for r0 in strips:
        y1p = torch.nn.functional.pad(y1[:, r0:r0 + rows], (0, 0, 1, 1, 1, 1))
        for dy in range(3):
            for dx in range(3):
                acc[:, r0:r0 + rows] += (f(y1p[:, dy:dy + rows, dx:dx + Wx])
                                         @ f(w2[dy, dx]))
    y2 = torch.relu(acc).to(x.dtype)
    y3 = (f(y2).reshape(-1, Mx) @ f(w3)).reshape(x.shape)
    if fault == "y3":
        y3 = 0.98 * y3
    return torch.relu(y3 + f(x)).to(x.dtype)


def test_bottleneck_comparison_sees_the_chain(monkeypatch):
    """chip_smoke's #15 comparison at the unit input set, the tool's widths
    (C = 256, M = 64) at B = 2, 16 x 16: the tool's `kernel` body through
    pl.pallas_call(interpret=True) passes against the plain version; the
    plain chain with the halo dropped at 4-row strip boundaries, with the
    centre tap of w2 zeroed, or with y3 scaled by 0.98 is refused."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    import tools._rn_pallas_block as tool

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    Bt, Ht = 2, 16
    monkeypatch.setattr(tool, "H", Ht)
    monkeypatch.setattr(tool, "W", Ht)
    C, M = tool.C, tool.M
    x, w1, w2, w3 = k15.inputs("cpu", 5, (Bt, Ht, Ht, C, M), scale="unit")
    ref = k15.bottleneck_block_plain(x, w1, w2, w3)
    assert torch.equal(_chain(x, w1, w2, w3), ref)
    jx = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (x, w1, w2, w3)]
    out = pl.pallas_call(
        tool.kernel, grid=(Bt,),
        in_specs=[pl.BlockSpec((1, Ht, Ht, C), lambda b: (b, 0, 0, 0)),
                  pl.BlockSpec((C, M), lambda b: (0, 0)),
                  pl.BlockSpec((3, 3, M, M), lambda b: (0, 0, 0, 0)),
                  pl.BlockSpec((M, C), lambda b: (0, 0))],
        out_specs=pl.BlockSpec((1, Ht, Ht, C), lambda b: (b, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((Bt, Ht, Ht, C), tool.DT),
        scratch_shapes=[pltpu.VMEM((Ht + 2, Ht + 2, M), tool.DT)],
        interpret=True)(*jx)
    tool_out = torch.from_numpy(np.array(out.astype(jnp.float32))).to(
        torch.bfloat16)
    chip_smoke._agree16("the tool's kernel", tool_out, ref)
    for fault in ("halo", "centre", "y3"):
        with pytest.raises(RuntimeError, match="disagrees"):
            chip_smoke._agree16(fault, _chain(x, w1, w2, w3, fault), ref)


# bench_wmt's CPU widths (bench.py:366) in place of Transformer-base's:
# the script's WMT AMP phase at B=4, src = tgt = 16, and its dropout phase
# (wmt_base()'s dropout 0.1 at these widths) at B=4
WMT_TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                ffn_size=128, max_position=64, dropout=0.0, use_tp=False)


@pytest.fixture
def cpu_wmt(cpu_smoke):
    for name, value in (("WMT_BASE", WMT_TINY), ("WMT_B", 4), ("WMT_S", 16),
                        ("WMT_DROP_B", 4), ("TRAIN_STEPS", 2)):
        cpu_smoke.setattr(chip_smoke, name, value)
    return cpu_smoke


def _plant_k4_cross(monkeypatch):
    """K4's dK scaled by 1.5 in its first call of a step: the backward
    reaches the last decoder layer's cross-attention first."""
    from paddle_tpu_torch.ops.cuda_kernels import attention_bwd as k4

    plain, seen = k4.attention_backward_plain, []

    def faulty(q, k, v, *args, **kw):
        dq, dk, dv = plain(q, k, v, *args, **kw)
        if not seen:
            seen.append(1)
            dk = (1.5 * dk.float()).to(dk.dtype)
        return dq, dk, dv
    monkeypatch.setattr(k4, "attention_backward_plain", faulty)


@pytest.mark.parametrize("plant", [None, "k4"])
def test_wmt_amp_gate_holds_the_port_and_refuses_a_planted_fault(cpu_wmt,
                                                                 plant):
    """The WMT AMP phase on the CPU: the port passes with K2/K4 three times
    a layer pair (encoder and decoder self-attention, cross-attention) and
    K3/K5 five times, all bf16, and no cross entropy kernel (soft labels);
    a K4 whose dK is scaled by 1.5 in the last decoder layer's
    cross-attention is refused by the gradient gate."""
    if plant:
        _plant_k4_cross(cpu_wmt)
    run = lambda: chip_smoke.train_wmt_amp(torch.device("cpu"), "CPU")  # noqa: E731
    if plant is None:
        _, counts = run()
        assert counts == {"causal_prefill_attention": {"bfloat16": 6},
                          "attention_backward": {"bfloat16": 6},
                          "layer_norm_act": {"bfloat16": 10},
                          "layer_norm_act_backward": {"bfloat16": 10}}
    else:
        with pytest.raises(RuntimeError, match="gradients beyond their limits"):
            run()


def _plant_flipped_mask_bit(monkeypatch):
    """The first dropout of a run reports a Mask with one element flipped
    (kept <-> dropped, where X is not 0) from the mask it applied."""
    from paddle_tpu_torch.ops import registry

    d = registry.get_op_def("dropout")
    plain, seen = d.compute, []

    def faulty(ctx):
        out = plain(ctx)
        if not ctx.is_meta and not seen:
            seen.append(1)
            m = out["Mask"].clone()
            i = int(ctx.input("X").reshape(-1).nonzero()[0])
            keep = m.reshape(-1).max()
            m.view(-1)[i] = keep if m.view(-1)[i] == 0 else 0
            out = dict(out, Mask=m)
        return out
    monkeypatch.setattr(d, "compute", faulty)


@pytest.mark.parametrize("plant", [None, "mask"])
def test_wmt_dropout_gate_holds_the_port_and_refuses_a_flipped_mask_bit(
        cpu_wmt, plant):
    """The dropout phase on the CPU: the port passes (no attention kernel,
    the attention unfused; K3/K5 bf16); one mask bit flipped between the
    mask an op applied and the mask the oracle reads is refused."""
    if plant:
        _plant_flipped_mask_bit(cpu_wmt)
    run = lambda: chip_smoke.train_wmt_dropout(torch.device("cpu"), "CPU")  # noqa: E731
    if plant is None:
        counts = run()
        assert counts == {"layer_norm_act": {"bfloat16": 10},
                          "layer_norm_act_backward": {"bfloat16": 10}}
    else:
        with pytest.raises(RuntimeError, match="dropout mask .*X \\* Mask"):
            run()


# decoder_tiny's widths in place of BERT-base's (vocab 97, hidden 32, 2
# layers of 2 heads): the script's prefix-cache (fp32, exact gate) and bf16
# serving (teacher-forced gate) phases, a 32-token system prompt (2 pages
# of 16) with 5 suffixes of 3-16 tokens, then the prompt alone twice (full
# hits, copy-on-write), and 4 requests of 3-20 tokens, 6 new tokens each
SERVE_TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
                  ffn_size=64, max_position=64)
# At the initializer's scale decoder_tiny's attention is near uniform and
# averages V over the context to about nothing, so no fault in the context
# (a zeroed page, a page read one ordinal off) moves a bf16 logit by more
# than a few units of its last place. The engines of these cases scale
# their random q/k/v projections by 4 and the attention output projection
# by 2: attention peaked, as a trained model's is, and the context sets the
# logits. The port then stays within 4 units of the dense bf16 oracle.
QKV_SCALE, OUT_SCALE = 4.0, 2.0


@pytest.fixture
def cpu_serve_tiny(cpu_smoke):
    for name, value in (("SERVE_CFG", SERVE_TINY), ("SERVE_LENS", (3, 9, 17, 20)),
                        ("SERVE_NEW", 6), ("PREFIX_SYS", 32),
                        ("PREFIX_SUFFIX", (3, 5, 7, 9, 16))):
        cpu_smoke.setattr(chip_smoke, name, value)
    cpu_smoke.setattr(chip_smoke, "_check_serving_launches", lambda *a: None)
    return cpu_smoke


@pytest.fixture
def cpu_serving(cpu_serve_tiny):
    import paddle_tpu_torch.serving as sv

    cpu_smoke = cpu_serve_tiny

    class PeakedEngine(sv.ServingEngine):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            with torch.no_grad():
                for n in self.parameter_names():
                    if n.endswith(".mha.qkv.w"):
                        self._scope.find_var(n).mul_(QKV_SCALE)
                    elif n.endswith(".mha.out.w"):
                        self._scope.find_var(n).mul_(OUT_SCALE)
    cpu_smoke.setattr(sv, "ServingEngine", PeakedEngine)
    return cpu_smoke


def _plant_k1_shifted_table(monkeypatch):
    """K1's plain version reading each row's page table shifted by one
    page: ordinal i reads the page of ordinal i + 1."""
    from paddle_tpu_torch.ops.cuda_kernels import paged_attention as k1

    plain = k1.paged_decode_attention_plain

    def faulty(q, k_pool, v_pool, page_table, *args, **kw):
        return plain(q, k_pool, v_pool, page_table.roll(-1, dims=1), *args,
                     **kw)
    monkeypatch.setattr(k1, "paged_decode_attention_plain", faulty)


def _plant_cow_without_copy(monkeypatch):
    """Copy-on-write that skips the copy: the new page stays zero."""
    from paddle_tpu_torch.ops import attention_ops

    def faulty(k_pool, v_pool, src, dst):
        for pool in (k_pool, v_pool):
            pool[dst.long().reshape(-1)[:1]] = 0
        return k_pool, v_pool
    monkeypatch.setattr(attention_ops, "kv_cache_copy_page_", faulty)


@pytest.mark.parametrize("plant", [None, "k1_shifted_table", "cow_without_copy"])
@pytest.mark.parametrize("phase", ["prefix_fp32", "bf16"])
def test_serving_gates_hold_the_port_and_refuse_a_planted_fault(
        cpu_serving, phase, plant):
    """The prefix-cache phase's exact fp32 gate (the dense oracle and the
    prefix_cache=False engine) and the bf16 phase's teacher-forced gate
    (within BF16_DELTA_ULPS bf16 units of the dense bf16 oracle's max), at
    decoder_tiny's widths on the CPU with peaked attention: each passes the
    port and refuses a K1 that reads the page table one page off and a
    copy-on-write that leaves the new page zero."""
    if plant == "k1_shifted_table":
        _plant_k1_shifted_table(cpu_serving)
    elif plant == "cow_without_copy":
        _plant_cow_without_copy(cpu_serving)
    run = {"prefix_fp32": chip_smoke.serve_prefix,
           "bf16": chip_smoke.serve_bf16}[phase]
    if plant is None:
        run(torch.device("cpu"), "CPU")
    else:
        with pytest.raises(RuntimeError, match="oracle|units below"):
            run(torch.device("cpu"), "CPU")


def test_bf16_fault_phase_refuses_both_faults(cpu_serve_tiny, capsys):
    """chip_smoke's serve_bf16_faults at decoder_tiny's widths on the CPU,
    the faults planted where the card's path calls them (the K1 wrapper's
    page table, the copy-on-write's page copy): the gate refuses a K1 that
    reads one page on at the random weights, and a copy-on-write that
    leaves the new page zero once the attention is peaked, which then also
    passes the unfaulted engine."""
    chip_smoke.serve_bf16_faults(torch.device("cpu"), "CPU")
    out = capsys.readouterr().out
    assert "refused k1_shifted_table at hidden width 32 with the random" in out
    assert "refused cow_without_copy at hidden width 32 with peaked" in out
    assert "passed the unfaulted engine with peaked attention" in out


def _plant_lamb_without_trust(monkeypatch):
    """LAMB's step without its trust ratio: p - lr r."""
    from paddle_tpu_torch.ops import registry

    d = registry.get_op_def("lamb")
    plain = d.compute

    def faulty(ctx):
        out = plain(ctx)
        p = ctx.input("Param").float()
        g = ctx.input("Grad").float()
        b1p = ctx.input("Beta1Pow").reshape(())
        b2p = ctx.input("Beta2Pow").reshape(())
        r = ((out["Moment1Out"] / (1 - b1p))
             / (torch.sqrt(out["Moment2Out"] / (1 - b2p)) + 1e-6) + 0.01 * p)
        lr = ctx.input("LearningRate").reshape(())
        assert g.shape == p.shape
        return dict(out, ParamOut=(p - lr * r).to(ctx.input("Param").dtype))
    monkeypatch.setattr(d, "compute", faulty)


@pytest.mark.parametrize("plant", [None, "no_trust"])
def test_lamb_phase_holds_the_port_and_refuses_a_planted_fault(cpu_smoke,
                                                               plant):
    """chip_smoke's LAMB phase at bert_tiny's widths, B=4, S=16 on the CPU:
    the port passes (schedule, step-1 formula, beta powers, launches), and
    a LAMB that drops the trust ratio is refused by the step-1 hold, whose
    limit is 1e-2 of each parameter's own step."""
    cpu_smoke.setattr(chip_smoke, "BERT_BASE", BERT_TINY)
    cpu_smoke.setattr(chip_smoke, "AMP_S", 16)
    if plant:
        _plant_lamb_without_trust(cpu_smoke)
    run = lambda: chip_smoke.train_bert_lamb(torch.device("cpu"), "CPU")  # noqa: E731
    if plant is None:
        _, counts = run()
        assert counts["causal_prefill_attention"] == {"bfloat16": 2}
        assert counts["layer_norm_act"] == {"float32": 1, "bfloat16": 4}
    else:
        with pytest.raises(RuntimeError, match="LAMB step-1 weights differ"):
            run()


def test_optimizer_phase_runs_on_the_cpu(cpu_smoke, monkeypatch):
    """chip_smoke's check_optimizers with the CPU standing in for the card
    (both sides the CPU, so they agree exactly; the sync debug mode is the
    card's alone, so the dispatch count is stubbed), and its dgc check at
    a small shape."""
    class Timer:
        def __init__(self, dev):
            pass

        def __call__(self, fn, reps=5):
            fn()
            return 0.0

    sync_free = chip_smoke._sync_free

    def stub(types, seen):
        seen.update(dict.fromkeys(types, 1))
        return sync_free(types, seen)
    monkeypatch.setattr(chip_smoke, "_Timer", Timer)
    monkeypatch.setattr(chip_smoke, "_sync_free", stub)
    monkeypatch.setattr(chip_smoke, "DGC_SHAPE", (300, 64))
    chip_smoke.check_optimizers(torch.device("cpu"), "CPU")



@pytest.fixture
def cpu_s2s(cpu_smoke):
    """chip_smoke's seq2seq phases cut to a dictionary of 4 words (EOS
    then comes up in the beams, so finished beams are continued), widths 8,
    B=4 pairs of up to 6 tokens, a decode of 2 sources in 3 beams over 8
    steps, 2 timed steps at lr 1e-2."""
    for name, value in (("S2S_DICT", 4), ("S2S_WORD", 8), ("S2S_HIDDEN", 8),
                        ("S2S_B", 4), ("S2S_T", 6), ("S2S_MIN_LEN", 2),
                        ("S2S_LR", 1e-2), ("S2S_STEPS", 2), ("S2S_DEC_B", 2),
                        ("S2S_BEAM", 3), ("S2S_MAX_LEN", 8)):
        cpu_smoke.setattr(chip_smoke, name, value)
    return cpu_smoke


def _plant_unfrozen_beams(monkeypatch):
    """beam_search without the frozen-beam rule: a finished row proposes
    its candidates like a live one."""
    from paddle_tpu_torch.ops import registry

    d = registry.get_op_def("beam_search")
    plain = d.compute

    def faulty(ctx):
        pre = ctx.input("pre_ids")
        ctx.env[ctx.op.inputs["pre_ids"][0]] = torch.full_like(pre, -7)
        try:
            return plain(ctx)
        finally:
            ctx.env[ctx.op.inputs["pre_ids"][0]] = pre
    monkeypatch.setattr(d, "compute", faulty)


def _plant_gru_unit_u_r_swapped(monkeypatch):
    """gru_unit with its update and reset gates swapped."""
    from paddle_tpu_torch.ops import registry, rnn_ops

    step = rnn_ops._gru_step

    def swapped(x_t, h_prev, weight, bias, *rest):
        H = h_prev.shape[-1]
        perm = torch.cat([torch.arange(H, 2 * H), torch.arange(H),
                          torch.arange(2 * H, 3 * H)])
        bias = None if bias is None else bias[:, perm]
        return step(x_t[:, perm], h_prev, weight[:, perm], bias, *rest)

    d = registry.get_op_def("gru_unit")
    plain = d.compute

    def faulty(ctx):
        monkeypatch.setattr(rnn_ops, "_gru_step", swapped)
        try:
            return plain(ctx)
        finally:
            monkeypatch.setattr(rnn_ops, "_gru_step", step)
    monkeypatch.setattr(d, "compute", faulty)


@pytest.mark.parametrize("plant", [None, "unfrozen_beams", "gru_u_r_swapped"])
def test_seq2seq_gates_hold_the_port_and_refuse_a_planted_fault(
        cpu_s2s, capsys, plant):
    """chip_smoke's seq2seq phase on the CPU: the training step against its
    oracle and the decode's beams against theirs pass the port, with
    finished beams continued in the decode; the decode gate refuses a
    beam_search without the frozen-beam rule, and a gru_unit with u and r
    swapped (there the training step's oracle refuses it first)."""
    if plant == "unfrozen_beams":
        _plant_unfrozen_beams(cpu_s2s)
    elif plant == "gru_u_r_swapped":
        _plant_gru_unit_u_r_swapped(cpu_s2s)
    run = lambda: chip_smoke.train_seq2seq(torch.device("cpu"), "CPU")  # noqa: E731
    if plant is None:
        counts, dec_counts = run()
        assert counts == {"softmax_xent_fwd": {"float32": 1},
                          "softmax_xent_bwd": {"float32": 1}}
        out = capsys.readouterr().out
        frozen = int(out.split(" selections continuing a finished beam")[0]
                     .rsplit(" ", 1)[1])
        assert frozen > 0, out
    elif plant == "unfrozen_beams":
        with pytest.raises(RuntimeError, match="not the oracle's best"):
            run()
    else:
        with pytest.raises(RuntimeError, match="differs from the oracle|loss"):
            run()


def test_seq2seq_decode_gate_refuses_u_r_swapped(cpu_s2s):
    """The decode gate alone (the training step skipped: the decode reads
    the startup's weights) refuses a gru_unit with u and r swapped."""
    import paddle_tpu_torch as pt

    _plant_gru_unit_u_r_swapped(cpu_s2s)
    main, startup, loss, infer, sent, scores = chip_smoke._s2s_programs()
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(RuntimeError, match="not the oracle's best"):
        chip_smoke.decode_seq2seq(torch.device("cpu"), "CPU", exe, scope,
                                  infer, sent, scores)


def test_mnist_phase_holds_the_port(cpu_smoke):
    """chip_smoke's MNIST phase at B=8 on the CPU: both models against
    their oracles, K6/K7 once each a step."""
    cpu_smoke.setattr(chip_smoke, "MNIST_B", 8)
    cpu_smoke.setattr(chip_smoke, "MNIST_STEPS", 2)
    runs = chip_smoke.train_mnist(torch.device("cpu"), "CPU")
    assert runs == [{"softmax_xent_fwd": {"float32": 1},
                     "softmax_xent_bwd": {"float32": 1}}] * 2


def _plant_recompute_drops_a_dep_grad(monkeypatch):
    """recompute_grad that drops its last floating dep's gradient (zeros,
    what the executor reads for a gradient never produced)."""
    from paddle_tpu_torch.ops import registry

    d = registry.get_op_def("recompute_grad")
    plain = d.compute

    def faulty(ctx):
        out = plain(ctx)
        grads = out["Deps@GRAD"]
        i = max(j for j, g in enumerate(grads) if g is not None)
        grads = list(grads)
        grads[i] = torch.zeros_like(grads[i])
        return dict(out, **{"Deps@GRAD": grads})
    monkeypatch.setattr(d, "compute", faulty)


@pytest.mark.parametrize("plant", [None, "dropped_dep_grad"])
def test_recompute_gate_holds_the_port_and_refuses_a_planted_fault(
        cpu_smoke, plant):
    """chip_smoke's recompute phase after the long-context AMP phase at
    bert_tiny's widths, S=640, B=2 on the CPU: the loss bit for bit the
    plain step's, the gradients within the gate, K10 twice a layer (the
    forward and the replay), K11 once, K3/K5 bf16 in the replays; a
    recompute_grad that drops one dep's gradient is refused."""
    cpu_smoke.setattr(chip_smoke, "BERT_BASE", BERT_TINY)
    cpu_smoke.setattr(chip_smoke, "LONG_B", 2)
    cpu_smoke.setattr(chip_smoke, "LONG_S", 640)
    cpu_smoke.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)
    _, _, plain = chip_smoke.train_bert_amp(torch.device("cpu"), "CPU", 2, 640,
                                            flash=True, keep=True)
    if plant:
        _plant_recompute_drops_a_dep_grad(cpu_smoke)
        with pytest.raises(RuntimeError, match="relative L2"):
            chip_smoke.train_bert_recompute(torch.device("cpu"), "CPU", plain)
        return
    _, counts = chip_smoke.train_bert_recompute(torch.device("cpu"), "CPU",
                                                plain)
    assert counts["flash_attention_fwd"] == {"bfloat16": 4}
    assert counts["flash_attention_backward"] == {"bfloat16": 2}
    assert counts["layer_norm_act"] == {"float32": 2, "bfloat16": 8}
    assert counts["layer_norm_act_backward"] == {"float32": 1, "bfloat16": 4}


@pytest.fixture
def cpu_infer(cpu_smoke):
    """chip_smoke's predictor phases at a small size on the CPU: ResNet-50
    at B=2, 64x64; BERT at bert_tiny's widths, B=2, S=16; no profiler."""
    for name, value in (("IR_B", 2), ("IB_B", 2), ("IB_S", 16),
                        ("BERT_BASE", BERT_TINY)):
        cpu_smoke.setattr(chip_smoke, name, value)
    cpu_smoke.setattr(chip_smoke, "_profile", lambda *a, **k: None)
    cpu_smoke.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)
    return cpu_smoke


def test_resnet_predictor_phase_holds_the_port(cpu_infer, capsys):
    """The fp32 predictor bit for bit the direct run and within the oracle
    gate, 53 K8 launches in each dtype, the bf16 gate passing the port and
    refusing K8 reading the variance one channel on."""
    counts, _ = chip_smoke.infer_resnet(torch.device("cpu"), "CPU")
    assert counts == [{"bn_apply_act": {"float32": 53}},
                      {"bn_apply_act": {"bfloat16": 53}}]
    assert "refuses K8 reading the variance one channel on" in \
        capsys.readouterr().out


def test_bert_predictor_phase_holds_the_port(cpu_infer, capsys):
    counts, _ = chip_smoke.infer_bert(torch.device("cpu"), "CPU")
    L = chip_smoke._bert_cfg(16).num_layers
    for dt, c in zip(("float32", "bfloat16"), counts):
        assert c == {"causal_prefill_attention": {dt: L},
                     "layer_norm_act": {dt: 2 * L + 1}}
    assert "refuses K2 reading the keys one position on" in \
        capsys.readouterr().out


def _plant_bn_fn_without_chain(monkeypatch):
    """`_BatchNormFn`'s backward without K9's chain mode: dx misses the
    batch statistics' own chain."""
    from paddle_tpu_torch.ops import nn_ops

    fwd = nn_ops._BatchNormFn.forward

    def forward(fctx, x2, scale, bias, mean, inv, res2, act, mode, count):
        return fwd(fctx, x2, scale, bias, mean, inv, res2, act, mode, None)
    monkeypatch.setattr(nn_ops._BatchNormFn, "forward", staticmethod(forward))


@pytest.mark.parametrize("plant", [None, "bn_without_chain"])
def test_resnet_recompute_phase_holds_the_port_and_refuses_a_planted_fault(
        cpu_smoke, plant):
    """chip_smoke's ResNet-50 AMP recompute phase at B=4, 64x64 on the
    CPU: loss and running statistics bit for bit the plain step's,
    gradients within the gate, K8 twice a batch norm and K9 once in the
    replays, K6 twice and K7 once; a `_BatchNormFn` whose backward drops
    the statistics' chain is refused."""
    cpu_smoke.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)
    cpu_smoke.setattr(chip_smoke, "RN_STEPS", 1)
    if plant:
        _plant_bn_fn_without_chain(cpu_smoke)
        with pytest.raises(RuntimeError, match="relative L2"):
            chip_smoke.recompute_resnet(torch.device("cpu"), "CPU")
        return
    counts, _ = chip_smoke.recompute_resnet(torch.device("cpu"), "CPU")
    assert counts == {"bn_apply_act": {"bfloat16": 106},
                      "bn_apply_act_backward": {"bfloat16": 53},
                      "softmax_xent_fwd": {"bfloat16": 2},
                      "softmax_xent_bwd": {"bfloat16": 1}}


def test_book_rest_phase_holds_the_port(cpu_smoke):
    """chip_smoke's word2vec and dense DeepFM phase at B=16 and, DeepFM,
    B=64 over a vocabulary of 1000 on the CPU: step 1 against the
    oracles, the SGD update, the loss falling; no kernel launched."""
    cpu_smoke.setattr(chip_smoke, "W2V_B", 16)
    cpu_smoke.setattr(chip_smoke, "DFM_B", 64)
    cpu_smoke.setattr(chip_smoke, "DFM_CFG", dict(chip_smoke.DFM_CFG,
                                                  vocab_size=1000))
    assert chip_smoke.book_rest(torch.device("cpu"), "CPU") == [{}, {}]


@pytest.fixture
def cpu_data(cpu_smoke, tmp_path):
    """chip_smoke's data-pipeline phases cut to 2 MultiSlot files of 256
    lines, batch 64 (8 batches a pass), DeepFM at vocab 2000 with a
    16-wide tower, 2 timed passes, the sequence tail at B=4, T=12, D=8 and
    recurrent widths 8; the data under tmp_path. The loader gate (a side
    CUDA stream) has nothing to hold on the CPU."""
    for name, value in (("CTR_FILES", 2), ("CTR_LINES", 256), ("CTR_B", 64),
                        ("CTR_PASSES", 2), ("CTR_DEVICE_ITERS", 2),
                        ("CTR_DEVICE_WINDOWS", 1), ("SEQ_B", 4), ("SEQ_T", 12),
                        ("SEQ_D", 8), ("SEQ_RNN_B", 3), ("SEQ_RNN_H", 8),
                        ("SEQ_PROJ", 4), ("SEQ_ROW", (2, 9, 8)),
                        ("SMOKE_DATA", str(tmp_path))):
        cpu_smoke.setattr(chip_smoke, name, value)
    cpu_smoke.setattr(chip_smoke, "DFM_CFG", dict(
        chip_smoke.DFM_CFG, vocab_size=2000, hidden_sizes=(16, 16, 16)))
    cpu_smoke.setattr(chip_smoke, "_check_loader", lambda *a: None)
    return cpu_smoke


def _plant_sgd_last_write_wins(monkeypatch):
    """sgd's row update by index_copy: of repeated ids only one row's
    update lands."""
    from paddle_tpu_torch.core.selected_rows import is_selected_rows
    from paddle_tpu_torch.ops import registry

    d = registry.get_op_def("sgd")
    plain = d.compute

    def faulty(ctx):
        g = ctx.input("Grad")
        if not is_selected_rows(g):
            return plain(ctx)
        p, lr = ctx.input("Param"), ctx.input("LearningRate").reshape(())
        rows = g.rows.long()
        return {"ParamOut": p.index_copy(0, rows, p[rows] - lr * g.values)}
    monkeypatch.setattr(d, "compute", faulty)


def _plant_dense_adam(monkeypatch):
    """adam on the SelectedRows grad made dense: every row's moments decay
    and every row with a moment moves (not lazy)."""
    from paddle_tpu_torch.core.selected_rows import is_selected_rows
    from paddle_tpu_torch.ops import registry

    d = registry.get_op_def("adam")
    plain = d.compute

    def faulty(ctx):
        name = ctx.op.inputs["Grad"][0]
        g = ctx.env[name]
        if is_selected_rows(g):
            ctx.env[name] = g.to_dense()
        try:
            return plain(ctx)
        finally:
            ctx.env[name] = g
    monkeypatch.setattr(d, "compute", faulty)


@pytest.mark.parametrize("plant", [None, "sgd_last_write_wins", "dense_adam"])
def test_ctr_phase_holds_the_port_and_refuses_a_planted_fault(cpu_data, capsys,
                                                              plant):
    """chip_smoke's DeepFM phase on the CPU: the parser, sparse = dense,
    lazy Adam and trainer gates pass the port; sparse = dense refuses an
    sgd whose repeated ids keep one update; the lazy Adam gate's second
    step refuses an adam that is not lazy (rows with moments that the
    step's ids miss move)."""
    if plant == "sgd_last_write_wins":
        _plant_sgd_last_write_wins(cpu_data)
    elif plant == "dense_adam":
        _plant_dense_adam(cpu_data)
    run = lambda: chip_smoke.ctr_deepfm(torch.device("cpu"), "CPU")  # noqa: E731
    if plant is None:
        assert run() == {}
        out = capsys.readouterr().out
        assert "equal bit for bit to the plain parser" in out
        assert "with nonzero moments" in out and "end to end" in out
    elif plant == "sgd_last_write_wins":
        with pytest.raises(RuntimeError, match="relative L2 away"):
            run()
    else:
        with pytest.raises(RuntimeError, match="step 2: untouched rows"):
            run()


def test_sparse_word2vec_and_seq_tail_phases_run_on_the_cpu(cpu_data, capsys):
    """chip_smoke's sparse word2vec phase and its sequence/RNN tail phase
    (the CPU on both sides, so only the phase's plumbing is held)."""
    def once(run, iters=5, passes=3):
        run()
        return [1.0]

    cpu_data.setattr(chip_smoke, "_timed_windows", once)
    assert chip_smoke.sparse_word2vec(torch.device("cpu"), "CPU") == {}
    chip_smoke.seq_tail(torch.device("cpu"), "CPU")
    out = capsys.readouterr().out
    assert "one SelectedRows of 400 rows" in out
    assert out.count(" grads, worst ") == 12


@pytest.fixture
def cpu_giant(cpu_data):
    """chip_smoke's giant-embedding phase cut to 4 files of 256 zipf lines,
    batch 64 (16 batches a pass), fm_emb 20,000 x 16 (1.28 MB) against a
    0.25 MB budget (4096 slots; fm_w1, 80 KB, stays dense), an evicting
    arm at 1024 slots; the trace stubbed (no device here) and the sync
    debug mode's dispatch count kept on the CPU."""
    for name, value in (("GIANT_VOCAB", 20_000), ("GIANT_BUDGET_MB", 0.25),
                        ("GIANT_SLOTS", 4096), ("GIANT_EVICT_SLOTS", 1024),
                        ("GIANT_FILES", 4)):
        cpu_data.setattr(chip_smoke, name, value)
    cpu_data.setattr(chip_smoke, "_profile", lambda *a, **k: None)

    def counting(types, seen):
        from paddle_tpu_torch.ops.registry import get_op_def

        saved = {t: get_op_def(t).compute for t in types}

        def wrap(t, plain):
            def compute(ctx):
                seen[t] = seen.get(t, 0) + 1
                return plain(ctx)
            return compute

        for t, plain in saved.items():
            get_op_def(t).compute = wrap(t, plain)

        def undo():
            for t, c in saved.items():
                get_op_def(t).compute = c
        return undo

    cpu_data.setattr(chip_smoke, "_sync_free", counting)
    return cpu_data


def _plant_evicted_after_install(monkeypatch):
    """emb_cache_install's Evicted read from the cache after the install
    (a view of the post-install rows): the evicted rows' trained values
    never reach the host tier."""
    from paddle_tpu_torch.ops import registry

    d = registry.get_op_def("emb_cache_install")
    plain = d.compute

    def faulty(ctx):
        out = plain(ctx)
        idx = ctx.input("Slots").reshape(-1).long()
        return {"Out": out["Out"], "Evicted": out["Out"][idx]}
    monkeypatch.setattr(d, "compute", faulty)


@pytest.mark.parametrize("plant", [None, "evicted_after_install"])
def test_giant_phase_holds_the_port_and_refuses_a_planted_fault(
        cpu_giant, capsys, plant):
    """chip_smoke's ctr_giant on the CPU: the parity, hit-rate, evicting
    arm, delta checkpoint and stall gates pass the port; an install whose
    Evicted reads the cache after the install is refused by the parity
    gate."""
    run = lambda: chip_smoke.ctr_giant(torch.device("cpu"), "CPU")  # noqa: E731
    if plant is None:
        assert run() == {}
        out = capsys.readouterr().out
        assert "end to end" in out and "evictions" in out
        assert "bit for bit the snapshot" in out
        assert "emb_host_stall raised StallError" in out
    else:
        _plant_evicted_after_install(cpu_giant)
        with pytest.raises(RuntimeError, match="tiered parity: drift"):
            run()
