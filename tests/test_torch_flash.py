"""The port's long-context attention (K10 forward, K11 backward: the port of
the bundled TPU flash-attention kernel, the JAX package's `flash_bundled`
arm) held against the JAX package.

* K10's and K11's plain versions against the bundled kernel module's own
  jnp references (`mha_reference_no_custom_vjp` with its residuals l and
  m, and `mha_reference_bwd`, which forms di from o as the kernel does),
  and against the JAX package's `flash_attention(use_pallas=True)` with
  its `jax.vjp`: fp32 and bf16, causal and not, S in {640, 1000}, dh in
  {16, 64, 128} (K10/K11 instantiate dh 64 and 128). The bundled kernel has no interpret mode and needs a TPU, so
  on the CPU `flash_attention` takes its `_reference_attention` arm.
* The dispatch: S = 512 reaches K2 and K4, S = 640 K10 and K11; the
  forward hands its output and log-sum-exp to the grad op through the
  executor's stash, and a grad op without them runs K10 again.
* bert_tiny at max_position = seq_len = 640 with use_flash_attention: the
  programs equal the JAX package's op for op, and 3 Adam steps follow its
  trajectory, fp32 and under AMP.

Tolerances, each of the max-abs of the reference:
  fp32: 1e-5 (sums in another order; measured 1.3e-6); lse atol 1e-5.
  bf16 against the bundled references on fp32 copies of the same bf16
  operands: 1e-2 (the port rounds P and dS to bf16 as the kernel does, the
  fp32 reference does not, and the outputs are rounded: measured 4.3e-3).
  bf16 against the JAX package's CPU arm: 3e-2 and 1.5e-2 in relative L2
  (that arm also rounds the scores themselves to bf16, where K10 keeps
  them fp32: measured 1.3e-2 and 5.4e-3).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas.ops.tpu import flash_attention as fa

import paddle_tpu as jpt
from paddle_tpu import unique_name as jun
from paddle_tpu.contrib import mixed_precision as jamp
from paddle_tpu.models import transformer as jtr
from paddle_tpu.ops import attention_ops as jao
import paddle_tpu_torch as tpt
from paddle_tpu_torch import backward as tbw
from paddle_tpu_torch import layers as TL
from paddle_tpu_torch import unique_name as tun
from paddle_tpu_torch.contrib import mixed_precision as tamp
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.ops import attention_ops as tao
from paddle_tpu_torch.ops.cuda_kernels import flash_attention as K10
from paddle_tpu_torch.ops.cuda_kernels import flash_attention_bwd as K11
from paddle_tpu_torch.weights import load_params

from __graft_entry__ import _example_feed

CASES = [(S, dh, causal, dt) for S, dh in ((640, 16), (1000, 64), (640, 128))
         for causal in (False, True) for dt in ("float32", "bfloat16")]
IDS = [f"S{S}-dh{dh}-{'causal' if c else 'full'}-{dt}" for S, dh, c, dt in CASES]
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
PKG_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (3e-2, 1.5e-2)}


def _inputs(S, dh, dt, n=4, B=1, nh=2):
    rng = np.random.default_rng(S + dh)
    return [torch.from_numpy(rng.standard_normal((B, nh, S, dh))
                             .astype(np.float32)).to(getattr(torch, dt))
            for _ in range(n)]


def _np(t):
    return t.float().numpy()


def _max_err(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(_np(got) - want).max() / np.abs(want).max())


def _rel_l2(got, want):
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(_np(got) - want) / np.linalg.norm(want))


@pytest.mark.parametrize("S,dh,causal,dt", CASES, ids=IDS)
def test_forward_plain_matches_the_bundled_reference(S, dh, causal, dt):
    q, k, v = _inputs(S, dh, dt, 3)
    sm = dh ** -0.5
    o, lse = K10.flash_attention_fwd_plain(q, k, v, causal, sm)
    jo, jl, jm = fa.mha_reference_no_custom_vjp(
        *(jnp.asarray(_np(t)) for t in (q, k, v)), causal=causal,
        sm_scale=sm, save_residuals=True)
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    assert _max_err(o, jo) <= TOL[dt]
    np.testing.assert_allclose(lse.numpy(), np.asarray(jm + jnp.log(jl)),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("S,dh,causal,dt", CASES, ids=IDS)
def test_backward_plain_matches_the_bundled_reference(S, dh, causal, dt):
    """mha_reference_bwd takes sm_scale = 1 only, so q comes pre-scaled;
    it is handed the port's o and the reference's l and m."""
    q, k, v, do = _inputs(S, dh, dt)
    q = (q.float() * dh ** -0.5).to(q.dtype)
    o, lse = K10.flash_attention_fwd_plain(q, k, v, causal, 1.0)
    got = K11.flash_attention_backward_plain(q, k, v, o, lse, do, causal, 1.0)
    jq, jk, jv, jdo, jo = (jnp.asarray(_np(t)) for t in (q, k, v, do, o))
    _, jl, jm = fa.mha_reference_no_custom_vjp(
        jq, jk, jv, causal=causal, sm_scale=1.0, save_residuals=True)
    want = fa.mha_reference_bwd(jq, jk, jv, None, None, jo, jl, jm, jdo,
                                causal=causal, sm_scale=1.0)
    for name, g, w in zip("qkv", got, want[:3]):
        assert g.dtype == q.dtype
        assert _max_err(g, w) <= TOL[dt], f"d{name}"


@pytest.mark.parametrize("S,dh,causal,dt", CASES, ids=IDS)
def test_plain_pair_matches_the_jax_flash_attention_and_its_vjp(S, dh, causal,
                                                                dt):
    q, k, v, do = _inputs(S, dh, dt)
    sm = dh ** -0.5
    o, lse = K10.flash_attention_fwd_plain(q, k, v, causal, sm)
    got = K11.flash_attention_backward_plain(q, k, v, o, lse, do, causal, sm)
    jd = jnp.float32 if dt == "float32" else jnp.bfloat16
    jq, jk, jv, jdo = (jnp.asarray(_np(t)).astype(jd) for t in (q, k, v, do))
    jo, vjp = jax.vjp(lambda a, b, c: jao.flash_attention(
        a, b, c, causal=causal, sm_scale=sm, use_pallas=True), jq, jk, jv)
    tmax, tl2 = PKG_TOL[dt]
    for name, g, w in zip(("o", "dq", "dk", "dv"), (o, *got), (jo, *vjp(jdo))):
        assert _max_err(g, w) <= tmax and _rel_l2(g, w) <= tl2, name


# -- the bf16 kernels' tile schedule, emulated -------------------------------
#
# bf16 K10/K11 on the card (csrc/flash_attention.cu, flash_attention_backward.cu)
# run in blocks of two warpgroups: K10 and K11's query pass own 128 query rows
# (64 a warpgroup) and stream key tiles of KN keys (K10: 128; the query pass:
# 128 at dh = 64, 64 at dh = 128), K11's key pass owns 128 keys (64 a
# warpgroup) and streams query tiles of 64 rows (32 at dh = 128). The emulation below follows
# that schedule in fp32 on bf16 values: the online softmax in base 2 with P
# rounded to bf16 at the running max, a warpgroup multiplying only the key
# tiles that hold a key at or before its last row (the key pass: the query
# tiles from its first key on), masks only where a tile crosses the causal
# bound or S, and the 7-product backward from lse and di = rowsum(O . dO).
# Band: 1e-2 of the reference's max-abs, as for the plain versions (P and dS
# rounded to bf16, outputs rounded; the references round neither).

LOG2E, LN2 = float(np.log2(np.e)), float(np.log(2.0))
FWD_KN, KEY_BLOCK = 128, 128


def _dq_kn(dh):
    return 128 if dh == 64 else 64


def _kv_qm(dh):
    return 64 if dh == 64 else 32


def _bf(t):
    return t.to(torch.bfloat16).float()


def _live(rows, cols, S, causal):
    live = (rows[:, None] < S) & (cols[None, :] < S)
    return live & (cols[None, :] <= rows[:, None]) if causal else live


def _emulate_fwd(q, k, v, causal, sm):
    """(out, lse) of [S, dh] fp32 operands holding bf16 values, by K10's
    tiles."""
    S, dh = q.shape
    out, lse = torch.zeros(S, dh), torch.zeros(S)
    for q0 in range(0, S, 128):
        key_end = min(S, q0 + 128) if causal else S
        ntiles = -(-key_end // FWD_KN)
        for w0 in (q0, q0 + 64):
            rows = torch.arange(w0, w0 + 64)
            mine = min(ntiles, (w0 + 63) // FWD_KN + 1) if causal else ntiles
            qw = torch.zeros(64, dh)
            qw[:max(0, min(64, S - w0))] = q[w0:w0 + 64]
            m, l = torch.full((64,), -np.inf), torch.zeros(64)
            o = torch.zeros(64, dh)
            for j in range(mine):
                k0 = j * FWD_KN
                cols = torch.arange(k0, k0 + FWD_KN)
                kt, vt = torch.zeros(FWD_KN, dh), torch.zeros(FWD_KN, dh)
                n = min(FWD_KN, S - k0)
                kt[:n], vt[:n] = k[k0:k0 + n], v[k0:k0 + n]
                s = qw @ kt.T * (sm * LOG2E)
                if k0 + FWD_KN > key_end or (causal and k0 + FWD_KN - 1 > w0):
                    live = (cols[None, :] < key_end) & (
                        cols[None, :] <= rows[:, None] if causal else True)
                    s = s.masked_fill(~live, -np.inf)
                mn = torch.maximum(m, s.amax(1))
                dead = mn == -np.inf
                alpha = torch.where(dead, 1.0, torch.exp2(m - mn))
                p = torch.where(dead[:, None], 0.0, torch.exp2(s - mn[:, None]))
                l = l * alpha + p.sum(1)
                o = o * alpha[:, None] + _bf(p) @ vt
                m = mn
            n = max(0, min(64, S - w0))
            out[w0:w0 + n] = _bf(o / l[:, None])[:n]
            lse[w0:w0 + n] = ((m + torch.log2(l)) * LN2)[:n]
    return out, lse


def _emulate_bwd(q, k, v, o, lse, do, causal, sm):
    """(dq, dk, dv) by K11's two passes over [S, dh] fp32 operands holding
    bf16 values: the query pass forms di = rowsum(O . dO) and dQ, the key
    pass dK and dV; P and dS are rebuilt in both (7 products)."""
    S, dh = q.shape
    kn = _dq_kn(dh)
    scale2 = sm * LOG2E
    pad = lambda t, r0, n: torch.cat(  # noqa: E731  rows r0.. of t, zeros past S
        [t[r0:r0 + n], torch.zeros(max(0, r0 + n - max(S, r0)), dh)])[:n]
    di = (o * do).sum(1)
    lse2 = lse * LOG2E
    dq = torch.zeros(S, dh)
    for q0 in range(0, S, 128):
        key_end = min(S, q0 + 128) if causal else S
        ntiles = -(-key_end // kn)
        for w0 in (q0, q0 + 64):
            rows = torch.arange(w0, w0 + 64)
            mine = min(ntiles, (w0 + 63) // kn + 1) if causal else ntiles
            qw, dow = pad(q, w0, 64), pad(do, w0, 64)
            rl = rows.clamp(max=S - 1)
            acc = torch.zeros(64, dh)
            for j in range(mine):
                k0 = j * kn
                cols = torch.arange(k0, k0 + kn)
                kt, vt = pad(k, k0, kn), pad(v, k0, kn)
                live = _live(rows, cols, S, causal) & (cols[None, :] < key_end)
                p = torch.where(live, torch.exp2(qw @ kt.T * scale2
                                                 - lse2[rl][:, None]), 0.0)
                ds = (dow @ vt.T - di[rl][:, None]) * p * sm
                acc += _bf(ds) @ kt
            n = max(0, min(64, S - w0))
            dq[w0:w0 + n] = _bf(acc)[:n]
    dk, dv = torch.zeros(S, dh), torch.zeros(S, dh)
    qm = _kv_qm(dh)
    for k0 in range(0, S, KEY_BLOCK):
        qfirst = k0 if causal else 0
        ntiles = -(-(S - qfirst) // qm)
        for wg, w0 in enumerate((k0, k0 + 64)):
            keys = torch.arange(w0, w0 + 64)
            first = min(ntiles, 64 * wg // qm) if causal else 0
            kw, vw = pad(k, w0, 64), pad(v, w0, 64)
            dka, dva = torch.zeros(64, dh), torch.zeros(64, dh)
            for j in range(first, ntiles):
                q0 = qfirst + j * qm
                cols = torch.arange(q0, q0 + qm)
                qt, dot = pad(q, q0, qm), pad(do, q0, qm)
                cl = cols.clamp(max=S - 1)
                live = _live(cols, keys, S, causal).T   # keys x queries
                p = torch.where(live, torch.exp2(kw @ qt.T * scale2
                                                 - lse2[cl][None, :]), 0.0)
                ds = (vw @ dot.T - di[cl][None, :]) * p * sm
                dva += _bf(p) @ dot
                dka += _bf(ds) @ qt
            n = max(0, min(64, S - w0))
            dk[w0:w0 + n], dv[w0:w0 + n] = _bf(dka)[:n], _bf(dva)[:n]
    return dq, dk, dv


TILE_CASES = [(S, dh, causal) for S in (63, 129, 193, 257) for dh in (64, 128)
              for causal in (False, True)]
TILE_IDS = [f"S{S}-dh{dh}-{'causal' if c else 'full'}" for S, dh, c in TILE_CASES]


@pytest.mark.parametrize("S,dh,causal", TILE_CASES, ids=TILE_IDS)
def test_bf16_tile_schedule_forward_matches_the_bundled_reference(S, dh,
                                                                 causal):
    q, k, v = (_bf(t[0, 0]) for t in _inputs(S, dh, "float32", 3))
    sm = dh ** -0.5
    o, lse = _emulate_fwd(q, k, v, causal, sm)
    jo, jl, jm = fa.mha_reference_no_custom_vjp(
        *(jnp.asarray(t.numpy())[None, None] for t in (q, k, v)),
        causal=causal, sm_scale=sm, save_residuals=True)
    assert _max_err(o, jo[0, 0]) <= TOL["bfloat16"]
    np.testing.assert_allclose(lse.numpy(), np.asarray(jm + jnp.log(jl))[0, 0],
                               rtol=0, atol=1e-5)
    po, plse = K10.flash_attention_fwd_plain(
        *(t[None, None].to(torch.bfloat16) for t in (q, k, v)), causal, sm)
    assert _max_err(o, _np(po[0, 0])) <= TOL["bfloat16"]
    np.testing.assert_allclose(lse.numpy(), plse[0, 0].numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("S,dh,causal", TILE_CASES, ids=TILE_IDS)
def test_bf16_tile_schedule_backward_matches_the_bundled_reference(S, dh,
                                                                  causal):
    """mha_reference_bwd takes sm_scale = 1 only, so q comes pre-scaled;
    both sides get the reference's o (rounded to bf16) and l, m."""
    q, k, v, do = (_bf(t[0, 0]) for t in _inputs(S, dh, "float32"))
    q = _bf(q * dh ** -0.5)
    jq, jk, jv, jdo = (jnp.asarray(t.numpy())[None, None] for t in (q, k, v, do))
    jo, jl, jm = fa.mha_reference_no_custom_vjp(
        jq, jk, jv, causal=causal, sm_scale=1.0, save_residuals=True)
    o = _bf(torch.from_numpy(np.array(jo[0, 0])))
    lse = torch.from_numpy(np.array(jm + jnp.log(jl))[0, 0])
    got = _emulate_bwd(q, k, v, o, lse, do, causal, 1.0)
    want = fa.mha_reference_bwd(jq, jk, jv, None, None,
                                jnp.asarray(o.numpy())[None, None], jl, jm,
                                jdo, causal=causal, sm_scale=1.0)
    for name, g, w in zip("qkv", got, want[:3]):
        assert _max_err(g, w[0, 0]) <= TOL["bfloat16"], f"d{name}"


# -- the op: dispatch and the stash ------------------------------------------

def _attention_program(S, dh=16, nh=2, B=1, causal=False):
    """q, k, v data vars -> fused_attention -> grads of Out with a fed
    cotangent, in the port."""
    main = tpt.Program()
    with tpt.program_guard(main, tpt.Program()), tun.guard():
        block = main.global_block
        ins = [block.create_var(name=n, shape=(B, nh, S, dh), dtype="float32",
                                stop_gradient=False) for n in "qkv"]
        out = TL.fused_attention(*ins, causal=causal, sm_scale=dh ** -0.5,
                                 use_pallas=True)
        cot = block.create_var(name="cot", shape=(B, nh, S, dh),
                               dtype="float32")
        grads = tbw.gradients([out], ins, [cot])
    feed = dict(zip(("q", "k", "v", "cot"),
                    (_np(t) for t in _inputs(S, dh, "float32"))))
    return main, feed, [out] + grads


def _spy(monkeypatch, calls, name):
    """Record the calls of attention_ops' kernel wrapper `name` on tensors
    (shape inference's calls on meta tensors left out)."""
    fn = getattr(tao, name)

    def spy(*args, **kwargs):
        out = fn(*args, **kwargs)
        if not args[0].is_meta:
            calls.append((name, args, out))
        return out
    monkeypatch.setattr(tao, name, spy)


@pytest.mark.parametrize("S,kernels", [
    (512, ["causal_prefill_attention", "attention_backward"]),
    (640, ["flash_attention_fwd", "flash_attention_backward"])])
def test_dispatch_by_sequence_length(monkeypatch, S, kernels):
    calls = []
    for name in ("causal_prefill_attention", "attention_backward",
                 "flash_attention_fwd", "flash_attention_backward"):
        _spy(monkeypatch, calls, name)
    main, feed, fetch = _attention_program(S)
    tpt.Executor(place="cpu").run(main, feed=feed, fetch_list=fetch,
                                  scope=tpt.Scope())
    assert [c[0] for c in calls] == kernels


def test_the_stash_hands_out_and_lse_to_the_grad_op(monkeypatch):
    calls = []
    for name in ("flash_attention_fwd", "flash_attention_backward"):
        _spy(monkeypatch, calls, name)
    main, feed, fetch = _attention_program(640, causal=True)
    tpt.Executor(place="cpu").run(main, feed=feed, fetch_list=fetch,
                                  scope=tpt.Scope())
    (fwd, _, (o, lse)), (bwd, args, _) = calls
    assert (fwd, bwd) == ("flash_attention_fwd", "flash_attention_backward")
    assert args[3] is o and args[4] is lse


def test_grad_op_without_the_stash_runs_the_forward_again(monkeypatch):
    """The grad op alone (its forward never ran in this executor run):
    K10 runs again for o and lse, and the grads are the same."""
    main, feed, fetch = _attention_program(640)
    full = tpt.Executor(place="cpu").run(main, feed=feed, fetch_list=fetch,
                                         scope=tpt.Scope())
    grad_op = next(op for op in main.global_block.ops
                   if op.type == "fused_attention_grad")
    env = {n: torch.from_numpy(feed[n]) for n in "qkv"}
    env[grad_op.inputs["Out@GRAD"][0]] = torch.from_numpy(feed["cot"])
    calls = []
    _spy(monkeypatch, calls, "flash_attention_fwd")
    out = tao.fused_attention_grad(tao.ExecContext(
        grad_op, env, torch.device("cpu"), stash={}))
    assert [c[0] for c in calls] == ["flash_attention_fwd"]
    for slot, want in zip(("Q@GRAD", "K@GRAD", "V@GRAD"), full[1:]):
        np.testing.assert_array_equal(out[slot].numpy(), want)


# -- bert_tiny at seq 640 through the flash path -------------------------------

LR, STEPS, B, S = 1e-3, 3, 2, 640


def _build(pt, un, tr, amp, use_amp):
    cfg = dataclasses.replace(tr.bert_tiny(use_tp=False), max_position=S,
                              use_flash_attention=True)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), un.guard():
        loss, _ = tr.bert_pretrain(cfg, seq_len=S)
        opt = pt.optimizer.Adam(learning_rate=LR)
        (amp.decorate(opt) if use_amp else opt).minimize(loss)
    return main, startup, loss, cfg


@pytest.fixture(scope="module", params=["fp32", "amp"])
def bert_long(request):
    """Both programs (the startups as dicts, taken before the JAX one is
    seeded), then 3 Adam steps on one batch from the JAX startup's weights:
    (losses, step-1 grads, final params) per package."""
    use_amp = request.param == "amp"
    jm, js, jl, cfg = _build(jpt, jun, jtr, jamp, use_amp)
    tm, ts, tl, _ = _build(tpt, tun, ttr, tamp, use_amp)
    out = {"amp": use_amp, "progs": ((jm, js.to_dict()), (tm, ts.to_dict()))}
    feed = _example_feed(cfg, B, S)
    js.random_seed = 5
    jscope, jexe = jpt.Scope(), jpt.Executor()
    jexe.run(js, scope=jscope)
    names = [p.name for p in jm.all_parameters()]
    tscope, texe = tpt.Scope(), tpt.Executor(place="cpu")
    texe.run(ts, scope=tscope)
    load_params(tscope, tm, {n: np.array(jscope.find_var(n)) for n in names})
    gnames = [n + "@GRAD" for n in names]
    for key, exe, prog, loss, scope in (("jax", jexe, jm, jl, jscope),
                                        ("torch", texe, tm, tl, tscope)):
        losses, grads = [], None
        for step in range(STEPS):
            vals = exe.run(prog, feed=feed, scope=scope,
                           fetch_list=[loss.name] + (gnames if step == 0 else []))
            losses.append(float(np.asarray(vals[0])))
            if step == 0:
                grads = {n: np.asarray(v, np.float32)
                         for n, v in zip(names, vals[1:])}
        params = {n: np.asarray(scope.find_var(n)) for n in names}
        out[key] = (losses, grads, params)
    return out


def test_bert_long_programs_equal_jax(bert_long):
    (jm, js), (tm, ts) = bert_long["progs"]
    jd, td = jm.to_dict(), tm.to_dict()
    assert td["blocks"][0]["ops"] == jd["blocks"][0]["ops"]
    assert td == jd and ts == js
    att = [op for op in tm.global_block.ops if op.type == "fused_attention"]
    assert len(att) == 2 and all(op.attr("use_pallas") for op in att)
    want = "bfloat16" if bert_long["amp"] else "float32"
    assert {tm.global_block.var(op.inputs["Q"][0]).dtype.value
            for op in att} == {want}


def test_bert_long_losses_agree_over_three_adam_steps(bert_long):
    """Step 1 reads the same weights: rtol 1e-4 (measured 4e-5 under AMP,
    1e-7 in fp32); the later steps 2e-3, as at seq 16."""
    jl, tl = bert_long["jax"][0], bert_long["torch"][0]
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-4)
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    assert tl[2] < tl[0]


def test_bert_long_step1_gradients_agree(bert_long):
    """fp32: 1e-4 of each gradient's max-abs (measured 1e-6). AMP: 6e-2 of
    it and 8e-2 in relative L2 (measured 3.4e-2 and 4.6e-2, lm_head.b: the
    JAX package's CPU arm rounds the scores to bf16, K10 does not, and
    bf16 products are rounded after sums in another order)."""
    jg, tg = bert_long["jax"][1], bert_long["torch"][1]
    tmax, tl2 = (6e-2, 8e-2) if bert_long["amp"] else (1e-4, 1e-4)
    assert sorted(tg) == sorted(jg)
    for n in jg:
        scale = max(float(np.abs(jg[n]).max()), 1e-12)
        assert float(np.abs(tg[n] - jg[n]).max()) <= tmax * scale, n
        l2 = np.linalg.norm(tg[n] - jg[n]) / max(np.linalg.norm(jg[n]), 1e-12)
        assert l2 <= tl2, n


def test_bert_long_params_agree_after_three_adam_steps(bert_long):
    """Adam moves each weight by about lr a step whatever its gradient's
    size, so a near-zero gradient of another sign moves it 2 lr apart:
    atol 2 k lr, as at seq 16."""
    jp, tp = bert_long["jax"][2], bert_long["torch"][2]
    for n in jp:
        assert tp[n].dtype == np.float32
        np.testing.assert_allclose(tp[n], jp[n], rtol=0, atol=2 * STEPS * LR,
                                   err_msg=n)
