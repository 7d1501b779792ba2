"""What each rank of the port's tensor-parallel tests runs (torch_rank_pool):
module-level functions of picklable arguments, importing only
paddle_tpu_torch. The JAX side of each comparison runs in the test
process, on the virtual CPU devices of tests/conftest.py."""
from __future__ import annotations

import numpy as np

# the planted faults of the Megatron rewrite, each refused by the tests
FAULTS = ("skip_row_sums", "bias_before_sum")


def plant(fault):
    """Monkeypatch the rewrite (in this rank's process) with `fault`:
    "skip_row_sums" drops the sum over tp of every row-parallel `mul`'s
    partial output; "bias_before_sum" treats the bias add as linear, so
    the replicated bias is added on every rank before the sum. Returns
    the function that takes the fault out again."""
    from paddle_tpu_torch.parallel import tensor_parallel as tpr

    saved = (tpr._Rewrite.allreduce, tpr._Rewrite._keeps_partial)

    def undo():
        tpr._Rewrite.allreduce, tpr._Rewrite._keeps_partial = saved

    if fault == "skip_row_sums":
        orig = tpr._Rewrite.allreduce

        def allreduce(self, name, red="sum", avg=False):
            prod = self.producer.get(name)
            if prod is not None and prod.type == "mul" and red == "sum":
                self.st[name] = None
                return
            orig(self, name, red, avg)
        tpr._Rewrite.allreduce = allreduce
    elif fault == "bias_before_sum":
        orig_keep = tpr._Rewrite._keeps_partial

        def keeps(self, op, partial):
            if op.type == "elementwise_add":
                return True
            return orig_keep(self, op, partial)
        tpr._Rewrite._keeps_partial = keeps
    elif fault is not None:
        raise ValueError(fault)
    return undo


def two_fc(pkg, tp_axis):
    """test_parallel.py:258's program: fc relu then fc, the first weight
    column-parallel and the second row-parallel (annotated on `tp_axis`)."""
    from importlib import import_module

    L = import_module(pkg.__name__ + ".layers")
    x = L.data(name="x", shape=[16], dtype="float32")
    h = L.fc(x, size=32, act="relu")
    out = L.fc(h, size=8)
    prog = pkg.default_main_program()
    params = prog.all_parameters()
    params[0].sharding = (None, tp_axis)
    params[2].sharding = (tp_axis, None)
    return out


def fc_rank(mesh_shape, params, x):
    """The two-fc program under with_data_parallel over `mesh_shape`, each
    dp rank feeding its rows; returns the fetched (global) output."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.weights import load_params

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        out = two_fc(pt, "tp")
    exe, scope = pt.Executor(place="cpu"), pt.Scope()
    exe.run(startup, scope=scope)
    load_params(scope, main, params)
    mesh = make_mesh(mesh_shape)
    feed = {"x": x}
    if "dp" in mesh_shape:
        feed = mesh.shard_feed(feed)
    target = pt.CompiledProgram(main).with_data_parallel(mesh=mesh)
    (got,) = exe.run(target, feed=feed, fetch_list=[out], scope=scope)
    types = [op.type for op in exe._program_for(target).global_block.ops]
    return got, types


def bert_programs(pkg, use_tp=True, seq=8, lr=1e-3, opt="adam", cfg=None):
    from importlib import import_module

    tr = import_module(pkg.__name__ + ".models.transformer")
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        c = cfg or tr.bert_tiny(use_tp=use_tp)
        loss, _ = tr.bert_pretrain(c, seq_len=seq)
        make = {"adam": pkg.optimizer.Adam, "sgd_clip": pkg.optimizer.SGD,
                "lamb": pkg.optimizer.Lamb,
                "lars_momentum": lambda learning_rate: pkg.optimizer
                .LarsMomentum(learning_rate=learning_rate, momentum=0.9)}[opt]
        clip = import_module(pkg.__name__ + ".clip")
        if opt == "sgd_clip":
            # global-norm clipping: a norm over tp-sharded gradients (the
            # setting is the package's global, reset once minimized)
            clip.set_gradient_clip(clip.GradientClipByGlobalNorm(0.05))
        try:
            make(learning_rate=lr).minimize(loss)
        finally:
            clip.set_gradient_clip(None)
    return main, startup, loss


def bert_rank(mesh_shape, params, feeds, fault=None, seq=8, opt="adam",
              cfg=None, save_dir=None, lr=1e-3):
    """bert_tiny(use_tp=True) under with_data_parallel over `mesh_shape`
    for len(feeds) steps from `params`: (losses, the global parameters
    after, this rank's shards of the qkv weights, the ops' types).
    `save_dir`: save_params after the steps, into its rank<N>."""
    undo = plant(fault)
    try:
        return _bert_steps(mesh_shape, params, feeds, seq, opt, cfg,
                           save_dir, lr)
    finally:
        undo()


def _bert_steps(mesh_shape, params, feeds, seq, opt, cfg, save_dir, lr):
    import torch.distributed as dist

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel.tensor_parallel import global_value
    from paddle_tpu_torch.weights import load_params

    main, startup, loss = bert_programs(pt, seq=seq, opt=opt, cfg=cfg, lr=lr)
    before = main.to_dict()
    exe, scope = pt.Executor(place="cpu"), pt.Scope()
    exe.run(startup, scope=scope)
    load_params(scope, main, params)
    mesh = make_mesh(mesh_shape)
    target = pt.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, mesh=mesh)
    losses = []
    for feed in feeds:
        if "dp" in mesh_shape:
            feed = mesh.shard_feed(feed)
        (lv,) = exe.run(target, feed=feed, fetch_list=[loss], scope=scope)
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
    names = [p.name for p in main.all_parameters()]
    shards = {n: np.asarray(scope.find_var(n)) for n in names
              if n.endswith(".qkv.w")}
    glob = {n: global_value(scope, n, scope.find_var(n)).numpy()
            for n in names}
    if save_dir is not None:
        import os

        pt.io.save_params(exe, os.path.join(save_dir, f"rank{dist.get_rank()}"),
                          main, scope=scope)
    types = [op.type for op in exe._program_for(target).global_block.ops]
    if main.to_dict() != before:
        raise AssertionError("the rewrite changed the user's program")
    dist.barrier()
    return losses, glob, shards, types


def bert_refusal_rank(what):
    """The rewrite's refusal on two tp ranks: a sub-block over tp-sharded
    values."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"tp": 2})
    assert what == "sub_block"
    from paddle_tpu_torch import layers as L

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = L.data(name="x", shape=[16], dtype="float32")
        h = L.fc(x, size=8, param_attr=pt.ParamAttr(name="w"))
        main.global_block.var("w").sharding = (None, "tp")
        cond = L.fill_constant([1], "bool", True)
        out = L.cond(cond, lambda: L.scale(h, 2.0),
                     lambda: L.scale(h, 3.0))
        loss = L.mean(out)
    feed = {"x": np.ones((2, 16), np.float32)}
    exe, scope = pt.Executor(place="cpu"), pt.Scope()
    exe.run(startup, scope=scope)
    target = pt.CompiledProgram(main).with_data_parallel(mesh=mesh)
    try:
        exe.run(target, feed=feed, fetch_list=[loss], scope=scope)
    except NotImplementedError as e:
        return str(e)
    return None


def example_bert_feed(B, S, vocab=1024, seed=0):
    rng = np.random.default_rng(seed)
    return {"src_ids": rng.integers(0, vocab, (B, S)).astype(np.int64),
            "pos_ids": np.tile(np.arange(S, dtype=np.int64), (B, 1)),
            "lm_label": rng.integers(0, vocab, (B, S)).astype(np.int64),
            "lm_weight": (rng.random((B, S)) < 0.5).astype(np.float32)}


def xent_rank(logits, labels):
    """The vocab-parallel cross entropy (plain path) on 2 tp ranks, each
    holding half the classes: (loss, the global logits gradient)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.parallel import make_mesh

    V = logits.shape[1]
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = L.data(name="x", shape=[V], dtype="float32")
        lab = L.data(name="lab", shape=[1], dtype="int64")
        lg = L.fc(x, size=V, bias_attr=False,
                  param_attr=pt.ParamAttr(name="eye"))
        main.global_block.var("eye").sharding = (None, "tp")
        loss = L.reduce_sum(L.softmax_with_cross_entropy(lg, lab))
        pt.backward.append_backward(loss)
    exe, scope = pt.Executor(place="cpu"), pt.Scope()
    exe.run(startup, scope=scope)
    import torch
    scope.set_var("eye", torch.eye(V))
    mesh = make_mesh({"tp": 2})
    target = pt.CompiledProgram(main).with_data_parallel(mesh=mesh)
    out = exe.run(target, feed={"x": logits, "lab": labels[:, None]},
                  fetch_list=[loss, lg.name + "@GRAD"], scope=scope)
    marked = [getattr(op, "tp_vocab", None) is not None
              for op in exe._program_for(target).global_block.ops
              if op.type.startswith("softmax_with_cross_entropy")]
    return out[0], out[1], marked


def serve_rank(params, prompts, prefix_cache, tp=2, max_new=6, draft_k=0):
    """decoder_tiny() served by a ServingEngine(tp=tp) on this rank, with
    `params` (global arrays): rank 0 schedules the prompts, the others
    follow. Returns (rank 0's tokens or the follower's run count, the pool
    var's annotation, this rank's pool shape)."""
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving import weights as sw
    from paddle_tpu_torch.serving.model import decoder_tiny

    eng = ServingEngine(decoder_tiny(), page_size=4, pool_pages=64,
                        max_inflight=4, device="cpu", tp=tp,
                        prefix_cache=prefix_cache, draft_k=draft_k)
    sw.load_params(eng, params)
    if eng._ctl.is_leader:
        rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        eng.run_until_drained()
        eng.stop_followers()
        out = [eng.result(r) for r in rids]
    else:
        out = eng.follow()
    pool = eng._decode_prog.global_block.var("kv_cache.k0")
    return out, pool.sharding, tuple(eng._scope.find_var("kv_cache.k0").shape)


def ring_rank(q, k, v, causal, do, sp):
    """ring_attention's op and hand-written grad op on this rank's slice
    of the sequence (dim 2) over an `sp` ring of every rank, through a
    program under with_collective: (out, dq, dk, dv) slices."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel.mesh import get_comm_context

    mesh = make_mesh({"sp": sp})
    get_comm_context().register_ring(5, "sp")
    try:
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup), pt.unique_name.guard():
            _, nh, S, dh = q.shape
            ins = []
            for n in ("q", "k", "v"):
                x = L.data(name=n, shape=[nh, S, dh], dtype="float32")
                x.stop_gradient = False
                x.sharding = (None, None, "sp", None)
                ins.append(x)
            out = L.ring_attention(*ins, causal=causal, ring_id=5)
            cot = L.data(name="cot", shape=[nh, S, dh], dtype="float32")
            cot.sharding = (None, None, "sp", None)
            loss = L.reduce_sum(L.elementwise_mul(out, cot))
            pt.backward.append_backward(loss)
        exe = pt.Executor(place="cpu")
        feed = mesh.shard_feed({"q": q, "k": k, "v": v, "cot": do},
                               axis="sp", program=main)
        target = pt.CompiledProgram(main).with_collective(mesh=mesh)
        return exe.run(target, feed=feed, fetch_list=[
            out, "q@GRAD", "k@GRAD", "v@GRAD"], scope=pt.Scope())
    finally:
        get_comm_context().unregister_ring(5)


def ring_program(pkg, sp, B=2, nh=2, S=16, dh=4):
    """test_attention.py:160's program: q = fc(x), ring_attention(q, x, x)
    on ring 5, the mean squared error to t; with `sp` the feeds are
    annotated on dim 2 and the fleet's SGD(0.1) averages the gradients
    over the `sp` ranks, else a plain SGD(0.1)."""
    from importlib import import_module

    L = import_module(pkg.__name__ + ".layers")
    x = L.data(name="x", shape=[nh, S, dh], dtype="float32")
    t = L.data(name="t", shape=[nh, S, dh], dtype="float32")
    if sp:
        x.sharding = (None, None, "sp", None)
        t.sharding = (None, None, "sp", None)
    q = L.fc(x, size=dh, num_flatten_dims=3, name="q")
    out = L.ring_attention(q, x, x, sm_scale=dh ** -0.5, ring_id=5)
    return L.mean(L.square_error_cost(out, t))


def ring_train_rank(x, t, w, b, sp, steps=4):
    """ring_program under with_collective over an `sp` ring of every rank,
    from the weights (w, b), for `steps` SGD steps: the final q.w_0."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.incubate.fleet import UserDefinedRoleMaker, fleet
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel.mesh import get_comm_context

    mesh = make_mesh({"sp": sp})
    get_comm_context().register_ring(5, "sp")
    try:
        main, startup = pt.Program(), pt.Program()
        main.random_seed = startup.random_seed = 9
        with pt.program_guard(main, startup), pt.unique_name.guard():
            loss = ring_program(pt, True)
            fleet.init(UserDefinedRoleMaker(worker_num=sp), mesh=mesh)
            opt = fleet.distributed_optimizer(pt.optimizer.SGD(0.1))
            opt.minimize(loss)
        exe, scope = pt.Executor(place="cpu"), pt.Scope()
        exe.run(startup, scope=scope)
        import torch
        scope.set_var("q.w_0", torch.from_numpy(w.copy()))
        scope.set_var("q.b_0", torch.from_numpy(b.copy()))
        target = pt.CompiledProgram(main).with_collective(mesh=mesh)
        feed = mesh.shard_feed({"x": x, "t": t}, axis="sp", program=main)
        for _ in range(steps):
            exe.run(target, feed=feed, fetch_list=[loss.name], scope=scope)
        return scope.find_var("q.w_0").numpy()
    finally:
        get_comm_context().unregister_ring(5)


def found_inf_rank(x, c, w):
    """decorate(SGD, dynamic loss scaling) over fc(x) * c summed, the fc
    weight column-parallel over 2 tp ranks, one step from `w`: `c` with an
    inf only in the columns of rank 1 poisons only rank 1's gradient
    shard. Returns (the global weight after the step, the loss scale, the
    bad-step counter, whether the unscale op is marked)."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.contrib import mixed_precision as amp
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel.tensor_parallel import global_value

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        xv = L.data(name="x", shape=[x.shape[1]], dtype="float32")
        cv = L.data(name="c", shape=[c.shape[1]], dtype="float32")
        h = L.fc(xv, size=c.shape[1], bias_attr=False,
                 param_attr=pt.ParamAttr(name="w"))
        main.global_block.var("w").sharding = (None, "tp")
        loss = L.reduce_sum(L.elementwise_mul(h, cv))
        amp.decorate(pt.optimizer.SGD(0.1), init_loss_scaling=8.0,
                     use_dynamic_loss_scaling=True).minimize(loss)
    exe, scope = pt.Executor(place="cpu"), pt.Scope()
    exe.run(startup, scope=scope)
    scope.set_var("w", torch.from_numpy(w.copy()))
    target = pt.CompiledProgram(main).with_data_parallel(
        mesh=make_mesh({"tp": 2}))
    exe.run(target, feed={"x": x, "c": c}, fetch_list=[loss], scope=scope)
    marked = [getattr(op, "tp_found", None) is not None
              for op in exe._program_for(target).global_block.ops
              if op.type == "check_finite_and_unscale"]
    return (global_value(scope, "w", scope.find_var("w")).numpy(),
            float(scope.find_var("@LOSS_SCALING@").reshape(-1)[0]),
            int(scope.find_var("@BAD_STEPS@").reshape(-1)[0]), marked)


def stalled_leader_rank(wait_s):
    """A tensor-parallel engine whose rank 0 never runs anything: rank 1's
    follow() must raise once the channel's timeout (patched to 2 s here)
    passes. Returns (rank, the error's text or None, seconds waited)."""
    import time

    import torch.distributed as dist

    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving import engine as E
    from paddle_tpu_torch.serving.model import decoder_tiny

    saved, E.TP_FOLLOW_TIMEOUT_S = E.TP_FOLLOW_TIMEOUT_S, 2.0
    try:
        eng = ServingEngine(decoder_tiny(), device="cpu", tp=2)
    finally:
        E.TP_FOLLOW_TIMEOUT_S = saved
    t0 = time.time()
    if eng._ctl.is_leader:
        time.sleep(wait_s)
        return 0, None, time.time() - t0
    try:
        eng.follow()
    except RuntimeError as e:       # gloo's timeout on the broadcast
        return dist.get_rank(), str(e)[:200], time.time() - t0
    return dist.get_rank(), None, time.time() - t0
