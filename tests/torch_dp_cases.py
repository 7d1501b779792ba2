"""What each rank of the port's multi-rank tests runs (torch_rank_pool):
module-level functions of picklable arguments, importing only
paddle_tpu_torch. The JAX side of each comparison runs in the test
process, on the virtual CPU devices of tests/conftest.py."""
from __future__ import annotations

import numpy as np


def build_mlp(pkg, opt="sgd", sizes=(8,), amp=False, lr=0.05):
    """The tiny regression MLP of tests/test_parallel.py:16 (fc relu
    layers, an fc head, the mean squared error) and its optimizer, built
    through `pkg` (either package) into the current programs."""
    from importlib import import_module

    L = import_module(pkg.__name__ + ".layers")
    x = L.data(name="x", shape=[16], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="float32")
    h = x
    for s in sizes:
        h = L.fc(h, size=s, act="relu")
    loss = L.mean(L.square_error_cost(L.fc(h, size=1), y))
    make = {"sgd": lambda: pkg.optimizer.SGD(lr),
            "momentum": lambda: pkg.optimizer.Momentum(lr, 0.9),
            "adam": lambda: pkg.optimizer.Adam(lr),
            "lamb": lambda: pkg.optimizer.Lamb(lr)}[opt]
    o = make()
    if amp:
        o = pkg.contrib.mixed_precision.decorate(o)
    return loss, o


def build_bert(pkg, seq=8, opt="adam", amp=False, lr=1e-3):
    from importlib import import_module

    tr = import_module(pkg.__name__ + ".models.transformer")
    loss, _ = tr.bert_pretrain(tr.bert_tiny(use_tp=False), seq_len=seq)
    o = {"sgd": pkg.optimizer.SGD, "adam": pkg.optimizer.Adam,
         "lamb": pkg.optimizer.Lamb,
         "momentum": lambda lr: pkg.optimizer.Momentum(lr, 0.9)}[opt](lr)
    if amp:
        o = pkg.contrib.mixed_precision.decorate(o)
    return loss, o


def programs(pkg, spec, nranks):
    """(main, startup, loss, transpiler) of `spec`, transpiled as its
    `mode` says, through `pkg`."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    mode = spec["mode"]
    t = None
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        if spec["model"] == "mlp":
            loss, opt = build_mlp(pkg, spec.get("opt", "sgd"),
                                  spec.get("sizes", (8,)),
                                  spec.get("amp", False), spec.get("lr", 0.05))
        else:
            loss, opt = build_bert(pkg, spec.get("seq", 8),
                                   spec.get("opt", "adam"),
                                   spec.get("amp", False),
                                   spec.get("lr", 1e-3))
        if mode == "fleet":
            from importlib import import_module

            fl = import_module(pkg.__name__ + ".incubate.fleet")
            strat = fl.DistributedStrategy()
            strat.allreduce_bucket_mb = spec.get("bucket_mb")
            strat.zero1 = spec.get("zero1")
            if spec.get("local_sgd"):
                strat.mode, strat.local_sgd_k = "local_sgd", spec["local_sgd"]
            fl.fleet.init(fl.UserDefinedRoleMaker(worker_num=nranks))
            fl.fleet.distributed_optimizer(opt, strat).minimize(loss)
        else:
            opt.minimize(loss)
    if mode in ("grad_allreduce", "local_sgd", "zero1"):
        from importlib import import_module

        col = import_module(pkg.__name__ + ".parallel.collective")
        if mode == "local_sgd":
            t = col.LocalSGD(k_steps=spec.get("k_steps", 2))
        elif mode == "zero1":
            sh = import_module(pkg.__name__ + ".parallel.sharding")
            sh.apply_zero1(main, nranks)
        else:
            t = col.GradAllReduce(bucket_mb=spec.get("bucket_mb"),
                                  zero1=spec.get("zero1"))
        if t is not None:
            t.transpile(startup, main, rank=0, nranks=nranks)
    return main, startup, loss, t


def load(scope, *arrays):
    """Set the JAX startup's arrays in the port's scope as they are (a
    ZeRO-1 program's parameter vars carry the shard's shape after its
    gathers' shape inference, in both packages, so load_params' shape
    check does not apply)."""
    import torch

    for group in arrays:
        for k, v in (group or {}).items():
            scope.set_var(k, torch.from_numpy(np.array(v)))


def train_rank(spec, params, feeds, state=None):
    """Build `spec`'s programs, load the JAX startup's `params`, and run
    each global feed of `feeds` as one step on this rank's rows (all rows
    for mode "plain" on one rank). Returns {"losses", "params", "program"
    (the transpiled main's to_dict), "buckets", "state_bytes"}."""
    import torch

    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel.mesh import world
    _, n = world()
    mesh = make_mesh()
    main, startup, loss, t = programs(tpt, spec, n)
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    exe.run(startup, scope=scope)
    load(scope, params, state)
    mode = spec["mode"]
    if mode in ("dp", "dp_zero1"):
        bs = tpt.BuildStrategy()
        bs.sharded_optimizer_states = mode == "dp_zero1"
        target = tpt.CompiledProgram(main, build_strategy=bs) \
            .with_data_parallel(loss_name=loss.name, mesh=mesh)
    elif mode == "plain":
        target = main
    else:
        target = tpt.CompiledProgram(main).with_collective(mesh=mesh)
    losses = []
    fetch = [loss.name] + spec.get("fetch", [])
    extra = []
    for feed in feeds:
        local = feed if mode == "plain" else mesh.shard_feed(feed)
        out = exe.run(target, feed=local, fetch_list=fetch, scope=scope)
        losses.append(np.asarray(out[0]).reshape(-1)[0].item())
        extra.append([np.asarray(o) for o in out[1:]])
    state = {v.name: scope.find_var(v.name) for v in main.list_vars()
             if getattr(v, "is_opt_state", False)
             and scope.find_var(v.name) is not None}
    return {"losses": losses,
            "params": {p.name: np.asarray(scope.find_var(p.name))
                       for p in main.all_parameters()},
            "program": main.to_dict(),
            "buckets": getattr(t, "last_buckets", None),
            "state_bytes": sum(s.numel() * s.element_size()
                               for s in state.values()),
            "state_shapes": {k: tuple(s.shape) for k, s in state.items()},
            "extra": extra}


# -- the collective ops, one program a case --------------------------------

def op_program(pkg, case):
    """(main, fetch names): `case`'s collective op over the fed `x` (and
    `x2`), its output gathered over the ring so every rank holds all of
    it."""
    from importlib import import_module

    L = import_module(pkg.__name__ + ".layers")
    op, attrs = case["op"], dict(case.get("attrs", {}))
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = L.data(name="x", shape=[3], dtype="float32")
        x2 = L.data(name="x2", shape=[5], dtype="float32")
        block = main.global_block
        if op in ("c_comm_init_all", "c_gen_nccl_id"):
            block.append_op(op, {}, {}, {"ring_id": 0})
            outs = [x.name]
        elif op == "local_sgd_sync":
            step = L.fill_constant(shape=[], dtype="int64",
                                   value=case["step"])
            snap = L.scale(x, scale=0.5)
            for n in ("p_out", "s_out"):
                block.create_var(name=n, shape=[-1, 3], dtype="float32")
            block.append_op(op, {"Param": [x.name], "Snapshot": [snap.name],
                                 "Step": [step.name]},
                            {"ParamOut": ["p_out"], "SnapshotOut": ["s_out"]},
                            dict(attrs, ring_id=0))
            outs = ["p_out", "s_out"]
        elif op == "c_allreduce_coalesced":
            for n in ("o1", "o2"):
                block.create_var(name=n, shape=[-1, 3], dtype="float32")
            block.append_op(op, {"X": [x.name, x2.name]},
                            {"Out": ["o1", "o2"]}, dict(attrs, ring_id=0))
            outs = ["o1", "o2"]
        else:
            block.create_var(name="out", shape=[-1, 3], dtype="float32")
            block.append_op(op, {"X": [x.name]}, {"Out": ["out"]},
                            dict(attrs, ring_id=0))
            outs = ["out"]
        fetch = []
        for n in outs:
            g = n + "@GATHERED"
            block.create_var(name=g, shape=[-1, 3], dtype="float32")
            block.append_op("c_allgather", {"X": [n]}, {"Out": [g]},
                            {"ring_id": 0})
            fetch.append(g)
    return main, fetch


def ops_rank(case, feed):
    """Run `case` under with_collective on every rank of the world, each
    feeding its rows; returns the fetches."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    main, fetch = op_program(tpt, case)
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    target = tpt.CompiledProgram(main).with_collective(mesh=mesh)
    return [np.asarray(a) for a in exe.run(
        target, feed=mesh.shard_feed(feed), fetch_list=fetch, scope=scope)]


def rnn_program(pkg, T=4):
    """tests/test_parallel.py:222's program: a c_allreduce_sum inside a
    StaticRNN body sums each step's rows over the ranks."""
    from importlib import import_module

    L = import_module(pkg.__name__ + ".layers")
    CF = import_module(pkg.__name__ + ".layers.control_flow")
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = L.data(name="x", shape=[T], dtype="float32")
        xt = L.transpose(x, perm=[1, 0])
        h0 = L.fill_constant(shape=[1], dtype="float32", value=0.0)
        rnn = CF.StaticRNN()
        with rnn.step():
            word = rnn.step_input(xt)
            prev = rnn.memory(init=h0)
            s = L.reduce_sum(word, keep_dim=True)
            main.current_block().append_op(
                "c_allreduce_sum", {"X": [s.name]}, {"Out": [s.name]},
                {"ring_id": 0})
            h = L.elementwise_add(prev, s)
            rnn.update_memory(prev, h)
            rnn.step_output(h)
        out = rnn()
    return main, out.name


def rnn_rank(feed, regime):
    """The StaticRNN program under `regime` ("collective" or "plain")."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    main, out = rnn_program(tpt)
    target = (tpt.CompiledProgram(main).with_collective(mesh=mesh)
              if regime == "collective" else main)
    (got,) = tpt.Executor(place="cpu").run(
        target, feed=mesh.shard_feed(feed), fetch_list=[out],
        scope=tpt.Scope())
    return np.asarray(got)


def refusal_rank(which):
    """with_data_parallel over the world on a program with an op that has
    no data-parallel rule; returns the message it raised."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.parallel import make_mesh

    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup), tpt.unique_name.guard():
        x = L.data(name="x", shape=[4], dtype="float32")
        assert which == "sub_block"   # a sub-block over sharded values
        h = L.fc(x, size=4)
        cond = L.fill_constant([1], "bool", True)
        out = L.cond(cond, lambda: L.scale(h, 2.0), lambda: L.scale(h, 3.0))
        loss = L.mean(out)
        tpt.optimizer.SGD(0.1).minimize(loss)
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    exe.run(startup, scope=scope)
    mesh = make_mesh()
    target = tpt.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, mesh=mesh)
    try:
        exe.run(target, feed={"x": np.ones((2, 4), np.float32)},
                fetch_list=[loss], scope=scope)
    except NotImplementedError as e:
        return str(e)
    return None


def reduce_program(pkg, which):
    """fc(x) reduced by `which` over the batch dim, times a weight, its mean
    the loss under SGD(0.1): (main, startup, loss, the reduction)."""
    from importlib import import_module

    L = import_module(pkg.__name__ + ".layers")
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = L.data(name="x", shape=[4], dtype="float32")
        h = L.fc(x, size=4, param_attr=pkg.ParamAttr(name="w"),
                 bias_attr=pkg.ParamAttr(name="b"))
        red = getattr(L, which)(h, dim=0)
        loss = L.mean(L.fc(L.unsqueeze(red, axes=[0]), size=1,
                           param_attr=pkg.ParamAttr(name="v")))
        pkg.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss, red


def reduce_rank(which, params, x):
    """reduce_program under with_data_parallel over the world, two steps
    from `params`: ([(loss, the reduction)] a step, the parameters)."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.weights import load_params

    main, startup, loss, red = reduce_program(tpt, which)
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    exe.run(startup, scope=scope)
    load_params(scope, main, params)
    mesh = make_mesh()
    target = tpt.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, mesh=mesh)
    got = [exe.run(target, feed=mesh.shard_feed({"x": x}),
                   fetch_list=[loss, red], scope=scope) for _ in range(2)]
    return got, {n: np.asarray(scope.find_var(n)) for n in params}


def identity_rank():
    """A c_allreduce_sum in a plain run and under with_data_parallel, with
    a process group live: the identity both times."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel.mesh import world

    rank, _ = world()
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup), tpt.unique_name.guard():
        x = L.data(name="x", shape=[3], dtype="float32")
        s = L.scale(x, scale=1.0)
        main.global_block.append_op("c_allreduce_sum", {"X": [s.name]},
                                    {"Out": [s.name]}, {"ring_id": 0})
    exe = tpt.Executor(place="cpu")
    xv = np.full((2, 3), rank + 1.0, np.float32)
    (plain,) = exe.run(main, feed={"x": xv}, fetch_list=[s], scope=tpt.Scope())
    dp = tpt.CompiledProgram(main).with_data_parallel(mesh=make_mesh())
    (under_dp,) = exe.run(dp, feed={"x": xv}, fetch_list=[s],
                          scope=tpt.Scope())
    return np.asarray(plain), np.asarray(under_dp), xv


def checkpoint_rank(spec, params, feeds, dirname):
    """Train `spec` (a ZeRO-1 fleet program), save_sharded, then load into
    a fresh scope and check every var came back bit for bit; returns the
    state's bytes on this rank and the shard files written."""
    import os

    import torch

    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel.mesh import world
    rank, n = world()
    mesh = make_mesh()
    main, startup, loss, _ = programs(tpt, spec, n)
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    exe.run(startup, scope=scope)
    load(scope, params)
    target = tpt.CompiledProgram(main).with_collective(mesh=mesh)
    for feed in feeds:
        exe.run(target, feed=mesh.shard_feed(feed), fetch_list=[loss],
                scope=scope)
    tpt.io.save_sharded(exe, dirname, main_program=main, scope=scope)
    fresh = tpt.Scope()
    exe.run(startup, scope=fresh)
    tpt.io.load_sharded(exe, dirname, main_program=main, scope=fresh,
                        shardings=mesh)
    for v in main.list_vars():
        a = scope.find_var(v.name)
        if (v.persistable or isinstance(v, tpt.Parameter)) and a is not None:
            b = fresh.find_var(v.name)
            assert b is not None and torch.equal(a, b), v.name
    state = {v.name: scope.find_var(v.name) for v in main.list_vars()
             if getattr(v, "is_opt_state", False)}
    return (sum(t.numel() * t.element_size() for t in state.values()),
            sorted(f for f in os.listdir(dirname) if ".zero1-" in f))


def dp_checkpoint_rank(spec, params, feeds, dirname):
    """Train `spec` under with_data_parallel with sharded_optimizer_states
    (ZeRO-1 on the executor's clone), then: save_sharded given the user's
    program must raise (the scope holds moment shards that program does
    not know of); save_sharded given the CompiledProgram writes the
    shards; a fresh executor and scope load them back through a new
    CompiledProgram of the same program, every var bit for bit, and one
    more step from each scope gives the same bits. Returns (the refusal's
    message, the shard files, the vars held as shards)."""
    import os

    import torch

    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.io import _held_shard
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel.mesh import world
    _, n = world()
    mesh = make_mesh()
    main, startup, loss, _ = programs(tpt, spec, n)

    def compiled():
        bs = tpt.BuildStrategy()
        bs.sharded_optimizer_states = True
        return tpt.CompiledProgram(main, build_strategy=bs) \
            .with_data_parallel(loss_name=loss.name, mesh=mesh)

    exe, scope, target = tpt.Executor(place="cpu"), tpt.Scope(), compiled()
    exe.run(startup, scope=scope)
    load(scope, params)
    for feed in feeds[:-1]:
        exe.run(target, feed=mesh.shard_feed(feed), fetch_list=[loss],
                scope=scope)
    try:
        tpt.io.save_sharded(exe, dirname, main_program=main, scope=scope)
        refused = None
    except ValueError as e:
        refused = str(e)
    tpt.io.save_sharded(exe, dirname, main_program=target, scope=scope)
    exe2, fresh, target2 = tpt.Executor(place="cpu"), tpt.Scope(), compiled()
    exe2.run(startup, scope=fresh)
    tpt.io.load_sharded(exe2, dirname, main_program=target2, scope=fresh,
                        shardings=mesh)
    clone = exe._program_for(target)
    held = []
    for v in clone.list_vars():
        a = scope.find_var(v.name)
        if (v.persistable or isinstance(v, tpt.Parameter)) and a is not None:
            b = fresh.find_var(v.name)
            assert b is not None and torch.equal(a, b), v.name
            if _held_shard(clone, v, a, n):
                held.append(v.name)
    last = mesh.shard_feed(feeds[-1])
    (la,) = exe.run(target, feed=last, fetch_list=[loss], scope=scope)
    (lb,) = exe2.run(target2, feed=last, fetch_list=[loss], scope=fresh)
    assert np.array_equal(la, lb), (la, lb)
    for p in main.all_parameters():
        assert torch.equal(scope.find_var(p.name), fresh.find_var(p.name)), \
            p.name
    return (refused, sorted(f for f in os.listdir(dirname) if ".zero1-" in f),
            sorted(held))


def dp_clone_rank():
    """with_data_parallel after the program is edited: an op appended
    after the first run is run (its output fetched), and
    invalidate_cache(program) drops the program's clones and their
    prepared records. Returns (the loss, the appended op's output, the
    executor's clones of the program, prepared clones) after each
    stage."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.parallel import make_mesh

    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup), tpt.unique_name.guard():
        x = L.data(name="x", shape=[4], dtype="float32")
        loss = L.mean(L.fc(x, size=2))
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    exe.run(startup, scope=scope)
    target = tpt.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, mesh=make_mesh())
    feed = {"x": np.ones((2, 4), np.float32)}

    def clones():
        made = [c for _, c, _ in exe._dp_clones.get(main, {}).values()]
        return len(made), sum(c in exe._prepared for c in made)

    (l1,) = exe.run(target, feed=feed, fetch_list=[loss], scope=scope)
    first = clones()
    with tpt.program_guard(main, startup):
        doubled = L.scale(loss, scale=2.0)
    l2, d2 = exe.run(target, feed=feed, fetch_list=[loss, doubled],
                     scope=scope)
    second = clones()
    exe.invalidate_cache(main)
    third = clones()
    return (float(l1), float(l2), float(d2), first, second, third)


def install_check_rank():
    import contextlib
    import io

    from paddle_tpu_torch import install_check

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        install_check.run_check(device="cpu")
    return buf.getvalue()


def zero1_checkpoint_as_rank0_of_2(dirname):
    """save_sharded of a ZeRO-1 program's scope as rank 0 of a world of 2
    (the world stood in for in this process): an Adam MLP under
    apply_zero1, one optimizer state held as the rank's half. Returns
    (main, startup, executor, the shard files written)."""
    import os
    from unittest import mock

    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.parallel import mesh as tmesh

    main, startup, _, _ = programs(tpt, dict(model="mlp", mode="zero1",
                                             opt="adam"), 2)
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    exe.run(startup, scope=scope)
    moment = next(v.name for v in main.list_vars()
                  if getattr(v, "is_opt_state", False)
                  and v.name + "@ZERO1_SHARD" in main.global_block.vars)
    full = scope.find_var(moment)
    scope.set_var(moment, full[: full.shape[0] // 2].clone() + 1.0)
    with mock.patch.object(tmesh, "world", lambda: (0, 2)), \
            mock.patch("torch.distributed.barrier", lambda *a, **k: None):
        tpt.io.save_sharded(exe, dirname, main_program=main, scope=scope)
    return main, startup, exe, sorted(f for f in os.listdir(dirname)
                                      if ".zero1-" in f)


def op_grad_program(pkg, case):
    """(main, fetch names): sum(square(op(x))) differentiated through the
    package's `gradients`, with x's gradient gathered over the ring."""
    from importlib import import_module

    L = import_module(pkg.__name__ + ".layers")
    bw = import_module(pkg.__name__ + ".backward")
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = L.data(name="x", shape=[3], dtype="float32")
        x.stop_gradient = False
        h = L.scale(x, scale=1.0)
        block = main.global_block
        block.create_var(name="out", shape=[-1, 3], dtype="float32")
        block.append_op(case["op"], {"X": [h.name]}, {"Out": ["out"]},
                        dict(case.get("attrs", {}), ring_id=0))
        loss = L.reduce_sum(L.square(block.var("out")))
        (g,) = bw.gradients([loss], [h])
        block.create_var(name="g@GATHERED", shape=[-1, 3], dtype="float32")
        block.append_op("c_allgather", {"X": [g.name]},
                        {"Out": ["g@GATHERED"]}, {"ring_id": 0})
    return main, ["g@GATHERED"]


def op_grad_rank(case, feed):
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    main, fetch = op_grad_program(tpt, case)
    target = tpt.CompiledProgram(main).with_collective(mesh=mesh)
    return [np.asarray(a) for a in tpt.Executor(place="cpu").run(
        target, feed=mesh.shard_feed(feed), fetch_list=fetch,
        scope=tpt.Scope())]


def _tiny_rn(pt):
    """(f)'s network cut for the CPU: an NHWC conv, a batch norm with its
    relu, another conv and batch norm, global pooling and an fc over 10
    classes (chip_smoke's RN_HW and RN_CLASSES patched to match)."""
    L = pt.layers
    img = L.data(name="img", shape=[8, 8, 3], dtype="float32")
    label = L.data(name="label", shape=[1], dtype="int64")
    h = L.batch_norm(L.conv2d(img, num_filters=8, filter_size=3, padding=1,
                              data_format="NHWC"), act="relu",
                     data_layout="NHWC")
    h = L.batch_norm(L.conv2d(h, num_filters=8, filter_size=3, padding=1,
                              data_format="NHWC"), data_layout="NHWC")
    h = L.pool2d(h, pool_type="avg", global_pooling=True, data_format="NHWC")
    return L.mean(L.softmax_with_cross_entropy(L.fc(h, size=10), label))


def smoke_dp_rank(outdir, fault=None, arms=None):
    """chip_smoke's dp_gloo2 worker on this CPU rank at bert_tiny widths
    (B=8, S=16), (f) on a two-conv network at 8x8 (B=8), (g) at the WMT
    test's tiny widths (B=4, S=8), (h) on bert_tiny(use_tp=True) at B=8,
    (i) on decoder_tiny()'s widths, (j) at B=1, nh=2, S=32, dh=8, (k) on
    bert_tiny(use_sp=True) at B=4, S=16 and (l) on (f)'s network at B=4: the
    device calls around a step become no-ops, the launch checks expect
    none. fault "lost_reduce": a bucket's allreduce returns its inputs
    unreduced. `arms`: the worker's arms (all by default). Every patch is
    undone on return."""
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import collective_ops as co

    reset = co.reset_comm_stats
    patches = [
        (cs, "AMP_B", 8), (cs, "AMP_S", 16),
        (cs, "_bert_cfg", lambda S, flash=False: transformer.TransformerConfig(
            vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
            ffn_size=128, max_position=64, dropout=0.0, use_tp=False)),
        (cs, "_expected_launches", lambda program: {}),
        (cs, "_dp_rn_build", _tiny_rn), (cs, "DP_RN_B", 8), (cs, "RN_HW", 8),
        (cs, "RN_CLASSES", 10), (cs, "WMT_S", 8), (cs, "WMT_DROP_B", 4),
        (cs, "WMT_BASE", dict(vocab_size=256, hidden_size=64, num_layers=2,
                              num_heads=4, ffn_size=128, max_position=64,
                              dropout=0.0, use_tp=False)),
        (torch.cuda, "synchronize", lambda *a, **k: None),
        (torch.cuda, "reset_peak_memory_stats", lambda *a, **k: None),
        (torch.cuda, "max_memory_allocated", lambda *a, **k: 0),
        (co, "reset_comm_stats", lambda timing=False: reset(False)),
        (cs, "_tp_cfg", lambda: transformer.TransformerConfig(
            vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
            ffn_size=128, max_position=64, dropout=0.0, use_tp=True)),
        (cs, "TP_B", 8), (cs, "SERVE_CFG", dict(
            vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
            ffn_size=64, max_position=64)),
        (cs, "SERVE_LENS", (5, 11, 20)), (cs, "SERVE_NEW", 4),
        (cs, "RING_B", 1), (cs, "RING_NH", 2), (cs, "RING_S", 32),
        (cs, "RING_DH", 8),
        (cs, "_sp_cfg", lambda: transformer.TransformerConfig(
            vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
            ffn_size=128, max_position=64, dropout=0.0, use_tp=False,
            use_sp=True)),
        (cs, "SP_BERT_B", 4), (cs, "SP_BERT_S", 16), (cs, "SP_RN_B", 4)]
    if fault == "lost_reduce":
        patches.append((co, "_all_reduce_many", lambda g, xs, what: list(xs)))
    saved = [(m, k, getattr(m, k)) for m, k, _ in patches]
    for m, k, v in patches:
        setattr(m, k, v)
    try:
        cs.dp_worker(outdir, dev=torch.device("cpu"),
                     arms=arms or cs.DP_ARMS)
    finally:
        for m, k, v in saved:
            setattr(m, k, v)
    return True


# -- batch statistics, random draws and resharding under with_data_parallel --

def build_sync_bn(pkg, model, lr=0.05):
    """(loss, Momentum(lr, 0.9)): "resnet", resnet_cifar10 on 16x16 images;
    "conv_bn", a conv with a batch norm (conv2d_bn after the stats pass),
    an fc with a batch_norm op and a data_norm, and an fc head on the mean
    squared error."""
    from importlib import import_module

    L = import_module(pkg.__name__ + ".layers")
    if model == "resnet":
        rn = import_module(pkg.__name__ + ".models.resnet")
        img = L.data(name="img", shape=[3, 16, 16], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="int64")
        loss, _, _ = rn.resnet_cifar10(img, label)
    else:
        img = L.data(name="img", shape=[2, 6, 6], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        h = L.batch_norm(L.conv2d(img, num_filters=4, filter_size=3,
                                  padding=1), act="relu")
        h = L.batch_norm(L.fc(h, size=8))
        h = L.data_norm(h)
        loss = L.mean(L.square_error_cost(L.fc(h, size=1), y))
    return loss, pkg.optimizer.Momentum(lr, 0.9)


def bn_stat_names(program):
    """The running-statistics vars of the program's batch norms."""
    return sorted({op.input(s)[0] for op in program.global_block.ops
                   if op.type in ("batch_norm", "conv2d_bn")
                   for s in ("Mean", "Variance")})


def sync_bn_programs(pkg, model):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss, opt = build_sync_bn(pkg, model)
        opt.minimize(loss)
    return main, startup, loss


def sync_bn_rank(model, init, feeds, fault=None):
    """`model`'s program under with_data_parallel over the world (one
    process: the plain program on the global batch), from `init` (the
    JAX startup's persistables), one step a feed on this rank's rows.
    fault "local_stats": every batch norm takes its own rank's statistics
    (the sync's allreduces skipped). Returns {"losses", "params", "stats",
    "launches"}."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel.mesh import world

    _, n = world()
    main, startup, loss = sync_bn_programs(tpt, model)
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    exe.run(startup, scope=scope)
    load(scope, init)
    mesh = make_mesh()
    target = tpt.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, mesh=mesh) if n > 1 else main
    saved = nn_ops._sync_group
    if fault == "local_stats":
        nn_ops._sync_group = lambda ctx: None
    try:
        losses = []
        for feed in feeds:
            (lv,) = exe.run(target, feed=mesh.shard_feed(feed) if n > 1
                            else feed, fetch_list=[loss], scope=scope)
            losses.append(float(np.asarray(lv).reshape(-1)[0]))
    finally:
        nn_ops._sync_group = saved
    synced = []
    if n > 1:
        clone = exe._program_for(target)
        synced = sorted(op.type for op in clone.global_block.ops
                        if getattr(op, "dp_sync", None) is not None)
    return {"losses": losses,
            "params": {p.name: np.asarray(scope.find_var(p.name))
                       for p in main.all_parameters()},
            "stats": {s: np.asarray(scope.find_var(s))
                      for s in bn_stat_names(main)},
            "synced": synced}


def draws_program(pkg):
    """Every op that draws random numbers with a data-parallel rule, on
    batch-sharded inputs: (main, startup, {name: fetch var})."""
    from importlib import import_module

    L = import_module(pkg.__name__ + ".layers")
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = L.data(name="x", shape=[8], dtype="float32")
        img = L.data(name="img", shape=[3, 6, 6], dtype="float32")
        seq = L.data(name="seq", shape=[5, 4], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="int64")
        out = {"dropout": L.dropout(x, dropout_prob=0.5),
               "uniform": L.uniform_random_batch_size_like(x, [-1, 5]),
               "gaussian": L.gaussian_random_batch_size_like(x, [-1, 3]),
               "sampling_id": L.sampling_id(L.softmax(x)),
               "random_crop": L.random_crop(img, [3, 4, 4])}
        out["nce"] = L.nce(x, label, num_total_classes=20,
                           num_neg_samples=3)
        out["sampled"] = L.sampled_softmax_with_cross_entropy(
            L.fc(x, size=30), label, num_samples=4)
        h0 = L.fill_constant_batch_size_like(seq, [2, -1, 6], "float32", 0.0,
                                             output_dim_idx=1)
        lstm_out, _, _ = L.lstm(seq, h0, h0, 5, 6, 2, dropout_prob=0.5)
        out["lstm"] = lstm_out
    return main, startup, out


def draws_rank(feed, fault=None):
    """The draws program under with_data_parallel over the world, one run
    on this rank's rows from a fresh scope; the draws gathered over the
    ranks (global rows). fault "per_rank_draw": each op draws only its own
    rows' numbers (the rule's mark ignored)."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.parallel import make_mesh

    main, startup, out = draws_program(tpt)
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    exe.run(startup, scope=scope)
    mesh = make_mesh()
    target = tpt.CompiledProgram(main).with_data_parallel(mesh=mesh)
    saved = registry.ExecContext.draw
    if fault == "per_rank_draw":
        registry.ExecContext.draw = lambda self, fn, shape: fn(tuple(shape))
    try:
        vals = exe.run(target, feed=mesh.shard_feed(feed),
                       fetch_list=list(out.values()), scope=scope)
    finally:
        registry.ExecContext.draw = saved
    return dict(zip(out, (np.asarray(v) for v in vals)))


def reshard_rank(spec, params, feeds, dirname, action):
    """ZeRO-1 under with_data_parallel (sharded_optimizer_states) over the
    world. action "save": train on feeds[:-1], save_sharded, then one step
    on feeds[-1]; "load": load_sharded from `dirname` into a fresh scope,
    then one step on feeds[-1]. Returns (this rank's optimizer state after
    the save or the load {name: array}, the parameters after the last
    step)."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel.mesh import world

    _, n = world()
    mesh = make_mesh()
    main, startup, loss, _ = programs(tpt, spec, n)
    bs = tpt.BuildStrategy()
    bs.sharded_optimizer_states = True
    target = tpt.CompiledProgram(main, build_strategy=bs).with_data_parallel(
        loss_name=loss.name, mesh=mesh)
    exe, scope = tpt.Executor(place="cpu"), tpt.Scope()
    exe.run(startup, scope=scope)
    load(scope, params)
    if action == "save":
        for feed in feeds[:-1]:
            exe.run(target, feed=mesh.shard_feed(feed), fetch_list=[loss],
                    scope=scope)
        tpt.io.save_sharded(exe, dirname, main_program=target, scope=scope)
    else:
        tpt.io.load_sharded(exe, dirname, main_program=target, scope=scope,
                            shardings=mesh)
    state = {v.name: np.asarray(scope.find_var(v.name))
             for v in main.list_vars()
             if getattr(v, "is_opt_state", False)
             and scope.find_var(v.name) is not None}
    exe.run(target, feed=mesh.shard_feed(feeds[-1]), fetch_list=[loss],
            scope=scope)
    return state, {p.name: np.asarray(scope.find_var(p.name))
                   for p in main.all_parameters()}
