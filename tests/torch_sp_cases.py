"""What each rank of the port's sequence- and spatial-parallel tests runs
(torch_rank_pool): module-level functions of picklable arguments,
importing only paddle_tpu_torch and chip_smoke (for its planted faults).
The JAX side of each comparison runs in the test process, on the virtual
CPU devices of tests/conftest.py."""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

S = 16


def bert_feed(B, S_=S, vocab=1024, seed=0):
    rng = np.random.default_rng(seed)
    return {"src_ids": rng.integers(0, vocab, (B, S_)).astype(np.int64),
            "pos_ids": np.tile(np.arange(S_, dtype=np.int64), (B, 1)),
            "lm_label": rng.integers(0, vocab, (B, S_)).astype(np.int64),
            "lm_weight": (rng.random((B, S_)) < 0.5).astype(np.float32)}


def bert_programs(pkg, use_tp=False, dropout=0.0, lr=1e-3):
    """bert_tiny(use_tp, use_sp=True) at S = 16 under Adam(lr)."""
    from importlib import import_module

    tr = import_module(pkg.__name__ + ".models.transformer")
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        cfg = tr.bert_tiny(use_tp=use_tp, use_sp=True)
        cfg.dropout = dropout
        loss, _ = tr.bert_pretrain(cfg, seq_len=S)
        pkg.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss


def conv_programs(pkg, model):
    """The programs of tests/test_spatial_partition.py ("small": two convs,
    a global average pool and an fc under SGD(0.1); "resnet":
    resnet_cifar10 under Momentum(0.05, 0.9)) and "uneven", an NHWC stack
    that reaches 7 rows: the s2d stem's 4 x 4 conv with padding [2, 1, 2,
    1] and a batch norm, a 3 x 3 stride-2 max pool, a 3 x 3 stride-2 conv
    (14 -> 7 rows) with a batch norm beside a 1 x 1 stride-2 shortcut, a
    3 x 3 average pool, a global pool and an fc, under Momentum(0.05, 0.9).
    The image's H and the label are annotated as the JAX test annotates
    them. Returns (main, startup, loss)."""
    from importlib import import_module

    L = import_module(pkg.__name__ + ".layers")
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        if model == "small":
            img = L.data(name="img", shape=[3, 16, 16], dtype="float32")
            label = L.data(name="label", shape=[1], dtype="int64")
            x = L.conv2d(img, num_filters=8, filter_size=3, padding=1,
                         act="relu", param_attr=pkg.ParamAttr(name="c1w"),
                         bias_attr=pkg.ParamAttr(name="c1b"))
            x = L.conv2d(x, num_filters=8, filter_size=3, padding=1,
                         stride=2, act="relu",
                         param_attr=pkg.ParamAttr(name="c2w"),
                         bias_attr=pkg.ParamAttr(name="c2b"))
            x = L.pool2d(x, pool_type="avg", global_pooling=True)
            logits = L.fc(x, size=10, param_attr=pkg.ParamAttr(name="fcw"),
                          bias_attr=pkg.ParamAttr(name="fcb"))
            loss = L.mean(L.softmax_with_cross_entropy(logits, label))
            opt, h = pkg.optimizer.SGD(learning_rate=0.1), 2
        elif model == "resnet":
            resnet = import_module(pkg.__name__ + ".models.resnet")
            loss, _, _ = resnet.resnet_cifar10()
            opt, h = pkg.optimizer.Momentum(learning_rate=0.05,
                                            momentum=0.9), 2
        else:
            img = L.data(name="img", shape=[28, 28, 3], dtype="float32")
            label = L.data(name="label", shape=[1], dtype="int64")
            x = L.conv2d(img, num_filters=8, filter_size=4, stride=1,
                         padding=[2, 1, 2, 1], bias_attr=False,
                         data_format="NHWC")
            x = L.batch_norm(x, act="relu", data_layout="NHWC")
            x = L.pool2d(x, pool_size=3, pool_type="max", pool_stride=2,
                         pool_padding=1, data_format="NHWC")
            y = L.conv2d(x, num_filters=16, filter_size=3, stride=2,
                         padding=1, bias_attr=False, data_format="NHWC")
            y = L.batch_norm(y, act="relu", data_layout="NHWC")
            sc = L.conv2d(x, num_filters=16, filter_size=1, stride=2,
                          bias_attr=False, data_format="NHWC")
            x = L.pool2d(L.elementwise_add(y, sc), pool_size=3,
                         pool_type="avg", pool_stride=1, pool_padding=1,
                         data_format="NHWC")
            x = L.pool2d(x, pool_type="avg", global_pooling=True,
                         data_format="NHWC")
            loss = L.mean(L.softmax_with_cross_entropy(L.fc(x, size=10),
                                                       label))
            opt, h = pkg.optimizer.Momentum(learning_rate=0.05,
                                            momentum=0.9), 1
        blk = main.global_block
        spec = [None] * 4
        spec[0], spec[h] = "dp", "sp"
        blk.var("img").sharding = tuple(spec)
        blk.var("label").sharding = ("dp", None)
        opt.minimize(loss)
    return main, startup, loss


def conv_feed(model, B=8, seed=0):
    rng = np.random.default_rng(seed)
    shape = {"small": (B, 3, 16, 16), "resnet": (B, 3, 32, 32),
             "uneven": (B, 28, 28, 3)}[model]
    return {"img": rng.standard_normal(shape).astype(np.float32),
            "label": rng.integers(0, 10, (B, 1)).astype(np.int64)}


def _run(main, startup, loss, params, feeds, mesh_shape, fetch=()):
    """`feeds` through `main` from `params` (the JAX startup's), under
    with_data_parallel over `mesh_shape` (None: the one-process run):
    (losses, the global parameters after, the last step's `fetch`)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel.tensor_parallel import global_value
    from paddle_tpu_torch.weights import load_params

    exe, scope = pt.Executor(place="cpu"), pt.Scope()
    exe.run(startup, scope=scope)
    load_params(scope, main, params)
    target, mesh = main, None
    if mesh_shape:
        mesh = make_mesh(mesh_shape)
        target = pt.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, mesh=mesh)
    losses, got = [], []
    for feed in feeds:
        if mesh is not None:
            feed = mesh.shard_feed(feed, program=main, strict=False)
        got = exe.run(target, feed=feed, fetch_list=[loss] + list(fetch),
                      scope=scope)
        losses.append(float(np.asarray(got[0]).reshape(-1)[0]))
    glob = {p.name: global_value(scope, p.name, scope.find_var(p.name))
            .numpy().copy() for p in main.all_parameters()}
    return losses, glob, [np.asarray(g) for g in got[1:]]


def bert_rank(mesh_shape, params, feeds, fault=None, use_tp=False,
              dropout=0.0):
    """bert_tiny(use_sp=True) under with_data_parallel over `mesh_shape`,
    `fault` planted (chip_smoke's): (losses, global parameters, the last
    step's dropout masks, gathered, whether the user's program stayed as
    it was)."""
    import chip_smoke as cs
    import paddle_tpu_torch as pt

    undo = cs._plant_sp_fault(fault)
    try:
        main, startup, loss = bert_programs(pt, use_tp, dropout)
        before = main.to_dict()
        masks = [op.output("Mask")[0] for op in main.global_block.ops
                 if op.type == "dropout"]
        losses, glob, got = _run(main, startup, loss, params, feeds,
                                 mesh_shape, masks)
        return losses, glob, got, main.to_dict() == before
    finally:
        undo()


def bert_one_process(params, feeds, use_tp=False, dropout=0.0):
    """The port's unsharded run of bert_programs, with its dropout masks."""
    import paddle_tpu_torch as pt

    main, startup, loss = bert_programs(pt, use_tp, dropout)
    masks = [op.output("Mask")[0] for op in main.global_block.ops
             if op.type == "dropout"]
    return _run(main, startup, loss, params, feeds, None, masks)


def conv_rank(mesh_shape, model, params, feed, steps, fault=None):
    """conv_programs(model) for `steps` steps on one batch over
    `mesh_shape` (None: one process), `fault` planted: (losses, global
    parameters)."""
    import chip_smoke as cs
    import paddle_tpu_torch as pt

    undo = cs._plant_sp_fault(fault)
    try:
        main, startup, loss = conv_programs(pt, model)
        losses, glob, _ = _run(main, startup, loss, params, [feed] * steps,
                               mesh_shape)
        return losses, glob
    finally:
        undo()


def found_inf_rank(x, c, w):
    """decorate(SGD, dynamic loss scaling) over sum(fc(x) * c), x and c
    [B, S, H] split on S over {"sp": 2}, one step from the weight `w`: an
    inf in rank 1's rows of c poisons only rank 1's partial gradient.
    Returns (the weight after the step, the loss scale, the bad-step
    counter)."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.contrib import mixed_precision as amp
    from paddle_tpu_torch.parallel import make_mesh

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        xv = L.data(name="x", shape=list(x.shape[1:]), dtype="float32")
        cv = L.data(name="c", shape=list(c.shape[1:]), dtype="float32")
        xv.sharding = cv.sharding = ("dp", "sp", None)
        h = L.fc(xv, size=c.shape[-1], num_flatten_dims=2, bias_attr=False,
                 param_attr=pt.ParamAttr(name="w"))
        loss = L.reduce_sum(L.elementwise_mul(h, cv))
        amp.decorate(pt.optimizer.SGD(0.1), init_loss_scaling=8.0,
                     use_dynamic_loss_scaling=True).minimize(loss)
    exe, scope = pt.Executor(place="cpu"), pt.Scope()
    exe.run(startup, scope=scope)
    scope.set_var("w", torch.from_numpy(w.copy()))
    mesh = make_mesh({"sp": 2})
    target = pt.CompiledProgram(main).with_data_parallel(mesh=mesh)
    exe.run(target, feed=mesh.shard_feed({"x": x, "c": c}, program=main,
                                         strict=False),
            fetch_list=[loss], scope=scope)
    return (scope.find_var("w").numpy(),
            float(scope.find_var("@LOSS_SCALING@").reshape(-1)[0]),
            int(scope.find_var("@BAD_STEPS@").reshape(-1)[0]))


def save_rank(params, feeds, dirname):
    """bert_rank over {"sp": 2}, then save_params into `dirname`/rank<N>:
    the global parameters saved."""
    import os

    import torch.distributed as dist

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.weights import load_params

    main, startup, loss = bert_programs(pt)
    exe, scope = pt.Executor(place="cpu"), pt.Scope()
    exe.run(startup, scope=scope)
    load_params(scope, main, params)
    mesh = make_mesh({"sp": 2})
    target = pt.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, mesh=mesh)
    for feed in feeds:
        exe.run(target, feed=mesh.shard_feed(feed, program=main,
                                             strict=False),
                fetch_list=[loss], scope=scope)
    pt.io.save_params(exe, os.path.join(dirname, f"rank{dist.get_rank()}"),
                      main, scope=scope)
    return {p.name: scope.find_var(p.name).numpy().copy()
            for p in main.all_parameters()}
