"""Ranks of the port's distributed CPU tests (``test_torch_distributed``,
``test_torch_fleet_tp``): gloo worlds started with the port's ``spawn``,
each rank joining through a ``FileStore`` in the test's temporary
directory (no TCP port), on the CPU. The parent writes ``inputs.pkl``
(weights and batches, from the JAX package) before it starts a world;
each rank runs one job function of this module and writes its results
to ``rank<r>.pkl`` (a failure's traceback to ``rank<r>.err``). This
module imports torch and the port only: the ranks never import jax."""
import os
import pickle
import traceback

import numpy as np

B, S, VOCAB, LR, CLIP, STEPS = 4, 12, 64, 1e-3, 0.1, 3
LIN_LR = 0.1


def start_world(nprocs, job, tmp, backend="gloo"):
    """Start ``nprocs`` ranks of ``job`` (a function name of this module)
    without waiting: the parent computes its references meanwhile.
    ``backend`` None leaves it to the backend rule."""
    from paddle_tpu_torch.distributed import spawn
    return spawn(entry, args=(job, str(tmp)), nprocs=nprocs, join=False,
                 backend=backend)


def join_world(ctx, tmp, timeout=300):
    """Every rank's results, in rank order; a rank's failure raises with
    its traceback."""
    for p in ctx.processes:
        p.join(timeout)
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
            p.join()
    errs = []
    for r, p in enumerate(ctx.processes):
        err = os.path.join(tmp, f"rank{r}.err")
        if os.path.exists(err):
            errs.append(open(err).read())
        elif p.exitcode:
            errs.append(f"rank {r} exited with {p.exitcode}")
    if errs:
        raise RuntimeError("\n".join(errs))
    out = []
    for r in range(len(ctx.processes)):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def entry(job, tmp):
    import torch
    torch.set_num_threads(1)
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    world = int(os.environ["PADDLE_TRAINERS_NUM"])
    try:
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        out = globals()[job](rank, world, tmp, inputs)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        # leave the world together: a process group still alive at
        # interpreter exit can abort the process
        from paddle_tpu_torch import distributed as dist
        if dist.is_initialized():
            dist.barrier()
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        raise


def _join(rank, world, tmp):
    import torch.distributed as tdist

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import init_parallel_env
    paddle.set_device("cpu")
    init_parallel_env(device="cpu", store=tdist.FileStore(
        os.path.join(tmp, "store"), world), rank=rank, world_size=world)


def _fleet(mp=1, dp=1):
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp}
    fleet.init(is_collective=True, strategy=s)
    return fleet


def _np(t):
    t = getattr(t, "_data", t)
    return t.detach().float().cpu().numpy()


# -- the 4-rank world: collectives, DataParallel, DistributedTrainStep ----

def _collectives(rank, world):
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import monitor
    monitor.reset()
    out = {}
    base = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    for name in ("SUM", "MAX", "MIN", "PROD", "AVG"):
        t = base * (rank + 1)
        dist.all_reduce(t, op=getattr(dist.ReduceOp, name))
        out[f"all_reduce_{name}"] = t.numpy()
    t = torch.full((3,), rank + 1, dtype=torch.int64)
    dist.all_reduce(t)
    out["all_reduce_int"] = t.numpy()
    tt = paddle.to_tensor(np.full((2,), rank + 1.0, np.float32))
    dist.all_reduce(tt)
    out["all_reduce_tensor"] = tt.numpy()
    t = base * (rank + 1)
    dist.reduce(t, dst=1)
    out["reduce"] = t.numpy()
    got = []
    dist.all_gather(got, torch.full((2,), float(rank)))
    out["all_gather"] = np.stack([g.numpy() for g in got])
    pre = [torch.zeros(2) for _ in range(world)]
    dist.all_gather(pre, torch.full((2,), float(rank * 10)))
    out["all_gather_into"] = np.stack([g.numpy() for g in pre])
    objs = []
    dist.all_gather_object(objs, {"rank": rank})
    out["all_gather_object"] = objs
    t = torch.full((3,), float(rank))
    dist.broadcast(t, src=2)
    out["broadcast"] = t.numpy()
    t = torch.zeros(2)
    src = [torch.full((2,), 100.0 + i) for i in range(world)] \
        if rank == 0 else None
    dist.scatter(t, src, src=0)
    out["scatter"] = t.numpy()
    t = torch.zeros(2)
    dist.reduce_scatter(t, [torch.full((2,), float(rank * world + i))
                            for i in range(world)])
    out["reduce_scatter_list"] = t.numpy()
    t = torch.zeros(2)
    dist.reduce_scatter(t, torch.arange(2.0 * world) + rank,
                        op=dist.ReduceOp.AVG)
    out["reduce_scatter_avg"] = t.numpy()
    got = []
    dist.alltoall(got, [torch.full((1,), float(rank * 10 + i))
                        for i in range(world)])
    out["alltoall"] = np.concatenate([g.numpy() for g in got])
    t = torch.zeros(world)
    dist.alltoall_single(t, torch.arange(float(world)) + rank * 10)
    out["alltoall_single"] = t.numpy()
    # uneven: rank r sends i + 1 elements to rank i
    send_sizes = [i + 1 for i in range(world)]
    recv_sizes = [rank + 1] * world
    t = torch.zeros(sum(recv_sizes))
    dist.alltoall_single(t, torch.full((sum(send_sizes),), float(rank)),
                         in_split_sizes=send_sizes,
                         out_split_sizes=recv_sizes)
    out["alltoall_single_uneven"] = t.numpy()
    nxt, prv = (rank + 1) % world, (rank - 1) % world
    t = torch.zeros(2)
    if rank % 2 == 0:
        dist.send(torch.full((2,), float(rank)), dst=nxt)
        dist.recv(t, src=prv)
    else:
        dist.recv(t, src=prv)
        dist.send(torch.full((2,), float(rank)), dst=nxt)
    out["send_recv"] = t.numpy()
    t = torch.zeros(2)
    tasks = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, torch.full((2,), float(rank)), nxt),
        dist.P2POp(dist.irecv, t, prv)])
    for task in tasks:
        task.wait()
    out["batch_isend_irecv"] = t.numpy()
    evens = dist.new_group([0, 2])
    t = torch.full((2,), float(rank + 1))
    if evens.is_member():
        dist.all_reduce(t, group=evens)
    out["new_group"] = (evens.ranks, evens.rank, t.numpy())
    dist.barrier()
    out["backend"] = dist.get_backend()
    out["staged_bytes"] = dist.communication.staged_bytes()
    out["calls"] = {k: v for k, v in monitor.counters().items()
                    if k.startswith("distributed.calls.")}
    return out


def _data_parallel(rank, world, inputs):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    x, y = inputs["dp_x"], inputs["dp_y"]

    def build(seed):
        paddle.seed(seed)
        return nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))

    ref = build(0)
    loss = nn.CrossEntropyLoss()(ref(paddle.to_tensor(x)),
                                 paddle.to_tensor(y))
    loss.backward()
    want = [_np(p.grad) for p in ref.parameters()]
    model = paddle.DataParallel(build(rank), comm_buffer_size=0.0001,
                                last_comm_buffer_size=0.0001)
    k = x.shape[0] // world
    part = slice(rank * k, (rank + 1) * k)
    xs, ys = paddle.to_tensor(x[part]), paddle.to_tensor(y[part])
    loss = nn.CrossEntropyLoss()(model(xs), ys)
    loss.backward()
    got = [_np(p.grad) for p in model.parameters()]
    weights_equal = all(np.array_equal(_np(a), _np(b)) for a, b in
                        zip(model.parameters(), ref.parameters()))
    for p in model.parameters():
        p.clear_gradient()
    with model.no_sync():
        nn.CrossEntropyLoss()(model(xs), ys).backward()
    local = [_np(p.grad) for p in model.parameters()]
    return dict(dp_grads=got, dp_want=want, dp_weights_equal=weights_equal,
                dp_buckets=len(model._buckets), no_sync=local)


def _train_steps(rank, inputs, stage):
    import torch

    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.bridge import llama_state_from_numpy
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.parallel_step import \
        DistributedTrainStep
    from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM
    hcg = fleet.get_hybrid_communicate_group()
    mp_rank = hcg.get_model_parallel_rank()
    cfg = LlamaConfig(**inputs["llama_cfg"])
    net = LlamaForCausalLM(cfg, device="cpu")
    net.load_state_dict(llama_state_from_numpy(inputs["llama_params"],
                                               mp_rank, 2))
    opt = optimizer.AdamW(LR, parameters=net.named_parameters(),
                          grad_clip=nn.ClipGradByGlobalNorm(CLIP))
    if stage == "p_g_os":
        from paddle_tpu_torch.distributed.sharding import \
            group_sharded_parallel
        model, opt, _ = group_sharded_parallel(net, opt, "p_g_os")
        step = DistributedTrainStep(model, lambda out, lab: out, opt)
    else:
        step = DistributedTrainStep(fleet.distributed_model(net),
                                    lambda out, lab: out,
                                    fleet.distributed_optimizer(opt),
                                    sharding_stage=stage)
    ids = torch.from_numpy(inputs["batch"])
    losses = [float(step((ids, ids), ids)) for _ in range(STEPS)]
    return dict(losses=losses, state_bytes=step.opt_state_bytes(),
                param_bytes=step.parameter_bytes(),
                stage=step._sharding_stage,
                params={n: _np(p) for n, p in
                        step.full_parameters().items()},
                mp_rank=mp_rank, dp_rank=hcg.get_data_parallel_rank())


def _zero_eager(rank, inputs, level):
    """``group_sharded_parallel`` at ``level`` (ZeRO-1 "os" / ZeRO-2
    "os_g") on the eager surface: 2 AdamW steps, each data rank on its
    half of the batch, against one process on the whole batch."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    x, y = inputs["dp_x"], inputs["dp_y"]

    def build():
        paddle.seed(3)
        net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))
        return net, paddle.optimizer.AdamW(1e-2,
                                           parameters=net.parameters())

    ref, ref_opt = build()
    for _ in range(2):
        nn.CrossEntropyLoss()(ref(paddle.to_tensor(x)),
                              paddle.to_tensor(y)).backward()
        ref_opt.step()
        ref_opt.clear_grad()
    net, opt = build()
    model, opt, _ = group_sharded_parallel(net, opt, level)
    dp = fleet.get_hybrid_communicate_group().get_data_parallel_rank()
    k = x.shape[0] // 2
    xs = paddle.to_tensor(x[dp * k:(dp + 1) * k])
    ys = paddle.to_tensor(y[dp * k:(dp + 1) * k])
    for _ in range(2):
        nn.CrossEntropyLoss()(model(xs), ys).backward()
        opt.step()
        opt.clear_grad()
    return dict(got=[_np(p) for p in net.parameters()],
                want=[_np(p) for p in ref.parameters()],
                stage=opt.sharding_stage,
                state=sum(t.numel() for t in opt._state.values()
                          if t.dim()))


def _zero3_eager(rank, inputs):
    """``group_sharded_parallel(level="p_g_os")`` in eager code: the
    LLaMA of ``_train_steps``, ``loss.backward(); opt.step()`` on this
    data rank's half of the batch for STEPS steps; the losses averaged
    over the data group and the parameters gathered."""
    import torch

    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.bridge import llama_state_from_numpy
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.communication import collectives as C
    from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_wrappers \
        import zero3_of
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM
    hcg = fleet.get_hybrid_communicate_group()
    mp_rank = hcg.get_model_parallel_rank()
    net = LlamaForCausalLM(LlamaConfig(**inputs["llama_cfg"]), device="cpu")
    net.load_state_dict(llama_state_from_numpy(inputs["llama_params"],
                                               mp_rank, 2))
    opt = optimizer.AdamW(LR, parameters=net.parameters(),
                          grad_clip=nn.ClipGradByGlobalNorm(CLIP))
    model, opt, _ = group_sharded_parallel(net, opt, "p_g_os")
    g = hcg.get_dp_sharding_group()
    ids = torch.from_numpy(inputs["batch"])
    k = ids.shape[0] // g.nranks
    mine = ids[g.rank * k:(g.rank + 1) * k]
    losses = []
    for _ in range(STEPS):
        loss = model(mine, labels=mine)
        loss.backward()
        opt.step()
        opt.clear_grad()
        mean = loss.detach().clone()
        C.all_reduce(mean, op=C.ReduceOp.AVG, group=g)
        losses.append(float(mean))
    return dict(losses=losses, mp_rank=mp_rank, stage=opt.sharding_stage,
                params={n: _np(p) for n, p in
                        zero3_of(net).full_parameters().items()})


def _mse(out, lab):
    return ((out - lab) ** 2).mean()


def _zero3_linears(rank, inputs, stage):
    """Two ``torch.nn.Linear`` layers (four gathered tensors: fewer than
    the ZeRO-3 gather cache holds) under ``DistributedTrainStep`` at
    ``sharding_stage`` for STEPS AdamW steps on the data group's halves
    of the batch; the losses and the gathered parameters (JAX layout)."""
    import torch

    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.parallel_step import \
        DistributedTrainStep
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                              torch.nn.Linear(16, 4))
    with torch.no_grad():
        for n, p in net.named_parameters():
            p.copy_(torch.from_numpy(inputs["lin_params"][n]).T)
    opt = optimizer.AdamW(LIN_LR, parameters=net.named_parameters())
    step = DistributedTrainStep(fleet.distributed_model(net), _mse,
                                fleet.distributed_optimizer(opt),
                                sharding_stage=stage)
    x = torch.from_numpy(inputs["lin_x"])
    y = torch.from_numpy(inputs["lin_y"])
    losses = [float(step((x,), y)) for _ in range(STEPS)]
    return dict(losses=losses, stage=step._sharding_stage,
                params={n: _np(p).T for n, p in
                        step.full_parameters().items()})


def world4(rank, world, tmp, inputs):
    _join(rank, world, tmp)
    out = _collectives(rank, world)
    out.update(_data_parallel(rank, world, inputs))
    fleet = _fleet(mp=2, dp=2)
    hcg = fleet.get_hybrid_communicate_group()
    out["groups"] = {
        "dp": hcg.get_data_parallel_group().ranks,
        "mp": hcg.get_model_parallel_group().ranks,
        "pp": hcg.get_pipe_parallel_group().ranks,
        "sharding": hcg.get_sharding_parallel_group().ranks,
        "sep": hcg.get_sep_parallel_group().ranks,
        "dp_src": hcg.get_data_parallel_group_src_rank(),
        "mp_src": hcg.get_model_parallel_group_src_rank(),
        "coord": (hcg.get_data_parallel_rank(),
                  hcg.get_model_parallel_rank())}
    out["steps"] = {s: _train_steps(rank, inputs, s)
                    for s in (0, 1, 2, 3, "p_g_os")}
    out["zero_eager"] = {lv: _zero_eager(rank, inputs, lv)
                         for lv in ("os", "os_g")}
    out["zero3_eager"] = _zero3_eager(rank, inputs)
    out["zero3_linears"] = {s: _zero3_linears(rank, inputs, s)
                            for s in (0, 3)}
    return out


# -- the 2-rank world (mp=2): TP layers, LLaMA, BERT, a clipped step -------

def _tp_layers(rank, inputs):
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
        VocabParallelEmbedding)
    from paddle_tpu_torch.nn import functional as F
    t = inputs["tp"]
    col = ColumnParallelLinear(16, 32, gather_output=False)
    row = RowParallelLinear(32, 16, input_is_parallel=True)
    with torch.no_grad():
        col.weight._data.copy_(torch.from_numpy(
            t["w1"][:, rank * 16:(rank + 1) * 16]))
        col.bias._data.copy_(torch.from_numpy(t["b1"][rank * 16:
                                                      (rank + 1) * 16]))
        row.weight._data.copy_(torch.from_numpy(
            t["w2"][rank * 16:(rank + 1) * 16]))
        row.bias._data.copy_(torch.from_numpy(t["b2"]))
    x = paddle.to_tensor(t["x"], stop_gradient=False)
    out = row(F.relu(col(x)))
    (out * paddle.to_tensor(t["cot"])).sum().backward()
    res = dict(mlp_out=_np(out), mlp_dx=_np(x.grad),
               mlp_dw1=_np(col.weight.grad), mlp_db1=_np(col.bias.grad),
               mlp_dw2=_np(row.weight.grad), mlp_db2=_np(row.bias.grad),
               distributed=(col.weight.is_distributed,
                            row.weight.is_distributed,
                            row.bias.is_distributed))
    emb = VocabParallelEmbedding(32, 8)
    with torch.no_grad():
        emb.weight._data.copy_(torch.from_numpy(
            t["emb"][rank * 16:(rank + 1) * 16]))
    e = emb(paddle.to_tensor(t["ids"]))
    (e * paddle.to_tensor(t["ecot"])).sum().backward()
    logits = paddle.to_tensor(t["logits"][..., rank * 16:(rank + 1) * 16],
                              stop_gradient=False)
    ce = ParallelCrossEntropy()(logits, paddle.to_tensor(t["labels"]))
    ce.sum().backward()
    res.update(emb_out=_np(e), emb_dw=_np(emb.weight.grad), ce=_np(ce),
               ce_dlogits=_np(logits.grad))
    return res


def _llama_grads(rank, inputs, fused):
    import dataclasses

    import torch

    from paddle_tpu_torch.bridge import llama_state_from_numpy
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig(**inputs["llama_cfg"])
    cfg = dataclasses.replace(cfg, fused_linear_ce=fused)
    net = LlamaForCausalLM(cfg, device="cpu")
    net.load_state_dict(llama_state_from_numpy(inputs["llama_params"],
                                               rank, 2))
    ids = torch.from_numpy(inputs["batch"])
    if fused:
        loss = net(ids, labels=ids)
    else:
        logits = net(ids)
        loss = F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                               ids.reshape(-1))
    loss.backward()
    return dict(loss=float(loss),
                grads={n: _np(p.grad) for n, p in net.named_parameters()})


def _bert_grads(rank, inputs, fused):
    import dataclasses

    import torch

    from paddle_tpu_torch.bridge import bert_state_from_numpy
    from paddle_tpu_torch.text.models import BertConfig, BertForPretraining
    cfg = dataclasses.replace(BertConfig(**inputs["bert_cfg"]),
                              fused_mlm_ce=fused)
    net = BertForPretraining(cfg, device="cpu", mp_degree=2)
    net.load_state_dict(bert_state_from_numpy(inputs["bert_params"], rank,
                                              2))
    b = inputs["bert_batch"]
    loss, _ = net(torch.from_numpy(b["ids"]), torch.from_numpy(b["types"]),
                  labels=torch.from_numpy(b["labels"]),
                  attention_mask=torch.from_numpy(b["mask"]))
    loss.backward()
    return dict(loss=float(loss),
                grads={n: np.zeros(tuple(p.shape), np.float32)
                       if p.grad is None else _np(p.grad)
                       for n, p in net.named_parameters()})


def _clipped_step(rank, inputs):
    res = _train_steps(rank, inputs, 0)
    return dict(losses=res["losses"], params=res["params"])


def _rng(rank):
    import torch

    from paddle_tpu_torch.distributed.fleet.layers.mpu import random as R
    R.model_parallel_random_seed(1234)
    x = torch.ones(4096)
    return dict(inside=_np(R.dropout(x, p=0.5)),
                outside=_np(R.dropout(x, p=0.5, rng_name=None)),
                seed=R.determinate_seed(R.MODEL_PARALLEL_RNG))


def world2(rank, world, tmp, inputs):
    _join(rank, world, tmp)
    _fleet(mp=2)
    out = dict(layers=_tp_layers(rank, inputs), rng=_rng(rank))
    out["llama"] = {f: _llama_grads(rank, inputs, f) for f in (False, True)}
    out["bert"] = {f: _bert_grads(rank, inputs, f) for f in (False, True)}
    out["clipped"] = _clipped_step(rank, inputs)
    return out


# -- on the card (tests/test_torch_kernels_cuda.py) ------------------------

def _store(tmp, world):
    import torch.distributed as tdist
    return tdist.FileStore(os.path.join(tmp, "store"), world)


def cuda_gloo(rank, world, tmp, inputs):
    """Two ranks on one card: the backend rule picks gloo, and the
    collectives stage their CUDA tensors through host memory."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.distributed import env
    env.init_parallel_env(store=_store(tmp, world), rank=rank,
                          world_size=world)
    monitor.reset()
    t = torch.full((1 << 16,), float(rank + 1), device="cuda")
    dist.all_reduce(t)
    got = []
    dist.all_gather(got, torch.full((4,), float(rank), device="cuda"))
    b = torch.full((4,), float(rank), device="cuda")
    dist.broadcast(b, src=1)
    return dict(backend=env.backend(), device=str(env.device()),
                on_cuda=t.is_cuda and all(g.is_cuda for g in got),
                all_reduce=_np(t[:4]), all_gather=[_np(g) for g in got],
                broadcast=_np(b), staged=dist.communication.staged_bytes())


def cuda_nccl_shared(rank, world, tmp, inputs):
    """Two ranks on one card forced onto NCCL: NCCL refuses it."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import env
    env.init_parallel_env(backend="nccl", store=_store(tmp, world),
                          rank=rank, world_size=world)
    t = torch.ones(4, device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return dict(value=_np(t))


def cuda_ring(rank, world, tmp, inputs):
    """Two ranks sharing the card (gloo): the ring cases on CUDA chunks."""
    import torch

    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.kernels.ring_attention import ring_attention_arrays
    env.init_parallel_env(store=_store(tmp, world), rank=rank,
                          world_size=world)
    mesh = mesh_mod.build_mesh({"sep": world})
    out = []
    for case in inputs["ring_cases"]:
        s = case["q"].shape[2] // world
        q, k, v, cot = (torch.from_numpy(
            case[n][:, :, rank * s:(rank + 1) * s].copy()).cuda()
            for n in ("q", "k", "v", "cot"))
        for t in (q, k, v):
            t.requires_grad_()
        got = ring_attention_arrays(q, k, v, mesh=mesh, causal=case["causal"],
                                    window=case["window"])
        (got * cot).sum().backward()
        out.append(dict(out=_np(got), dq=_np(q.grad), dk=_np(k.grad),
                        dv=_np(v.grad), on_cuda=got.is_cuda))
    from paddle_tpu_torch import distributed as dist
    return dict(ring=out, backend=env.backend(),
                staged=dist.communication.staged_bytes())


def cuda_sp(rank, world, tmp, inputs):
    """Two ranks sharing the card (gloo), mp=2 with ``sequence_parallel``:
    a tiny LLaMA's fused loss and merged gradients (the sequence-parallel
    norms' summed over mp) against rank 0's own mp=1 model from the same
    seed on the card."""
    import torch

    from paddle_tpu_torch.distributed import env, fleet
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.distributed.fleet.meta_optimizers \
        .dygraph_optimizer.hybrid_parallel_optimizer import \
        sum_sequence_parallel_grads
    from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM
    env.init_parallel_env(store=_store(tmp, world), rank=rank,
                          world_size=world)
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"mp_degree": 2}
    fleet.init(is_collective=True, strategy=s)
    g = fleet.get_hybrid_communicate_group().get_model_parallel_group()
    cfg = LlamaConfig.tiny(vocab=256, hidden=256, layers=2, heads=4)
    cfg.fused_linear_ce, cfg.fused_ce_chunks = True, 2
    cfg.sequence_parallel = True
    ids = torch.randint(0, 256, (2, 64), generator=torch.Generator()
                        .manual_seed(5)).cuda()
    net = LlamaForCausalLM(cfg, seed=2)
    loss = net(ids, labels=ids)
    loss.backward()
    sum_sequence_parallel_grads([(p, p.grad) for p in net.parameters()], g)
    grads = _merged_grads(net, g)
    out = dict(loss=float(loss), backend=env.backend())
    if rank == 0:
        saved = mesh_mod.get_mesh()
        mesh_mod.set_mesh(None)
        try:
            ref = LlamaForCausalLM(cfg, seed=2)
        finally:
            mesh_mod.set_mesh(saved)
        want = ref(ids, labels=ids)
        want.backward()
        out["want_loss"] = float(want)
        out["ratios"] = {}
        for n, p in ref.named_parameters():
            r = p.grad.detach().float().cpu().numpy()
            tol = 1e-4 * max(1.0, float(np.abs(r).max()))
            out["ratios"][n] = float(np.abs(grads[n] - r).max()) / tol
    return out


# -- the pipeline worlds (test_torch_pipeline_ranks.py) ---------------------

PIPE_M, PIPE_LR, PIPE_CLIP, PIPE_STEPS = 4, 0.1, 1.0, 2


def _pipe_fleet(pp, mp=1, dp=1, mode="", vpp=1, accumulate=PIPE_M):
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"pp_degree": pp, "mp_degree": mp, "dp_degree": dp}
    s.pipeline_configs = {"accumulate_steps": accumulate,
                          "schedule_mode": mode, "vpp_degree": vpp}
    fleet.init(is_collective=True, strategy=s)
    return fleet


def _block_cls():
    import torch

    class Block(torch.nn.Module):
        """The JAX tests' ``_Block``: tanh(fc(x))."""

        def __init__(self, din, dout=None):
            super().__init__()
            self.fc = torch.nn.Linear(din, dout or din)

        def forward(self, x):
            return torch.tanh(self.fc(x))

    return Block


def _load_linear_pipe(model, params):
    """JAX Linear weights ([in, out]) onto this stage's modules."""
    import torch
    state = {}
    for name, p in model.state_dict().items():
        a = params[name]
        state[name] = torch.from_numpy(np.ascontiguousarray(
            a.T if name.endswith("fc.weight") else a))
    model.load_state_dict(state)


def _pipe_train(model, opt_of, data, steps=PIPE_STEPS):
    from paddle_tpu_torch import monitor
    monitor.reset()
    opt = opt_of(model)
    losses = [float(model.train_batch(data, opt)) for _ in range(steps)]
    params = {n: _np(p) for n, p in model.named_parameters()}
    return dict(losses=losses, params=params,
                stats=dict(getattr(model.last_runner, "stats", {}) or {}),
                sends=int(monitor.counters().get("distributed.calls.send",
                                                 0)))


def _sgd(model):
    from paddle_tpu_torch import nn, optimizer
    return optimizer.SGD(PIPE_LR, parameters=model.parameters(),
                         grad_clip=nn.ClipGradByGlobalNorm(PIPE_CLIP))


def _pipe_blocks(inputs, S, mode, vpp, widths=None, seg="uniform", dp=1):
    """A PipelineLayer of Blocks (or of ``widths`` Blocks under ``seg``)
    with the JAX weights, trained PIPE_STEPS steps (``dp`` > 1: each data
    rank on its part of the batch)."""
    import torch

    from paddle_tpu_torch.distributed.fleet import distributed_model
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer)
    Block = _block_cls()
    key = "het" if widths else "blocks"
    descs = [LayerDesc(Block, a, b) for a, b in widths] if widths else \
        [LayerDesc(Block, inputs["D"]) for _ in range(inputs["n_blocks"])]
    _pipe_fleet(S, mode=mode, vpp=vpp, dp=dp)
    pl = PipelineLayer(descs, num_stages=S, loss_fn=torch.nn.MSELoss(),
                       seg_method=seg)
    model = distributed_model(pl)
    _load_linear_pipe(model, inputs[f"{key}_params"])
    x, y = inputs[f"{key}_x"], inputs[f"{key}_y"]
    out = _pipe_train(model, _sgd, (torch.from_numpy(x),
                                      torch.from_numpy(y)))
    out["type"] = type(model).__name__
    # evaluation on the updated stages: the loss on every rank, the
    # output on the last stage (None elsewhere)
    out["eval_loss"] = float(model.eval_batch((torch.from_numpy(x),
                                               torch.from_numpy(y))))
    y_out = model.eval_batch((torch.from_numpy(x), None),
                             compute_loss=False)
    out["eval_out"] = None if y_out is None else _np(y_out)
    return out


def _pipe_llama(inputs, tied, mp=1, mode="FThenB"):
    import dataclasses

    import torch

    from paddle_tpu_torch.bridge import pipe_state_from_numpy
    from paddle_tpu_torch.distributed.fleet import (
        distributed_model, get_hybrid_communicate_group)
    from paddle_tpu_torch.text.models import LlamaConfig, build_llama_pipe
    _pipe_fleet(2, mp=mp, mode=mode, accumulate=2)
    cfg = dataclasses.replace(LlamaConfig(**inputs["llama_cfg"]),
                              tie_word_embeddings=tied)
    model = distributed_model(build_llama_pipe(cfg, device="cpu"))
    mp_rank = get_hybrid_communicate_group().get_model_parallel_rank()
    key = "tied" if tied else "untied"
    model.load_state_dict(pipe_state_from_numpy(
        inputs[f"llama_{key}"], cfg, mp_rank, mp,
        names=model.state_dict().keys()))
    ids = torch.from_numpy(inputs["llama_ids"])
    out = _pipe_train(model, _sgd, (ids, ids))
    out["mp_rank"] = mp_rank
    if mp > 1:
        from paddle_tpu_torch.bridge import tp_merge
        from paddle_tpu_torch.bridge import _pipe_to_llama_names
        from paddle_tpu_torch.distributed.communication import \
            collectives as C
        g = get_hybrid_communicate_group().get_model_parallel_group()
        rename = _pipe_to_llama_names(cfg.num_hidden_layers, tied)
        merged = {}
        for n, p in model.named_parameters():
            parts = C.all_gather(None, p.detach().contiguous(), group=g)
            merged[n] = _np(tp_merge(parts, "llama", rename(n)))
        out["params"] = merged
    return out


def _pipe_apply(rank, world):
    """``pipeline_apply*`` over the world's pp group against the
    sequential run of the same blocks in this rank: the largest
    differences of the outputs and of the gradients (stage and input)."""
    import torch

    from paddle_tpu_torch.distributed import fleet, pipeline
    fleet.init(is_collective=True, strategy=fleet.DistributedStrategy())
    group = fleet.get_hybrid_communicate_group().get_data_parallel_group()
    S, M, V = world, PIPE_M, 2
    gen = torch.Generator().manual_seed(6)
    w = torch.randn(S * V, 8, 8, generator=gen) * 0.3
    b = torch.randn(S * V, 8, generator=gen) * 0.1
    xs = torch.randn(M, 3, 8, generator=gen)

    def block(p, x, m, c):
        return torch.tanh(x @ p["w"] + p["b"])

    def chunk(c):
        return {"w": w[c].clone().requires_grad_(),
                "b": b[c].clone().requires_grad_()}

    out = {}
    for name in ("gpipe", "zb", "vpp", "zbvpp"):
        vv = V if "vpp" in name else 1
        cs = [chunk(v * S + rank) for v in range(vv)]
        x = xs.clone().requires_grad_()
        if name == "gpipe":
            ys = pipeline.pipeline_apply(block, cs[0], x, group)
        elif name == "zb":
            ys = pipeline.pipeline_apply_zb(block, cs[0], x, group)
        elif name == "vpp":
            ys = pipeline.pipeline_apply_vpp(block, cs, x, V, group)
        else:
            ys = pipeline.pipeline_apply_zbvpp(block, cs, x, V, group)
        (ys ** 2).mean().backward()
        ref = [chunk(c) for c in range(S * vv)]
        xr = xs.clone().requires_grad_()
        y = xr
        for p in ref:
            y = block(p, y, 0, 0)
        (y ** 2).mean().backward()
        errs = [float((ys - y).detach().abs().max())]
        for v, c in enumerate(cs):
            errs.append(float((c["w"].grad - ref[v * S + rank]["w"].grad)
                              .abs().max()))
        if rank == 0:
            errs.append(float((x.grad - xr.grad).abs().max()))
        out[name] = max(errs)
    return out


def pipe_world(rank, world, tmp, inputs):
    """Every schedule of a Block pipeline at pp=world against JAX; world
    2: the LLaMA pipe tied and untied; world 4: the heterogeneous stages
    and the LLaMA pipe at pp=2 x mp=2. First, ``pipeline_apply*`` over
    the world."""
    _join(rank, world, tmp)
    out = {"blocks": {}, "apply": _pipe_apply(rank, world)}
    for mode, vpp in inputs["modes"]:
        out["blocks"][(mode, vpp)] = _pipe_blocks(inputs, world, mode, vpp)
    if world == 4:
        out["het"] = _pipe_blocks(inputs, 4, "FThenB", 1,
                                  widths=inputs["het_widths"],
                                  seg=inputs["het_seg"])
        out["llama_mp2"] = _pipe_llama(inputs, False, mp=2, mode="1F1B")
        out["pp2_dp2"] = _pipe_blocks(inputs, 2, "1F1B", 1, dp=2)
    else:
        out["llama_untied"] = _pipe_llama(inputs, False, mode="1F1B")
        out["llama_tied"] = _pipe_llama(inputs, True, mode="ZBH1")
    return out


# -- the sequence-parallel worlds (test_torch_sequence_parallel.py) --------

def _fleet_degrees(**degrees):
    """``fleet.init`` at ``degrees`` ({"sep": 2, "mp": 2, ...})."""
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {f"{k}_degree": v for k, v in degrees.items()}
    fleet.init(is_collective=True, strategy=s)
    return fleet


def _sep_drift(rank, inputs):
    """Each sep rank feeds its own sequence chunk to the LLaMA (no
    wrapper) and steps an AdamW through ``fleet.distributed_optimizer``:
    the ring must see the other chunk and the step reduce over sep, else
    the ranks attend within their chunks and their weights drift."""
    import torch

    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.bridge import llama_state_from_numpy
    from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM
    fleet = _fleet_degrees(sep=2)
    sep = fleet.get_hybrid_communicate_group().get_sep_parallel_rank()
    net = LlamaForCausalLM(LlamaConfig(**inputs["llama_cfg"]), device="cpu")
    net.load_state_dict(llama_state_from_numpy(inputs["llama_params"]))
    opt = fleet.distributed_optimizer(
        optimizer.AdamW(LR, parameters=net.parameters()))
    ids = torch.from_numpy(inputs["batch"])
    k = ids.shape[1] // 2
    mine = ids[:, sep * k:(sep + 1) * k]
    losses = []
    for _ in range(STEPS):
        loss = net(mine, labels=mine)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return dict(losses=losses, sep_rank=sep,
                params={n: _np(p) for n, p in net.named_parameters()})


def _ring_cases(inputs, degree):
    """Each ring case of ``inputs["ring_cases"]`` on this rank's chunk
    (sep=``degree``): the output and the q / k / v gradients of
    sum(out * cot), chunks."""
    import torch

    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.kernels.ring_attention import ring_attention_arrays
    mesh = mesh_mod.build_mesh({"sep": degree},
                               world_size=mesh_mod.ensure_mesh().ranks.size)
    r = mesh.group("sep").rank
    out = []
    for case in inputs["ring_cases"]:
        s = case["q"].shape[2] // degree
        q, k, v, cot = (torch.from_numpy(case[n][:, :, r * s:(r + 1) * s]
                                         .copy())
                        for n in ("q", "k", "v", "cot"))
        for t in (q, k, v):
            t.requires_grad_()
        got = ring_attention_arrays(q, k, v, mesh=mesh, causal=case["causal"],
                                    window=case["window"])
        (got * cot).sum().backward()
        out.append(dict(out=_np(got), dq=_np(q.grad), dk=_np(k.grad),
                        dv=_np(v.grad), rank=r))
    return out


def ring_world(rank, world, tmp, inputs):
    _join(rank, world, tmp)
    return dict(ring=_ring_cases(inputs, world))


def _llama_net(inputs, key="llama", mp_rank=0, mp=1, **cfg):
    import dataclasses

    from paddle_tpu_torch.bridge import llama_state_from_numpy
    from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM
    c = dataclasses.replace(LlamaConfig(**inputs[f"{key}_cfg"]), **cfg)
    net = LlamaForCausalLM(c, device="cpu")
    net.load_state_dict(llama_state_from_numpy(inputs[f"{key}_params"],
                                               mp_rank, mp))
    return net


def _merged_grads(net, group):
    """{name: the global gradient}: the mp ranks' shards merged."""
    from paddle_tpu_torch.bridge import tp_merge
    from paddle_tpu_torch.distributed.communication import collectives as C
    out = {}
    for n, p in net.named_parameters():
        parts = C.all_gather(None, p.grad.contiguous(), group=group)
        out[n] = _np(tp_merge(parts, "llama", n))
    return out


def _sp_layers(rank, inputs):
    """The sequence-parallel linears (surface Layers, mp=2) on the JAX
    weights: scatter -> column -> row -> gather, gradients of
    sum(out * cot); and the scatter / gather round trip."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed.fleet.utils.sequence_parallel_utils \
        import (ColumnSequenceParallelLinear, GatherOp, ReduceScatterOp,
                RowSequenceParallelLinear, ScatterOp)
    t = inputs["sp"]
    col = ColumnSequenceParallelLinear(16, 32, has_bias=True)
    row = RowSequenceParallelLinear(32, 16, has_bias=True)
    with torch.no_grad():
        col.weight._data.copy_(torch.from_numpy(
            t["w1"][:, rank * 16:(rank + 1) * 16]))
        col.bias._data.copy_(torch.from_numpy(t["b1"][rank * 16:
                                                      (rank + 1) * 16]))
        row.weight._data.copy_(torch.from_numpy(
            t["w2"][rank * 16:(rank + 1) * 16]))
        row.bias._data.copy_(torch.from_numpy(t["b2"]))
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_optimizers \
        .dygraph_optimizer.hybrid_parallel_optimizer import \
        sum_sequence_parallel_grads
    x = paddle.to_tensor(t["x"], stop_gradient=False)
    out = GatherOp.apply(row(col(ScatterOp.apply(x))))
    (out * paddle.to_tensor(t["cot"])).sum().backward()
    # the bias, a sequence-parallel parameter, holds its rows' part: the
    # step's (the optimizer's) sum over mp
    sum_sequence_parallel_grads(
        [(row.bias, row.bias._data.grad)],
        fleet.get_hybrid_communicate_group().get_model_parallel_group())
    res = dict(out=_np(out), dx=_np(x.grad), dw1=_np(col.weight.grad),
               db1=_np(col.bias.grad), dw2=_np(row.weight.grad),
               db2=_np(row.bias.grad),
               bias_marked=bool(getattr(row.bias, "sequence_parallel",
                                        False)))
    y = torch.arange(64, dtype=torch.float32).reshape(2, 8, 4)
    half = ScatterOp.apply(y)
    res["round_trip"] = _np(GatherOp.apply(half))
    res["scattered"] = _np(half)
    res["reduce_scattered"] = _np(ReduceScatterOp.apply(y))
    return res


def _llama_sp(rank, inputs):
    """LLaMA with ``sequence_parallel`` at mp=2: the fused loss and every
    gradient (merged), the sequence-parallel norms' summed over mp (as the
    step sums them)."""
    import torch

    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_optimizers \
        .dygraph_optimizer.hybrid_parallel_optimizer import \
        sum_sequence_parallel_grads
    from paddle_tpu_torch.distributed.fleet.utils.sequence_parallel_utils \
        import ColumnSequenceParallelLinearModule
    from paddle_tpu_torch.distributed.fleet.utils.sequence_parallel_utils \
        import register_sequence_parallel_allreduce_hooks
    g = fleet.get_hybrid_communicate_group().get_model_parallel_group()
    net = _llama_net(inputs, mp_rank=rank, mp=2, sequence_parallel=True)
    # the hooks register nothing: the step's sum is the only one (once,
    # not twice)
    register_sequence_parallel_allreduce_hooks(net)
    ids = torch.from_numpy(inputs["batch"])
    loss = net(ids, labels=ids)
    loss.backward()
    sum_sequence_parallel_grads([(p, p.grad) for p in net.parameters()], g)
    sp_types = isinstance(net.llama.layers[0].self_attn.q_proj,
                          ColumnSequenceParallelLinearModule)
    return dict(loss=float(loss), grads=_merged_grads(net, g),
                sp_modules=sp_types)


def _llama_steps(rank, inputs, wrap="step", key="llama", labels="batch"):
    """STEPS AdamW steps of the LLaMA on the global batch: through
    ``DistributedTrainStep`` ("step": it splits the batch and the
    sequence) or eagerly through ``fleet.distributed_model`` (the
    wrapper splits) and ``distributed_optimizer`` ("eager"); the labels
    are ``inputs[labels]``."""
    import torch

    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.parallel_step import \
        DistributedTrainStep
    hcg = fleet.get_hybrid_communicate_group()
    mp = hcg.get_model_parallel_world_size()
    net = _llama_net(inputs, key, mp_rank=hcg.get_model_parallel_rank(),
                     mp=mp)
    model = fleet.distributed_model(net)
    opt = fleet.distributed_optimizer(
        optimizer.AdamW(LR, parameters=net.parameters()))
    ids = torch.from_numpy(inputs["batch"])
    lab = torch.from_numpy(inputs[labels])
    losses = []
    if wrap == "step":
        step = DistributedTrainStep(model, lambda out, lab: out, opt)
        losses = [float(step((ids, lab), lab)) for _ in range(STEPS)]
    else:
        for _ in range(STEPS):
            loss = model(ids, labels=lab)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.detach()))
    return dict(losses=losses, wrapper=type(model).__name__)


def _sep_refusals():
    """On the current sep=2 mesh, what must raise rather than attend
    within a rank's chunk: {case: "<exception type>: <message>", or None
    when nothing was raised}; and a LLaMA built on the mesh, which takes
    the ring (its logits under no_grad)."""
    import torch

    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        PipelineLayer, PipelineParallel, SegmentParallel)
    from paddle_tpu_torch.distributed.parallel_step import \
        DistributedTrainStep
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.text.models import (BertConfig, BertModel,
                                              LlamaConfig, LlamaForCausalLM)
    hcg = fleet.get_hybrid_communicate_group()
    cfg = LlamaConfig.tiny(vocab=64)
    saved = mesh_mod.get_mesh()
    mesh_mod.set_mesh(None)
    try:
        whole = LlamaForCausalLM(cfg, device="cpu")
        bert = BertModel(BertConfig.tiny(), device="cpu")
    finally:
        mesh_mod.set_mesh(saved)
    split = LlamaForCausalLM(cfg, device="cpu")
    ids = torch.zeros((1, 4), dtype=torch.int64)
    cache = [(torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 4, 16))] * 2
    cases = {
        "pipeline": lambda: PipelineParallel(
            PipelineLayer([torch.nn.Linear(4, 4)], num_stages=1)),
        "moe": lambda: MoELayer(16, 16, 2, device="cpu"),
        "segment_whole_llama": lambda: SegmentParallel(whole, hcg),
        "segment_bert": lambda: SegmentParallel(bert, hcg),
        "step_whole_llama": lambda: DistributedTrainStep(
            whole, lambda out, lab: out,
            optimizer.AdamW(LR, parameters=whole.parameters())),
        "kv_cache": lambda: split(ids, kv_caches=cache, cache_index=0),
        "chunk_logits": lambda: split(ids),
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    with torch.no_grad():
        out["logits_shape"] = tuple(split(ids).shape)
    out["takes_ring"] = all(
        m.self_attn.sep_group is not None for m in split.llama.layers)
    return out


def sep_world2(rank, world, tmp, inputs):
    _join(rank, world, tmp)
    out = dict(drift=_sep_drift(rank, inputs))
    out["steps"] = {name: _llama_steps(rank, inputs, *run)
                    for name, run in inputs["sep_runs"].items()}
    out["refusals"] = _sep_refusals()
    _fleet_degrees(mp=2)
    out["sp_layers"] = _sp_layers(rank, inputs)
    out["llama_sp"] = _llama_sp(rank, inputs)
    return out


def sep_world4(rank, world, tmp, inputs):
    """sep=2 x mp=2: the LLaMA's steps through DistributedTrainStep."""
    _join(rank, world, tmp)
    hcg = _fleet_degrees(sep=2, mp=2).get_hybrid_communicate_group()
    out = dict(coord=(hcg.get_sep_parallel_rank(),
                      hcg.get_model_parallel_rank()))
    out["steps"] = {name: _llama_steps(rank, inputs, *run)
                    for name, run in inputs["sep_runs"].items()}
    return out


# -- the expert-parallel worlds (test_torch_moe_ep.py) ---------------------

def _moe_layer(inputs, case, device="cpu"):
    import torch

    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.bridge import ep_shard
    mode, gname, top_k, cf, gs = case
    layer = MoELayer(d_model=inputs["moe_h"], d_hidden=inputs["moe_dff"],
                     num_experts=inputs["moe_e"], gate=gname, top_k=top_k,
                     capacity_factor=cf, group_size=gs, dispatch_mode=mode,
                     device=device)
    ep = layer.experts
    layer.load_state_dict({
        k: torch.tensor(ep_shard(v, k, ep.ep_rank, ep.ep_degree))
        for k, v in inputs["moe_params"].items()})
    return layer.eval()


def _moe_layer_grads(rank, inputs, name):
    """One MoE layer case at this world's dp x ep: the output rows, l_aux
    and the gradients of D * sum(out * cot) + l_aux on this data rank's
    rows (so that the data group's mean is the whole batch's loss),
    parameter gradients averaged over the data group as a step does."""
    import torch

    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.communication import collectives as C
    hcg = fleet.get_hybrid_communicate_group()
    data = hcg.get_dp_sharding_group()
    layer = _moe_layer(inputs, inputs["moe_cases"][name])
    x_all, cot_all = inputs["moe_x"], inputs["moe_cot"]
    k = x_all.shape[0] // data.nranks
    rows = slice(data.rank * k, (data.rank + 1) * k)
    x = torch.from_numpy(x_all[rows].copy()).requires_grad_()
    monitor.reset()
    out = layer(x)
    loss = data.nranks * (out * torch.from_numpy(cot_all[rows])).sum() \
        + layer.l_aux
    loss.backward()
    grads = {"gate_weight": layer.gate_weight.grad}
    for n in ("w1", "b1", "w2", "b2"):
        grads[n] = getattr(layer.experts, n).grad
    for g in grads.values():
        C.all_reduce(g, op=C.ReduceOp.AVG, group=data)
    return dict(out=_np(out), l_aux=float(layer.l_aux), x_grad=_np(x.grad),
                grads={n: _np(g) for n, g in grads.items()},
                ep_rank=layer.experts.ep_rank, dp_rank=data.rank,
                local_experts=layer.experts.num_local_experts,
                counters={c: v for c, v in monitor.counters().items()
                          if c.startswith("kernels.moe.dispatch_path")})


def _moe_net_steps(rank, inputs):
    """dryrun phase 3's MoENet (MoE + Linear head, CE + 0.01 l_aux) for
    STEPS AdamW steps through DistributedTrainStep."""
    import torch

    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.parallel_step import \
        DistributedTrainStep
    from paddle_tpu_torch.nn._modules import CrossEntropyLoss

    class MoENet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.moe = _moe_layer(inputs, inputs["moe_cases"]["einsum"])
            self.head = torch.nn.Linear(inputs["moe_h"], 8)

        def forward(self, x):
            return self.head(self.moe(x))

    net = MoENet().train()
    with torch.no_grad():
        net.head.weight.copy_(torch.from_numpy(inputs["head_w"].T))
        net.head.bias.copy_(torch.from_numpy(inputs["head_b"]))
    ce = CrossEntropyLoss()

    def loss_fn(out, lab):
        return ce(out.reshape(-1, 8), lab.reshape(-1)) + 0.01 * net.moe.l_aux

    opt = fleet.distributed_optimizer(
        optimizer.AdamW(LR, parameters=net.parameters()))
    step = DistributedTrainStep(fleet.distributed_model(net), loss_fn, opt)
    x = torch.from_numpy(inputs["net_x"])
    y = torch.from_numpy(inputs["net_y"])
    return dict(losses=[float(step((x,), y)) for _ in range(STEPS)])


def _ernie_ep(rank, inputs):
    """The tiny ERNIE-MoE at ep=2: CE + aux, its loss, aux and every
    gradient (the experts' merged over ep)."""
    import dataclasses

    import torch

    from paddle_tpu_torch.bridge import ep_merge, ernie_moe_state_from_numpy
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.communication import collectives as C
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.text.models import (ErnieMoEConfig,
                                              ErnieMoEForCausalLM)
    hcg = fleet.get_hybrid_communicate_group()
    ep = hcg.get_expert_parallel_group()
    cfg = ErnieMoEConfig(**inputs["ernie_cfg"])
    net = ErnieMoEForCausalLM(cfg, device="cpu").eval()
    net.load_state_dict(ernie_moe_state_from_numpy(
        inputs["ernie_params"], ep_rank=ep.rank, ep_degree=ep.nranks))
    ids = torch.from_numpy(inputs["ernie_ids"])
    logits = net(ids)
    aux = net.aux_loss()
    loss = F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                           ids.reshape(-1)) + aux
    loss.backward()
    grads = {}
    for n, p in net.named_parameters():
        parts = C.all_gather(None, p.grad.contiguous(), group=ep)
        grads[n] = _np(ep_merge(parts, n))
    # a one-rank model from the same seed equals the ep model's weights
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    saved = mesh_mod.get_mesh()
    mesh_mod.set_mesh(None)
    try:
        whole = ErnieMoEForCausalLM(cfg, device="cpu", seed=3)
    finally:
        mesh_mod.set_mesh(saved)
    mine = ErnieMoEForCausalLM(cfg, device="cpu", seed=3)
    seeded = all(
        torch.equal(ep_merge(C.all_gather(None, p.detach().contiguous(),
                                          group=ep), n), w)
        for (n, p), (_, w) in zip(mine.named_parameters(),
                                  whole.named_parameters()))
    return dict(loss=float(loss), aux=float(aux), logits=_np(logits),
                grads=grads, seeded_equal=seeded,
                expert_bytes=sum(p.numel() for n, p in net.named_parameters()
                                 if ".experts." in n))


def moe_world(rank, world, tmp, inputs):
    _join(rank, world, tmp)
    ep = inputs["moe_ep"]
    fleet = _fleet_degrees(ep=ep, dp=world // ep)
    hcg = fleet.get_hybrid_communicate_group()
    out = dict(ep=hcg.get_expert_parallel_world_size(),
               dp=hcg.get_data_parallel_world_size())
    out["layer"] = {name: _moe_layer_grads(rank, inputs, name)
                    for name in inputs["moe_cases"]}
    out["net"] = _moe_net_steps(rank, inputs)
    if world == ep:
        out["ernie"] = _ernie_ep(rank, inputs)
    return out
