"""The port's ``distributed`` package held against the JAX package's on
its virtual CPU mesh.

The reference runs in this process on a ``dp x mp`` mesh of its 8
devices; the port runs one process per rank (``distributed.spawn``),
on gloo through a ``file://`` store under ``tmp_path``, at world size 2
(mp 2) and 4 (dp 2 x mp 2). The children import neither ``jax`` nor
``paddle_tpu`` (they assert it); inputs and results cross as pickled
numpy. The mapping held: rank ``r`` is device ``r`` of the reference's
mesh, a sharded reference array is the ranks' tensors put together in
mesh order, a replicated one is every rank's tensor.

- collectives: every case of ``tests/test_distributed.py``'s
  ``TestCollectives`` with its inputs (``all_reduce`` sharded,
  replicated and MAX, ``all_gather`` both forms, ``all_to_all``,
  ``reduce_scatter``, ``scatter``/``broadcast``, the gradient through
  ``shard_tensor``, the psum), plus the gather order on a sharded
  input, ``reduce``, ``gather``, ``ppermute`` (a ring over mp),
  ``alltoall_single`` and the object collectives;
- layers (``TestMpLayers``'s): ``VocabParallelEmbedding``, the
  Column/Row pair, ``ParallelCrossEntropy`` and the sequence-parallel
  linears from the reference's weights: outputs, input gradients and
  weight gradients; ``DataParallel`` (and ``no_sync``);
- the ``HybridCommunicateGroup`` of (dp, pp, sharding, sep, mp) =
  (2, 1, 1, 1, 2) and (1, 2, 1, 1, 2): each rank's place and group on
  every axis against the reference's mesh coordinates;
- in this process: ``TCPStore``, ``RNGStatesTracker`` and the tracker's
  ``dropout``, ``recompute`` and ``recompute_sequential`` against the
  reference's on a 2-layer stack (forward and gradients), and dropout
  under ``recompute`` drawing the forward's masks again.

Tolerance fp32 1e-5.
"""
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import spawn

TOL = 1e-5
WORLDS = {2: (1, 2), 4: (2, 2)}  # world size: (dp, mp)
HCG_CASES = ((2, 1, 1, 1, 2), (1, 2, 1, 1, 2))
AXES = ("dp", "pp", "sharding", "sep", "mp")


def _f32(*shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _layer_inputs():
    return {"x": _f32(4, 8, 16, seed=1), "ids": np.random.RandomState(2)
            .randint(0, 100, (4, 8)), "logits": _f32(4, 100, seed=3),
            "lbl": np.random.RandomState(4).randint(0, 100, (4, 1)),
            "sp_x": _f32(2, 8, 16, seed=5), "dp_x": _f32(4, 8, seed=6)}


# -- the reference ------------------------------------------------------------

def _reference(dp, mp):
    """Every case's global result on the reference's dp x mp mesh, and
    the reference layers' weights."""
    import jax
    from jax.sharding import PartitionSpec as P

    import paddle_tpu as pt
    import paddle_tpu.distributed as jdist
    import paddle_tpu.nn as jnn
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.distributed.fleet.meta_parallel.parallel_layers import (
        mp_layers as jmp,
    )
    from paddle_tpu.distributed.fleet.utils import (
        sequence_parallel_utils as jsp,
    )
    from paddle_tpu.framework.jax_compat import shard_map

    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": mp}
    jfleet.init(is_collective=True, strategy=strategy)
    T = pt.to_tensor  # noqa: N806
    out, w = {}, {}
    try:
        xs = jdist.shard_tensor(T(np.arange(8, dtype=np.float32)
                                  .reshape(2, 4)), spec=("dp", None))
        out["all_reduce_sharded"] = jdist.all_reduce(
            xs, group=jdist.new_group(axes="dp")).numpy()
        out["all_reduce_replicated"] = jdist.all_reduce(
            T(np.ones((3,), np.float32)),
            group=jdist.new_group(axes="mp")).numpy()
        xm = jdist.shard_tensor(T(np.array([[1.0], [5.0]], np.float32)),
                                spec=("dp",))
        out["all_reduce_max"] = jdist.all_reduce(
            xm, op=jdist.ReduceOp.MAX, group="dp").numpy()
        out["all_gather"] = jdist.all_gather(
            T(np.ones((4, 2), np.float32)),
            group=jdist.new_group(axes="mp")).numpy()
        lst = []
        jdist.all_gather(lst, T(np.ones((2, 2), np.float32)), group="mp")
        out["all_gather_list"] = np.stack([t.numpy() for t in lst])
        g8 = np.arange(8, dtype=np.float32).reshape(8, 1)
        out["all_gather_order"] = jdist.all_gather(
            jdist.shard_tensor(T(g8), spec=("mp", None)), group="mp").numpy()
        parts = jdist.gather(jdist.shard_tensor(T(g8), spec=("mp", None)),
                             group="mp")
        out["gather"] = np.stack([p.numpy() for p in parts])
        a = T(np.arange(64, dtype=np.float32).reshape(8, 8))
        g44 = np.arange(16, dtype=np.float32).reshape(4, 4)
        sh = jdist.shard_tensor(T(g44), spec=("mp", None))
        out["reshard"] = jdist.sharding_constraint(sh, None, "mp").numpy()
        out["replicate"] = jdist.replicate(sh).numpy()
        out["shard_parameter"] = jdist.shard_tensor(
            T(g44), spec=(None, "mp")).numpy()
        out["all_to_all"] = jdist.all_to_all(
            a, group="mp", split_axis=1, concat_axis=0).numpy()
        out["reduce_scatter"] = jdist.reduce_scatter(
            T(np.ones((8, 2), np.float32)), group="mp").numpy()
        sc = jdist.scatter(T(np.ones((8, 2), np.float32)), group="dp")
        out["scatter"] = sc.numpy()
        out["broadcast"] = jdist.broadcast(sc, group="dp").numpy()
        out["reduce"] = jdist.reduce(T(np.ones((3,), np.float32)),
                                     group="mp").numpy()
        wt = T(np.ones((4, 4), np.float32), stop_gradient=False)
        jdist.shard_tensor(wt * 3.0, spec=("dp", "mp")).sum().backward()
        out["grad_through_shard"] = wt.grad.numpy()
        mesh = jdist.get_env().mesh

        def psum(x):
            return jdist.all_reduce(pt.Tensor(x), group="mp")._data

        out["psum"] = np.asarray(jax.jit(shard_map(
            psum, mesh=mesh, in_specs=P("mp"), out_specs=P(),
            check_vma=False))(np.ones((8,), np.float32)))
        ring = [(i, (i + 1) % mp) for i in range(mp)]

        def shift(x):
            return jdist.ppermute(pt.Tensor(x), ring, group="mp")._data

        out["ppermute"] = np.asarray(jax.jit(shard_map(
            shift, mesh=mesh, in_specs=P("mp"), out_specs=P("mp"),
            check_vma=False))(np.arange(2 * mp, dtype=np.float32)))
        out["alltoall_single"] = jdist.alltoall_single(
            None, T(np.arange(16, dtype=np.float32).reshape(8, 2)),
            group="mp").numpy()
        out["all_gather_object"] = jdist.all_gather_object(
            [], {"k": [1, 2]}, group="mp")
        out["scatter_object_list"] = jdist.scatter_object_list(
            [], [f"o{i}" for i in range(mp)], group="mp")

        li = _layer_inputs()
        col = jmp.ColumnParallelLinear(16, 32, gather_output=False)
        row = jmp.RowParallelLinear(32, 16, input_is_parallel=True)
        x = T(li["x"], stop_gradient=False)
        y = row(col(x))
        y.mean().backward()
        w["col"] = {"weight": col.weight.numpy(), "bias": col.bias.numpy()}
        w["row"] = {"weight": row.weight.numpy(), "bias": row.bias.numpy()}
        out["colrow_y"] = y.numpy()
        out["colrow_dx"] = x.grad.numpy()
        out["col_grads"] = {"weight": col.weight.grad.numpy(),
                            "bias": col.bias.grad.numpy()}
        out["row_grads"] = {"weight": row.weight.grad.numpy(),
                            "bias": row.bias.grad.numpy()}
        emb = jmp.VocabParallelEmbedding(100, 16)
        e = emb(T(li["ids"]))
        e.mean().backward()
        w["emb"] = {"weight": emb.weight.numpy()}
        out["emb_y"] = e.numpy()
        out["emb_grads"] = {"weight": emb.weight.grad.numpy()}
        lg = T(li["logits"], stop_gradient=False)
        loss = jmp.ParallelCrossEntropy()(lg, T(li["lbl"]))
        loss.sum().backward()
        out["pce_loss"] = loss.numpy()
        out["pce_grad"] = lg.grad.numpy()
        scol = jsp.ColumnSequenceParallelLinear(16, 32, gather_output=False)
        srow = jsp.RowSequenceParallelLinear(32, 16, input_is_parallel=True)
        sx = T(li["sp_x"], stop_gradient=False)
        sy = srow(scol(jsp.ScatterOp.apply(sx)))
        sy.mean().backward()
        w["scol"] = {"weight": scol.weight.numpy(),
                     "bias": scol.bias.numpy()}
        w["srow"] = {"weight": srow.weight.numpy(),
                     "bias": srow.bias.numpy()}
        out["sp_y"] = sy.numpy()
        out["sp_dx"] = sx.grad.numpy()
        out["scol_grads"] = {"weight": scol.weight.grad.numpy(),
                             "bias": scol.bias.grad.numpy()}
        out["srow_grads"] = {"weight": srow.weight.grad.numpy(),
                             "bias": srow.bias.grad.numpy()}
        lin = jnn.Linear(8, 4)
        dy = jdist.DataParallel(lin)(T(li["dp_x"]))
        dy.mean().backward()
        w["dp"] = {"weight": lin.weight.numpy(), "bias": lin.bias.numpy()}
        out["dp_y"] = dy.numpy()
        out["dp_grads"] = {"weight": lin.weight.grad.numpy(),
                           "bias": lin.bias.grad.numpy()}
        jdist.DataParallel(lin)(T(li["dp_x"])).mean().backward()
        out["dp_grads_twice"] = {"weight": lin.weight.grad.numpy(),
                                 "bias": lin.bias.grad.numpy()}
    finally:
        jenv.reset_env()
    return out, w


def _reference_hcg(degrees):
    """Each rank's place and group members on every axis, and the world
    sizes, from the reference's mesh: rank r is device r."""
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.distributed import fleet as jfleet

    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {f"{a}_degree": d for a, d in
                               zip(AXES, degrees)}
    jfleet.init(is_collective=True, strategy=strategy)
    try:
        hcg = jfleet.get_hybrid_communicate_group()
        sizes = {"dp": hcg.get_data_parallel_world_size(),
                 "mp": hcg.get_model_parallel_world_size(),
                 "pp": hcg.get_pipe_parallel_world_size(),
                 "sharding": hcg.get_sharding_parallel_world_size(),
                 "sep": hcg.get_sep_parallel_world_size()}
        ids = np.vectorize(lambda d: d.id)(jenv.get_env().mesh.devices)
    finally:
        jenv.reset_env()
    ranks = {}
    for r in range(ids.size):
        coords = tuple(int(c) for c in np.argwhere(ids == r)[0])
        ranks[r] = {}
        for i, a in enumerate(AXES):
            line = list(coords)
            line[i] = slice(None)
            ranks[r][a] = (coords[i], [int(v) for v in ids[tuple(line)]])
    return sizes, ranks


# -- the ranks ------------------------------------------------------------------

def _child_setup():
    torch.set_num_threads(1)
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    assert not bad, f"a rank process loaded {bad[:5]}"


def _strategy(fleet, degrees):
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {f"{a}_degree": d for a, d in zip(AXES, degrees)}
    return s


def _collective_cases(dist, hcg, mp):
    from paddle_tpu_torch.distributed import _comm

    routed = set()  # the torch.distributed functions _comm.run was given
    run = _comm.run

    def spy(fn, *args, **kwargs):
        routed.add(fn.__name__)
        return run(fn, *args, **kwargs)

    _comm.run = spy
    try:
        out = _collective_calls(dist, hcg, mp)
    finally:
        _comm.run = run
    out["routed"] = sorted(routed)
    return out


def _collective_calls(dist, hcg, mp):
    T = torch.tensor  # noqa: N806
    rank = dist.get_rank()
    out = {}
    xs = dist.shard_tensor(torch.arange(8, dtype=torch.float32)
                           .reshape(2, 4), spec=("dp", None))
    out["all_reduce_sharded"] = dist.all_reduce(
        xs.clone(), group=dist.new_group(axes="dp"))
    out["all_reduce_replicated"] = dist.all_reduce(
        torch.ones(3), group=dist.new_group(axes="mp"))
    xm = dist.shard_tensor(T([[1.0], [5.0]]), spec=("dp",))
    out["all_reduce_max"] = dist.all_reduce(
        xm.clone(), op=dist.ReduceOp.MAX, group="dp")
    out["all_gather"] = dist.all_gather(torch.ones(4, 2),
                                        group=dist.new_group(axes="mp"))
    lst = []
    dist.all_gather(lst, torch.ones(2, 2), group="mp")
    out["all_gather_list"] = torch.stack(lst)
    g8 = torch.arange(8, dtype=torch.float32).reshape(8, 1)
    mine = dist.shard_tensor(g8, spec=("mp", None))
    out["all_gather_order"] = dist.all_gather(mine, group="mp")
    out["gather"] = torch.stack(dist.gather(mine, group="mp"))
    g44 = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    sh = dist.shard_tensor(g44, spec=("mp", None))
    out["reshard"] = dist.sharding_constraint(sh, None, "mp")
    out["replicate"] = dist.replicate(sh)
    param = torch.nn.Parameter(g44.clone())
    dist.shard_parameter(param, None, "mp")
    out["shard_parameter"] = param.detach()
    out["shard_parameter_global"] = dist.shard.gather_global(
        param.detach(), param._dist_layout)
    a = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    out["all_to_all"] = dist.all_to_all(
        dist.shard_tensor(a, spec=("mp", None)), group="mp", split_axis=1,
        concat_axis=0)
    out["reduce_scatter"] = dist.reduce_scatter(torch.ones(8, 2),
                                                group="mp")
    src = hcg.get_data_parallel_group_src_rank()
    sc = dist.scatter(torch.ones(8, 2), src=src, group="dp")
    out["scatter"] = sc
    out["broadcast"] = dist.broadcast(sc.clone(), src=src, group="dp")
    out["reduce"] = dist.reduce(torch.ones(3), group="mp")
    wt = torch.ones(4, 4, requires_grad=True)
    dist.shard_tensor(wt * 3.0, spec=("dp", "mp")).sum().backward()
    out["grad_through_shard"] = dist.all_reduce(wt.grad.clone())
    out["psum"] = dist.all_reduce(
        dist.shard_tensor(torch.ones(8), spec=("mp",)).clone(), group="mp")
    ring = [(i, (i + 1) % mp) for i in range(mp)]
    out["ppermute"] = dist.ppermute(dist.shard_tensor(
        torch.arange(2 * mp, dtype=torch.float32), spec=("mp",)), ring,
        group="mp")
    out["alltoall_single"] = dist.alltoall_single(None, dist.shard_tensor(
        torch.arange(16, dtype=torch.float32).reshape(8, 2),
        spec=("mp", None)), group="mp")
    out = {k: v.detach().numpy() for k, v in out.items()}
    out["all_gather_object"] = dist.all_gather_object(
        [], {"k": [1, 2]}, group="mp")
    out["scatter_object_list"] = dist.scatter_object_list(
        [], [f"o{i}" for i in range(mp)],
        src=hcg.get_model_parallel_group_src_rank(), group="mp")
    out["broadcast_object_list"] = dist.broadcast_object_list(
        [f"from{rank}"], src=0)
    out["backend"] = dist.get_backend()
    dist.barrier(group="mp")
    for name in ("send", "recv", "isend", "irecv"):
        try:
            getattr(dist, name)(torch.ones(1), 0)
        except NotImplementedError:
            out[f"raises_{name}"] = True
    return out


def _layer_cases(dist, weights, dp_rank, dp):
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
        VocabParallelEmbedding,
    )
    from paddle_tpu_torch.distributed.fleet.utils import (
        sequence_parallel_utils as sp,
    )
    from paddle_tpu_torch.models import gather_jax_layout, load_jax_weights
    from paddle_tpu_torch.nn import Linear

    li = {k: torch.from_numpy(v) for k, v in _layer_inputs().items()}
    out = {}

    def built(layer, key):
        load_jax_weights(layer, weights[key])
        return layer

    col = built(ColumnParallelLinear(16, 32, gather_output=False,
                                     device="cpu"), "col")
    row = built(RowParallelLinear(32, 16, input_is_parallel=True,
                                  device="cpu"), "row")
    x = li["x"].clone().requires_grad_()
    y = row(col(x))
    y.mean().backward()
    out["colrow_y"], out["colrow_dx"] = y.detach().numpy(), x.grad.numpy()
    out["col_grads"] = gather_jax_layout(col, grads=True)
    out["row_grads"] = gather_jax_layout(row, grads=True)
    emb = built(VocabParallelEmbedding(100, 16, device="cpu"), "emb")
    e = emb(li["ids"])
    e.mean().backward()
    out["emb_y"] = e.detach().numpy()
    out["emb_grads"] = gather_jax_layout(emb, grads=True)
    lg = dist.shard_tensor(li["logits"], spec=(None, "mp")).detach() \
        .requires_grad_()
    loss = ParallelCrossEntropy()(lg, li["lbl"])
    loss.sum().backward()
    out["pce_loss"], out["pce_grad"] = loss.detach().numpy(), lg.grad.numpy()
    scol = built(sp.ColumnSequenceParallelLinear(16, 32, gather_output=False,
                                                 device="cpu"), "scol")
    srow = built(sp.RowSequenceParallelLinear(32, 16, input_is_parallel=True,
                                              device="cpu"), "srow")
    sx = li["sp_x"].clone().requires_grad_()
    sy = srow(scol(sp.ScatterOp.apply(sx)))
    (sy.sum() / sx.numel()).backward()  # the global mean
    out["sp_y"], out["sp_dx"] = sy.detach().numpy(), sx.grad.numpy()
    out["scol_grads"] = gather_jax_layout(scol, grads=True)
    out["srow_grads"] = gather_jax_layout(srow, grads=True)
    lin = built(Linear(8, 4, device="cpu"), "dp")
    net = dist.DataParallel(lin)
    b = 4 // dp
    xb = li["dp_x"][dp_rank * b:(dp_rank + 1) * b]
    dy = net(xb)
    (dy.sum() / 16).backward()  # the global mean's share
    out["dp_y"] = dy.detach().numpy()
    out["dp_grads"] = {n: p.grad.clone().numpy()
                       for n, p in lin.named_parameters()}
    lin.zero_grad(set_to_none=True)
    with net.no_sync():
        (net(xb).sum() / 16).backward()
    (net(xb).sum() / 16).backward()
    out["dp_grads_no_sync_twice"] = {n: p.grad.clone().numpy()
                                     for n, p in lin.named_parameters()}
    lin.zero_grad(set_to_none=True)
    (net(xb).sum() / 16).backward()
    (net(xb).sum() / 16).backward()
    out["dp_grads_synced_twice"] = {n: p.grad.clone().numpy()
                                    for n, p in lin.named_parameters()}
    with net.no_sync():
        (net(xb).sum() / 16).backward()
    (net(xb).sum() / 16).backward()
    out["dp_grads_synced_twice_then_no_sync"] = {
        n: p.grad.clone().numpy() for n, p in lin.named_parameters()}
    with net.no_sync():
        (net(xb).sum() / 16).backward()
    for p in lin.parameters():
        p.grad.zero_()  # the local part is cleared before it is summed
    (net(xb).sum() / 16).backward()
    out["dp_grads_cleared_local"] = {n: p.grad.numpy()
                                     for n, p in lin.named_parameters()}
    return out


def _hcg_case(fleet, degrees):
    fleet.init(is_collective=True, strategy=_strategy(fleet, degrees))
    hcg = fleet.get_hybrid_communicate_group()
    got = {}
    for a, name in (("dp", "data"), ("mp", "model"), ("pp", "pipe"),
                    ("sharding", "sharding"), ("sep", "sep")):
        size = getattr(hcg, f"get_{name}_parallel_world_size")()
        rank = getattr(hcg, f"get_{name}_parallel_rank")()
        group = getattr(hcg, f"get_{name}_parallel_group")()
        src = getattr(hcg, f"get_{name}_parallel_group_src_rank")()
        got[a] = (size, rank, group.ranks, group.nranks, group.rank, src)
    got["stage"] = (hcg.get_stage_id(), hcg.is_first_stage(),
                    hcg.is_last_stage())
    got["check"] = hcg.get_check_parallel_group().ranks
    got["world"] = (hcg.get_global_rank(), hcg.get_world_size())
    return got


def _rank_worker(root):
    _child_setup()
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet

    with open(f"{root}/weights.pkl", "rb") as f:
        dp, mp, weights = pickle.load(f)
    dist.init_parallel_env(backend="gloo",
                           init_method=f"file://{root}/store")
    fleet.init(is_collective=True,
               strategy=_strategy(fleet, (dp, 1, 1, 1, mp)))
    hcg = fleet.get_hybrid_communicate_group()
    res = {"coords": (hcg.get_data_parallel_rank(),
                      hcg.get_model_parallel_rank())}
    res["collectives"] = _collective_cases(dist, hcg, mp)
    res["layers"] = _layer_cases(dist, weights, res["coords"][0], dp)
    if dist.get_world_size() == 4:
        res["hcg"] = {d: _hcg_case(fleet, d) for d in HCG_CASES}
    with open(f"{root}/rank{dist.get_rank()}.pkl", "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world size: (reference results, [each rank's results])}."""
    out = {}
    for world, (dp, mp) in WORLDS.items():
        ref, weights = _reference(dp, mp)
        root = tmp_path_factory.mktemp(f"world{world}")
        with open(root / "weights.pkl", "wb") as f:
            pickle.dump((dp, mp, weights), f)
        spawn(_rank_worker, args=(str(root),), nprocs=world)
        ranks = []
        for r in range(world):
            with open(root / f"rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        out[world] = (ref, ranks)
    return out


def _joined(ranks, key, axis, along, dp_rank=0, kind="collectives"):
    """The ranks' local results for ``key`` put together along ``axis``
    ("mp" or "dp") on dim ``along`` (the other coordinate fixed)."""
    i = 1 if axis == "mp" else 0
    pick = [o for o in ranks if o["coords"][1 - i] == dp_rank]
    pick.sort(key=lambda o: o["coords"][i])
    return np.concatenate([o[kind][key] for o in pick], axis=along)


REPLICATED = ("all_reduce_sharded", "all_reduce_replicated",
              "all_reduce_max", "all_gather", "all_gather_list",
              "all_gather_order", "gather", "reduce", "grad_through_shard",
              "psum", "replicate")


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("key", REPLICATED)
def test_collective_matches_reference_on_every_rank(worlds, world, key):
    ref, ranks = worlds[world]
    for o in ranks:
        np.testing.assert_allclose(o["collectives"][key], ref[key],
                                   atol=TOL, rtol=0, err_msg=key)


SHARDED = {"all_to_all": ("mp", 1), "reduce_scatter": ("mp", 0),
           "ppermute": ("mp", 0), "alltoall_single": ("mp", 0),
           "scatter": ("dp", 0), "reshard": ("mp", 1),
           "shard_parameter": ("mp", 1)}


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("key", sorted(SHARDED))
def test_sharded_collective_matches_reference_in_mesh_order(worlds, world,
                                                            key):
    ref, ranks = worlds[world]
    axis, along = SHARDED[key]
    dp = WORLDS[world][0]
    for other in range(dp if axis == "mp" else WORLDS[world][1]):
        got = _joined(ranks, key, axis, along, other)
        np.testing.assert_allclose(got, ref[key], atol=TOL, rtol=0)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_every_collective_goes_through_one_entry(worlds, world):
    """``_comm.run`` counts the collectives that stage CUDA tensors
    through the host (``jit.TrainStep`` reads the count), so every
    public collective reaches ``torch.distributed`` through it. (On gloo
    ``all_to_all`` reaches it as ``all_to_all_single``: gloo has no list
    all-to-all on every torch version.)"""
    _, ranks = worlds[world]
    want = {"all_reduce", "all_gather", "broadcast", "scatter",
            "all_to_all_single", "_exchange", "barrier",
            "all_gather_object", "broadcast_object_list",
            "scatter_object_list"}
    for o in ranks:
        assert want <= set(o["collectives"]["routed"]), \
            want - set(o["collectives"]["routed"])


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_shard_parameter_records_its_layout(worlds, world):
    ref, ranks = worlds[world]
    for o in ranks:
        # the reference keeps one global array: its value is the reshard's
        np.testing.assert_array_equal(
            o["collectives"]["shard_parameter_global"], ref["replicate"])


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_broadcast_object_and_point_to_point_surface(worlds, world):
    ref, ranks = worlds[world]
    mp = WORLDS[world][1]
    for o in ranks:
        c = o["collectives"]
        # the dp group's source chunk on every member
        np.testing.assert_array_equal(c["broadcast"],
                                      ref["broadcast"][:c["broadcast"]
                                                       .shape[0]])
        assert c["all_gather_object"] == ref["all_gather_object"]
        # member i receives slot i (the reference's one controller is
        # member 0 and receives slot 0)
        assert c["scatter_object_list"] == [f"o{o['coords'][1]}"]
        assert c["broadcast_object_list"] == ["from0"]
        assert c["backend"] == "gloo"
        assert all(c[f"raises_{n}"] for n in ("send", "recv", "isend",
                                             "irecv"))
    assert ref["scatter_object_list"] == ["o0"] and mp > 1


LAYER_OUT = ("colrow_y", "colrow_dx", "emb_y", "pce_loss", "sp_dx")
LAYER_GRADS = ("col_grads", "row_grads", "emb_grads", "scol_grads",
               "srow_grads")


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("key", LAYER_OUT + LAYER_GRADS)
def test_layer_matches_reference(worlds, world, key):
    ref, ranks = worlds[world]
    for o in ranks:
        got = o["layers"][key]
        if key in LAYER_GRADS:
            assert got.keys() == ref[key].keys()
            for n in got:
                np.testing.assert_allclose(got[n], ref[key][n], atol=TOL,
                                           rtol=0, err_msg=f"{key}/{n}")
        else:
            np.testing.assert_allclose(got, ref[key], atol=TOL, rtol=0)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_sharded_layer_outputs_match_reference_in_mesh_order(worlds, world):
    ref, ranks = worlds[world]
    for dp_rank in range(WORLDS[world][0]):
        got = _joined(ranks, "pce_grad", "mp", -1, dp_rank, "layers")
        np.testing.assert_allclose(got, ref["pce_grad"], atol=TOL, rtol=0)
        got = _joined(ranks, "sp_y", "mp", 1, dp_rank, "layers")
        np.testing.assert_allclose(got, ref["sp_y"], atol=TOL, rtol=0)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_data_parallel_matches_reference(worlds, world):
    ref, ranks = worlds[world]
    got = _joined(ranks, "dp_y", "dp", 0, 0, "layers")
    np.testing.assert_allclose(got, ref["dp_y"], atol=TOL, rtol=0)
    for o in ranks:
        for n, g in o["layers"]["dp_grads"].items():
            np.testing.assert_allclose(g, ref["dp_grads"][n], atol=TOL,
                                       rtol=0, err_msg=n)
            # no_sync then a synced backward: both batches, summed once
            np.testing.assert_allclose(
                o["layers"]["dp_grads_no_sync_twice"][n],
                2 * ref["dp_grads"][n], atol=TOL, rtol=0, err_msg=n)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_data_parallel_sums_each_backward_once(worlds, world):
    """Gradients accumulated over backwards, synced or not, hold every
    backward's part summed over dp once, as the reference's global
    gradients accumulate."""
    ref, ranks = worlds[world]
    for o in ranks:
        got = o["layers"]
        for n, once in ref["dp_grads"].items():
            twice = ref["dp_grads_twice"][n]
            np.testing.assert_allclose(got["dp_grads_synced_twice"][n],
                                       twice, atol=TOL, rtol=0, err_msg=n)
            np.testing.assert_allclose(
                got["dp_grads_synced_twice_then_no_sync"][n], 2 * twice,
                atol=TOL, rtol=0, err_msg=n)
            np.testing.assert_allclose(got["dp_grads_cleared_local"][n],
                                       once, atol=TOL, rtol=0, err_msg=n)


@pytest.mark.parametrize("degrees", HCG_CASES)
def test_hybrid_group_matches_reference_mesh(worlds, degrees):
    sizes, want = _reference_hcg(degrees)
    _, ranks = worlds[4]
    for r, o in enumerate(ranks):
        got = o["hcg"][degrees]
        assert got["world"] == (r, 4)
        for a in AXES:
            size, rank, members, nranks, grank, src = got[a]
            place, line = want[r][a]
            assert (size, nranks) == (sizes[a], len(line)), a
            assert (rank, grank, members, src) == (place, place, line,
                                                   line[0]), a
        stage = want[r]["pp"][0]
        assert got["stage"] == (stage, stage == 0,
                                stage == degrees[1] - 1)
        dp_line = want[r]["dp"][1]
        assert got["check"] == dp_line


# -- in this process ------------------------------------------------------------

@pytest.fixture
def port_rng():
    """The port's random state, put back after the test."""
    from paddle_tpu_torch.framework import random as rng

    saved = rng.get_state()
    yield rng
    rng.replace_state(saved)


def test_tcp_store_methods():
    from paddle_tpu_torch.distributed import TCPStore

    master = TCPStore("127.0.0.1", 0, is_master=True, world_size=2,
                      timeout=30)
    client = TCPStore("127.0.0.1", master.port, is_master=False, timeout=30)
    master.set("a", "1")
    client.set("b", b"\x00\x01")
    assert client.get("a") == b"1" and master.get("b") == b"\x00\x01"
    with pytest.raises(KeyError):
        client.get("missing")
    assert master.add("n", 2) == 2 and client.add("n", 3) == 5
    client.wait(["a", "b"], timeout=5)
    with pytest.raises(TimeoutError):
        client.wait("never", timeout=0.2)
    assert master.delete_key("a") and not master.delete_key("a")
    with pytest.raises(KeyError):
        client.get("a")


def test_rng_tracker_named_state(port_rng):
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        RNGStatesTracker,
    )
    from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers \
        import random as prand

    rng = port_rng

    tr = RNGStatesTracker()
    tr.add("a", 100)
    with pytest.raises(ValueError):
        tr.add("b", 100)
    with pytest.raises(ValueError):
        tr.add("a", 7)
    rng.seed(1)
    outside = rng.get_state()
    with tr.rng_state("a"):
        k1 = rng.next_seed_words()
    with tr.rng_state("a"):
        k2 = rng.next_seed_words()
    assert k1 != k2
    # the state outside the blocks is untouched
    after = rng.get_state()
    assert after["words"].equal(outside["words"])
    # the named state is the seed's own stream
    rng.seed(100)
    assert rng.next_seed_words() == k1
    with pytest.raises(ValueError):
        with tr.rng_state("missing"):
            pass
    # the tracker's dropout: a mask from the named state, reproducible
    x = torch.ones(64, 64)
    prand.model_parallel_random_seed(5)
    d1 = prand.dropout(x, 0.5)
    prand.model_parallel_random_seed(5)
    d2 = prand.dropout(x, 0.5)
    assert torch.equal(d1, d2) and 0.3 < (d1 == 0).float().mean() < 0.7
    assert torch.equal(prand.dropout(x, 0.5, training=False), x)


def _stacks():
    """A reference 2-layer stack and the port's with its weights."""
    import paddle_tpu as pt
    import paddle_tpu.nn as jnn
    from paddle_tpu_torch.nn import Linear

    pt.seed(3)
    j = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    t1, t2 = Linear(8, 16, device="cpu"), Linear(16, 4, device="cpu")
    with torch.no_grad():
        for jl, tl in ((j[0], t1), (j[2], t2)):
            tl.weight.copy_(torch.from_numpy(np.array(jl.weight.numpy())))
            tl.bias.copy_(torch.from_numpy(np.array(jl.bias.numpy())))
    return j, torch.nn.Sequential(t1, torch.nn.ReLU(), t2)


@pytest.mark.parametrize("sequential", [False, True])
def test_recompute_matches_reference(sequential):
    import paddle_tpu as pt
    from paddle_tpu.distributed.fleet.utils import recompute as jrec
    from paddle_tpu.distributed.fleet.utils import (
        recompute_sequential as jrec_seq,
    )
    from paddle_tpu_torch.distributed.fleet.utils import (
        recompute, recompute_sequential,
    )

    j, t = _stacks()
    xv = _f32(5, 8, seed=9)
    jx = pt.to_tensor(xv, stop_gradient=False)
    tx = torch.from_numpy(xv).requires_grad_()
    if sequential:
        jy = jrec_seq({"segments": 2}, j, jx)
        ty = recompute_sequential({"segments": 2}, t, tx)
    else:
        jy = jrec(j, jx)
        ty = recompute(t, tx)
    (jy * jy).sum().backward()
    (ty * ty).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), jy.numpy(), atol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), atol=TOL)
    jgrads = [np.asarray(p.grad.numpy()) for p in j.parameters()]
    for g, want in zip([p.grad.numpy() for p in t.parameters()], jgrads):
        np.testing.assert_allclose(g, want, atol=TOL)


def test_recompute_replays_the_forwards_dropout(port_rng):
    from paddle_tpu_torch.distributed.fleet.utils import recompute
    from paddle_tpu_torch.nn import functional as TF

    rng = port_rng

    def block(x):
        return TF.dropout(torch.tanh(x), 0.5) * 3.0

    grads = []
    for use in (False, True):
        rng.seed(42)
        x = torch.from_numpy(_f32(16, 16, seed=1)).requires_grad_()
        y = recompute(block, x) if use else block(x)
        y.sum().backward()
        grads.append(x.grad)
    assert torch.equal(grads[0], grads[1])
    # and the draws after it go on from the forward's
    rng.seed(42)
    block(torch.zeros(16, 16))
    plain_next = rng.next_seed_words()
    rng.seed(42)
    x = torch.zeros(16, 16, requires_grad=True)
    recompute(block, x).sum().backward()
    assert rng.next_seed_words() == plain_next


# -- SyncBatchNorm over dp ------------------------------------------------------

SBN_X = _f32(8, 4, 3, 3, seed=31)  # the global batch, NCHW
SBN_COT = _f32(8, 4, 3, 3, seed=32)


def _sync_bn_worker(root):
    """One dp rank: SyncBatchNorm (the reference's weights) in training
    mode on its half of the global batch, ``sum(out * cotangent)``
    backward."""
    _child_setup()
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.nn.layer.layers import load_jax_weights

    with open(f"{root}/weights.pkl", "rb") as f:
        weights = pickle.load(f)
    dist.init_parallel_env(backend="gloo",
                           init_method=f"file://{root}/store")
    rank, n = dist.get_rank(), dist.get_world_size()
    bn = tnn.SyncBatchNorm(4, device="cpu")
    load_jax_weights(bn, weights)
    rows = slice(rank * 8 // n, (rank + 1) * 8 // n)
    x = torch.from_numpy(SBN_X[rows]).requires_grad_()
    out = bn(x)
    (out * torch.from_numpy(SBN_COT[rows])).sum().backward()
    res = {"out": out.detach().numpy(), "dx": x.grad.numpy(),
           "dw": bn.weight.grad.numpy(), "db": bn.bias.grad.numpy(),
           "mean": bn._mean.numpy(), "var": bn._variance.numpy()}
    with open(f"{root}/rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


def test_sync_batch_norm_at_dp2_is_the_global_batch(tmp_path):
    """Two dp ranks over gloo, each with half of the batch: the outputs
    and input gradients put together, the parameter gradients summed over
    the ranks and each rank's running statistics equal the reference's
    batch norm over the whole batch (the statistics GSPMD computes for
    its sharded batch) within 1e-5."""
    import paddle_tpu as pt
    import paddle_tpu.nn as pnn

    ref = pnn.SyncBatchNorm(4)
    weights = {n: np.asarray(t.numpy()) for n, t in ref.state_dict().items()}
    x = pt.to_tensor(SBN_X, stop_gradient=False)
    out = ref(x)
    (out * pt.to_tensor(SBN_COT)).sum().backward()
    with open(tmp_path / "weights.pkl", "wb") as f:
        pickle.dump(weights, f)
    spawn(_sync_bn_worker, args=(str(tmp_path),), nprocs=2)
    ranks = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    want = {"out": out.numpy(), "dx": x.grad.numpy(),
            "dw": ref.weight.grad.numpy(), "db": ref.bias.grad.numpy(),
            "mean": ref._mean.numpy(), "var": ref._variance.numpy()}
    got = {"out": np.concatenate([r["out"] for r in ranks]),
           "dx": np.concatenate([r["dx"] for r in ranks]),
           "dw": ranks[0]["dw"] + ranks[1]["dw"],
           "db": ranks[0]["db"] + ranks[1]["db"]}
    for r in ranks:
        for k in ("mean", "var"):
            np.testing.assert_allclose(r[k], np.asarray(want[k]), rtol=0,
                                       atol=TOL, err_msg=k)
    for k, g in got.items():
        w = np.asarray(want[k])
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=TOL * max(np.abs(w).max(), 1.0),
                                   err_msg=k)
