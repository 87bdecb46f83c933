"""Class-sharded ``margin_cross_entropy`` and ``io.DistributedBatchSampler``
held against the JAX package.

``F.margin_cross_entropy`` over a ``group`` of more than one rank takes
this rank's classes ``[N, C_local]`` (the reference's arrays are global:
it ignores ``group``). Spawned ranks on gloo (``paddle_tpu_torch.
distributed.spawn``, a ``file://`` store under the test's directory; the
children import neither ``jax`` nor ``paddle_tpu``) hold uneven class
shards over 3 ranks (7, 7 and 6 of 20 classes) and over a group of 2 of
them (10 and 10; the third rank out of the group), with the targets
spread over every shard: the loss on every rank, each rank's
``return_softmax`` shard and its logits' gradient, each within ``TOL``
of the reference's whole-logits result and of its columns, for the
ArcFace margins (1.0, 0.5, 0.0) and the combined ones (0.9, 0.4, 0.15),
``mean`` and ``sum``.

``DistributedBatchSampler``: the batches every rank draws over 3 epochs
(``set_epoch``), with and without ``shuffle`` and ``drop_last``, over 2
and 3 replicas and 10 or 11 samples, index for index the reference's.
"""
import pickle
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import spawn

TOL = 1e-5
N, C = 6, 20
SPLITS = {3: [7, 7, 6], 2: [10, 10]}  # group size: each rank's classes
MARGINS = {"arcface": (1.0, 0.5, 0.0, 16.0), "combined": (0.9, 0.4, 0.15,
                                                         8.0)}
REDUCTIONS = ("mean", "sum")


def _inputs():
    rng = np.random.RandomState(5)
    x = rng.randn(N, C).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)  # cosines
    label = np.array([0, 8, 19, 13, 6, 14], np.int64)  # every shard
    return x, label


def _reference(margins, reduction):
    """The reference's loss, softmax and logits' gradient on the whole
    logits."""
    import paddle_tpu as pt
    import paddle_tpu.nn.functional as JF

    x, label = _inputs()
    m1, m2, m3, s = margins
    xt = pt.to_tensor(x, stop_gradient=False)
    loss, sm = JF.margin_cross_entropy(xt, pt.to_tensor(label), m1, m2, m3,
                                       s, return_softmax=True,
                                       reduction=reduction)
    loss.backward()
    return (float(loss.numpy()), np.asarray(sm.numpy()),
            np.asarray(xt.grad.numpy()))


def _margin_worker(root):
    torch.set_num_threads(1)
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    assert not bad, f"a rank process loaded {bad[:5]}"
    import torch.distributed as tdist

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.collective import Group
    from paddle_tpu_torch.nn import functional as F

    dist.init_parallel_env(backend="gloo",
                           init_method=f"file://{root}/store")
    rank = dist.get_rank()
    pair = tdist.new_group([0, 1])  # every rank makes it
    groups = {3: Group(ranks=[0, 1, 2], pg=tdist.group.WORLD),
              2: Group(ranks=[0, 1], pg=pair)}
    x, label = _inputs()
    out = {}
    for size, group in groups.items():
        if rank >= size:
            continue
        lo = sum(SPLITS[size][:rank])
        cols = slice(lo, lo + SPLITS[size][rank])
        for mname, margins in MARGINS.items():
            for reduction in REDUCTIONS:
                xl = torch.from_numpy(x[:, cols].copy()).requires_grad_()
                loss, sm = F.margin_cross_entropy(
                    xl, torch.from_numpy(label), *margins, group=group,
                    return_softmax=True, reduction=reduction)
                loss.backward()
                out[(size, mname, reduction)] = (
                    cols, float(loss.detach()), sm.detach().numpy(),
                    xl.grad.numpy())
    with open(f"{root}/margin.{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def margin_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("margin")
    spawn(_margin_worker, args=(str(root),), nprocs=3)
    ranks = []
    for r in range(3):
        with open(root / f"margin.{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("margins", list(MARGINS))
@pytest.mark.parametrize("size", sorted(SPLITS))
def test_class_sharded_margin_ce_matches_reference(margin_runs, size,
                                                   margins, reduction):
    """Each rank of the group: the loss the reference's, its softmax and
    its logits' gradient the reference's columns of its classes."""
    loss, sm, grad = _reference(MARGINS[margins], reduction)
    held = 0
    for out in margin_runs:
        key = (size, margins, reduction)
        if key not in out:
            continue
        held += 1
        cols, got_loss, got_sm, got_grad = out[key]
        assert abs(got_loss - loss) <= TOL * max(1.0, abs(loss)), \
            (got_loss, loss)
        np.testing.assert_allclose(got_sm, sm[:, cols], atol=TOL, rtol=0)
        np.testing.assert_allclose(got_grad, grad[:, cols], atol=TOL,
                                   rtol=0)
    assert held == size


def test_margin_ce_on_one_rank_is_the_whole_logits():
    """No group (or one of one rank): the whole-logits form, as
    before."""
    from paddle_tpu_torch.nn import functional as F

    x, label = _inputs()
    loss, sm, grad = _reference(MARGINS["arcface"], "mean")
    xt = torch.from_numpy(x).requires_grad_()
    got, got_sm = F.margin_cross_entropy(xt, torch.from_numpy(label),
                                         *MARGINS["arcface"],
                                         return_softmax=True)
    got.backward()
    assert abs(float(got.detach()) - loss) <= TOL
    np.testing.assert_allclose(got_sm.detach().numpy(), sm, atol=TOL)
    np.testing.assert_allclose(xt.grad.numpy(), grad, atol=TOL)


# -- DistributedBatchSampler ----------------------------------------------

SAMPLER = [(n, reps, bs, shuffle, drop)
           for n, reps in ((10, 3), (11, 2), (10, 2))
           for bs in (2, 3)
           for shuffle in (False, True)
           for drop in (False, True)]


@pytest.mark.parametrize("n,reps,bs,shuffle,drop", SAMPLER)
def test_distributed_batch_sampler_matches_reference(n, reps, bs, shuffle,
                                                     drop):
    """Every rank's batches, epoch by epoch, and ``len``: the
    reference's."""
    from paddle_tpu.io import DistributedBatchSampler as JSampler

    from paddle_tpu_torch.io import DistributedBatchSampler

    data = list(range(n))
    for rank in range(reps):
        mine = DistributedBatchSampler(data, bs, num_replicas=reps,
                                       rank=rank, shuffle=shuffle,
                                       drop_last=drop)
        ref = JSampler(data, bs, num_replicas=reps, rank=rank,
                       shuffle=shuffle, drop_last=drop)
        assert len(mine) == len(ref)
        for epoch in range(3):
            mine.set_epoch(epoch)
            ref.set_epoch(epoch)
            assert list(mine) == list(ref), (rank, epoch)


def test_distributed_batch_sampler_resolves_from_the_namespace():
    import paddle_tpu_torch as paddle

    from paddle_tpu_torch.io import sampler

    assert paddle.io.DistributedBatchSampler is \
        sampler.DistributedBatchSampler
    batches = list(paddle.io.DistributedBatchSampler(
        list(range(10)), 2, num_replicas=3, rank=2))
    # 10 padded to 12 with indices 0, 1; rank 2 strides from 2
    assert batches == [[2, 5], [8, 1]]
