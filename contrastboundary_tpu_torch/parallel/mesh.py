"""Data parallelism over the ranks of a process group (counterpart of
contrastboundary_tpu/parallel/mesh.py).

The JAX package shards the batch's axis 0 over a 1-D device mesh and
replicates the parameters; XLA's partitioner then inserts every
all-reduce: the gradients', the BatchNorm statistics', the losses' and the
metrics'. Here each rank holds its own batch (the global batch is the
ranks' batches stacked on axis 0), the parameters are broadcast from rank
0 once, and the port's modules call the few collectives below by hand:

- ``all_reduce_sum``: a sum across ranks that autograd sees (its backward
  is the same sum of the cotangents);
- ``global_means``: local means as the global batch's, for every BatchNorm
  statistic (differentiable, as flax's batch statistics are);
- ``global_mean``: a local sum over the global count (the count summed
  without gradient), for every loss;
- ``all_reduce_grads``: one flat sum of every gradient after backward;
- ``all_reduce_metrics``: one flat sum of the step's losses and confusion;
- ``local_rows`` and ``gather_rows``: a rank's rows of an eval batch, and
  the rows of every rank gathered back in rank order.

At world size 1 (no process group) each is the identity, or the local
expression it replaces, and issues no collective. Every collective is
counted, calls and bytes by kind (``read_counts``), for the tests and the
card's smoke run.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Sequence

import torch
import torch.distributed as dist

KINDS = ("all_reduce", "all_gather", "broadcast", "barrier")
_counts = {k: [0, 0] for k in KINDS}


def reset_counts() -> None:
    for v in _counts.values():
        v[0] = v[1] = 0


def read_counts() -> Dict[str, Dict[str, int]]:
    """{kind: {'calls', 'bytes'}} since the last ``reset_counts``; bytes
    are those of this rank's tensor (an all-gather's input)."""
    return {k: {"calls": c, "bytes": b} for k, (c, b) in _counts.items()}


def _count(kind: str, t: torch.Tensor) -> None:
    _counts[kind][0] += 1
    _counts[kind][1] += t.numel() * t.element_size()


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _all_reduce(t: torch.Tensor, kind: str = "all_reduce") -> torch.Tensor:
    _count(kind, t)
    dist.all_reduce(t)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone())


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over ranks of ``x``; differentiable: each rank's cotangent of the
    sum flows back to every rank's ``x``."""
    return x if process_count() == 1 else _AllReduceSum.apply(x)


def global_mean(local_sum: torch.Tensor, local_count: torch.Tensor) -> torch.Tensor:
    """This rank's share of a mean over the global batch: ``local_sum`` over
    the count summed across ranks (at least 1), so that the ranks' shares
    sum to the global mean and their gradients to its gradient. World size
    1: ``local_sum / max(local_count, 1)``."""
    if process_count() > 1:
        local_count = _all_reduce(local_count.detach().clone())
    return local_sum / torch.clamp_min(local_count, 1.0)


def global_means(means: Sequence[torch.Tensor], rows: int) -> list:
    """Local means, each over this rank's ``rows`` rows, as the means over
    every rank's rows (the global batch): one all-reduce of the weighted
    sums and the row count, differentiable through the sums (for the
    BatchNorm statistics; a caller under ``no_grad`` takes them as they
    are). World size 1: ``means`` as they are, and no collective."""
    if process_count() == 1:
        return list(means)
    s = all_reduce_sum(torch.cat([m.reshape(-1) * rows for m in means]
                                 + [means[0].new_full((1,), rows)]))
    parts = (s[:-1] / s[-1].detach()).split([m.numel() for m in means])
    return [p.view_as(m) for p, m in zip(parts, means)]


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum every gradient across ranks in place, as one flat all-reduce.
    Each rank's loss is already its share of the global mean, so the sum
    (not an average) is the gradient of the global loss."""
    if process_count() == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = _all_reduce(torch.cat([g.reshape(-1) for g in grads]))
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))


@torch.no_grad()
def all_reduce_metrics(metrics: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The step's metrics summed across ranks, as one flat all-reduce: each
    rank's loss is its share of the global mean and its confusion counts
    its rows, so the sums are the global values."""
    if process_count() == 1:
        return dict(metrics)
    keys = list(metrics)
    flat = _all_reduce(torch.cat([metrics[k].float().reshape(-1) for k in keys]))
    parts = flat.split([metrics[k].numel() for k in keys])
    return {k: v.view_as(metrics[k]).to(metrics[k].dtype) for k, v in zip(keys, parts)}


def _device() -> torch.device:
    """The device of this rank's collectives' scratch tensors."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0 in place,
    one flat broadcast per dtype (the counterpart of placing the state
    under replicated_sharding)."""
    if process_count() == 1:
        return module
    tensors = list(module.parameters()) + list(module.buffers())
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        group = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in group])
        _count("broadcast", flat)
        dist.broadcast(flat, src=0)
        for t, v in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(v.view_as(t))
    return module


def broadcast_object(obj):
    """Rank 0's ``obj`` (any picklable value) on every rank."""
    if process_count() == 1:
        return obj
    box = [obj]
    _counts["broadcast"][0] += 1
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    """Wait for every rank (a one-element all-reduce on the rank's device)."""
    if process_count() > 1:
        _all_reduce(torch.zeros(1, device=_device()), "barrier")


def shard_batch(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    """This rank's batch (its shard of the global batch, built by
    make_batch_iterator with shard_index = the rank) as tensors on its
    device."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def check_divisible(batch_size: int, what: str) -> None:
    """Raise unless ``batch_size`` splits evenly over the ranks (the JAX
    package's rule: the data mesh divides every batch)."""
    w = process_count()
    if batch_size % w:
        raise ValueError(f"{what} {batch_size} is not a multiple of the world size {w}: "
                         "every rank takes an equal share of each batch")


def local_rows(batch: Mapping) -> dict:
    """Rank r's rows [r·b/W, (r+1)·b/W) of every entry of an eval batch of
    b rows (all of them at world size 1)."""
    w = process_count()
    if w == 1:
        return dict(batch)
    b = len(next(iter(batch.values())))
    check_divisible(b, "the eval batch")
    r = process_index()
    return {k: v[r * b // w:(r + 1) * b // w] for k, v in batch.items()}


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated on axis 0 in rank order (``x`` at
    world size 1)."""
    w = process_count()
    if w == 1:
        return x
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(w)]
    _count("all_gather", x)
    dist.all_gather(out, x)
    return torch.cat(out, 0)
