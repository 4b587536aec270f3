"""Sums and gathers across the processes of a multi-process mesh.

A ("dcn", axis) mesh (parallel/batching.py) spans the processes of an
initialized torch.distributed process group, each holding the whole data
and the replicated parameters (the JAX package's multi-controller
model), each evaluating the likelihood of its own shards. What crosses
processes is tiny: the likelihood's local sum, the parameters'
cotangents, the time chunks' totals (O(shards s^2)). It runs over a gloo
group on host copies: gloo runs on the CPU and with several processes on
one card (NCCL refuses two ranks on one card), and a few KB a collective
cost nothing that matters.

Every sum is an all-gather followed by the sum of the parts in rank
order, so every rank holds the same bits and the ranks' optimizers take
the same steps.

The differentiable collectives are `torch.autograd.Function`s with
`backward`, `jvp` and `vmap` rules, so the Laplace layer's torch.func
transforms (vmap, jvp, grad, jacfwd, hessian) run through them. The
likelihood's sum of local terms is

    total = process_sum(local(replicate(params)))

`process_sum` all-reduces forward and passes the cotangent through (its
output is replicated: every rank's copy is the one value);
`replicate` is the identity forward and all-reduces the cotangents
backward, the one place where a gradient crosses processes. Forward
mode needs no exchange at `replicate` (a replicated tangent is the same
everywhere) and sums the tangents at `process_sum`. `gather` (each
rank's tensor, concatenated in rank order) is `replicate` of a
`process_sum` of zero-padded parts: its cotangent is summed over the
ranks that read the gathered tensor, and each keeps its own part.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class Processes:
    """The processes of a multi-process mesh: `group` (a gloo group over
    every rank of the default process group: that group itself when its
    backend is gloo, else a new one, which every process makes in the
    same order), `size`, this process's `rank`."""

    def __init__(self):
        if not dist.is_initialized():
            raise RuntimeError(
                "a multi-process mesh needs torch.distributed: call "
                "init_process_group in every process first")
        self.group = (dist.group.WORLD if dist.get_backend() == "gloo"
                      else dist.new_group(backend="gloo"))
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)

    def __repr__(self):
        return f"Processes(rank={self.rank}, size={self.size})"


def _all_gather(x, procs: Processes):
    """Every rank's x (same shape everywhere), host copies in rank
    order."""
    buf = x.detach().to("cpu").contiguous()
    parts = [torch.empty_like(buf) for _ in range(procs.size)]
    dist.all_gather(parts, buf, group=procs.group)
    return parts


def sum_plain(x, procs: Processes):
    """The sum of every rank's x, in rank order, on x's device; no
    autograd (the kernel cores' stitch)."""
    parts = _all_gather(x, procs)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total.to(x.device)


def first_rank(x, procs: Processes):
    """Rank 0's x (same shape everywhere) on every rank, a host copy: what
    every rank's host decisions read, so that the ranks decide alike."""
    return _all_gather(x, procs)[0]


def gather_plain(x, dim: int, procs: Processes):
    """Every rank's x concatenated along `dim` in rank order, on x's
    device; no autograd (the kernel cores' stitch)."""
    return torch.cat(_all_gather(x, procs), dim=dim).to(x.device)


class _ProcessSum(torch.autograd.Function):
    """process_sum: forward the sum over ranks; backward the identity (the
    output is replicated); jvp the sum of the tangents."""

    generate_vmap_rule = False

    @staticmethod
    def forward(x, procs):
        return sum_plain(x, procs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.procs = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def jvp(ctx, x_t, _):
        return _ProcessSum.apply(x_t, ctx.procs)

    @staticmethod
    def vmap(info, in_dims, x, procs):
        # the batched tensor whole: every rank has the same batch
        return _ProcessSum.apply(x, procs), in_dims[0]


class _Replicate(torch.autograd.Function):
    """replicate: forward the identity (copies); backward the sum over
    ranks of every cotangent, in one collective; jvp the identity."""

    generate_vmap_rule = False

    @staticmethod
    def forward(procs, *xs):
        return tuple(x.clone() for x in xs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.procs = inputs[0]
        ctx.shapes = [x.shape for x in inputs[1:]]

    @staticmethod
    def backward(ctx, *gs):
        flat = torch.cat([g.reshape(-1) for g in gs])
        summed = _ProcessSum.apply(flat, ctx.procs)
        sizes = [g.numel() for g in gs]
        return (None, *(s.reshape(shape) for s, shape in zip(
            summed.split(sizes), ctx.shapes)))

    @staticmethod
    def jvp(ctx, _, *ts):
        return tuple(t.clone() for t in ts)

    @staticmethod
    def vmap(info, in_dims, procs, *xs):
        return _Replicate.apply(procs, *xs), tuple(in_dims[1:])


class _Gather(torch.autograd.Function):
    """gather: forward every rank's x concatenated along `dim`; backward
    the cotangent summed over ranks, this rank's part; jvp the gather of
    the tangents."""

    generate_vmap_rule = False

    @staticmethod
    def forward(x, dim, procs):
        return gather_plain(x, dim, procs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.dim, ctx.procs = inputs
        ctx.m = x.shape[ctx.dim]

    @staticmethod
    def backward(ctx, g):
        summed = _ProcessSum.apply(g, ctx.procs)
        return summed.narrow(ctx.dim, ctx.procs.rank * ctx.m, ctx.m), \
            None, None

    @staticmethod
    def jvp(ctx, x_t, _dim, _procs):
        return _Gather.apply(x_t, ctx.dim, ctx.procs)

    @staticmethod
    def vmap(info, in_dims, x, dim, procs):
        if in_dims[0] is None:
            return _Gather.apply(x, dim, procs), None
        dim = dim % (x.dim() - 1)
        return _Gather.apply(x.movedim(in_dims[0], 0), dim + 1, procs), 0


def process_sum(x, procs: Processes):
    """The sum of every rank's x (same shape on every rank), the same bits
    on every rank, differentiable to any order (module docstring)."""
    return _ProcessSum.apply(x, procs)


def replicate(xs, procs: Processes):
    """The replicated tensors xs (a dict or a sequence) as they enter a
    local computation whose result `process_sum` adds up: equal values,
    with the cotangents of every rank summed backward in one collective
    (module docstring). Entries that are not tensors pass as they
    are."""
    keys = [k for k in (list(xs) if isinstance(xs, dict) else
                        range(len(xs))) if isinstance(xs[k], torch.Tensor)]
    out = dict(xs) if isinstance(xs, dict) else list(xs)
    for k, r in zip(keys, _Replicate.apply(procs, *(xs[k] for k in keys))):
        out[k] = r
    return out


def gather(x, dim: int, procs: Processes):
    """Every rank's x (same shape on every rank) concatenated along `dim`
    in rank order, differentiable to any order (module docstring)."""
    return _Gather.apply(x, dim, procs)
