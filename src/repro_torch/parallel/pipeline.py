"""Pipeline parallelism: the GPipe microbatch schedule over the ranks of a
process group (the JAX package's ``parallel/pipeline.py``).

Off every path, as in the JAX package: the depth-parallel option for
models whose layers do not fit one stage.  Rank ``s`` of ``group`` is
stage ``s``.  Schedule: ``n_micro + n_stages - 1`` ticks; at tick ``t``
stage ``s`` runs microbatch ``t - s`` (a stage idles in its bubbles, where
the JAX package computes a discarded value).  Activations move one stage
forward with ``send``/``recv``, the last stage's outputs go to every rank
(JAX's ``psum`` over the stage axis), and ``autograd.Function``s around
the point-to-point ops carry the gradients back through the schedule.
"""

from __future__ import annotations

from typing import Callable, List

import torch
import torch.distributed as dist

from repro_torch import tree


class _Ledger:
    """One pipelined call's group and its sends still in flight."""

    def __init__(self, group, n_micro: int):
        self.group = group
        self.n_micro = n_micro
        self.pending: List = []        # (work, tensor kept alive until sent)

    def peer(self, stage: int) -> int:
        """The global rank of stage ``stage``."""
        return (stage if self.group is None
                else dist.get_global_rank(self.group, stage))

    def isend(self, t: torch.Tensor, stage: int, tag: int) -> None:
        t = t.contiguous()
        self.pending.append((dist.isend(t, self.peer(stage), self.group,
                                        tag), t))

    def recv(self, like: torch.Tensor, stage: int, tag: int) -> torch.Tensor:
        buf = torch.empty_like(like, memory_format=torch.contiguous_format)
        dist.recv(buf, self.peer(stage), self.group, tag)
        return buf

    def wait(self) -> None:
        for work, _ in self.pending:
            work.wait()
        self.pending.clear()

    def back_tag(self, m: int) -> int:
        """Gradients travel on tags of their own: the backward's order of
        microbatches need not be the forward's."""
        return self.n_micro + m


class _Start(torch.autograd.Function):
    """The token every ``_Recv`` hangs from: its backward runs after all
    theirs, and waits for the gradients they sent."""

    @staticmethod
    def forward(ctx, ledger, anchor):
        ctx.ledger = ledger
        return anchor.detach().clone()

    @staticmethod
    def backward(ctx, g):
        ctx.ledger.wait()
        return None, g


class _Send(torch.autograd.Function):
    """Send microbatch ``m``'s activation to stage ``dst``; the output is a
    token whose backward receives the activation's gradient from ``dst``."""

    @staticmethod
    def forward(ctx, ledger, x, dst, m):
        ctx.ledger, ctx.dst, ctx.m, ctx.like = ledger, dst, m, x.detach()
        ledger.isend(x.detach(), dst, m)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        g = ctx.ledger.recv(ctx.like, ctx.dst, ctx.ledger.back_tag(ctx.m))
        return None, g, None, None


class _Recv(torch.autograd.Function):
    """Receive microbatch ``m``'s activation from stage ``src``; the
    backward sends its gradient back."""

    @staticmethod
    def forward(ctx, ledger, token, like, src, m):
        ctx.ledger, ctx.src, ctx.m, ctx.dev = ledger, src, m, token.device
        return ledger.recv(like, src, m)

    @staticmethod
    def backward(ctx, g):
        ctx.ledger.isend(g, ctx.src, ctx.ledger.back_tag(ctx.m))
        return None, torch.zeros((), device=ctx.dev), None, None, None


class _Broadcast(torch.autograd.Function):
    """The last stage's outputs to every rank.  The output is replicated:
    every rank computes the same loss from it, and the backward takes the
    last stage's own gradient of that loss (a JAX ``shard_map`` output
    with a replicated spec, differentiated once).  The other ranks' tokens
    get a zero gradient, which starts their sends' backwards."""

    @staticmethod
    def forward(ctx, ledger, src, y, *tokens):
        ctx.ledger, ctx.src, ctx.n_tokens = ledger, src, len(tokens)
        out = y.detach().clone()
        dist.broadcast(out, ledger.peer(src), ledger.group)
        return out

    @staticmethod
    def backward(ctx, g):
        mine = dist.get_rank(ctx.ledger.group) == ctx.src
        zeros = (g.new_zeros(()),) * ctx.n_tokens
        return (None, None, g if mine else None) + zeros


def gpipe(stage_fn: Callable, group=None) -> Callable:
    """Build a pipelined apply ``(stage_params, x_micro) -> y_micro`` over
    the ranks of ``group`` (the default group for ``None``).

    ``stage_fn(params, x) -> y`` is one stage's computation, with the
    output shaped as the input.  ``stage_params`` holds leaves with a
    leading stage axis of the group's size (JAX's stacked parameters);
    rank ``s`` reads slice ``s``.  ``x_micro`` is ``(n_micro, mb, ...)``,
    the same on every rank; every rank returns the same ``y_micro``.  Every
    rank must run the backward of a loss of ``y_micro`` (the same loss),
    since the gradients cross ranks.  CUDA stages need an NCCL group:
    gloo's point-to-point ops take CPU tensors only.
    """

    def pipelined(stage_params, x_micro):
        if x_micro.is_cuda and dist.get_backend(group) == "gloo":
            raise ValueError("gloo's send/recv take CPU tensors only: run "
                             "CUDA stages over an NCCL group")
        n_stages = dist.get_world_size(group)
        s = dist.get_rank(group)
        n_micro = x_micro.shape[0]
        ledger = _Ledger(group, n_micro)
        params = tree.map(lambda p: p[s], stage_params)
        anchor = torch.zeros((), device=x_micro.device, requires_grad=True)
        token = _Start.apply(ledger, anchor)
        outs, sent = [None] * n_micro, []
        for t in range(n_micro + n_stages - 1):
            m = t - s
            if not 0 <= m < n_micro:
                continue                      # this stage's bubble
            inp = (x_micro[m] if s == 0 else
                   _Recv.apply(ledger, token, x_micro[0], s - 1, m))
            out = stage_fn(params, inp)
            if s < n_stages - 1:
                sent.append(_Send.apply(ledger, out, s + 1, m))
            else:
                outs[m] = out
        ledger.wait()
        y = (torch.stack(outs) if s == n_stages - 1
             else torch.zeros_like(x_micro))
        return _Broadcast.apply(ledger, n_stages - 1, y, *sent)

    return pipelined


def sequential_reference(stage_fn: Callable, stage_params, x_micro):
    """Oracle: run the stages back to back on each microbatch, without
    pipelining."""
    n_stages = tree.leaves(stage_params)[0].shape[0]
    outs = []
    for x in x_micro:
        for s in range(n_stages):
            x = stage_fn(tree.map(lambda q, s=s: q[s], stage_params), x)
        outs.append(x)
    return torch.stack(outs)
