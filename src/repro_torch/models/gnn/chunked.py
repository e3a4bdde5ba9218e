"""Constant-memory chunked edge accumulation (mirrors
:mod:`repro.models.gnn.chunked`).

Autograd of a loop ``acc = acc + f(args, x_i)`` would keep every chunk's
working set alive until the backward pass — for a linear accumulation that
is pure waste, and at hundreds of chunks × multi-GB edge tensors it is
what runs the full-graph equivariant cells out of memory.
:func:`sum_over_chunks` declares the linearity with a
``torch.autograd.Function``: the forward accumulates ``Σ f(args, x_i)``
under ``no_grad`` and saves only its inputs; the backward re-runs each
chunk on detached leaves with the *same* output cotangent
(d(Σf)/dargs = Σ df/dargs), accumulating argument cotangents chunk by
chunk.  Peak memory: one chunk's working set + the accumulators,
independent of the chunk count.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch import _tree

Tensor = torch.Tensor


def _differentiable(t) -> bool:
    return isinstance(t, Tensor) and (t.is_floating_point() or t.is_complex())


class _SumOverChunks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, args, xs, out_shape, with_x_grads, args_constrain, n_args, *flat):
        a, x = list(flat[:n_args]), list(flat[n_args:])
        ctx.f, ctx.args, ctx.xs, ctx.n_args = f, args, xs, n_args
        ctx.args_constrain = args_constrain
        ctx.with_x_grads = with_x_grads
        ctx.save_for_backward(*flat)
        acc = torch.zeros(tuple(out_shape.shape), dtype=out_shape.dtype, device=x[0].device)
        targs = _tree.unflatten(args, a)
        for i in range(x[0].shape[0]):
            acc = acc + f(targs, _tree.unflatten(xs, [t[i] for t in x]))
        return acc

    @staticmethod
    def backward(ctx, g):
        flat = ctx.saved_tensors
        a, x = list(flat[:ctx.n_args]), list(flat[ctx.n_args:])
        need = ctx.needs_input_grad[7:]
        need_a = [n and _differentiable(t) for n, t in zip(need[:ctx.n_args], a)]
        need_x = [ctx.with_x_grads and n and _differentiable(t)
                  for n, t in zip(need[ctx.n_args:], x)]
        gargs = _constrained(ctx, [torch.zeros_like(t) if n else None
                                   for t, n in zip(a, need_a)])
        gxs = [[] if n else None for n in need_x]
        for i in range(x[0].shape[0]):
            la = [t.detach().requires_grad_(n) for t, n in zip(a, need_a)]
            lx = [t[i].detach().requires_grad_(n) for t, n in zip(x, need_x)]
            wrt = [t for t, n in zip(la, need_a) if n] + [t for t, n in zip(lx, need_x) if n]
            with torch.enable_grad():
                out = ctx.f(_tree.unflatten(ctx.args, la), _tree.unflatten(ctx.xs, lx))
                grads = list(torch.autograd.grad(out, wrt, grad_outputs=g, allow_unused=True))
            del out
            for j, n in enumerate(need_a):
                if n:
                    gi = grads.pop(0)
                    if gi is not None:
                        gargs[j] += gi
            gargs = _constrained(ctx, gargs)
            for j, n in enumerate(need_x):
                if n:
                    gi = grads.pop(0)
                    gxs[j].append(torch.zeros_like(lx[j]) if gi is None else gi)
        gx = [None if s is None else torch.stack(s) for s in gxs]
        return (None, None, None, None, None, None, None, *gargs, *gx)


def _constrained(ctx, gargs):
    """The accumulated argument cotangents re-annotated by the caller's
    ``args_constrain`` (None where no cotangent is taken)."""
    if ctx.args_constrain is None:
        return gargs
    return _tree.leaves(ctx.args_constrain(_tree.unflatten(ctx.args, gargs)))


def _run(f, args, xs, out_shape, with_x_grads: bool, args_constrain=None) -> Tensor:
    a, x = _tree.leaves(args), _tree.leaves(xs)
    return _SumOverChunks.apply(f, args, xs, out_shape, with_x_grads, args_constrain, len(a),
                                *a, *x)


def sum_over_chunks(f: Callable, args: Any, xs: Any, out_shape,
                    args_constrain: Callable[[Any], Any] | None = None) -> Tensor:
    """Σ_i f(args, x_i) over the leading axis of ``xs`` (trees ok).

    f must be pure; the output's shape and dtype come from ``out_shape``
    (anything with ``.shape`` and ``.dtype``, such as a tensor on the
    ``meta`` device), its device from ``xs``.  ``args_constrain``
    re-annotates the accumulated argument cotangents after each backward
    chunk (on a mesh, it keeps them sharded; with no rules installed it is
    the identity).  The index and geometry inputs ``xs`` get no cotangent.
    """
    return _run(f, args, xs, out_shape, False, args_constrain)


def sum_over_chunks_with_x_grads(f: Callable, args: Any, xs: Any, out_shape) -> Tensor:
    """Variant that also propagates cotangents into the floating ``xs``
    chunks (stacked back to the original layout).  Used when per-edge
    geometry requires gradients (force training); costs one extra ys-sized
    buffer."""
    return _run(f, args, xs, out_shape, True)
