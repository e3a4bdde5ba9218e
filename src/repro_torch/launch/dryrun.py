"""Multi-pod dry-run: run every (architecture × shape) cell once, as one
rank of the production mesh, and extract the roofline terms (mirrors
:mod:`repro.launch.dryrun`).

Nothing is computed on any device: the process joins a *fake* process
group of 256 ranks (``--mesh single``, a (16, 16) ``("data", "model")``
mesh) or 512 (``--mesh multi``, (2, 16, 16) with a ``"pod"`` axis) — the
analogue of the reference's fake host devices — as rank 0, distributes
each cell's arguments, ``meta`` tensors (shapes and dtypes, no storage), by
their specs, and runs ``cell.fn`` once under the mesh's axis rules.  A
dispatch mode sees every op the rank runs on its local shards and records:

  flops        of the local matrix products and attention ops
               (``torch.utils.flop_counter``'s formulas, plus the
               matrix-vector and dot products it has none for), of the
               other arithmetic by XLA's convention (a pointwise op one
               a result element, a reduction or a scatter-accumulate one
               an input element; copies none), and of the port's own
               operators by ``_OP_COSTS``; local ops only —
               the DTensor-level op is skipped, or the global op's flops
               would be counted beside the rank's;
  bytes        read and written by the local ops, unfused (each op's inputs
               read once, its outputs written once) — not XLA's post-fusion
               "bytes accessed", an upper bound of it;
  collectives  the output bytes of each collective the rank issues, by kind;
  memory       the local arguments' bytes, and the peak of live local
               storage the ops allocate (views and in-place results
               excluded), split into the outputs and the rest (temp).

Two passes per cell, as in the reference: the memory pass runs the cell as
built; the cost pass runs the reference's cost variants (LM cells at 2 and
4 layers with a linear fit in depth, the GNN cost cell, the spectral
component cells × their trip counts).  The counts of a run are exact for
any variant here (each op is seen), so the variants are kept for parity of
the reports.  An op with no DTensor sharding rule raises, and the cell is
recorded with that error; a failing cell never stops the run, and the exit
code is then 1.

Usage:
    python -m repro_torch.launch.dryrun --cell glm4-9b/train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh single [--out build/dryrun]
    python -m repro_torch.launch.dryrun --all --mesh multi --skip-cost-pass
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils import _pytree as pytree

from repro_torch import _tree
from repro_torch.configs import ARCHS
from repro_torch.launch import roofline as rl
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_production_mesh, mesh_shape, rules_for_mesh

_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d")
_KIND_OF = (("all_gather", "all_gather"), ("allgather", "all_gather"),
            ("reduce_scatter", "reduce_scatter"), ("all_reduce", "all_reduce"),
            ("allreduce", "all_reduce"), ("all_to_all", "all_to_all"),
            ("alltoall", "all_to_all"))
_GB = 2 ** 30


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _kmeans_iter_cost(x, c, x_norm, block_q, *, out):
    """B2 (``repro_torch::kmeans_iter``, one fused Lloyd iteration): the
    2·n·k·d flops of its distance tile and the n·(d+1) adds of its epilogue
    (each row and a one into its cluster's [d+1] sums and count); it reads x
    and c once and writes labels, dmin, sums and counts (one [k, d+1]
    block)."""
    n, d = x.shape
    return (2.0 * n * c.shape[0] * d + n * (d + 1),
            _nbytes(x) + _nbytes(c) + sum(_nbytes(t) for t in out))


# the port's own operators, which no flop formula of torch's covers:
# (flops, bytes) of one call
_OP_COSTS = {"repro_torch::kmeans_iter": _kmeans_iter_cost}

# products torch's flop counter has no formula for: flops from the args
_VECTOR_PRODUCTS = {
    "aten::mv": lambda a, v, *_, **__: 2.0 * a.shape[0] * a.shape[1],
    "aten::addmv": lambda b, a, v, *_, **__: 2.0 * a.shape[0] * a.shape[1],
    "aten::dot": lambda a, b, *_, **__: 2.0 * a.numel(),
    "aten::vdot": lambda a, b, *_, **__: 2.0 * a.numel(),
}
# scatter-accumulates (self, dim, index, source, ...): one flop a source element
_ACCUMULATES = {"aten::index_add", "aten::index_add_", "aten::scatter_add",
                "aten::scatter_add_", "aten::scatter_reduce", "aten::scatter_reduce_"}


def _arithmetic_flops(func, args, outs) -> float:
    """Flops of an op with no matrix formula, by XLA's convention."""
    name = func._schema.name
    if name in _VECTOR_PRODUCTS:
        return _VECTOR_PRODUCTS[name](*args)
    if name in _ACCUMULATES:
        return float(args[3].numel())
    if name == "aten::clone":  # a copy
        return 0.0
    if torch.Tag.pointwise in func.tags:
        return float(sum(t.numel() for t in outs))
    if torch.Tag.reduction in func.tags and isinstance(args[0], torch.Tensor):
        return float(args[0].numel())
    return 0.0


class RankCounter(TorchDispatchMode):
    """Counts one rank's local work (see the module docstring).

    A DTensor op's local computation runs in DTensor's C++ dispatch, out of
    this mode's sight, and so do the collectives of the redistribution it
    implies.  So for a DTensor op the mode asks DTensor's sharding
    propagator for the input layouts the op will use, redistributes the
    arguments to them itself — its collectives and copies then run as
    plain-tensor ops, which the mode sees — and counts the local op from
    the local shards' shapes."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = []  # (kind, output bytes)
        self.live = 0
        self.peak = 0
        self.ops = collections.Counter()  # local ops run, by name

    def _release(self, n: int) -> None:
        self.live -= n

    def _hold(self, t, n: int) -> None:
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._release, n)

    def _count(self, func, args, kwargs, out, results) -> None:
        """Count the local op ``func`` on ``args`` (plain tensors: the local
        shards) giving ``out``; ``results`` are the tensors holding its new
        storage (``out``'s, or the DTensors wrapping them)."""
        packet = func.overloadpacket
        self.ops[str(func)] += 1
        outs = [t for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
        own = _OP_COSTS.get(func._schema.name)
        if own is not None:
            flops, nbytes = own(*args, **kwargs, out=outs)
            self.flops += flops
            self.bytes += nbytes
        else:
            if packet in self._flop_registry:
                self.flops += float(self._flop_registry[packet](*args, **kwargs, out_val=out))
            else:
                self.flops += _arithmetic_flops(func, args, outs)
            if any(r.alias_info is not None for r in func._schema.returns):
                return  # a view or an in-place op: no new storage
            ins = [t for t in pytree.tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        for holder, t in zip(results, outs):
            self._hold(holder, _nbytes(t))

    def _redistributed(self, func, args, kwargs):
        """``args``/``kwargs`` with each DTensor moved to the layout the op
        will compute in (DTensor's own choice), under this mode."""
        from torch.distributed.tensor import DTensor, Replicate

        disp = DTensor._op_dispatcher
        info = disp.unwrap_to_op_info(func, args, kwargs)
        disp.sharding_propagator.propagate(info)
        osh = info.output_sharding
        if osh is None or not osh.needs_redistribute:
            return args, kwargs
        schema = osh.redistribute_schema
        leaves, spec = pytree.tree_flatten((args, kwargs))
        want = pytree.tree_leaves((tuple(schema.args_schema), dict(schema.kwargs_schema)))
        if len(want) != len(leaves):
            raise RuntimeError(f"{func}: the redistribution schema does not match its args")
        new = []
        with self:
            for a, w in zip(leaves, want):
                if type(a) is torch.Tensor and hasattr(w, "placements"):
                    # a plain tensor stands for a replicated one (implicit
                    # replication): make that explicit, so its shard counts
                    a = DTensor.from_local(a, w.mesh, [Replicate()] * w.mesh.ndim,
                                           run_check=False)
                if isinstance(a, DTensor) and hasattr(w, "placements"):
                    # replicated → partial is local (DTensor's own business,
                    # and not a public redistribution): keep those dims
                    tgt = [h if t.is_partial() and h.is_replicate() else t
                           for t, h in zip(w.placements, a.placements)]
                    if tuple(tgt) != tuple(a.placements):
                        a = a.redistribute(a.device_mesh, tgt)
                new.append(a)
        return pytree.tree_unflatten(new, spec)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        leaves = pytree.tree_leaves((args, kwargs))
        if any(isinstance(t, DTensor) for t in leaves):
            args, kwargs = self._redistributed(func, args, kwargs)
            out = func(*args, **kwargs)
            loc = lambda t: t.to_local() if isinstance(t, DTensor) else t  # noqa: E731
            l_args, l_kwargs = pytree.tree_map(loc, (args, kwargs))
            self._count(func, l_args, l_kwargs, pytree.tree_map(loc, out),
                        [t for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)])
            return out
        out = func(*args, **kwargs)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            name = func.__name__.split(".")[0]
            outs = [t for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
            for key, kind in _KIND_OF:
                if key in name:
                    self.coll.append((kind, sum(_nbytes(t) for t in outs)))
                    break
            return out
        self._count(func, args, kwargs, out,
                    [t for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)])
        return out


_REGISTERED = []


def register_strategies() -> None:
    """DTensor sharding strategies for the ops the models use that DTensor
    has none for, or none that every torch release runs (registered once):
    ``scatter_reduce`` (the GNNs' segment max/min) and ``index_add`` (their
    segment sums) run replicated, or sharded alike on a dim they do not
    scatter along; ``detach_`` keeps its input's layout."""
    if _REGISTERED:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.scatter_reduce.two)
    def _scatter_reduce(self, dim, index, src, reduce, include_self=True):
        dim = dim % self.ndim
        out = [([Replicate()], [Replicate(), None, Replicate(), Replicate(), None, None])]
        for d in range(self.ndim):
            if d != dim:
                out.append(([Shard(d)], [Shard(d), None, Shard(d), Shard(d), None, None]))
        return out

    @register_sharding(torch.ops.aten.index_add.default)
    def _index_add(self, dim, index, source):
        dim = dim % self.ndim
        out = [([Replicate()], [Replicate(), None, Replicate(), Replicate()])]
        for d in range(self.ndim):
            if d != dim:
                out.append(([Shard(d)], [Shard(d), None, Replicate(), Shard(d)]))
        return out

    # in place, layout unchanged (a redistribution under autograd dispatches
    # it); torch 2.13 has this strategy, 2.11 has none
    from torch.distributed.tensor import DTensor, Partial

    detach_ = torch.ops.aten.detach_.default
    if detach_ not in DTensor._op_dispatcher.sharding_propagator.op_strategy_funcs:
        @register_sharding(detach_)
        def _detach_(self):
            return [([p], [p]) for p in [Replicate(), Partial()] + [Shard(d) for d in
                                                                    range(self.ndim)]]

    _REGISTERED.append(True)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    total = 0
    for x in _tree.leaves(tree):
        if isinstance(x, DTensor):
            total += _nbytes(x.to_local())
        elif isinstance(x, torch.Tensor):
            total += _nbytes(x)
    return total


def _distribute(args, specs, mesh):
    """Each tensor leaf of ``args`` (meta) distributed by its spec."""
    return tuple(shd.distribute_tree(a, s, mesh) for a, s in zip(args, specs))


def run_and_measure(cell, mesh, rules):
    """Run one cell as rank 0; return (metrics dict, memory dict, seconds)."""
    from torch.distributed.tensor.experimental import implicit_replication

    t0 = time.monotonic()
    with shd.axis_rules(rules, mesh), implicit_replication():
        args = _distribute(cell.args, cell.in_specs, mesh)
        arg_bytes = _local_bytes(args)
        counter = RankCounter()
        with counter:
            out = cell.fn(*args)
        # the outputs' new storage: a result that is an argument (a donated
        # state updated in place, a cache) is counted with the arguments
        arg_ids = {id(x) for x in _tree.leaves(args)}
        out_bytes = _local_bytes([x for x in _tree.leaves(out) if id(x) not in arg_ids])
    dt = time.monotonic() - t0
    temp = max(counter.peak - out_bytes, 0)
    mem = {
        "argument_size_gb": arg_bytes / _GB,
        "output_size_gb": out_bytes / _GB,
        "temp_size_gb": temp / _GB,
        "total_hbm_gb": (arg_bytes + out_bytes + temp) / _GB,
    }
    metrics = {
        "flops": counter.flops,
        "bytes": counter.bytes,
        "coll": {k: float(v) for k, v in rl.collective_bytes(counter.coll).items()},
        "ops": dict(counter.ops.most_common()),
    }
    return metrics, mem, dt


def model_flops_for(arch, shape_name: str) -> float:
    sspec = arch.shapes[shape_name]
    if arch.family == "lm":
        return rl.lm_model_flops(arch.config, shape_name, sspec.dims)
    if arch.family == "spectral":
        return rl.spectral_model_flops(
            sspec.dims, arch.config.fixed_restarts, arch.config.fixed_kmeans_iters
        )
    if arch.family == "recsys":
        return rl.recsys_model_flops(arch.config, shape_name, sspec.dims)
    from repro_torch.configs.cells import gnn_batch_shapes, gnn_shape_config

    cfg = gnn_shape_config(arch, sspec)
    batch, _ = gnn_batch_shapes(arch, sspec, {})
    return rl.gnn_model_flops(arch.name, cfg, sspec.dims,
                              batch.node_feat.shape[0], batch.edge_src.shape[0])


def _fit_linear(m2, m4, L_full):
    """total(L) = const + L·slope from measurements at L=2, 4."""
    out = {}
    for key in ("flops", "bytes"):
        slope = (m4[key] - m2[key]) / 2.0
        const = m2[key] - 2.0 * slope
        out[key] = max(const + L_full * slope, 0.0)
    coll = {}
    for k in m2["coll"]:
        slope = (m4["coll"][k] - m2["coll"][k]) / 2.0
        const = m2["coll"][k] - 2.0 * slope
        coll[k] = max(const + L_full * slope, 0.0)
    out["coll"] = coll
    return out


def join_fake_group(world: int) -> None:
    """Join a fake process group of ``world`` ranks as rank 0 (collectives
    do nothing and return at once)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def run_cell(arch_name: str, shape_name: str, mesh_kind: str,
             variant: str = "gspmd", gather_dtype: str | None = None,
             skip_cost_pass: bool = False, mesh=None) -> dict:
    """One cell's report.  ``mesh`` (a DeviceMesh over the fake group)
    replaces the production mesh of ``mesh_kind`` — how tests run a small
    mesh."""
    from repro_torch.configs.cells import (build_cell, gnn_cost_cell, lm_cost_cells,
                                           spectral_component_cells)

    arch = ARCHS[arch_name]
    register_strategies()
    if mesh is None:
        join_fake_group(512 if mesh_kind == "multi" else 256)
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device_type="cpu")
    rules = rules_for_mesh(mesh)
    gdt = {"bf16": torch.bfloat16, None: None}[gather_dtype]
    kw = {"variant": variant, "gather_dtype": gdt} if arch.family == "spectral" else {}
    cell = build_cell(arch, shape_name, rules, mesh=mesh, **kw)
    n_chips = mesh.size()
    result = {"cell": cell.name, "mesh": mesh_kind, "chips": n_chips,
              "mesh_shape": mesh_shape(mesh)}
    if cell.skip:
        result["skip"] = cell.skip
        print(f"[{cell.name} @ {mesh_kind}] {cell.skip}")
        return result

    # ---- memory pass (the cell as built)
    base, mem, t_mem = run_and_measure(cell, mesh, rules)
    top = ", ".join(f"{n} {name}" for name, n in list(base["ops"].items())[:6])
    print(f"[{cell.name} @ {mesh_kind}] memory pass: {json.dumps(mem)} ({t_mem:.0f}s; "
          f"{sum(base['ops'].values())} ops, most: {top})")
    result["memory_analysis"] = mem
    result["raw_rolled"] = base

    # ---- cost pass
    cost = base
    t_cost = 0.0
    if not skip_cost_pass:
        if arch.family == "lm":
            ms = {}
            for L, ccell in lm_cost_cells(arch, shape_name, rules):
                m, _, dt = run_and_measure(ccell, mesh, rules)
                t_cost += dt
                ms[L] = m
            cost = _fit_linear(ms[2], ms[4], arch.config.n_layers)
            result["cost_fit"] = {str(L): m for L, m in ms.items()}
        elif arch.family == "gnn":
            # the port's layers are a Python loop whatever ``scan_layers``
            # says: a cost cell that would only unroll the scan is the cell
            # as built, so its terms are the memory pass's
            unrolled = arch
            if getattr(arch.config, "scan_layers", False):
                unrolled = dataclasses.replace(
                    arch, config=dataclasses.replace(arch.config, scan_layers=False))
            ccell = gnn_cost_cell(unrolled, shape_name, rules)
            if ccell is not None:
                cost, _, t_cost = run_and_measure(ccell, mesh, rules)
        elif arch.family == "spectral":
            comps = spectral_component_cells(arch, shape_name, rules, mesh=mesh,
                                             variant=variant, gather_dtype=gdt)
            total = {"flops": 0.0, "bytes": 0.0, "coll": {k: 0.0 for k in base["coll"]}}
            detail = {}
            for label, ccell, trips in comps:
                m, _, dt = run_and_measure(ccell, mesh, rules)
                t_cost += dt
                detail[label] = {"per_call": m, "trips": trips}
                total["flops"] += m["flops"] * trips
                total["bytes"] += m["bytes"] * trips
                for k in total["coll"]:
                    total["coll"][k] += m["coll"][k] * trips
            # eigh has no flop formula: add ~10 m^3 analytic, as the reference
            # does — whole, since every rank solves the projected problem itself
            k_ = arch.shapes[shape_name].dims["k"]
            m_ = 2 * k_
            total["flops"] += 10.0 * m_ ** 3 * (arch.config.fixed_restarts + 1)
            cost = total
            result["spectral_components"] = detail

    # structural health gate: a non-finite number means the run is broken,
    # not slow — record it as a cell failure
    from repro_torch.core.health import numeric_problems

    problems = numeric_problems({"memory_analysis": mem, "cost": cost}, context=cell.name)
    if problems:
        raise ValueError("; ".join(problems))

    report = rl.analyze_raw(
        cell.name, mesh_kind, n_chips,
        flops_dev=cost["flops"], bytes_dev=cost["bytes"], coll_by_kind=cost["coll"],
        model_flops_total=model_flops_for(arch, shape_name),
        mem_gb=mem["total_hbm_gb"], compile_s=t_mem + t_cost,
    )
    print(f"[{cell.name} @ {mesh_kind}] roofline: compute={report.compute_s:.4f}s "
          f"memory={report.memory_s:.4f}s collective={report.collective_s:.4f}s "
          f"bottleneck={report.bottleneck} useful_ratio={report.useful_ratio:.3f}")
    result.update(dataclasses.asdict(report))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", help="arch/shape, e.g. glm4-9b/train_4k")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--arch", help="run all shapes of one arch")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--variant", default="gspmd", help="spectral matvec engine")
    ap.add_argument("--gather-dtype", default=None)
    ap.add_argument("--skip-cost-pass", action="store_true",
                    help="memory check only (multi-pod sweep)")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    todo = []
    if args.cell:
        a, s = args.cell.split("/", 1)
        todo.append((a, s))
    elif args.arch:
        todo += [(args.arch, s) for s in ARCHS[args.arch].shapes]
    elif args.all:
        for a in ARCHS.values():
            todo += [(a.name, s) for s in a.shapes]
    else:
        ap.error("one of --cell/--arch/--all required")

    os.makedirs(os.path.join(args.out, args.mesh), exist_ok=True)
    failures = 0
    for arch_name, shape_name in todo:
        tag = f"{arch_name}__{shape_name}"
        if args.variant != "gspmd":
            tag += f"__{args.variant}" + (f"_{args.gather_dtype}" if args.gather_dtype else "")
        path = os.path.join(args.out, args.mesh, tag + ".json")
        try:
            res = run_cell(arch_name, shape_name, args.mesh,
                           variant=args.variant, gather_dtype=args.gather_dtype,
                           skip_cost_pass=args.skip_cost_pass)
        except Exception as e:  # a failing cell is recorded, and the run goes on
            traceback.print_exc()
            res = {"cell": f"{arch_name}/{shape_name}", "mesh": args.mesh,
                   "error": f"{type(e).__name__}: {e}"}
            failures += 1
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
    print(f"dry-run finished: {len(todo) - failures}/{len(todo)} cells OK")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
