"""Production training launcher (mirrors :mod:`repro.launch.train`).

    torchrun --nproc-per-node N -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 1000 --ckpt-dir /ckpt/run1 [--data-parallel D --model-parallel M] \\
        [--grad-compress] [--elastic]
    python -m repro_torch.launch.train --smoke --device cpu

One process a rank.  Under ``torchrun`` the group comes from its
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``);
without it a one-rank group is made on a ``FileStore`` in a temporary
directory, so the reference's mesh exists on one device as well, (1, 1).
The backend is NCCL on the card (each rank on ``cuda:<local rank>``) and
gloo on ``--device cpu``.  Features exercised:
  * a ``("data", "model")`` DeviceMesh and logical-axis sharded params and
    optimizer state as DTensors (ZeRO-1 moments), batches sharded over
    ``("batch", None)``, the step run under the mesh's axis rules — so
    ``moe_ffn`` takes its expert-parallel path, as the reference's does,
  * microbatch accumulation + remat (per-arch accumulation from
    ``configs.cells.LM_ACCUM``; the config's remat policy),
  * checkpoint/auto-resume (``repro_torch.train.loop``), async saves;
    rank 0 writes, every rank restores onto its mesh,
  * elastic restart: ``--elastic`` re-plans the mesh from the live rank
    count (``ckpt.elastic.plan_elastic_mesh``) and the restored checkpoint
    is resharded onto it,
  * ``--grad-compress`` is accepted, as the reference accepts it; the
    compressed all-reduce works over a ``pod`` axis, which this
    ``("data", "model")`` mesh lacks, so it is not engaged (a line says so).

Only global rank 0 prints.  Runs on the card unless ``--device cpu`` is
given.  Ranks outside the mesh (more ranks than ``data·model``) return None
at once.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import os
import shutil
import tempfile
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS
from repro_torch.configs.cells import LM_ACCUM, OPT_CFG, zero1_opt_specs
from repro_torch.data.tokens import MarkovTokenStream
from repro_torch.launch.sharding import P
from repro_torch.train.loop import TrainLoopConfig, run_training
from repro_torch.train.state import TrainState, init_state, make_train_step


@contextlib.contextmanager
def process_group(backend: str):
    """The default group: the one already initialized, else ``torchrun``'s
    (``WORLD_SIZE`` set), else a one-rank group on a ``FileStore`` in a
    temporary directory.  A group made here is destroyed on exit."""
    if dist.is_initialized():
        yield
        return
    tmp = None
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, timeout=datetime.timedelta(seconds=600))
    else:
        tmp = tempfile.mkdtemp(prefix="repro_torch_pg_")
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def build_mesh(n_dev: int, data_parallel: int, model_parallel: int, elastic: bool,
               device_type: str):
    """The reference's mesh choice: ``plan_elastic_mesh`` with ``elastic``,
    else ``(data_parallel or n_dev // model_parallel, model_parallel)``
    over the first ranks; a grid larger than the group raises, as the
    reference's reshape of its devices does."""
    from repro_torch.ckpt.elastic import plan_elastic_mesh
    from torch.distributed.device_mesh import DeviceMesh

    mp = model_parallel
    if mp < 1 or data_parallel < 0:
        raise SystemExit(f"--model-parallel {mp} / --data-parallel {data_parallel}: "
                         "need model ≥ 1 and data ≥ 0")
    if elastic:
        return plan_elastic_mesh(n_dev, mp, device_type=device_type)
    dp = data_parallel or n_dev // mp
    if dp < 1 or dp * mp > n_dev:
        raise SystemExit(f"cannot lay {n_dev} ranks out as a (data {dp}, model {mp}) mesh")
    ranks = torch.arange(dp * mp).reshape(dp, mp)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "model"))


def _local_metrics(step):
    """``step`` with its metrics made whole on every rank (the loss of a
    data-sharded batch is a partial sum until reduced)."""
    from torch.distributed.tensor import DTensor

    def run(state, batch):
        state, metrics = step(state, batch)
        return state, {k: v.full_tensor() if isinstance(v, DTensor) else v
                       for k, v in metrics.items()}

    return run


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data-parallel", type=int, default=0, help="0 = auto")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--elastic", action="store_true",
                    help="re-plan mesh from live device count (restart path)")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda unless cpu is asked for)")
    return ap.parse_args(argv)


def main(argv=None):
    """Parse ``argv``, train, and return the final state — each leaf this
    rank's local shard, the whole tensor on a one-rank mesh — or None on a
    rank outside the mesh."""
    args = parse_args(argv)
    from repro_torch._device import resolve_device

    resolve_device(args.device)  # no card and no --device cpu: raise before any group
    if ARCHS[args.arch].family != "lm":
        raise SystemExit("train.py drives the LM family; see examples/ for others")
    with process_group(backend_of(args)):
        run = prepare(args)
        if run is None:
            return None  # a rank the mesh left out
        from torch.distributed.tensor import DTensor

        from repro_torch import _tree

        with run.context():
            state = run_training(_local_metrics(run.step), run.state, run.batches,
                                 TrainLoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                                                 ckpt_every=max(args.steps // 5, 1)),
                                 log=run.log)
        return _tree.map(lambda x: x.to_local() if isinstance(x, DTensor) else x, state)


def backend_of(args) -> str:
    """NCCL on the card, gloo on the CPU."""
    return "nccl" if torch.device(args.device).type == "cuda" else "gloo"


@dataclasses.dataclass
class Run:
    """What a rank trains with: the mesh and its rules, the distributed
    state, the step, the batch of step ``i`` (``batches(i)``), the config
    and rank 0's printer.  Model code runs under :meth:`context`."""

    mesh: Any
    rules: dict
    cfg: Any
    state: TrainState
    step: Any
    batches: Any
    log: Any

    def context(self):
        from torch.distributed.tensor.experimental import implicit_replication

        from repro_torch.launch import sharding as shd

        stack = contextlib.ExitStack()
        stack.enter_context(shd.axis_rules(self.rules, self.mesh))
        stack.enter_context(implicit_replication())
        return stack


def prepare(args) -> Optional[Run]:
    """The mesh, the state distributed on it and the step, in an
    initialized group (printing the launcher's first lines); None on a rank
    the mesh leaves out."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch._device import cpu_generator, resolve_device
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import mesh_shape, rules_for_mesh
    from repro_torch.models import transformer as tfm

    dev = resolve_device(None if args.device == "cuda" else args.device)
    arch = ARCHS[args.arch]
    cfg = arch.smoke_config if args.smoke else arch.config
    device_type = "cuda" if backend_of(args) == "nccl" else "cpu"
    mesh = build_mesh(dist.get_world_size(), args.data_parallel, args.model_parallel,
                      args.elastic, device_type)
    if mesh.get_coordinate() is None:
        return None
    rules = rules_for_mesh(mesh)
    log = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    log(f"mesh {mesh_shape(mesh)}  arch {cfg.name}  params ~{cfg.param_count()/1e6:.0f}M")
    if args.grad_compress:
        log("[grad-compress] the (data, model) mesh has no pod axis: the compressed "
            "all-reduce is not engaged")

    params = tfm.init_params(cfg, cpu_generator(0), device=dev)
    pspec = shd.to_partition_specs(tfm.logical_specs(cfg), rules)
    ospec = zero1_opt_specs(pspec, params, rules)
    sspec = TrainState(params=pspec, opt={"m": ospec, "v": ospec, "step": P()}, step=P())
    state = shd.distribute_tree(init_state(params), sspec, mesh)
    del params
    accum = LM_ACCUM.get(cfg.name, 1) if not args.smoke else 1
    step = make_train_step(lambda p, b: tfm.train_loss(p, b, cfg), OPT_CFG,
                           accum_steps=accum)

    stream = MarkovTokenStream(cfg.vocab, seed=0)
    bspec = shd.placements(shd.resolve(("batch", None), rules), mesh, 2)

    def batches(i):
        stream._step = i
        b = stream.next_batch(args.batch, args.seq)
        return {k: distribute_tensor(torch.from_numpy(v).to(dev), mesh, bspec)
                for k, v in b.items()}

    return Run(mesh=mesh, rules=rules, cfg=cfg, state=state, step=step, batches=batches,
               log=log)


if __name__ == "__main__":
    main()
