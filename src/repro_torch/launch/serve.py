"""Serving launcher: batched spectral-clustering jobs, online OOS labels and
LM decode (mirrors :mod:`repro.launch.serve`).

    python -m repro_torch.launch.serve --mode cluster --n 20000 --clusters 64
    python -m repro_torch.launch.serve --mode serve --n 4000 --clusters 8 \\
        --requests 64 --registry-dir /tmp/reg
    python -m repro_torch.launch.serve --mode decode --arch qwen3-0.6b --smoke
    python -m repro_torch.launch.serve --mode serve --device cpu ...

``cluster`` mode accepts graphs and returns labels; ``serve`` mode trains one
index and answers point queries by out-of-sample extension through the
micro-batcher — no eigensolve per request; ``decode`` mode runs the LM
decode path of the model zoo: a prompt prefilled into a KV cache, then
greedy decode steps against it.  All run on the card unless ``--device
cpu`` is given.  The exit code is the failure count (clamped below 126;
decode mode has no requests and exits 0).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import sys
import time

import numpy as np
import torch


def _json_safe(o):
    # strict-JSON logs: a NaN residual in a stage report must not produce a
    # line downstream parsers reject
    if isinstance(o, float) and not math.isfinite(o):
        return str(o)
    if isinstance(o, dict):
        return {k: _json_safe(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_json_safe(v) for v in o]
    return o


def _failure_log():
    """(fail, count): ``fail(req, stage, error, **extra)`` logs one
    structured JSON error line to stderr and counts it."""
    count = [0]

    def fail(req, stage, error, **extra):
        count[0] += 1
        print(json.dumps(_json_safe({"event": "request_error", "req": req, "stage": stage,
                                     "error": error, **extra})),
              file=sys.stderr, flush=True)

    return fail, count


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_cluster(args) -> int:
    """Request loop with per-request fault isolation; returns the failure
    count.  Per request: the pipeline's own guards and ladders (PyTorch
    runs eagerly, so they are always live; ``--strict`` also makes an
    unconverged embed raise), then :func:`repro_torch.core.health
    .result_problems` on the outputs, then ``--deadline-s``.
    ``--inject-fault nan-graph`` poisons every odd request's edge weights."""
    from repro_torch.core import health
    from repro_torch.core.health import PipelineError
    from repro_torch.core.spectral import EigConfig, SpectralPipeline
    from repro_torch.data.sbm import sbm_graph

    dev = torch.device(args.device)
    pipe = SpectralPipeline(n_clusters=args.clusters, eig=EigConfig(strict=args.strict))
    print(f"[config] {pipe.to_dict()}")  # the reproducibility record
    fail, failures = _failure_log()
    for req in range(args.requests):
        coo, _ = sbm_graph(args.n // args.clusters, args.clusters, 0.2, 0.01, seed=req,
                           device=dev)
        if args.inject_fault == "nan-graph" and req % 2 == 1:
            from repro_torch.testing.faults import poison_graph

            coo = poison_graph(coo)
        t0 = time.perf_counter()
        try:
            out = pipe.run(coo, torch.Generator().manual_seed(req), device=dev)
            _sync(dev)
            latency = time.perf_counter() - t0
            problems = health.result_problems(out)
            if problems:
                fail(req, "post_hoc", "; ".join(problems),
                     reports=health.reports_to_dict(out.reports))
                continue
            if args.deadline_s is not None and latency > args.deadline_s:
                fail(req, "deadline", f"latency {latency:.3f}s exceeds "
                                      f"--deadline-s {args.deadline_s}", latency_s=latency)
                continue
            print(f"[req {req}] n={coo.shape[0]} k={args.clusters} latency={latency:.3f}s "
                  f"restarts={int(out.lanczos_restarts)} reports="
                  f"{json.dumps(_json_safe(health.reports_to_dict(out.reports)))}")
            if args.recluster_k:
                # embed once, serve many k — Stage 3 reruns on the cached
                # embedding, Lanczos does not
                t0 = time.perf_counter()
                emb = pipe.embed(pipe.prepare(coo, device=dev),
                                 torch.Generator().manual_seed(req), device=dev)
                _sync(dev)
                t_embed = time.perf_counter() - t0
                for k2 in args.recluster_k:
                    t0 = time.perf_counter()
                    pipe.cluster(emb, torch.Generator().manual_seed(1000 + req),
                                 n_clusters=k2, device=dev)
                    _sync(dev)
                    print(f"[req {req}]   re-cluster k={k2}: {time.perf_counter() - t0:.3f}s "
                          f"on the cached embedding (embed once: {t_embed:.3f}s)")
        except PipelineError as e:
            fail(req, e.stage, e.detail, ladder=list(e.ladder), remedy=e.remedy)
        except Exception as e:  # isolation: a request must not kill the loop
            fail(req, "unknown", repr(e))
    print(json.dumps({"event": "serve_summary", "requests": args.requests,
                      "failures": failures[0]}), flush=True)
    return failures[0]


def serve_online(args) -> int:
    """Online point labelling: train once (the full pipeline on a blob pool),
    build a :class:`~repro_torch.serve.oos.ServingIndex`, optionally publish
    it through the registry, then drive query requests through the
    :class:`~repro_torch.serve.batcher.MicroBatcher` into
    :func:`~repro_torch.serve.oos.serve_fn`.  Served embeddings feed the
    mini-batch k-means stream; when centroid drift crosses the threshold a
    refreshed index is published (health-gated) and swapped into the
    batcher.  Per-request fault isolation (a poisoned request fails through
    :func:`~repro_torch.core.health.numeric_problems` on its rows),
    ``--deadline-s``, and the failure count as the return value.
    ``--inject-fault nan-query`` poisons every odd request."""
    from repro_torch.core.health import numeric_problems
    from repro_torch.core.spectral import SpectralPipeline
    from repro_torch.serve import (BatchConfig, EmbeddingRegistry, MicroBatcher, OOSConfig,
                                   RegistryGateError, adjusted_rand_index, build_index,
                                   needs_refresh, rebase, serve_fn, stream_from_index,
                                   stream_update)

    dev = torch.device(args.device)
    rng = np.random.default_rng(0)
    k, d = args.clusters, args.dim
    centers = rng.normal(size=(k, d)) * 8.0
    pool = np.concatenate([centers[i] + rng.normal(size=(args.n // k, d))
                           for i in range(k)]).astype(np.float32)

    pipe = SpectralPipeline(n_clusters=k)
    print(f"[config] {pipe.to_dict()}")
    t0 = time.perf_counter()
    result = pipe.run(pool, torch.Generator().manual_seed(0), device=dev)
    _sync(dev)
    train_s = time.perf_counter() - t0
    n_train = int(result.labels.shape[0])
    print(f"[train] full pipeline on n={n_train}: {train_s:.2f}s")

    oos_cfg = OOSConfig.from_graph_config(pipe.graph, method=args.oos_method)
    index = build_index(pool, result, config=oos_cfg, device=dev)
    registry = None
    if args.registry_dir:
        registry = EmbeddingRegistry(args.registry_dir)
        v = registry.publish(index)
        print(json.dumps({"event": "index_published", "version": v}))

    stream = stream_from_index(index)
    fail, failures = _failure_log()
    latencies = []
    with MicroBatcher(functools.partial(serve_fn, index), d,
                      BatchConfig(batch_size=args.batch_size,
                                  max_wait_s=args.max_wait_ms / 1e3), device=dev) as mb:
        for req in range(args.requests):
            tru = rng.integers(k)
            q = (centers[tru] + rng.normal(size=(args.rows_per_request, d))).astype(np.float32)
            if args.inject_fault == "nan-query" and req % 2 == 1:
                q[0, 0] = np.nan
            t0 = time.perf_counter()
            try:
                out = mb.label(q, timeout=30.0)
            except Exception as e:  # isolation: this request only
                fail(req, "serve_fn", repr(e))
                continue
            latency = time.perf_counter() - t0
            problems = numeric_problems({"embedding": out.embedding, "dist2": out.dist2},
                                        context=f"req {req}")
            if problems:
                fail(req, "post_hoc", "; ".join(problems))
                continue
            if args.deadline_s is not None and latency > args.deadline_s:
                fail(req, "deadline", f"latency {latency:.3f}s exceeds {args.deadline_s}")
                continue
            latencies.append(latency)
            stream, _ = stream_update(stream, torch.from_numpy(out.embedding))
            if bool(needs_refresh(stream)):
                # drift: publish the refreshed centroids as a new version and
                # swap it into the batcher; the pool is unchanged, so the
                # persisted LSH tables stay valid
                new_index = dataclasses.replace(index, centroids=stream.centroids)
                if registry is not None:
                    try:
                        v = registry.publish(new_index)
                        print(json.dumps({"event": "drift_refresh", "req": req,
                                          "version": v}))
                    except RegistryGateError as e:
                        fail(req, "refresh_gate", str(e))
                        continue
                index = new_index
                mb.set_fn(functools.partial(serve_fn, index))
                stream = rebase(stream)
        stats = mb.stats
    lat = np.sort(np.asarray(latencies)) if latencies else np.zeros(1)
    # diagnostic: re-serve the head of the pool — labels should reproduce the
    # training clustering (the held-out gate is chip_smoke.py's serve phase)
    head = min(n_train, 2048)
    pool_out = serve_fn(index, pool[:head])
    summary = {
        "event": "serve_summary", "requests": args.requests,
        "failures": failures[0], "batches": stats.batches,
        "fill": round(stats.fill, 3),
        "p50_ms": round(float(lat[len(lat) // 2]) * 1e3, 2),
        "p99_ms": round(float(lat[min(int(len(lat) * 0.99), len(lat) - 1)]) * 1e3, 2),
        "train_ari_vs_served": round(adjusted_rand_index(pool_out.labels,
                                                         result.labels[:head]), 4),
    }
    print(json.dumps(summary), flush=True)
    return failures[0]


@dataclasses.dataclass
class Decoded:
    """One greedy decode: the prefill's last-position logits [B, V], every
    step's token [B, steps] and logits [steps, B, V] (V the padded vocab),
    and the prefill's and the decode loop's seconds (host clock, each ended
    by a device synchronisation)."""

    prefill_logits: torch.Tensor
    tokens: torch.Tensor
    logits: torch.Tensor
    prefill_s: float
    decode_s: float


def decode_loop(params, cache, cache_len, token, cfg, steps: int):
    """``steps`` greedy decode steps from ``token`` [B] at ``cache_len`` [B]:
    (each step's token, each step's logits [B, V]).  The cache is updated in
    place; nothing is read back to the host."""
    from repro_torch.models import transformer as tfm

    tokens, logits_seen = [], []
    for _ in range(steps):
        logits, cache = tfm.decode_step(params, cache, cache_len, token, cfg)
        token = logits[:, 0].argmax(-1)
        cache_len = cache_len + 1
        tokens.append(token)
        logits_seen.append(logits[:, 0])
    return tokens, logits_seen


def prefill_cache(params, prompt: torch.Tensor, cfg, max_len: int):
    """Prefill ``prompt`` [B, P] and pad its KV cache to ``max_len`` slots:
    (last-position logits [B, V], cache, cache_len [B] = P)."""
    import torch.nn.functional as F

    from repro_torch.models import transformer as tfm

    B, P = prompt.shape
    logits, cache = tfm.prefill(params, prompt, cfg)
    cache = {k: F.pad(v, (0, 0, 0, 0, 0, max_len - P)) for k, v in cache.items()}
    return logits[:, -1], cache, torch.full((B,), P, dtype=torch.int64, device=prompt.device)


def greedy_decode(params, prompt: torch.Tensor, cfg, max_len: int, steps: int) -> Decoded:
    """Prefill ``prompt`` [B, P] into a cache of ``max_len`` slots, decode
    ``steps`` tokens greedily.  Raises when the cache has no room for them
    (the reference drops the writes past its end)."""
    P = prompt.shape[1]
    if P + steps > max_len:
        raise ValueError(f"a {P}-token prompt and {steps} decode steps need {P + steps} "
                         f"cache slots, the cache has {max_len}")
    dev = prompt.device
    t0 = time.perf_counter()
    logits, cache, cache_len = prefill_cache(params, prompt, cfg, max_len)
    token = logits.argmax(-1)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tokens, step_logits = decode_loop(params, cache, cache_len, token, cfg, steps)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return Decoded(prefill_logits=logits, tokens=torch.stack(tokens, 1),
                   logits=torch.stack(step_logits), prefill_s=prefill_s, decode_s=decode_s)


def decode_inputs(cfg, batch: int, prompt_len: int, dev):
    """The launcher's parameters (seed 0) and prompt [batch, prompt_len]
    (seed 1), drawn on ``dev`` from the counter-based stream."""
    from repro_torch import _random
    from repro_torch._device import cpu_generator
    from repro_torch.models import transformer as tfm

    params = tfm.init_params(cfg, cpu_generator(0), device=dev)
    prompt = _random.Stream.from_generator(cpu_generator(1)).integers(
        (batch, prompt_len), cfg.vocab, dev)
    return params, prompt


def serve_decode(args) -> int:
    """LM decode: ``--arch``'s config (``--smoke``: its reduced config) with
    random weights, a prompt of ``--seq // 2`` tokens prefilled into a cache
    of ``--seq`` slots, ``--tokens`` greedy steps timed; prints the
    reference's line.  Returns 0."""
    from repro_torch.configs import ARCHS

    arch = ARCHS[args.arch]
    cfg = arch.smoke_config if args.smoke else arch.config
    B, S = args.batch, args.seq
    params, prompt = decode_inputs(cfg, B, S // 2, torch.device(args.device))
    out = greedy_decode(params, prompt, cfg, S, args.tokens)
    print(f"decoded {args.tokens} tokens x batch {B}: "
          f"{args.tokens * B / out.decode_s:.1f} tok/s "
          f"({out.decode_s / args.tokens * 1e3:.1f} ms/step)", flush=True)
    return 0


def main(argv=None) -> int:
    """Parse ``argv`` and run the mode; returns the process exit code (the
    failure count, clamped below the shell's reserved range)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["cluster", "serve", "decode"], default="cluster")
    ap.add_argument("--device", default="cuda",
                    help="torch device the modes run on (cuda unless cpu is asked for)")
    ap.add_argument("--n", type=int, default=8000)
    ap.add_argument("--clusters", type=int, default=16)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--dim", type=int, default=16, help="serve mode: point dimensionality")
    ap.add_argument("--oos-method", choices=["exact", "lsh"], default="exact",
                    help="serve mode: out-of-sample neighbour search")
    ap.add_argument("--batch-size", type=int, default=64,
                    help="serve mode: static rows of a served batch")
    ap.add_argument("--max-wait-ms", type=float, default=10.0,
                    help="serve mode: micro-batcher max-wait flush")
    ap.add_argument("--rows-per-request", type=int, default=4)
    ap.add_argument("--registry-dir", default=None,
                    help="serve mode: publish versioned index snapshots here")
    ap.add_argument("--recluster-k", type=int, nargs="*", default=None,
                    help="extra cluster counts served from the cached embedding "
                         "(Stage 3 only, no second eigensolve)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request wall budget; slower requests count as failures")
    ap.add_argument("--strict", action="store_true",
                    help="cluster mode: EigConfig(strict=True) — unconverged embeds raise")
    ap.add_argument("--inject-fault", choices=["none", "nan-graph", "nan-query"],
                    default="none",
                    help="poison every odd request (nan-graph: cluster mode; nan-query: "
                         "serve mode) — fault-isolation smoke: the loop must survive, "
                         "the exit code counts them")
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=16)
    args = ap.parse_args(argv)
    from repro_torch._device import resolve_device

    args.device = str(resolve_device(args.device))
    run = {"cluster": serve_cluster, "serve": serve_online, "decode": serve_decode}[args.mode]
    return min(run(args), 125)


if __name__ == "__main__":
    sys.exit(main())
