"""Training launcher: a seeded model, the synthetic stream, the train step
and async checkpoints on one device.

  python -m repro_torch.launch.train --arch stablelm-1.6b --fp32 \
      --steps 4 --batch 4 --seq 1024
  python -m repro_torch.launch.train --device cpu --arch stablelm-1.6b-smoke
  python -m repro_torch.launch.train --mesh 2x2 --rules fsdp_tp

Port of ``repro.launch.train``: config registry → train state (random
weights from ``--seed``; bf16 parameters and activations unless
``--fp32``) → the deterministic data pipeline with prefetch → the train
step (microbatch accumulation, optional int8 error feedback, the
optimizer the config names or ``--optimizer``, warmup-cosine) → async
checkpoints every ``--ckpt-every`` steps and at the end, ``--resume``
from the latest → the heartbeat monitor.  It prints the reference's lines
(``step N loss … gnorm … lr … s``, ``done``).

Runs on ``--device cuda`` (the default; attention through K1 forward and
the recompute backward) or ``cpu`` (the plain versions).  ``--attn-impl``
is ``auto`` (K1 on CUDA, the plain version on the CPU), ``cuda``,
``torch`` or ``ref``.  ``--mesh DxM`` trains over a ("data", "model")
mesh whose every position is the run's device (``cuda:0`` repeated on
the card, ``cpu`` with ``--device cpu``) under ``--rules`` ``fsdp_tp``
(the default, as the reference's) or ``tp``: the state is held as its
shards and the step splits the batch over the data shards and the heads,
MLP columns and vocab over the model shards
(:mod:`repro_torch.training.train_step`); ``1x1`` is the unsharded step.
:func:`main` returns the run's metrics: losses, grad norms, learning
rates, step seconds, tokens/s, K1 launches, peak memory, the device, and
the bytes of parameters and of optimizer state each mesh position holds.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, PrefetchIterator, SyntheticSource
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.fault_tolerance import (
    HeartbeatMonitor, RecoveryLog,
)
from repro_torch.kernels.fusemax import fusemax_attention_cuda
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import device_info
from repro_torch.model.layers import Runtime, resolve_device
from repro_torch.optim import make_optimizer, tree_leaves, warmup_cosine
from repro_torch.training.train_step import (
    init_train_state, make_train_step, shard_train_state,
)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="stablelm-1.6b-smoke")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--rules", default="fsdp_tp", choices=("tp", "fsdp_tp"))
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--attn-impl", default="auto",
                    choices=("auto", "cuda", "torch", "ref"))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", action="store_true")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    return ap


def parse_mesh(text: str) -> tuple:
    """``DxM`` → (D, M)."""
    try:
        d, m = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh {text}: expected DxM, e.g. 2x2") from None
    if d < 1 or m < 1:
        raise SystemExit(f"--mesh {text}: sizes must be >= 1")
    return d, m


def build(args, dev=None):
    """(cfg, rt, optimizer, step_fn, mesh, rules) of the parsed flags; the
    mesh's positions all on ``dev`` (default: ``--device``)."""
    cfg = get_config(args.arch)
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    rt = Runtime(attn_impl=args.attn_impl, param_dtype=dtype,
                 activation_dtype=dtype)
    shape = parse_mesh(args.mesh)
    dev = dev or torch.device(args.device)
    mesh = make_mesh(shape, ("data", "model"), [dev] * (shape[0] * shape[1]))
    rules = shd.make_rules(mesh, args.rules)
    opt = make_optimizer(args.optimizer or cfg.default_optimizer)
    lr = warmup_cosine(args.lr, args.warmup, args.steps)
    step_fn = make_train_step(cfg, opt, lr, rt,
                              microbatches=args.microbatches,
                              compression=args.compression, mesh=mesh,
                              rules=rules)
    return cfg, rt, opt, step_fn, mesh, rules


def main(argv: Optional[list] = None) -> dict:
    """Train on ``argv``'s flags and return the run's metrics."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg, rt, opt, step_fn, mesh, rules = build(args, dev)
    monitor = HeartbeatMonitor(n_workers=1)
    log = RecoveryLog()
    state = init_train_state(cfg, args.seed, opt, rt,
                             compression=args.compression, device=dev)
    state = shard_train_state(state, cfg, mesh, rules)

    start_step = 0
    saver = None
    if args.ckpt_dir:
        saver = ckpt.AsyncCheckpointer(args.ckpt_dir)
        if args.resume:
            last = ckpt.latest_step(args.ckpt_dir)
            if last is not None:
                state.load_tree(ckpt.restore(args.ckpt_dir, last,
                                             state.as_tree()))
                start_step = last
                log.record("resume", step=last)
                print(f"resumed from step {last}")

    source = SyntheticSource(DataConfig(
        global_batch=args.batch, seq_len=args.seq, vocab=cfg.vocab,
        seed=args.seed, frontend=cfg.frontend, d_model=cfg.d_model,
        n_mtp=cfg.n_mtp))
    it = PrefetchIterator(source, start_step=start_step)
    k1_before = fusemax_attention_cuda.launches
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    hist = {"loss": [], "grad_norm": [], "lr": [], "step_s": []}
    t_last = time.time()
    try:
        for i in range(start_step, args.steps):
            batch = {k: v.to(dev, non_blocking=True)
                     for k, v in next(it).items()}
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t_last
            t_last = time.time()
            hist["loss"].append(loss)
            hist["grad_norm"].append(float(metrics["grad_norm"]))
            hist["lr"].append(float(metrics["lr"]))
            hist["step_s"].append(dt)
            if (i + 1) % args.log_every == 0:
                monitor.heartbeat(0, dt)
                print(f"step {i + 1:6d} loss {loss:8.4f} "
                      f"gnorm {hist['grad_norm'][-1]:7.3f} "
                      f"lr {hist['lr'][-1]:.2e} {dt:6.2f}s")
            if saver and (i + 1) % args.ckpt_every == 0:
                saver.save_async(i + 1, state.as_tree())
                log.record("checkpoint", step=i + 1)
        if saver:
            saver.save_async(args.steps, state.as_tree())
            saver.wait()
    finally:
        it.close()
    print("done")
    tokens = args.batch * args.seq
    # the first step builds kernels and warms the allocator
    steady = hist["step_s"][1:] or hist["step_s"]
    return {
        "arch": cfg.name, "steps": args.steps, "start_step": start_step,
        "batch": args.batch, "seq": args.seq, "fp32": args.fp32,
        "attn_impl": args.attn_impl,
        "optimizer": args.optimizer or cfg.default_optimizer,
        "losses": hist["loss"], "grad_norms": hist["grad_norm"],
        "lrs": hist["lr"], "step_seconds": hist["step_s"],
        "tokens_per_s": tokens / (sum(steady) / len(steady))
        if steady else None,
        "fusemax_prefill_launches": fusemax_attention_cuda.launches
        - k1_before,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)
        if dev.type == "cuda" else None,
        "recovery_log": log.events, "device": device_info(dev),
        "mesh": args.mesh, "rules": args.rules,
        "position_bytes": position_bytes(state),
    }


def position_bytes(state) -> dict:
    """Per mesh position, the bytes of parameters and of optimizer state
    it holds (one position: the whole state)."""
    if hasattr(state, "position_bytes"):
        return state.position_bytes()
    size = lambda t: t.numel() * t.element_size()
    opt = [t for t in tree_leaves(state.opt_state) if t.ndim]
    return {"params": [sum(size(p) for p in state.params.values())],
            "opt_state": [sum(size(t) for t in opt)]}


if __name__ == "__main__":
    main()
