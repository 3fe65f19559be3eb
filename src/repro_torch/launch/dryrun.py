"""Dry run: every (arch x shape x mesh) cell's per-card memory, FLOPs,
bytes, collectives and roofline on H100 terms — without a tensor.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell on 512 host "devices" and reads XLA's memory and cost analyses; the
port has no compiler to ask, so for each cell it

  * builds the model on the ``meta`` device (:func:`abstract_params`:
    shapes and dtypes, no storage — DeepSeek-V3 in bf16 is 1.3 TB) and
    places it by the cell's rules on the production mesh
    (:func:`repro_torch.launch.mesh.make_production_mesh`: 16 x 16 or
    2 x 16 x 16 H100s on ``meta`` devices);
  * sums per-card memory from the shard shapes: parameters, optimizer
    state, grads and the remat activations of the per-card batch;
  * counts FLOPs with ``torch.utils.flop_counter.FlopCounterMode`` over
    the step on meta tensors (train: the loss and its grads, the remat
    recompute included; prefill; decode), with attention through the
    ``"meta"`` stand-in and counted by formula instead
    (:func:`attention_flops`: the (query, key) pairs the causal and window
    masks leave — chip_smoke's ``bound_ms`` count; on meta the plain
    version would count the full S² and loop over blocks);
  * reckons the bytes a step must move (:func:`hbm_bytes`) and its
    collectives (:mod:`repro_torch.analysis.collectives`), then the
    roofline (:mod:`repro_torch.analysis.roofline`) at the card's peaks.

FLOPs and bytes per card assume an even split over the mesh's cards.

Results land in ``$REPRO_TORCH_DRYRUN_OUT/<mesh>/<arch>__<shape>.json``
(default ``out/torch_dryrun/``; resumable).

  python -m repro_torch.launch.dryrun --list
  python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k \\
      --mesh single
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Any, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.collectives import collective_stats
from repro_torch.analysis.roofline import card_peaks, out_dir, roofline
from repro_torch.configs import ARCHS, SHAPES, cell_applicable, get_config
from repro_torch.configs.shapes import ShapeCell, input_specs
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import axis_spans_hosts, make_production_mesh
from repro_torch.model import transformer as tf
from repro_torch.model.layers import Runtime
from repro_torch.optim import make_optimizer
from repro_torch.optim.common import tree_flatten
from repro_torch.training.train_step import opt_state_axes

#: a card's memory (H100 SXM, 80 GB)
CARD_BYTES = 80e9


# ---------------------------------------------------------------------------
# abstract state (no device allocation, ever)
# ---------------------------------------------------------------------------

def abstract_params(cfg, rt: Runtime, with_mtp: bool = True):
    """(model on ``meta``, its parameters' logical axes): the module tree
    without an init, so no generator draws and nothing is stored.  With
    the MTP head by default, as the reference's ``init`` builds it for
    every cell."""
    model = tf.Model(cfg, dtype=rt.param_dtype, device="meta",
                     with_mtp=with_mtp)
    return model, shd.param_axes(cfg, model)


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype,
                                          device="meta").element_size()


def _shard_bytes(shardings: dict, leaves: dict) -> int:
    """Bytes one position holds of ``leaves`` placed by ``shardings``."""
    return sum(_nbytes(sh.shard_shape(tuple(leaves[k].shape)),
                       leaves[k].dtype) for k, sh in shardings.items())


# ---------------------------------------------------------------------------
# counts
# ---------------------------------------------------------------------------

def _pairs(s: int, window: Optional[int]) -> int:
    """(query, key) pairs of causal attention over ``s`` tokens, within
    ``window`` keys where one is given."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def _head_dims(cfg, absorbed: bool) -> tuple:
    """(E, F) of an attention layer's scores and values."""
    if cfg.mla is None:
        return cfg.dh, cfg.dh
    m = cfg.mla
    if absorbed:
        return m.kv_lora_rank + m.rope_dim, m.kv_lora_rank
    return m.nope_dim + m.rope_dim, m.v_dim


def attention_flops(cfg, kind: str, batch: int, seq: int,
                    window_aware: bool = True) -> float:
    """Attention FLOPs of one step by formula, over every attention layer:
    train / prefill 2·(E + F) per (query, key) pair the causal (and, if
    ``window_aware``, the window) mask leaves, per query head — a train
    step adds the remat forward and the recompute backward's 2·(3E + 2F);
    decode one query per sequence against ``seq`` cached keys (a ring's
    window).  MLA decode attends the absorbed latents."""
    total = 0.0
    for spec in cfg.layer_specs():
        if spec.attn == "none":
            continue
        window = spec.window if window_aware else None
        if kind == "decode":
            e, f = _head_dims(cfg, absorbed=True)
            keys = seq if spec.window is None else min(seq, spec.window)
            total += 2 * (e + f) * cfg.n_heads * batch * keys
            continue
        e, f = _head_dims(cfg, absorbed=False)
        pairs = batch * cfg.n_heads * _pairs(seq, window)
        total += 2 * (e + f) * pairs
        if kind == "train":
            total += 2 * (e + f) * pairs + 2 * (3 * e + 2 * f) * pairs
    return total


def counted_flops(cfg, model, kind: str, specs: dict, rt: Runtime,
                  caches: Optional[list] = None) -> float:
    """FlopCounterMode's FLOPs of the step on meta tensors (attention
    through the ``"meta"`` stand-in, which it does not see)."""
    with FlopCounterMode(display=False) as fc:
        if kind == "train":
            params = [p for p in model.parameters()]
            for p in params:
                p.requires_grad_(True)
            loss, _ = tf.loss_fn(cfg, model, specs, rt)
            torch.autograd.grad(loss, params, allow_unused=True)
        elif kind == "prefill":
            with torch.no_grad():
                tf.prefill(cfg, model, {"inputs": specs["inputs"]}, caches,
                           rt)
        else:
            with torch.no_grad():
                tf.decode_step(cfg, model, specs["inputs"], caches,
                               specs["kv_len"], rt)
    return float(fc.get_total_flops())


def activation_bytes(cfg, batch: int, seq: int, tp: int, act_bytes: int,
                     seq_shard: bool = False) -> int:
    """Remat activations of one card's batch: every (pattern, repeat)
    unit's saved input [B, S, d], plus one unit's live set in its
    recompute — per layer its norm / residual streams (4·d), its q, k, v
    and attention output split over the model axis ((2·Hq + 2·Hkv)·dh /
    tp) and its MLP hidden (3·d_ff / tp) — plus the fp32 logits over a
    model shard of the vocab."""
    s = seq // tp if seq_shard else seq
    units = sum(reps for _, reps in cfg.runs())
    longest = max(len(pattern) for pattern, _ in cfg.runs())
    dh = cfg.dh if cfg.mla is None else \
        cfg.mla.nope_dim + cfg.mla.rope_dim
    per_layer = 4 * cfg.d_model \
        + (2 * cfg.n_heads + 2 * cfg.n_kv_heads) * dh / tp \
        + 3 * max(cfg.d_ff, cfg.moe.d_ff_expert * cfg.moe.top_k
                  if cfg.moe else 0) / tp
    saved = units * batch * s * cfg.d_model * act_bytes
    live = longest * batch * s * per_layer * act_bytes
    logits = batch * s * cfg.vocab / tp * 4
    return int(saved + live + logits)


def hbm_bytes(kind: str, *, param_dev: int, grad_dev: int, opt_dev: int,
              act_dev: int, cache_dev: int, microbatches: int = 1) -> float:
    """The HBM bytes one card's step must move at least: train — the
    parameters read forward, in the remat recompute and backward each
    microbatch and read and written by the update, the grads written and
    read per microbatch and read by the update, the optimizer state read
    and written, the remat activations written and read; prefill — the
    parameters read and the cache written; decode — the parameters and
    the cache read."""
    if kind == "train":
        mb = microbatches
        return float((3 * mb + 2) * param_dev + (2 * mb + 1) * grad_dev
                     + 2 * opt_dev + 2 * act_dev)
    return float(param_dev + cache_dev)


# ---------------------------------------------------------------------------
# a cell
# ---------------------------------------------------------------------------

def lower_cell(arch: str, shape: str, multi_pod: bool = False, *,
               mesh: Optional[shd.Mesh] = None, cfg=None,
               batch: Optional[int] = None, seq: Optional[int] = None,
               dtype: torch.dtype = torch.bfloat16,
               seq_shard: bool = False, microbatches: int = 1,
               grad_accum_dtype: str = "float32", shard_grads: bool = False,
               cache_seq_shard: bool = True,
               decode_splits: Optional[int] = None,
               window_aware: bool = True) -> dict:
    """One cell's record: memory, cost, collectives and roofline per card.
    ``mesh`` (default: the production mesh), ``cfg`` (default: the arch's),
    ``batch`` / ``seq`` (default: the shape cell's) and ``dtype`` (the
    parameters' and activations') override the reference's cell; the
    other flags are the reference's levers (``decode_splits`` default: the
    model axis's size)."""
    cfg = cfg or get_config(arch)
    base = SHAPES[shape]
    cell = ShapeCell(base.name, seq or base.seq_len,
                     batch or base.global_batch, base.kind)
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    train = cell.kind == "train"
    tp = mesh.shape.get("model", 1)
    mode = "fsdp_tp" if train else "serve"
    rules = shd.make_rules(mesh, mode, seq_shard=seq_shard)
    rt = Runtime(attn_impl="meta", param_dtype=dtype, activation_dtype=dtype,
                 shard_activation=shd.act_sharder(mesh, rules),
                 decode_splits=decode_splits or tp)
    t0 = time.time()
    model, axes = abstract_params(cfg, rt, with_mtp=True)
    named = dict(model.named_parameters())
    p_sh = shd.param_shardings(axes, named, mesh, rules)
    n_params = sum(p.numel() for p in named.values())
    act_bytes = torch.empty((), dtype=dtype, device="meta").element_size()
    dp = shd._data_axes(mesh)
    n_data = math.prod(mesh.shape[a] for a in dp)
    b_dev = cell.global_batch // n_data \
        if cell.global_batch % n_data == 0 else cell.global_batch
    specs = input_specs(cfg, shape, act_dtype=dtype)
    specs = {k: torch.empty((cell.global_batch,) + (
        (cell.seq_len if cell.kind != "decode" else 1,)
        if v.ndim >= 2 else ()) + tuple(v.shape[2:]), dtype=v.dtype,
        device="meta") for k, v in specs.items()}
    record: dict[str, Any] = {
        "arch": arch, "shape": shape, "mesh": _mesh_name(mesh),
        "mesh_shape": mesh.shape, "chips": chips, "mode": mode,
        "kind": cell.kind, "batch": cell.global_batch, "seq": cell.seq_len,
        "dtype": str(dtype).replace("torch.", ""), "params": n_params,
        "model_axis_spans_hosts": "model" in mesh.shape
        and axis_spans_hosts(mesh, "model"),
    }
    param_dev = _shard_bytes(p_sh, named)
    gdt = getattr(torch, grad_accum_dtype)
    grad_bytes = torch.empty((), dtype=gdt, device="meta").element_size()
    cache_sh = caches = None
    cache_dev = opt_dev = grad_dev = act_dev = 0
    if train:
        opt = make_optimizer(cfg.default_optimizer)
        opt_state = opt.init(named)
        o_axes = tree_flatten(opt_state_axes(opt_state, axes))
        o_leaves = {k: v for k, v in tree_flatten(opt_state).items() if v.ndim}
        o_sh = shd.param_shardings({k: o_axes[k] for k in o_leaves},
                                   o_leaves, mesh, rules)
        opt_dev = _shard_bytes(o_sh, o_leaves)
        for k, sh in p_sh.items():
            shape_ = tuple(named[k].shape)
            if shard_grads:
                shape_ = sh.shard_shape(shape_)
            else:
                nm = shd.Sharding(mesh, tuple(
                    p if p == "model" else None for p in sh.parts(
                        len(shape_)))).shard_shape(shape_)
                shape_ = nm
            grad_dev += _nbytes(shape_, gdt)
        act_dev = activation_bytes(cfg, b_dev // microbatches, cell.seq_len,
                                   tp, act_bytes, seq_shard)
    else:
        caches = tf.init_cache(cfg, cell.global_batch, cell.seq_len, dtype,
                               "meta")
        c_axes = tree_flatten({str(i): c for i, c in
                        enumerate(shd.cache_axes(cfg))})
        c_leaves = tree_flatten({str(i): c for i, c in enumerate(caches)})
        cache_sh = shd.cache_shardings(c_axes, c_leaves, mesh,
                                       seq_shard_fallback=cache_seq_shard)
        cache_dev = _shard_bytes(cache_sh, c_leaves)
    counted = counted_flops(cfg, model, cell.kind, specs, rt, caches)
    attn = attention_flops(cfg, cell.kind, cell.global_batch, cell.seq_len,
                           window_aware=window_aware)
    flops = (counted + attn) / chips
    nbytes = hbm_bytes(cell.kind, param_dev=param_dev, grad_dev=grad_dev,
                       opt_dev=opt_dev, act_dev=act_dev, cache_dev=cache_dev,
                       microbatches=microbatches)
    cs = collective_stats(
        cfg, kind=cell.kind, mesh=mesh, param_sh=p_sh,
        param_shapes={k: tuple(v.shape) for k, v in named.items()},
        param_bytes=act_bytes, batch=cell.global_batch, seq=cell.seq_len,
        act_bytes=act_bytes, microbatches=microbatches,
        shard_grads=shard_grads, grad_bytes=grad_bytes, cache_sh=cache_sh,
        cache_shapes=None if caches is None else {
            k: tuple(v.shape) for k, v in tree_flatten(
                {str(i): c for i, c in enumerate(caches)}).items()},
        splits=rt.decode_splits)
    peak_dev = param_dev + opt_dev + grad_dev + act_dev + cache_dev
    record["memory"] = {
        "param_bytes": param_dev, "opt_state_bytes": opt_dev,
        "grad_bytes": grad_dev, "activation_bytes": act_dev,
        "cache_bytes": cache_dev, "peak_bytes_est": peak_dev,
        "fits": peak_dev <= CARD_BYTES}
    record["cost"] = {"flops": flops, "bytes_accessed": nbytes,
                      "counted_flops": counted / chips,
                      "attention_flops": attn / chips}
    record["collectives"] = {"bytes_by_kind": cs.bytes_by_kind,
                             "counts": cs.counts,
                             "total_bytes": cs.total_bytes,
                             "network_bytes": cs.network_bytes}
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    rep = roofline(arch=arch, shape=shape, mesh=record["mesh"], chips=chips,
                   hlo_flops=flops, hlo_bytes=nbytes,
                   collective_bytes=cs.total_bytes, tokens=tokens,
                   train=train, cfg=cfg, dtype=dtype,
                   network_bytes=cs.network_bytes)
    record["roofline"] = rep.to_dict()
    record["card"] = card_peaks().name
    record["peaks"] = card_peaks().source
    record["lower_s"] = round(time.time() - t0, 3)
    record["ok"] = True
    return record


def _mesh_name(mesh: shd.Mesh) -> str:
    if mesh.shape == {"data": 16, "model": 16}:
        return "single"
    if mesh.shape == {"pod": 2, "data": 16, "model": 16}:
        return "multi"
    return "x".join(str(n) for n in mesh.sizes)


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------

def all_cells():
    for arch, cfg in ARCHS.items():
        for shape in SHAPES:
            if cell_applicable(cfg, shape):
                yield arch, shape


def run_cell(arch: str, shape: str, mesh_name: str, force: bool,
             **kw) -> dict:
    rec_dir = out_dir(mesh_name)
    os.makedirs(rec_dir, exist_ok=True)
    path = os.path.join(rec_dir, f"{arch}__{shape}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            rec = json.load(f)
        print(f"[skip] {mesh_name}/{arch}/{shape} (cached ok={rec.get('ok')})")
        return rec
    print(f"[run ] {mesh_name}/{arch}/{shape} ...", flush=True)
    try:
        rec = lower_cell(arch, shape, multi_pod=(mesh_name == "multi"), **kw)
    except Exception as e:
        rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "ok": False,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    status = "ok" if rec.get("ok") else "FAIL"
    extra = ""
    if rec.get("ok"):
        r = rec["roofline"]
        extra = (f" dominant={r['dominant']}"
                 f" frac={r['roofline_fraction']:.2f}"
                 f" fits={rec['memory']['fits']}")
    print(f"[{status:4s}] {mesh_name}/{arch}/{shape}{extra}", flush=True)
    return rec


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=("single", "multi", "both"))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-accum-dtype", default="float32")
    ap.add_argument("--shard-grads", action="store_true")
    args = ap.parse_args(argv)

    cells = [(a, s) for a, s in all_cells()
             if (args.arch in (None, a)) and (args.shape in (None, s))]
    if args.list:
        for a, s in cells:
            print(f"{a:28s} {s}")
        print(f"{len(cells)} applicable cells")
        return 0
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    n_fail = 0
    for mesh_name in meshes:
        for arch, shape in cells:
            rec = run_cell(arch, shape, mesh_name, args.force,
                           seq_shard=args.seq_shard,
                           microbatches=args.microbatches,
                           grad_accum_dtype=args.grad_accum_dtype,
                           shard_grads=args.shard_grads)
            n_fail += 0 if rec.get("ok") else 1
    print(f"done; {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
