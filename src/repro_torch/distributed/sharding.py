"""Sharding of the serving tier's paged KV pool over a list of devices.

Port of the paged-pool part of ``repro.distributed.sharding``: the page
arrays of :mod:`repro_torch.serving.kv_cache` split along the *kv-head*
axis (GQA ``k_pages`` / ``v_pages`` and their ``k_scale`` / ``v_scale``)
or the *latent-rank* axis (MLA ``ckv_pages`` / ``krope_pages``), while
the page dimension stays whole on every shard.  Page ids are therefore
global: block tables, free lists and the prefix index stay on the host,
one copy, and admission, growth, preemption and COW are unchanged.  MLA
scale pools (one scalar per latent vector, no rank axis) and SSM slot
state are replicated.  :func:`validate_kv_shard` refuses head / rank
counts the shard count does not divide, with the reference's messages.

One controller drives every shard, as the reference's ``shard_map`` does
from one process: a sharded leaf of a layer's cache is a list of ``tp``
tensors, shard ``d`` on ``KVShard.devices[d]``, each with its own sink
page (``[P + 1, ...]``).  The attention paths
(:mod:`repro_torch.model.attention`) run each shard's kernel on that
shard's device and gather the results in shard order on the engine's
device — head outputs (GQA) or the page strips' partials (MLA) — which
stands in for the reference's ``all_gather``.  A device list may repeat
a device: on one card every shard sits on ``cuda:0``, as the reference's
tests put several host "devices" on one CPU.  Weights, activations and
the SSM state stay on the engine's device.

The logical-axis rules of training, serving and the dry run are the
reference's, over a :class:`Mesh` of named axes (``"pod"``, ``"data"``,
``"model"``): :func:`make_rules` (modes ``tp``, ``fsdp_tp``, ``serve``),
:func:`param_shardings`, :func:`batch_shardings` and
:func:`cache_shardings` (with the sequence-shard fallback) give a
:class:`Sharding` per leaf, whose ``spec`` is a per-dimension tuple of
``None``, an axis name or a tuple of axis names — a ``PartitionSpec``'s
contents.  :func:`param_axes` gives the port's parameters the
reference's logical axes (the port's modules carry none), and
:mod:`repro_torch.distributed.placement` holds a leaf as the shards its
spec gives.  The reference's ``shard_map_fn`` has no counterpart: one
controller drives every shard.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh: ``devices`` (``torch.device``, repeats allowed) in
    row-major order over the named axes ``axis_names`` of sizes ``sizes``
    (default: one axis of every device).  ``shape`` maps each axis to its
    size, as a jax mesh's does; position ``i`` of the flat list is the
    mesh coordinate :meth:`coords` gives."""
    devices: tuple
    axis_names: tuple = ("model",)
    sizes: Optional[tuple] = None

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        names = tuple(self.axis_names)
        sizes = (len(devs),) if self.sizes is None and len(names) == 1 \
            else tuple(int(n) for n in (self.sizes or ()))
        if len(sizes) != len(names) or len(set(names)) != len(names) \
                or math.prod(sizes) != len(devs):
            raise ValueError(f"mesh axes {names} of sizes {sizes} do not "
                             f"hold {len(devs)} devices")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "sizes", sizes)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, pos: int) -> Dict[str, int]:
        """The axis coordinates of flat position ``pos`` (row-major)."""
        out = {}
        for name, n in reversed(list(zip(self.axis_names, self.sizes))):
            pos, out[name] = divmod(pos, n)
        return {name: out[name] for name in self.axis_names}

    def position(self, coords: Dict[str, int]) -> int:
        """The flat position of ``coords`` (axes left out: 0)."""
        pos = 0
        for name, n in zip(self.axis_names, self.sizes):
            pos = pos * n + coords.get(name, 0)
        return pos


@dataclasses.dataclass(frozen=True)
class KVShard:
    """Device sharding of the paged KV pool: pages split along the kv-head
    (GQA) / latent-rank (MLA) axis over ``devices``, shard ``d`` on
    ``devices[d]``.  Threaded through ``Runtime.kv_shard`` into the paged
    attention paths, which keep greedy streams bit-identical to the
    unsharded pool's."""
    devices: tuple
    axis: str = "model"

    @property
    def size(self) -> int:
        return len(self.devices)


def validate_kv_shard(cfg, tp: int) -> None:
    """Reject configs whose paged-pool shard axes ``tp`` does not divide:
    GQA pages shard on ``n_kv_heads`` (query heads follow: Hq = Hkv x
    group), MLA latent pages on ``kv_lora_rank`` and ``rope_dim``."""
    if tp <= 1:
        return
    problems = []
    attns = {spec.attn for spec in cfg.layer_specs()}
    if "gqa" in attns and cfg.n_kv_heads % tp:
        problems.append(
            f"n_kv_heads={cfg.n_kv_heads} is not divisible by tp={tp}")
    if "mla" in attns:
        if cfg.mla.kv_lora_rank % tp:
            problems.append(
                f"mla.kv_lora_rank={cfg.mla.kv_lora_rank} is not "
                f"divisible by tp={tp}")
        if cfg.mla.rope_dim % tp:
            problems.append(
                f"mla.rope_dim={cfg.mla.rope_dim} is not divisible by "
                f"tp={tp}")
    if problems:
        raise ValueError(
            "cannot shard the paged KV pool over "
            f"{tp} devices: " + "; ".join(problems) +
            " — pick a tp that divides the kv-head/latent axes, or serve "
            "this config unsharded (mesh=None)")


#: paged-cache leaf name → the dimension (from the right) that shards:
#: GQA page arrays are [P + 1, page_size, Hkv, dh] (head axis at -2) and
#: their scale pools [P + 1, page_size, Hkv] (-1); MLA latent pages are
#: [P + 1, page_size, r] (rank axis at -1).  Every other leaf — the MLA
#: scale pools [P + 1, page_size], SSM state — is replicated.
_PAGED_SHARD_DIMS = {"k_pages": -2, "v_pages": -2,
                     "ckv_pages": -1, "krope_pages": -1,
                     "k_scale": -1, "v_scale": -1}


def leaf_parts(leaf) -> List[torch.Tensor]:
    """The tensors of a cache leaf: its shards, or the leaf itself."""
    return list(leaf) if isinstance(leaf, (list, tuple)) else [leaf]


def shard_slice(n: int, d: int, tp: int) -> slice:
    """Shard ``d``'s part of an axis of ``n`` (``tp`` divides ``n``)."""
    return slice(d * n // tp, (d + 1) * n // tp)


def shard_paged_caches(caches: list, shard: KVShard) -> list:
    """Split every sharded leaf of an ``init_paged_cache`` list into
    ``shard.size`` tensors per :data:`_PAGED_SHARD_DIMS`, shard ``d``
    moved to ``shard.devices[d]``, in place (a layer at a time, so the
    whole pool is never held twice).  Returns ``caches``."""
    for c in caches:
        attn = c.get("attn", {})
        for name, dim in _PAGED_SHARD_DIMS.items():
            if name in attn:
                attn[name] = [part.contiguous().to(dev) for part, dev in
                              zip(attn[name].chunk(shard.size, dim),
                                  shard.devices)]
    return caches


def visible_devices() -> List[torch.device]:
    """The CUDA devices this process sees, in order."""
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def replica_device_groups(dp: int, tp: int = 1,
                          devices: Optional[Sequence] = None) -> list:
    """Partition ``devices`` (default: :func:`visible_devices`) into ``dp``
    contiguous groups of ``tp`` for data-parallel serving replicas —
    replica i owns devices [i*tp, (i+1)*tp); replicas never communicate
    (routing is host-side).  With fewer than ``dp*tp`` devices and ``tp
    == 1`` the groups wrap round-robin (every replica may share one
    device); with ``tp > 1`` the device count must cover every group."""
    if dp < 1 or tp < 1:
        raise ValueError(f"need dp >= 1 and tp >= 1, got dp={dp} tp={tp}")
    devs = list(devices) if devices is not None else visible_devices()
    need = dp * tp
    if len(devs) < need:
        if tp > 1 or not devs:
            raise ValueError(
                f"dp={dp} tp={tp} needs {need} devices, have {len(devs)}")
        return [[devs[i % len(devs)]] for i in range(dp)]
    return [devs[i * tp:(i + 1) * tp] for i in range(dp)]


# ---------------------------------------------------------------------------
# Logical-axis rules (training, serving, the dry run)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's placement on ``mesh``: ``spec`` holds, per dimension,
    ``None`` (whole), a mesh axis name or a tuple of them (the dimension
    splits over their product, row-major) — a ``NamedSharding``'s
    contents."""
    mesh: Mesh
    spec: tuple

    def parts(self, ndim: int) -> tuple:
        """The spec padded with ``None`` to ``ndim`` dimensions."""
        return tuple(self.spec) + (None,) * (ndim - len(self.spec))

    def shard_index(self, part, pos: int) -> tuple:
        """(index, count) of position ``pos``'s shard of a dimension split
        by ``part``."""
        if part is None:
            return 0, 1
        coords = self.mesh.coords(pos)
        idx, count = 0, 1
        for a in ((part,) if isinstance(part, str) else part):
            n = self.mesh.shape[a]
            idx, count = idx * n + coords[a], count * n
        return idx, count

    def region(self, shape, pos: int) -> tuple:
        """The slices of a ``shape`` leaf that position ``pos`` holds."""
        out = []
        for dim, part in zip(shape, self.parts(len(shape))):
            idx, count = self.shard_index(part, pos)
            out.append(shard_slice(dim, idx, count))
        return tuple(out)

    def shard_shape(self, shape) -> tuple:
        """The shape of one shard (every split divides its dimension)."""
        out = []
        for dim, part in zip(shape, self.parts(len(shape))):
            count = self.shard_index(part, 0)[1]
            out.append(dim // count)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis name → mesh axis (or tuple of mesh axes, or None)."""
    rules: tuple

    def lookup(self, name: Optional[str]):
        for k, v in self.rules:
            if k == name:
                return v
        return None


def _data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def make_rules(mesh, mode: str = "tp", seq_shard: bool = False) -> dict:
    """Build (param_rules, act_rules) for a mesh + parallelism mode:
    ``tp`` (tensor-parallel over "model", replicated over data),
    ``fsdp_tp`` (also ``embed`` / ``expert_mlp`` / ``latent`` over the
    data axes, ZeRO-3 style) or ``serve``; ``seq_shard`` puts the
    activations' "seq" on "model"."""
    dp = _data_axes(mesh)
    tp_rules = (("heads", "model"), ("kv_heads", "model"), ("mlp", "model"),
                ("vocab", "model"), ("experts", "model"), ("inner", "model"))
    if mode in ("tp", "serve"):
        param = ShardingRules(tp_rules + (
            ("embed", None), ("expert_mlp", None), ("layers", None),
            ("latent", None), ("state", None), ("head_dim", None),
        ))
    elif mode == "fsdp_tp":
        param = ShardingRules(tp_rules + (
            ("embed", dp), ("expert_mlp", dp), ("latent", dp),
            ("layers", None), ("state", None), ("head_dim", None),
        ))
    else:
        raise ValueError(mode)
    act = ShardingRules((
        ("batch", dp),
        ("seq", "model" if seq_shard else None),
        ("heads", "model"), ("kv_heads", "model"),
        ("mlp", "model"), ("expert_mlp", None),
        ("experts", "model"), ("vocab", "model"),
        ("embed", None), ("head_dim", None),
    ))
    return {"param": param, "act": act}


def _spec_for(axes: Sequence, rules: ShardingRules, shape=None) -> tuple:
    """A logical-axes tuple as a spec, dropping any mesh axis already used
    (a mesh axis appears at most once per array)."""
    used: set = set()
    parts = []
    for name in axes:
        v = rules.lookup(name)
        if v is None:
            parts.append(None)
            continue
        vt = (v,) if isinstance(v, str) else tuple(v)
        vt = tuple(a for a in vt if a not in used)
        if not vt:
            parts.append(None)
            continue
        parts.append(vt if len(vt) > 1 else vt[0])
        used.update(vt)
    return tuple(parts)


def _divisible(shape, spec: tuple, mesh) -> tuple:
    """Drop assignments that do not divide the array dimension."""
    parts = []
    for dim, part in zip(shape,
                         tuple(spec) + (None,) * (len(shape) - len(spec))):
        if part is None:
            parts.append(None)
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        total = math.prod(int(mesh.shape[a]) for a in axes)
        parts.append(part if dim % total == 0 else None)
    return tuple(parts)


def _spec_axes(spec: tuple) -> set:
    """Every mesh axis a spec names."""
    out: set = set()
    for part in spec:
        if part is not None:
            out.update((part,) if isinstance(part, str) else part)
    return out


def param_shardings(axes: Dict[str, Optional[tuple]], shapes: Dict[str, Any],
                    mesh: Mesh, rules: dict) -> Dict[str, Sharding]:
    """A :class:`Sharding` per leaf of a flat ``{name: logical axes}``
    (``None``: replicated) from the leaves' shapes (tensors or shapes)."""
    pr = rules["param"]
    out = {}
    for name, ax in axes.items():
        shape = tuple(getattr(shapes[name], "shape", shapes[name]))
        spec = () if ax is None else _divisible(shape, _spec_for(ax, pr),
                                                mesh)
        out[name] = Sharding(mesh, spec)
    return out


def act_sharder(mesh: Mesh, rules: dict):
    """The activation hook (``Runtime.shard_activation``) of ``rules``.
    One controller places activations by the step that makes them, so
    there is nothing for the hook to constrain: it is the identity, as the
    reference's default hook is."""
    return _identity_activation


def _identity_activation(x, axes):
    return x


def batch_shardings(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Sharding]:
    """Shard batch inputs: the leading (batch) dim over the data axes
    where they divide it."""
    dp = _data_axes(mesh)
    n = math.prod(int(mesh.shape[a]) for a in dp)
    out = {}
    for k, v in batch.items():
        shape = tuple(v.shape)
        spec = [None] * len(shape)
        if dp and shape and shape[0] % n == 0:
            spec[0] = dp if len(dp) > 1 else dp[0]
        out[k] = Sharding(mesh, tuple(spec))
    return out


#: the serving caches' structural rules (``cache_shardings``)
def _cache_rules(mesh) -> ShardingRules:
    return ShardingRules((("batch", _data_axes(mesh)), ("kv_heads", "model"),
                          ("heads", "model"), ("inner", "model"),
                          ("layers", None)))


def cache_axes(cfg) -> list:
    """The dense caches' structural axes, one dict per layer like
    :func:`repro_torch.model.transformer.init_cache`'s list (the
    reference's ``cache_axes``): GQA ``k`` / ``v`` ``(batch, kv_heads,
    None, None)``, MLA latents ``(batch, None, None)``, SSM state by kind."""
    out = []
    for spec in cfg.layer_specs():
        ax: dict = {}
        if spec.attn == "gqa":
            ax["attn"] = {"k": ("batch", "kv_heads", None, None),
                          "v": ("batch", "kv_heads", None, None)}
        elif spec.attn == "mla":
            ax["attn"] = {"ckv": ("batch", None, None),
                          "krope": ("batch", None, None)}
        if spec.ssm == "mamba":
            ax["ssm"] = {"h": ("batch", "inner", None),
                         "conv": ("batch", None, "inner")}
        elif spec.ssm == "mlstm":
            ax["ssm"] = {"c": ("batch", "heads", None, None),
                         "n": ("batch", "heads", None),
                         "m": ("batch", "heads"),
                         "conv": ("batch", None, "inner")}
        elif spec.ssm == "slstm":
            ax["ssm"] = {k: ("batch", "embed") for k in ("c", "n", "m", "h")}
        out.append(ax)
    return out


def cache_shardings(axes: Dict[str, tuple], shapes: Dict[str, Any],
                    mesh: Mesh, seq_shard_fallback: bool = True
                    ) -> Dict[str, Sharding]:
    """A :class:`Sharding` per cache leaf of a flat ``{name: structural
    axes}``.  Where the kv-head count does not divide the model axis
    (gemma2: 8 kv heads on a 16-way axis) the cache would replicate;
    instead its slot dimension (second to last) shards over "model", and
    decode runs split-K over the strips (each computes partials over its
    keys; one combine merges them)."""
    ar = _cache_rules(mesh)
    out = {}
    for name, ax in axes.items():
        shape = tuple(getattr(shapes[name], "shape", shapes[name]))
        spec = _divisible(shape, _spec_for(ax, ar), mesh)
        if (seq_shard_fallback and "kv_heads" in ax
                and "model" in mesh.axis_names
                and "model" not in _spec_axes(spec)):
            slot_dim = len(ax) - 2
            if shape[slot_dim] % mesh.shape["model"] == 0:
                parts = list(spec + (None,) * (len(shape) - len(spec)))
                parts[slot_dim] = "model"
                spec = tuple(parts)
        out[name] = Sharding(mesh, spec)
    return out


# ---------------------------------------------------------------------------
# The port's parameters' logical axes
# ---------------------------------------------------------------------------

_NORM = ("embed",)
_MLP = {"wi_gate": ("embed", "mlp"), "wi_up": ("embed", "mlp"),
        "wo": ("mlp", "embed")}
#: a layer's leaves (after ``layers.<L>.`` / ``mtp.<j>.``) → logical axes;
#: ``ssm.*`` depends on the mixer kind (:data:`_SSM_AXES`)
_LAYER_AXES = {
    **{f"{n}.{p}": _NORM for n in ("ln1", "ln2", "post1", "post2")
       for p in ("scale", "bias")},
    "attn.wq": ("embed", "heads", "head_dim"),
    "attn.wk": ("embed", "kv_heads", "head_dim"),
    "attn.wv": ("embed", "kv_heads", "head_dim"),
    "attn.wo": ("heads", "head_dim", "embed"),
    "attn.w_dq": ("embed", "latent"),
    "attn.w_uq": ("latent", "heads", "head_dim"),
    "attn.w_dkv": ("embed", "latent"),
    "attn.w_uk": ("latent", "heads", "head_dim"),
    "attn.w_uv": ("latent", "heads", "head_dim"),
    "attn.q_norm.scale": ("latent",),
    "attn.kv_norm.scale": ("latent",),
    **{f"mlp.{k}": v for k, v in _MLP.items()},
    **{f"moe.shared.{k}": v for k, v in _MLP.items()},
    "moe.router": ("embed", "experts"),
    "moe.wi_gate": ("experts", "embed", "expert_mlp"),
    "moe.wi_up": ("experts", "embed", "expert_mlp"),
    "moe.wo": ("experts", "expert_mlp", "embed"),
}
_SSM_AXES = {
    "mamba": {"w_in": ("embed", "inner"), "conv_w": (None, "inner"),
              "conv_b": ("inner",), "w_xproj": ("inner", None),
              "w_dt": (None, "inner"), "dt_bias": ("inner",),
              "a_log": ("inner", "state"), "d_skip": ("inner",),
              "w_out": ("inner", "embed")},
    "mlstm": {"w_in": ("embed", "inner"), "conv_w": (None, "inner"),
              "conv_b": ("inner",), "wq": ("inner", "inner"),
              "wk": ("inner", "inner"), "wv": ("inner", "inner"),
              "w_gates": ("inner", None), "b_gates": (None,),
              "norm_scale": ("inner",), "w_out": ("inner", "embed")},
    "slstm": {"w_gates": ("embed", None), "r_gates": ("heads", None, None),
              "b_gates": (None,), "norm_scale": ("embed",),
              "w_out": ("embed", "embed")},
}
_TOP_AXES = {"embed.table": ("vocab", "embed"),
             "unembed.table": ("vocab", "embed"),
             "frontend_proj.w": ("embed", "embed"),
             "final_norm.scale": _NORM, "final_norm.bias": _NORM}


def param_axes(cfg, model) -> Dict[str, tuple]:
    """The reference's logical axes of each of ``model``'s parameters
    (``named_parameters()`` names), as its ``init`` returns them for the
    leaf — without the leading ``"layers"`` of a stacked run, since the
    port keeps one leaf per layer (:mod:`repro_torch.bridge`).  The model
    is read as it is; its modules carry no axes."""
    specs = cfg.layer_specs()
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".", 2)
        if parts[0] in ("layers", "mtp"):
            spec = specs[int(parts[1])] if parts[0] == "layers" \
                else specs[-1]
            leaf = parts[2]
            if leaf.startswith("ssm."):
                ax = _SSM_AXES[spec.ssm].get(leaf[4:])
            else:
                ax = _LAYER_AXES.get(leaf)
        else:
            ax = _TOP_AXES.get(name)
        if ax is None:
            raise KeyError(f"{cfg.name}: no logical axes for {name}")
        out[name] = ax
    return out


def data_shards(mesh: Mesh) -> list:
    """Each data shard's mesh positions, in model-axis order: the
    positions that share their data-axis (``"pod"``, ``"data"``)
    coordinates, data shards in row-major order of those axes."""
    dp = _data_axes(mesh)
    groups: dict = {}
    for pos in range(mesh.size):
        c = mesh.coords(pos)
        groups.setdefault(tuple(c[a] for a in dp), []).append(pos)
    return [groups[k] for k in sorted(groups)]


@dataclasses.dataclass
class DenseCacheShards:
    """One data shard's view of a dense cache leaf split over the model
    axis: ``parts`` in shard order, each on its position's device, split
    along ``dim`` — 1 (kv heads) or 2 (slots: the sequence-sharded
    fallback of :func:`cache_shardings`, whose decode runs K2 on each
    strip).  The attention paths write and read the parts in place."""
    parts: list
    dim: int
