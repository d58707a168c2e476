"""Tensor parallelism: the widest layers' output channels split over the
devices of one process.

Counterpart of ``multishiftseg_tpu/core/mesh.py``'s ``tensor_parallel_shardings``
(:93-136), ``shard_params`` and ``place_train_state`` (:139-156). JAX shards a
leaf of the parameters, the Adam moments or the BatchNorm statistics over the
mesh's ``model`` axis when its trailing dimension is at least
``model_parallel_min_size`` and divides by ``model_parallel``, and XLA
partitions the contractions. :func:`tensor_parallel_plan` applies the same rule
to the port's ``state_dict`` (the JAX trailing dimension is dim 0 of a conv or
linear weight, a bias and every per-channel vector), and
:func:`apply_tensor_parallel` replaces each module that owns planned tensors
by a :class:`ChannelShards`: one clone of the module per device, each holding
its slice of the output channels (weight, bias, norm and running statistics),
so the parameters, their gradients and their optimizer state live
1/``model_parallel`` on each device and nothing keeps a whole copy.

The compute is column-parallel: a sharded conv or linear computes its slice of
the output channels on its device from a copy of the whole input, and the
per-channel work that follows (bias, BatchNorm in either mode, FrozenBN,
GroupNorm over whole groups, ReLU, channel dropout, residual adds) runs on the
slices, carried as :class:`Shards`. The slices are concatenated
(:func:`full`) where an op needs every channel. Autograd runs through the
copies: each shard's weight gets its own gradient and the input's gradient
sums the shards'. The model code routes its layers through :func:`apply`,
:func:`relu` and :func:`add`, which are the plain calls on whole tensors.

Layout: one process drives its ``model_parallel`` devices (JAX keeps the
``model`` axis inside a host, ``make_global_mesh``); the data axis stays the
processes, so DDP and every global reduction of ``core.mesh`` are unchanged.
The devices are an explicit list (:func:`tensor_parallel_devices`) that may
repeat one device: every shard on one card, or on the CPU.

Checkpoints keep the unsharded, per-layer layout: a :class:`ChannelShards`
writes and reads its module's own keys (``conv.weight``, not
``conv.shards.0.weight``), and :func:`optimizer_state_dict` /
:func:`load_optimizer_state_dict` convert the optimizer's state, so a
checkpoint moves between ``model_parallel`` 1 and N either way.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


class Shards:
    """A tensor split along ``dim`` into ``parts``, each on its device."""

    __slots__ = ("parts", "dim")

    def __init__(self, parts: Sequence[torch.Tensor], dim: int):
        self.parts = list(parts)
        self.dim = dim

    @property
    def sizes(self) -> List[int]:
        return [p.shape[self.dim] for p in self.parts]

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (the first part's by default)."""
        device = self.parts[0].device if device is None else device
        return torch.cat([p.to(device) for p in self.parts], self.dim)

    def map(self, fn) -> "Shards":
        return Shards([fn(p) for p in self.parts], self.dim)


def full(x):
    """``x`` whole: the concatenation of its slices when it is :class:`Shards`."""
    return x.gather() if isinstance(x, Shards) else x


def split_like(x, sizes: Sequence[int], devices: Sequence[torch.device], dim: int) -> Shards:
    """``x`` (whole or :class:`Shards`) as slices of ``sizes`` along ``dim`` on
    ``devices``."""
    if isinstance(x, Shards) and x.sizes == list(sizes) and x.dim == dim:
        return Shards([p.to(d) for p, d in zip(x.parts, devices)], dim)
    x = full(x)
    parts, start = [], 0
    for size, dev in zip(sizes, devices):
        parts.append(x.narrow(dim, start, size).to(dev))
        start += size
    return Shards(parts, dim)


def apply(layer: Optional[nn.Module], x, *args):
    """``layer(x, *args)`` for a whole tensor, or ``x`` when ``layer`` is None;
    a :class:`ChannelShards` returns its slices; an ``nn.Sequential`` runs its
    layers through here, an ``nn.ReLU`` runs on each slice, any other layer
    gets the whole tensor."""
    if layer is None:
        return x
    if isinstance(layer, ChannelShards):
        return layer.forward_shards(x, *args)
    if isinstance(x, Shards):
        if isinstance(layer, nn.Sequential):
            for sub in layer:
                x = apply(sub, x)
            return x
        if isinstance(layer, nn.ReLU):
            return x.map(layer)
        return layer(x.gather(), *args)
    return layer(x, *args)


def per_channel(fn, x, vec: torch.Tensor, dim: int = 1):
    """``fn(x, vec)`` for a ``vec`` that runs along ``x``'s channel ``dim``
    (a channel-dropout mask): on each slice with its slice of ``vec``."""
    if not isinstance(x, Shards):
        return fn(x, vec)
    if vec is None:
        return x.map(lambda p: fn(p, None))
    part = split_like(vec, x.sizes, [p.device for p in x.parts], dim)
    return Shards([fn(a, b) for a, b in zip(x.parts, part.parts)], x.dim)


def elementwise(fn, x):
    """``fn(x)`` for an elementwise ``fn``: on each slice of :class:`Shards`."""
    return x.map(fn) if isinstance(x, Shards) else fn(x)


def relu(x):
    return elementwise(F.relu, x)


def add(a, b):
    """``a + b``, on the slices when either is :class:`Shards`."""
    if isinstance(b, Shards) and not isinstance(a, Shards):
        a, b = b, a
    if isinstance(a, Shards):
        b = split_like(b, a.sizes, [p.device for p in a.parts], a.dim)
        return Shards([p + q for p, q in zip(a.parts, b.parts)], a.dim)
    return a + b


# ---------------------------------------------------------------------------
# the plan: which state_dict entries shard


def _is_channel_module(module: nn.Module) -> bool:
    """Modules whose every tensor runs along the output channel in dim 0."""
    from ..models.resnet import FrozenBN

    return isinstance(module, (nn.Conv2d, nn.Linear, nn.BatchNorm2d, nn.GroupNorm,
                               nn.LayerNorm, FrozenBN))


def _jax_trailing(module: nn.Module, leaf: str, t: torch.Tensor) -> int:
    """The size of the JAX leaf's trailing dimension, read from the port's tensor:
    dim 0 of a conv or linear weight, a bias and every per-channel vector; a
    third of dim 0 for a packed ``in_proj`` (JAX's q/k/v kernels are
    ``[C, C]`` each); the last dim of an embedding or a bare table, whose
    layouts are JAX's."""
    if _is_channel_module(module):
        return t.shape[0]
    if leaf in ("in_proj_weight", "in_proj_bias"):
        return t.shape[0] // 3
    return t.shape[-1]


def _local_tensors(module: nn.Module):
    """A module's own parameters and persistent buffers, by leaf name."""
    out = [(n, p) for n, p in module.named_parameters(recurse=False)]
    out += [(n, b) for n, b in module.named_buffers(recurse=False)
            if b is not None and n not in module._non_persistent_buffers_set]
    return out


def tensor_parallel_plan(model: nn.Module, model_parallel: int,
                         min_size: int = 1024) -> List[str]:
    """The ``state_dict`` keys that shard over ``model_parallel`` devices: JAX's
    rule (``tensor_parallel_shardings``), a tensor whose JAX trailing dimension
    is at least ``min_size`` and divisible by ``model_parallel``. Empty at
    ``model_parallel`` 1. ``model`` is the unsharded model."""
    if model_parallel <= 1:
        return []
    keys = []
    for name, module in model.named_modules():
        for leaf, t in _local_tensors(module):
            size = _jax_trailing(module, leaf, t)
            if t.dim() >= 1 and size >= min_size and size % model_parallel == 0:
                keys.append(f"{name}.{leaf}" if name else leaf)
    return keys


# ---------------------------------------------------------------------------
# placement


def tensor_parallel_devices(model_parallel: int, devices: Optional[Sequence] = None,
                            home: Optional[torch.device] = None) -> List[torch.device]:
    """The shards' devices: ``devices``, or ``model_parallel`` copies of a CPU
    ``home``, or the ``model_parallel`` cards from ``home``'s (the current card
    by default); refuses fewer, as JAX's ``make_mesh`` refuses to truncate. A
    list may repeat a device (every shard on one card)."""
    if devices is None:
        home = torch.device("cuda" if home is None else home)
        if home.type == "cpu":
            devices = [home] * model_parallel
        else:
            first = torch.cuda.current_device() if home.index is None else home.index
            count = torch.cuda.device_count()
            if first + model_parallel > count:
                raise ValueError(f"model_parallel = {model_parallel} from cuda:{first} needs "
                                 f"{first + model_parallel} cards; {count} are visible")
            devices = [torch.device("cuda", first + j) for j in range(model_parallel)]
    devs = [torch.device(d) for d in devices]
    if len(devs) != model_parallel:
        raise ValueError(f"model_parallel = {model_parallel} but {len(devs)} devices given "
                         f"({[str(d) for d in devs]})")
    return devs


def _slice_module(module: nn.Module, i: int, n: int) -> nn.Module:
    """A clone of ``module`` holding slice ``i`` of ``n`` of its output channels
    (its norm child's too): every tensor that runs along them, sliced in dim 0."""
    out = module.weight.shape[0]
    with torch.no_grad():
        clone = copy.deepcopy(module)
        for sub in clone.modules():
            for leaf, t in _local_tensors(sub):
                if t.dim() >= 1 and t.shape[0] == out:
                    piece = t.detach()[i * out // n:(i + 1) * out // n].clone()
                    if isinstance(t, nn.Parameter):
                        setattr(sub, leaf, nn.Parameter(piece, requires_grad=t.requires_grad))
                    else:
                        setattr(sub, leaf, piece)
            if isinstance(sub, nn.Conv2d):
                sub.out_channels //= n
            elif isinstance(sub, nn.Linear):
                sub.out_features //= n
            elif isinstance(sub, nn.BatchNorm2d):
                sub.num_features //= n
            elif isinstance(sub, nn.GroupNorm):
                sub.num_groups //= n
                sub.num_channels //= n
            elif isinstance(sub, nn.LayerNorm):
                sub.normalized_shape = (out // n,)
    return clone


class ChannelShards(nn.Module):
    """``module`` with its output channels split over ``devices``: a conv or a
    linear (with a detectron2 ``Conv2d``'s norm and activation), a BatchNorm,
    FrozenBN, GroupNorm (over whole groups) or LayerNorm. ``shards[i]`` is a
    clone of ``module`` with slice ``i`` on ``devices[i]``. Called as a module
    it returns the whole output (:func:`full`); :func:`apply` takes the
    slices. Its ``state_dict`` entries are the module's own, whole."""

    def __init__(self, module: nn.Module, devices: Sequence[torch.device]):
        super().__init__()
        from ..models.layers import Conv2d

        n = len(devices)
        if isinstance(module, nn.GroupNorm) or (isinstance(module, Conv2d)
                                                and isinstance(module.norm, nn.GroupNorm)):
            groups = (module if isinstance(module, nn.GroupNorm) else module.norm).num_groups
            if groups % n:
                raise ValueError(f"GroupNorm of {groups} groups does not split over {n} shards")
        if isinstance(module, nn.Conv2d) and module.groups != 1:
            raise NotImplementedError("a grouped convolution does not shard by output channel")
        self.kind = ("layer_norm" if isinstance(module, nn.LayerNorm)
                     else "norm" if not isinstance(module, (nn.Conv2d, nn.Linear))
                     else "map")
        self.dim = -1 if isinstance(module, (nn.Linear, nn.LayerNorm)) else 1
        self.devices = [torch.device(d) for d in devices]
        self.shards = nn.ModuleList(_slice_module(module, i, n).to(dev)
                                    for i, dev in enumerate(self.devices))
        self.eps = getattr(module, "eps", None)
        self.channels = module.weight.shape[0]
        self.leaves = list(self.shards[0].state_dict().keys())
        self._register_state_dict_hook(_gather_state)
        self._register_load_state_dict_pre_hook(_split_state, with_module=True)

    def forward_shards(self, x, *args) -> Shards:
        if self.kind == "map":
            x = full(x)
            return Shards([s(x.to(d), *args) for s, d in zip(self.shards, self.devices)],
                          self.dim)
        if self.kind == "norm":
            part = split_like(x, [self.channels // len(self.shards)] * len(self.shards),
                              self.devices, self.dim)
            return Shards([s(p) for s, p in zip(self.shards, part.parts)], self.dim)
        # LayerNorm normalises over every channel, then each slice takes its affine
        x = full(x)
        y = F.layer_norm(x, (self.channels,), None, None, self.eps)
        part = split_like(y, [self.channels // len(self.shards)] * len(self.shards),
                          self.devices, -1)
        return Shards([p * s.weight.to(p.dtype) + s.bias.to(p.dtype)
                       for s, p in zip(self.shards, part.parts)], -1)

    def forward(self, x, *args) -> torch.Tensor:
        return self.forward_shards(x, *args).gather()


def _gather_state(module: ChannelShards, state_dict, prefix, local_metadata):
    for leaf in module.leaves:
        parts = [state_dict.pop(f"{prefix}shards.{i}.{leaf}")
                 for i in range(len(module.shards))]
        state_dict[prefix + leaf] = torch.cat([p.detach().cpu() for p in parts])
    return state_dict


def _split_state(module: ChannelShards, state_dict, prefix, local_metadata, strict,
                 missing_keys, unexpected_keys, error_msgs):
    for leaf in module.leaves:
        if prefix + leaf in state_dict:
            whole = state_dict.pop(prefix + leaf)
            for i, piece in enumerate(whole.chunk(len(module.shards))):
                state_dict[f"{prefix}shards.{i}.{leaf}"] = piece


def apply_tensor_parallel(model: nn.Module, devices: Sequence[torch.device],
                          min_size: int = 1024) -> List[str]:
    """Shard ``model`` in place over ``devices`` by :func:`tensor_parallel_plan`;
    returns the planned keys. Each module that owns planned tensors must own
    nothing else and be of a type :class:`ChannelShards` takes (a detectron2
    ``Conv2d`` takes its norm along); anything else raises, so that no tensor
    JAX shards stays whole."""
    from ..models.layers import Conv2d

    plan = tensor_parallel_plan(model, len(devices), min_size)
    planned = set(plan)
    modules = dict(model.named_modules())
    units: Dict[str, nn.Module] = {}
    for name, module in modules.items():
        local = [f"{name}.{leaf}" if name else leaf for leaf, _ in _local_tensors(module)]
        hit = [k for k in local if k in planned]
        if not hit:
            continue
        parent_name = name.rsplit(".", 1)[0] if "." in name else ""
        parent = modules.get(parent_name) if name else None
        if isinstance(parent, Conv2d) and parent.norm is module:
            continue  # shards with its conv
        if len(hit) != len(local) or not _is_channel_module(module):
            raise NotImplementedError(
                f"{name or type(module).__name__}: JAX shards {sorted(hit)} of "
                f"{type(module).__name__}, which the port does not split by output channel")
        if isinstance(module, Conv2d) and module.norm is not None:
            norm_keys = [f"{name}.norm.{leaf}" for leaf, _ in _local_tensors(module.norm)]
            if not all(k in planned for k in norm_keys):
                raise NotImplementedError(f"{name}: its norm is not sharded with it")
        units[name] = module
    for name, module in units.items():
        parent_name, _, leaf = name.rpartition(".")
        setattr(modules[parent_name] if parent_name else model, leaf,
                ChannelShards(module, devices))
    return plan


def place_tensor_parallel(model: nn.Module, train_cfg, home: torch.device,
                          devices: Optional[Sequence] = None
                          ) -> Optional[List[torch.device]]:
    """The trainers' placement (JAX ``place_train_state``): with
    ``train.model_parallel > 1``, shard ``model`` (already on ``home``) over
    :func:`tensor_parallel_devices` by ``train.model_parallel_min_size`` and
    return the devices; else None. A model without a tensor to shard raises."""
    mp = train_cfg.model_parallel
    if mp <= 1:
        return None
    devs = tensor_parallel_devices(mp, devices, home)
    if not apply_tensor_parallel(model, devs, train_cfg.model_parallel_min_size):
        raise ValueError(f"train.model_parallel = {mp}: no tensor of this model reaches "
                         f"model_parallel_min_size = {train_cfg.model_parallel_min_size}")
    return devs


def is_tensor_parallel(model: nn.Module) -> bool:
    return any(isinstance(m, ChannelShards) for m in model.modules())


# ---------------------------------------------------------------------------
# optimizer state in the unsharded layout


def _logical_params(model: nn.Module) -> Dict[int, tuple]:
    """id(shard parameter) -> (the unsharded parameter's key, shard index,
    shard count) for every sharded parameter of ``model``."""
    out = {}
    for name, module in model.named_modules():
        if isinstance(module, ChannelShards):
            for i, shard in enumerate(module.shards):
                for leaf, p in shard.named_parameters():
                    out[id(p)] = (f"{name}.{leaf}", i, len(module.shards))
    return out


def unsharded_grads(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Each parameter's gradient under the unsharded model's name, a sharded
    one's shards concatenated (on the CPU); parameters without one left out."""
    logical = _logical_params(model)
    parts: Dict[str, List] = {}
    out = {}
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        key = logical.get(id(p))
        if key is None:
            out[name] = p.grad.detach().cpu()
        else:
            parts.setdefault(key[0], [None] * key[2])[key[1]] = p.grad.detach().cpu()
    for name, shards in parts.items():
        out[name] = torch.cat(shards)
    return out


def state_bytes(model: nn.Module, optimizer: torch.optim.Optimizer) -> List[int]:
    """Bytes of parameters plus optimizer state by shard index: entry 0 the
    unsharded tensors and shard 0's (the home device's), entry i shard i's."""
    logical = _logical_params(model)
    n = max((k[2] for k in logical.values()), default=1)
    out = [0] * n
    for p in model.parameters():
        i = logical[id(p)][1] if id(p) in logical else 0
        out[i] += p.numel() * p.element_size() + sum(
            t.numel() * t.element_size() for t in optimizer.state.get(p, {}).values()
            if torch.is_tensor(t))
    return out


def optimizer_state_dict(model: nn.Module, optimizer: torch.optim.Optimizer) -> dict:
    """``optimizer.state_dict()`` as the unsharded model's optimizer would hold
    it: each sharded parameter's shards one entry, its state concatenated in
    dim 0 (on the CPU), its group's ``names`` the unsharded ones."""
    logical = _logical_params(model)
    sd = optimizer.state_dict()
    if not logical:
        return sd
    state, groups, index = {}, [], 0
    for group, saved in zip(optimizer.param_groups, sd["param_groups"]):
        seen: Dict[str, int] = {}
        members: Dict[int, List] = {}
        ids, names = [], []
        for j, (p, k) in enumerate(zip(group["params"], saved["params"])):
            key = logical.get(id(p))
            if key is None:
                ids.append(index)
                if k in sd["state"]:
                    state[index] = sd["state"][k]
                if "names" in saved:
                    names.append(saved["names"][j])
                index += 1
                continue
            if key[0] not in seen:
                seen[key[0]] = index
                members[index] = [None] * key[2]
                ids.append(index)
                names.append(key[0])
                index += 1
            members[seen[key[0]]][key[1]] = sd["state"].get(k)
        for at, parts in members.items():
            if parts[0] is not None:
                state[at] = {
                    s: (torch.cat([q[s].detach().cpu() for q in parts])
                        if torch.is_tensor(v) and v.dim() >= 1 else v)
                    for s, v in parts[0].items()}
        out = dict(saved, params=ids)
        if "names" in saved:
            out["names"] = names
        groups.append(out)
    return {"state": state, "param_groups": groups}


def load_optimizer_state_dict(model: nn.Module, optimizer: torch.optim.Optimizer,
                              sd: dict) -> None:
    """Load an unsharded-layout optimizer state (:func:`optimizer_state_dict`,
    or one saved at ``model_parallel`` 1) into ``model``'s optimizer, each
    sharded parameter's state split in dim 0 over its shards."""
    logical = _logical_params(model)
    if not logical:
        optimizer.load_state_dict(sd)
        return
    state, groups, index = {}, [], 0
    for group, saved in zip(optimizer.param_groups, sd["param_groups"]):
        saved_ids = iter(saved["params"])
        seen: Dict[str, int] = {}
        ids = []
        for p in group["params"]:
            key = logical.get(id(p))
            if key is None or key[0] not in seen:
                k = next(saved_ids)
                if key is not None:
                    seen[key[0]] = k
            else:
                k = seen[key[0]]
            entry = sd["state"].get(k)
            if entry is not None and key is not None:
                # every shard its own copy: Adam counts its step in place
                entry = {s: (v.chunk(key[2])[key[1]].clone() if torch.is_tensor(v) and v.dim()
                             else v.clone() if torch.is_tensor(v) else v)
                         for s, v in entry.items()}
            if entry is not None:
                state[index] = entry
            ids.append(index)
            index += 1
        out = dict(saved, params=ids)
        if "names" in group:
            out["names"] = list(group["names"])
        groups.append(out)
    optimizer.load_state_dict({"state": state, "param_groups": groups})
