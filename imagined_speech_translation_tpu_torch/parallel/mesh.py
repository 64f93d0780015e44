"""The mesh: its axis sizes, which rows a shard holds, the process group of
each axis, and the train state committed to the ranks.

Port of ``imagined_speech_translation_tpu.parallel.mesh``.  JAX lays one
program over a mesh of devices and XLA inserts the collectives; here a mesh
is a record of the axis sizes over the ranks of the process group (training,
one process a rank, ordered row-major as ``(dcn, data, model)``) or over the
devices of one process (serving, one model replica a device), and the
collectives are explicit (``parallel.data_parallel``,
``parallel.tensor_parallel``, ``parallel.context``).  The batch splits over
the ``data`` axis, jointly over ``("dcn", "data")`` when ``n_dcn > 1``:
shard ``dcn_idx * n_data + data_idx`` holds the contiguous rows of that
index, as JAX's ``("dcn", "data")`` spec orders them, and is replicated over
every other axis (``model``, or a ``seq`` axis of ``parallel.context``).
``channel_mask`` is replicated.

Tensor parallelism over ``model`` takes the JAX module's ``_TP_RULES``,
matched on the JAX path of each leaf (the port's modules carry the flax
names; a Dense ``weight`` is the flax ``kernel``) and laid onto the torch
layout: ``nn.Linear`` is ``(out, in)`` and ``RegionLinear`` ``(R, out,
in)``, so the flax kernel's last two entries swap.  The optimizer moments
mirror the parameters.  :func:`shard_train_state` keeps this rank's slice of
every sharded tensor of a full state.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn

from .distributed import process_count, process_index
from .tensor_parallel import TensorParallel

BATCH_AXES = ("dcn", "data")


@dataclass(frozen=True)
class Mesh:
    """Axis sizes and the mesh's entries, ``prod(sizes)`` of them in
    row-major order: rank numbers (a training mesh) or ``torch.device``\\ s
    of this process (a serving mesh)."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    devices: tuple

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def over_ranks(self) -> bool:
        return all(isinstance(d, int) for d in self.devices)

    @property
    def n_batch_shards(self) -> int:
        """The shards the batch splits into: the ``dcn`` and ``data`` axes."""
        return math.prod(n for a, n in self.shape.items() if a in BATCH_AXES)

    def batch_axes(self):
        return ("dcn", "data") if "dcn" in self.axis_names else "data"

    def coords(self, rank: int | None = None) -> dict[str, int]:
        """``rank``'s index on every axis (default: this process's)."""
        if not self.over_ranks:
            raise ValueError("a serving mesh has one shard per device, not per rank")
        rank = process_index() if rank is None else rank
        if rank not in self.devices:
            raise ValueError(f"rank {rank} is not on the mesh {self.devices}")
        pos, out = self.devices.index(rank), {}
        for name, n in reversed(list(zip(self.axis_names, self.sizes))):
            pos, out[name] = divmod(pos, n)
        return out

    def shard_index(self, rank: int | None = None) -> int:
        """The batch shard of ``rank`` (default: this process's)."""
        c = self.coords(rank)
        return c.get("dcn", 0) * self.shape.get("data", 1) + c.get("data", 0)

    def members(self, axes, rank: int | None = None) -> list[int]:
        """The ranks that differ from ``rank`` only on ``axes`` (a name or a
        tuple), in mesh order: ``rank``'s group along those axes."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        c = self.coords(rank)
        return [r for r in self.devices
                if all(v == c[a] for a, v in self.coords(r).items() if a not in axes)]

    def group(self, axes):
        """The process group of this rank along ``axes`` (None: the default
        group, when it holds every rank).  Every rank creates every group of
        those axes, in one order, the first time any of them is asked for:
        ``torch.distributed.new_group`` is collective."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        key = (self.devices, self.axis_names, self.sizes, axes)
        if key not in _GROUPS:
            blocks = {tuple(self.members(axes, r)) for r in self.devices}
            if len(blocks) == 1 and len(self.devices) == process_count():
                _GROUPS[key] = {r: None for r in self.devices}
            else:
                _GROUPS[key] = {}
                for block in sorted(blocks):
                    g = dist.new_group(list(block))
                    _GROUPS[key].update({r: g for r in block})
        return _GROUPS[key][process_index()]


_GROUPS: dict = {}


def make_mesh(
    n_data: int = -1,
    n_model: int = 1,
    *,
    n_dcn: int = 1,
    axis_names: tuple[str, str] = ("data", "model"),
    devices=None,
) -> Mesh:
    """A ``(data, model)`` mesh, ``(dcn, data, model)`` with ``n_dcn > 1``,
    over ``devices``: by default the ranks of the process group (one rank
    outside one); given devices (``"cuda:0"``, ``"cpu"``, repeats allowed)
    make a serving mesh of one replica each.  The sizes and errors are the
    JAX function's."""
    if devices is None:
        devices = list(range(process_count()))
    else:
        devices = [d if isinstance(d, int) else torch.device(d) for d in devices]
    n = len(devices)
    if n_data == -1:
        if n % (n_model * n_dcn):
            raise ValueError(f"{n} devices not divisible by model={n_model} x dcn={n_dcn}")
        n_data = n // (n_model * n_dcn)
    if n_dcn * n_data * n_model > n:
        raise ValueError(f"mesh {n_dcn}x{n_data}x{n_model} needs more than {n} devices")
    if n_model > 1 and not (devices and isinstance(devices[0], int)):
        raise ValueError("a serving mesh holds one replica a device; tensor parallelism "
                         "(n_model > 1) splits a training mesh's ranks")
    names = (("dcn",) if n_dcn > 1 else ()) + tuple(axis_names)
    sizes = ((n_dcn,) if n_dcn > 1 else ()) + (n_data, n_model)
    return Mesh(names, sizes, tuple(devices[: n_dcn * n_data * n_model]))


@dataclass(frozen=True)
class Sharding:
    """How a leaf lies on a mesh: per dimension ``None`` (whole) or the
    axis name(s) it splits over, as JAX's ``PartitionSpec``."""

    mesh: Mesh
    spec: tuple = ()


def replicate(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


# The JAX module's _TP_RULES: (path regex, flax PartitionSpec), matched on
# the JAX path of each leaf; first match wins, and only at the spec's rank.
_TP_RULES: tuple[tuple[str, tuple], ...] = (
    # BART decoder FFN: column- then row-parallel
    (r"bart/.*fc1/kernel$", (None, "model")),
    (r"bart/.*fc1/bias$", ("model",)),
    (r"bart/.*fc2/kernel$", ("model", None)),
    # attention projections: heads column-parallel, output row-parallel
    (r"bart/.*(q_proj|k_proj|v_proj)/kernel$", (None, "model")),
    (r"bart/.*(q_proj|k_proj|v_proj)/bias$", ("model",)),
    (r"bart/.*out_proj/kernel$", ("model", None)),
    # region-encoder wide projections (leading region axis at dim 0)
    (r"region_encoders/.*cnn_to_attn_fc1/kernel$", (None, None, "model")),
    (r"region_encoders/.*ffn\d/linear1/kernel$", (None, None, "model")),
    (r"region_encoders/.*ffn\d/gate/kernel$", (None, None, "model")),
    (r"region_encoders/.*ffn\d/linear2/kernel$", (None, "model", None)),
)


def _dense_modules(module: nn.Module) -> set[str]:
    """The state-dict prefixes of ``module``'s Dense layers."""
    from ..models.layers import RegionLinear

    return {name for name, m in module.named_modules()
            if isinstance(m, (nn.Linear, RegionLinear))}


def _tp_spec(key: str, ndim: int, dense: set[str]) -> tuple:
    """The torch-layout spec of the state-dict entry ``key`` under tensor
    parallelism: the first rule that matches its JAX path at its rank, with
    a Dense kernel's last two entries swapped; ``()`` (replicated) else."""
    prefix, _, leaf = key.rpartition(".")
    kernel = leaf == "weight" and prefix in dense
    path = prefix.replace(".", "/") + "/" + ("kernel" if kernel else leaf)
    for pattern, spec in _TP_RULES:
        if re.search(pattern, path):
            if len(spec) != ndim:
                return ()
            return spec[:-2] + (spec[-1], spec[-2]) if kernel else spec
    return ()


def state_sharding_tree(state, mesh: Mesh, *, tp: bool = False) -> dict[str, Sharding]:
    """How every tensor of the state lies on ``mesh``: keyed ``module.<key>``
    for the module's state dict, ``mu.<name>`` and ``nu.<name>`` for the
    optimizer moments.  Replicated, or with ``tp`` the JAX ``_TP_RULES`` in
    the torch layout, the moments mirroring their parameters."""
    sd = state.module.state_dict()
    dense = _dense_modules(state.module)
    specs = {k: _tp_spec(k, v.dim(), dense) if tp else () for k, v in sd.items()}
    tree = {f"module.{k}": Sharding(mesh, spec) for k, spec in specs.items()}
    opt = getattr(state, "opt_state", None)
    if opt is not None:
        for moment in ("mu", "nu"):
            tree.update({f"{moment}.{n}": Sharding(mesh, specs[n]) for n in getattr(opt, moment)})
    return tree


def batch_sharding(mesh: Mesh, batch: dict, *, batch_axis: int = 0) -> dict[str, Sharding]:
    """Shardings for a batch dict: the ``batch_axis`` of every leaf over the
    batch axes, ``channel_mask`` replicated."""

    def spec(k, v):
        if k == "channel_mask" or not hasattr(v, "ndim"):
            return replicate(mesh)
        axes: list = [None] * v.ndim
        axes[batch_axis] = mesh.batch_axes()
        return Sharding(mesh, tuple(axes))

    return {k: spec(k, v) for k, v in batch.items()}


def _rows(v, batch_axis: int, shard: int, n_shards: int):
    n = v.shape[batch_axis]
    if n % n_shards:
        raise ValueError(f"batch of {n} rows not divisible by the mesh's {n_shards} "
                         "batch shards")
    per = n // n_shards
    index = [slice(None)] * v.ndim
    index[batch_axis] = slice(shard * per, (shard + 1) * per)
    return v[tuple(index)]


def split_batch(mesh: Mesh, batch: dict, *, batch_axis: int = 0) -> list[dict]:
    """The batch's shards in mesh order, each with its contiguous rows;
    ``channel_mask`` (and any leaf without a shape) goes to every shard."""
    n = mesh.n_batch_shards
    return [
        {k: v if k == "channel_mask" or not hasattr(v, "ndim") else _rows(v, batch_axis, i, n)
         for k, v in batch.items()}
        for i in range(n)
    ]


def shard_batch(mesh: Mesh, batch: dict, *, batch_axis: int = 0, rank: int | None = None):
    """This rank's rows of ``batch`` (numpy arrays or tensors) on a training
    mesh: shard :meth:`Mesh.shard_index`; ``channel_mask`` whole."""
    i, n = mesh.shard_index(rank), mesh.n_batch_shards
    return {k: v if k == "channel_mask" or not hasattr(v, "ndim") else _rows(v, batch_axis, i, n)
            for k, v in batch.items()}


@torch.no_grad()
def broadcast_tensors(tensors, src: int = 0) -> None:
    """Overwrite contiguous ``tensors`` on every rank with rank ``src``'s,
    bit for bit: they travel as bytes, which every backend carries (gloo has
    no bfloat16)."""
    for t in tensors:
        dist.broadcast(t.view(-1).view(torch.uint8), src)


def shard_train_state(state, mesh: Mesh, *, tp: bool = False):
    """Commit a train state to a training mesh: every rank takes the first
    rank's parameters, BatchNorm statistics and optimizer moments, so the
    ranks start equal (JAX replicates the state with ``device_put``).  With
    ``tp`` each rank then keeps its slice, along the ``model`` axis, of every
    tensor that ``_TP_RULES`` shards (parameters and moments alike), and the
    state records the layout (``state.tensor_parallel``)."""
    if not mesh.over_ranks:
        raise ValueError("a train state is committed over the ranks of a training mesh")
    if process_count() > 1:
        opt = state.opt_state
        broadcast_tensors([*state.module.state_dict().values(), *opt.mu.values(),
                           *opt.nu.values()], src=mesh.devices[0])
    n_model = mesh.shape.get("model", 1)
    if not tp or n_model == 1:
        return state
    tree = state_sharding_tree(state, mesh, tp=True)
    dims = {k.removeprefix("module."): s.spec.index("model") for k, s in tree.items()
            if k.startswith("module.") and "model" in s.spec}
    layout = TensorParallel(mesh.coords()["model"], n_model, mesh.group("model"), dims)
    module, opt = state.module, state.opt_state
    for key in dims:
        prefix, _, leaf = key.rpartition(".")
        owner = module.get_submodule(prefix)
        whole = getattr(owner, leaf).detach()
        setattr(owner, leaf, nn.Parameter(layout.local(key, whole).clone()))
        opt.mu[key] = layout.local(key, opt.mu[key]).clone()
        opt.nu[key] = layout.local(key, opt.nu[key]).clone()
    state.tensor_parallel = layout
    return state
