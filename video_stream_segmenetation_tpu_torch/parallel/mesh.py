"""Device mesh and sharding (port of ``parallel/mesh.py``): stream-batch
data parallelism over CUDA devices.

Streams are independent, so the scale-out shards the leading stream axis S
over the mesh's ``data`` axis and replicates the models.  A serving step
crosses devices in two places only: the face path's cadence counts (one
scalar a shard, runtime/pipeline.py::face_selections) and the outputs,
concatenated in slot order on the mesh's first device (the recovery
snapshots go to the host shard by shard).  The data-parallel
trainer sums its replicas' gradients in shard order (:func:`reduce_sum`).
The ``model`` axis is a replica axis, as the reference's (it keeps it size
1): each data row's work runs on that row's first device.

A mesh may name one device more than once, ``make_mesh(4,
devices=[torch.device("cuda", 0)] * 4)`` or the CPU eight times: virtual
shards, the port's form of the reference's
``--xla_force_host_platform_device_count``, which run the sharded logic
for real on one device.

This module is the one place that knows about devices, as the reference's
is.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


def resolve_device(device) -> torch.device:
    """``cuda`` (the port's default) must have a card; the CPU only on
    request.  A CUDA device without an index is the current one."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch.cuda.is_available() is False; "
                               "pass device='cpu' to run the plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(n_data, n_model)`` grid of devices (:func:`make_mesh`)."""

    grid: tuple  # n_data rows of n_model torch.devices

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: len(self.grid), MODEL_AXIS: len(self.grid[0])}

    @property
    def data_devices(self) -> tuple:
        """Each data shard's device: its row's first."""
        return tuple(row[0] for row in self.grid)

    @property
    def devices(self) -> tuple:
        """The distinct devices the shards run on, in shard order."""
        return tuple(dict.fromkeys(self.data_devices))

    @property
    def first(self) -> torch.device:
        return self.grid[0][0]


def make_mesh(n_data: int | None = None, n_model: int = 1, devices=None) -> Mesh:
    """A mesh over the given devices, by default every visible CUDA device
    (with none, it raises as :func:`resolve_device` does: no CPU fallback).
    ``devices`` may repeat a device (virtual shards)."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > len(devices):
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs {n_data * n_model} devices, "
                         f"got {len(devices)}")
    use = devices[: n_data * n_model]
    return Mesh(tuple(tuple(use[i * n_model:(i + 1) * n_model]) for i in range(n_data)))


def stream_sharding(mesh: Mesh, n: int) -> list[tuple[int, int]]:
    """Each data shard's contiguous row range ``[a, b)`` of an ``n``-stream
    axis; ``n`` must divide over the data axis."""
    n_data = mesh.shape[DATA_AXIS]
    if n % n_data:
        raise ValueError(f"{n} streams do not divide over the mesh 'data' axis "
                         f"({n_data} shards)")
    per = n // n_data
    return [(i * per, (i + 1) * per) for i in range(n_data)]


def replicated(mesh: Mesh) -> tuple:
    """The devices a replicated tree lives on."""
    return mesh.devices


def tree_map(fn, tree):
    """``fn`` over every tensor of ``tree`` (dataclasses such as StreamState
    and PipelineKnobs, dicts, tuples, lists); other leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: tree_map(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def shard_stream_tree(mesh: Mesh, tree, axis: int = 0) -> list:
    """``tree``'s tensors split on their stream axis ``axis`` into each data
    shard's rows, each shard's copy on its device (a mesh of one shard:
    the tree itself, on its device)."""
    devs = mesh.data_devices
    n = None

    def split(t):
        nonlocal n
        n = t.shape[axis]
        return t

    tree_map(split, tree)
    ranges = stream_sharding(mesh, n)
    if len(ranges) == 1:
        return [tree_map(lambda t: t.to(devs[0], non_blocking=True), tree)]
    return [tree_map(lambda t, a=a, b=b, d=d: t.narrow(axis, a, b - a).to(
        d, non_blocking=True, copy=True), tree) for (a, b), d in zip(ranges, devs)]


def gather_stream_tree(parts: list, device):
    """The inverse of :func:`shard_stream_tree` on axis 0: the shards'
    trees as one, rows in shard order, on ``device`` (one shard: its tree
    as it is, where it already lives there)."""
    cols = zip(*(_leaves(p) for p in parts))
    whole = iter([gather_rows(list(c), device) for c in cols])
    return tree_map(lambda _: next(whole), parts[0])


def _leaves(tree) -> list:
    """``tree``'s tensors in :func:`tree_map`'s order."""
    out = []
    tree_map(lambda t: out.append(t) or t, tree)
    return out


def shard_replicas(mesh: Mesh, module: torch.nn.Module) -> list:
    """``module`` for each data shard: itself on the first (it must live on
    the mesh's first device), a deep copy on each other shard's device --
    a virtual shard's too, so that each shard's gradient is its own."""
    first = next(module.parameters()).device
    if first != mesh.first:
        raise ValueError(f"the module is on {first}, the mesh's first device is {mesh.first}")
    return [module] + [copy.deepcopy(module).to(d) for d in mesh.data_devices[1:]]


def replicate_tree(mesh: Mesh, tree) -> dict:
    """``{device: tree on it}`` for every distinct device of the mesh (numpy
    leaves become tensors); a tensor already there is used as it is."""
    def put(dev):
        def one(t):
            return t.to(dev, non_blocking=True)
        return tree_map(one, _as_tensors(tree))

    return {dev: put(dev) for dev in replicated(mesh)}


def _as_tensors(tree):
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree)
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_as_tensors(v) for v in tree)
    return tree


def gather_rows(parts: list, device) -> torch.Tensor:
    """Row blocks in order, concatenated on ``device`` (one block: as it
    is, where it is already)."""
    if len(parts) == 1 and parts[0].device == device:
        return parts[0]
    return torch.cat([p.to(device, non_blocking=True) for p in parts])


def data_parallel_forward(mesh: Mesh, replicas: list, batch: int):
    """A model's forward over the mesh's data shards, for calls whose
    leading axis is ``batch`` (any other raises ValueError: a loss that
    calls the model on part of the batch would train another function):
    the call's tensors split on that axis (:func:`shard_stream_tree`), each
    shard's rows through its replica (:func:`shard_replicas`), and every
    output gathered in shard order on the first device
    (:func:`gather_stream_tree`).  Each replica runs its class's own
    forward, so the result may be installed on ``replicas[0]``
    (:func:`installed_forward`) without calling itself."""
    forwards = [functools.partial(type(r).forward, r) for r in replicas]

    def forward(x, *args, **kwargs):
        if x.shape[0] != batch:
            raise ValueError(f"the model was called on {x.shape[0]} rows of a step made "
                             f"for a batch of {batch}")
        parts = shard_stream_tree(mesh, (x, args, kwargs))
        outs = [f(px, *pa, **pk) for f, (px, pa, pk) in zip(forwards, parts)]
        return gather_stream_tree(outs, mesh.first)

    return forward


@contextlib.contextmanager
def installed_forward(module: torch.nn.Module, forward):
    """``module(...)`` calls ``forward`` inside the context (an attribute of
    the instance over its class's method), and its own forward after."""
    module.forward = forward
    try:
        yield module
    finally:
        del module.forward


def reduce_sum(tensors: list, device) -> torch.Tensor:
    """The sum of ``tensors`` on ``device``, added in list (shard) order:
    the same order on every run and device."""
    acc = tensors[0].to(device, non_blocking=True)
    for t in tensors[1:]:
        acc = acc + t.to(device, non_blocking=True)
    return acc


def exclusive_prefix(counts: list, devices) -> list:
    """Per shard, the sum of the shards' ``counts`` before it (scalar
    tensors, each on its shard's device), on that shard's device: the
    running sum moves one device on at a time, with non-blocking copies
    and no host synchronisation."""
    out, acc = [], None
    for c, dev in zip(counts, devices):
        out.append(torch.zeros_like(c, device=dev) if acc is None
                   else acc.to(dev, non_blocking=True))
        acc = c if acc is None else out[-1] + c
    return out


def on_device(device):
    """A context in which ``device`` is the current CUDA device (the
    kernels' C entry points launch on the current device's context; the
    CPU needs none)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def sharded_step(mesh: Mesh, step_for):
    """A step over the mesh's data shards: ``run(shard_args, shard_kwargs=
    None, shards=None) -> [result a shard]`` calls ``step_for(device)`` (the
    step on that device's replicas) with each shard's arguments, on that
    device (:func:`on_device`), one shard after the other from this thread,
    with no host synchronisation between them.  ``shards``: the data shards
    the arguments are for, in order (all by default; a step over some rows
    runs on the shards that hold them)."""
    devs = mesh.data_devices

    def run(shard_args, shard_kwargs=None, shards=None):
        shards = range(len(devs)) if shards is None else shards
        kws = shard_kwargs or [{}] * len(shard_args)
        out = []
        for j, args, kw in zip(shards, shard_args, kws):
            with on_device(devs[j]):
                out.append(step_for(devs[j])(*args, **kw))
        return out

    return run
