"""The device mesh: shards, replicas and the reductions between them.

Port of ``sonicsim_tpu.parallel.mesh`` (the reference's DDP data
parallelism, separation/train.py:91). The JAX mesh is single-controller:
one process holds every device, a ``mesh=`` call returns the whole result
and ``Trainer(n_devices=2)`` trains in that process. The port keeps that
contract, with no process group:

* a :class:`Mesh` is a tuple of ``torch.device``s, which may repeat a
  device: ``(cpu,) * 8`` stands for the JAX tests' eight virtual CPU
  devices, ``(cuda:0,) * 2`` for two replicas on one card;
* :func:`shard_batch` splits a tensor's leading axis, one shard per
  device, by the sizes :func:`shard_slices` gives. Torch needs no static
  shapes, so a shard may be one item shorter than another (or empty) where
  the mesh does not divide the axis, instead of padded;
* :func:`replicate` makes one replica of a module per device whose
  parameters and buffers are differentiable copies of the primary's (the
  tensor itself where the device is the primary's), so one backward sums
  every replica's gradient into the primary's parameters;
* :func:`parallel_apply` runs the replicas concurrently, one thread each,
  inside a replica context, with the caller's grad mode, inference mode,
  autocast and intra-op thread count;
* what XLA's collectives do becomes copies to one device and a reduction
  there: :func:`all_reduce_sum` (``psum``) for the replicas of a running
  :func:`parallel_apply`, :func:`reduce_max` (``pmax``) and :func:`gather`
  (a sharded result read whole) for the caller.

The mesh has one axis, the data axis, and no name for it: the JAX mesh's
axis name feeds ``shard_map`` and ``PartitionSpec``, which the port does
not have. ``batch_sharding`` and ``replicated_sharding`` name XLA
shardings, which have no torch meaning either, and are left out.
"""

from __future__ import annotations

import threading
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Sequence

import torch
import torch.nn as nn


@dataclass(frozen=True)
class Mesh:
    """A one-axis mesh of devices; the first holds the primary weights and
    the gathered results."""

    devices: tuple

    def __init__(self, devices: Sequence):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def primary(self) -> torch.device:
        return self.devices[0]


def available_devices(device_type: str = "cuda") -> list:
    """The devices of ``device_type`` this process sees: each card, or the
    one CPU (as JAX has one CPU device without the XLA flag)."""
    if device_type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


def make_mesh(n_devices: int | None = None) -> Mesh:
    """The first ``n_devices`` cards (every card by default), as
    ``jax.devices()[:n]``. Raises where there is no card: build a
    :class:`Mesh` of CPU devices directly for the CPU."""
    devices = available_devices("cuda")
    if not devices:
        raise RuntimeError("make_mesh: no CUDA device; build a Mesh of CPU devices "
                           "directly for the CPU")
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices)


def _shard_bounds(n: int, size: int) -> list:
    """``(start, stop)`` of each of ``size`` contiguous shards of an axis of
    ``n``, in order: ``torch.tensor_split``'s sizes, which differ by at most
    one."""
    out, start = [], 0
    for i in range(size):
        stop = start + n // size + (i < n % size)
        out.append((start, stop))
        start = stop
    return out


def shard_slices(n: int, mesh: Mesh) -> list:
    """``(device, slice)`` of each non-empty shard :func:`shard_batch` cuts
    an axis of ``n`` into, in mesh order."""
    return [(device, slice(a, b))
            for device, (a, b) in zip(mesh.devices, _shard_bounds(n, mesh.size)) if b > a]


def shard_batch(batch: torch.Tensor, mesh: Mesh) -> list:
    """One shard of ``batch`` per device of the mesh, on that device: its
    leading axis cut as :func:`shard_slices` cuts it (a shard may be
    empty)."""
    return [batch[a:b].to(device)
            for device, (a, b) in zip(mesh.devices, _shard_bounds(len(batch), mesh.size))]


def replicate(module: nn.Module, mesh: Mesh, state: dict | None = None) -> list:
    """One replica of ``module`` (whose parameters lie on the mesh's first
    device) per device of the mesh: shallow module copies whose parameters
    and buffers are ``.to(device)`` of the primary's, the same tensor on the
    primary's device, a differentiable copy elsewhere. Autograd then sums
    every replica's gradient into the primary's parameters in one backward.
    ``state`` maps qualified names to tensors that stand in for the module's
    own (the cast state of ``infer.precision.cast_state``). A replica's
    plain tensor attributes move to its device too."""
    override = {}
    if state:
        named = dict(module.named_parameters())
        named.update(module.named_buffers())
        override = {id(named[k]): v for k, v in state.items() if k in named}
    copies: dict = {}

    def on(t, device):
        if t is None:
            return None
        src = override.get(id(t), t)
        key = (id(t), device)
        if key not in copies:
            copies[key] = src.to(device)
        return copies[key]

    replicas = []
    for device in mesh.devices:
        made: dict = {}
        for m in module.modules():
            r = m._replicate_for_data_parallel()
            made[id(m)] = r
        for m in module.modules():
            r = made[id(m)]
            for name, sub in m._modules.items():
                r._modules[name] = None if sub is None else made[id(sub)]
            for name, p in m._parameters.items():
                # a plain attribute: a replica holds no parameters of its own
                # (RNNBase.__setattr__ keeps its flat weight list in step)
                setattr(r, name, on(p, device))
            for name, b in m._buffers.items():
                r._buffers[name] = on(b, device)
            for name, v in list(vars(r).items()):
                if torch.is_tensor(v) and v.device != device:
                    setattr(r, name, v.to(device))
        replicas.append(made[id(module)])
    return replicas


class _Group:
    """The replicas of one :func:`parallel_apply`: a barrier and one slot
    per replica for the values they exchange."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n)
        self.slots: list = [None] * n

    def exchange(self, index: int, value) -> list:
        """Every replica's ``value``, in replica order (all replicas must
        call it the same number of times, in the same order)."""
        self.slots[index] = value
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()  # nobody writes the next values before all read these
        return out


@dataclass
class ReplicaContext:
    group: _Group
    index: int
    device: torch.device


_local = threading.local()


def replica_context() -> ReplicaContext | None:
    """The context of the replica this thread runs, or None outside
    :func:`parallel_apply`."""
    return getattr(_local, "ctx", None)


def all_reduce_sum(x):
    """``psum`` over the replicas of the running :func:`parallel_apply`: the
    sum of every replica's ``x`` (a tensor, or a Python number), in replica
    order (so every replica gets the same bits), on this replica's device.
    Differentiable: the gradient of each replica's sum reaches every
    replica's ``x``."""
    ctx = replica_context()
    if ctx is None:
        raise RuntimeError("all_reduce_sum outside a replica context (parallel_apply)")
    parts = ctx.group.exchange(ctx.index, x)
    if not torch.is_tensor(x):
        return sum(parts)
    total = parts[0].to(ctx.device)
    for p in parts[1:]:
        total = total + p.to(ctx.device)
    return total


def reduce_max(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """``pmax``: the elementwise maximum of per-shard tensors, on ``device``."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = torch.maximum(out, p.to(device))
    return out


def gather(outs: Sequence, device) -> Any:
    """Per-shard outputs (tensors, or tuples and lists of them) concatenated
    on their leading axis on ``device``: the sharded result read whole."""
    first = outs[0]
    if isinstance(first, (tuple, list)):
        return type(first)(gather([o[i] for o in outs], device) for i in range(len(first)))
    return torch.cat([o.to(device) for o in outs])


def parallel_apply(replicas: Sequence, inputs: Sequence, mesh: Mesh) -> list:
    """``replicas[i](inputs[i])`` on ``mesh.devices[i]``, all at once, one
    thread each (the replicas of a batch-statistics model meet at their
    norms, :func:`all_reduce_sum`). Each thread runs in the caller's grad
    mode, inference mode, autocast and intra-op thread count, and in a
    :class:`ReplicaContext`. The first exception of any replica is raised
    here, after every thread has ended."""
    n = len(replicas)
    if not n == len(inputs) == mesh.size:
        raise ValueError(f"{n} replicas, {len(inputs)} inputs, a mesh of {mesh.size}")
    group = _Group(n)
    grad = torch.is_grad_enabled()
    inference = torch.is_inference_mode_enabled()
    n_threads = torch.get_num_threads()
    autocast = {t: (torch.is_autocast_enabled(t), torch.get_autocast_dtype(t))
                for t in {d.type for d in mesh.devices}}
    results: list = [None] * n
    errors: list = [None] * n

    def work(i: int) -> None:
        device = mesh.devices[i]
        _local.ctx = ReplicaContext(group, i, device)
        done = False
        try:
            torch.set_num_threads(n_threads)
            on, dtype = autocast[device.type]
            scope = torch.cuda.device(device) if device.type == "cuda" else nullcontext()
            with torch.inference_mode(inference), torch.set_grad_enabled(grad), \
                    torch.autocast(device.type, dtype=dtype, enabled=on), scope:
                results[i] = replicas[i](inputs[i])
            done = True
        except Exception as e:  # raised again by the caller
            errors[i] = e
        finally:
            _local.ctx = None
            if not done:
                group.barrier.abort()  # release the replicas waiting at a norm

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    first = next((e for e in errors if e is not None and
                  not isinstance(e, threading.BrokenBarrierError)), None)
    first = first or next((e for e in errors if e is not None), None)
    if first is not None:
        raise first
    return results


def data_parallel(module: nn.Module, batch: torch.Tensor, mesh: Mesh,
                  state: dict | None = None):
    """``module(batch)`` computed by its replicas over ``mesh``: the batch
    sharded, the replicas run at once, their outputs gathered on the mesh's
    first device (where ``module``'s parameters must lie)."""
    replicas = replicate(module, mesh, state)
    return gather(parallel_apply(replicas, shard_batch(batch, mesh), mesh), mesh.primary)

