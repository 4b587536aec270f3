"""Across-track batching and the device mesh of a sharded likelihood.

Port of smoothsde_tpu/parallel/batching.py. Tracks are independent, so
the likelihood is a sum of per-track terms: a flat multi-track dataset is
packed into a padded (n_tracks, track_len, ...) batch, and a per-track
likelihood is evaluated on each track and summed.

The mesh is single-controller within a process, as a JAX `Mesh` under
`shard_map` is: one process drives every device of it. `Mesh` holds a
tuple of this process's `torch.device`s (repeats allowed: several shards
on one device) and the axis names; a shard's tensors live on its device,
launches on distinct cards stay asynchronous (the shards run
concurrently; on one card in turn), and what crosses shards is an
explicit copy (parallel/dist.py). A ("dcn", axis) mesh adds an outer
axis over the processes of an initialized torch.distributed process
group (the JAX package's multi-host mesh, `auto_mesh` under several
processes): every process holds the whole data and the replicated
parameters, evaluates its own shards on its own devices, and the sums
and the time chunks' totals cross processes through the collectives of
parallel/collectives.py (gloo, on host copies of a few KB).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from smoothsde_tpu_torch.parallel.collectives import Processes, gather_plain


class PackedTracks(NamedTuple):
    """Padded per-track tensors. Padding rows carry NaN observations and
    lie past each track's length, so they never contribute likelihood."""

    obs: torch.Tensor  # (K, L, d)
    times: torch.Tensor  # (K, L)
    lengths: torch.Tensor  # (K,)


def pack_tracks(obs, times, ids, pad_multiple: int = 128, *,
                dtype=torch.float64, device="cuda") -> PackedTracks:
    """Split a flat (n, d) multi-track dataset into a padded batch on
    `device`. Time continues linearly into the padding (+1 a slot) so
    that dt stays positive."""
    obs = np.asarray(obs, float)
    times = np.asarray(times, float)
    ids = np.asarray(ids)
    starts = np.concatenate([[0], np.where(ids[1:] != ids[:-1])[0] + 1,
                             [len(ids)]])
    K = len(starts) - 1
    L = int(np.max(np.diff(starts)))
    L = -(-L // pad_multiple) * pad_multiple
    obs_p = np.full((K, L, obs.shape[1]), np.nan)
    t_p = np.zeros((K, L))
    lens = np.diff(starts)
    for k in range(K):
        s, e = starts[k], starts[k + 1]
        obs_p[k, : e - s] = obs[s:e]
        t_p[k, : e - s] = times[s:e]
        t_p[k, e - s:] = times[e - 1] + 1.0 + np.arange(L - (e - s))
    return PackedTracks(
        torch.as_tensor(obs_p, dtype=dtype, device=device),
        torch.as_tensor(t_p, dtype=dtype, device=device),
        torch.as_tensor(lens, device=device),
    )


class Mesh:
    """A device mesh: `devices` (a tuple of torch.device, this process's
    shards; repeats allowed) along the axis `axis_names[-1]`, and with
    axis_names ("dcn", axis) an outer axis over the processes of the
    default torch.distributed group (`processes`, a
    collectives.Processes; every process builds the mesh, with as many
    shards as every other). `shape` maps each axis to its length, as for
    jax.sharding.Mesh: {"dcn": processes, axis: this process's shards}. The shards are numbered process-major: this
    process's are `shard_offset` .. `shard_offset` + shape[axis] - 1 of
    `n_shards`."""

    def __init__(self, devices, axis_names=("tracks",)):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        dcn = self.axis_names[:1] == ("dcn",)
        if len(self.axis_names) != 1 + dcn or not self.devices:
            raise ValueError("a Mesh has one axis, or ('dcn', axis), and at "
                             "least one device")
        self.processes = None
        if dcn:
            self.processes = Processes()
            counts = gather_plain(torch.tensor([len(self.devices)]), 0,
                                  self.processes)
            if not bool((counts == len(self.devices)).all()):
                raise ValueError(f"the processes hold {counts.tolist()} "
                                 "shards: a ('dcn', axis) mesh needs the "
                                 "same number in every process")
        self.shape = {self.axis: len(self.devices)}
        if dcn:
            self.shape = {"dcn": self.processes.size, **self.shape}

    @property
    def axis(self) -> str:
        """The shards' axis (the inner one of a ("dcn", axis) mesh)."""
        return self.axis_names[-1]

    @property
    def n_proc(self) -> int:
        return self.shape.get("dcn", 1)

    @property
    def n_shards(self) -> int:
        """Shards over every process."""
        return self.n_proc * len(self.devices)

    @property
    def shard_offset(self) -> int:
        """The number of this process's first shard."""
        rank = self.processes.rank if self.processes is not None else 0
        return rank * len(self.devices)

    @property
    def n_cards(self) -> int:
        """Distinct devices this process's shards live on."""
        return len(set(self.devices))

    def __repr__(self):
        return f"Mesh({list(map(str, self.devices))}, {self.axis_names})"


def make_mesh(n_devices: Optional[int] = None, axis: str = "tracks",
              device=None) -> Mesh:
    """A one-process mesh over the first `n_devices` visible cards (all
    of them if None), or, with `device` ("cpu", "cuda:0", ...),
    `n_devices` shards (1 if None) on that one device: the counterpart of
    the JAX tests' virtual CPU devices
    (--xla_force_host_platform_device_count)."""
    if device is not None:
        return Mesh([device] * (1 if n_devices is None else n_devices),
                    (axis,))
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                           "device='cpu' for a mesh on the CPU")
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"make_mesh: {n} devices asked, {count} visible")
    return Mesh([torch.device("cuda", i) for i in range(n)], (axis,))


def _local_devices(device):
    """This process's devices in a multi-process mesh: the one CPU for
    "cpu", the one card of an indexed CUDA device ("cuda:1"), every
    visible card for None or "cuda"."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cpu" or device.index is not None:
            return [device]
    return list(make_mesh(None).devices)


def auto_mesh(axis: str = "tracks", device=None) -> Mesh:
    """A mesh over every device of the kind of `device`: every visible
    card for None or a CUDA device, the one CPU for "cpu"
    (`SDE.fit(mesh="auto")` passes the model's device). Under an
    initialized torch.distributed group of more than one process, a
    ("dcn", axis) mesh of shape (processes, this process's devices,
    `_local_devices`): the JAX package's multi-host layout, the outer
    axis across processes, each process's shards on its own devices."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return Mesh(_local_devices(device), ("dcn", axis))
    if device is not None and torch.device(device).type == "cpu":
        return make_mesh(1, axis, device="cpu")
    return make_mesh(None, axis)


def shard_sizes(n: int, n_shards: int):
    """Contiguous shard sizes of n items: as equal as possible, the
    larger first (numpy.array_split's)."""
    q, r = divmod(n, n_shards)
    return [q + 1] * r + [q] * (n_shards - r)


def shard_batch(tree, mesh: Mesh, axis: str = "tracks"):
    """Split a PackedTracks-style tuple of tensors along its leading axis
    into mesh.n_shards contiguous shards: a list with one tuple of the
    same type for each of this process's shards, each on its shard's
    device (every shard on a one-process mesh)."""
    if axis != mesh.axis:
        raise ValueError(f"mesh has no shard axis {axis!r}")
    leaves = list(tree)
    sizes = shard_sizes(leaves[0].shape[0], mesh.n_shards)
    parts = [x.split(sizes) for x in leaves]
    off = mesh.shard_offset
    return [type(tree)(*(p[off + r].to(dev) for p in parts))
            for r, dev in enumerate(mesh.devices)]


def batched_loglik(per_track_loglik, packed, *args):
    """The sum over tracks of per_track_loglik(obs_k, times_k, length_k,
    *args) -> 0-d tensor, for a PackedTracks or the shards of
    `shard_batch` (each shard's sum on its device, the total on the first
    shard's; on a ("dcn", axis) mesh this process's shards' sum, which
    parallel/collectives.process_sum adds up). A Python loop over the
    tracks: a per-track likelihood may branch on its data."""
    shards = [packed] if isinstance(packed, PackedTracks) else list(packed)
    out = shards[0].obs.device
    total = []
    for sh in shards:
        vals = [per_track_loglik(o, t, m, *args)
                for o, t, m in zip(sh.obs, sh.times, sh.lengths)]
        if vals:
            total.append(torch.stack(vals).sum().to(out))
    return torch.stack(total).sum()
