"""Across-track batching and the device mesh of a sharded likelihood.

Port of smoothsde_tpu/parallel/batching.py. Tracks are independent, so
the likelihood is a sum of per-track terms: a flat multi-track dataset is
packed into a padded (n_tracks, track_len, ...) batch, and a per-track
likelihood is evaluated on each track and summed.

The mesh is single-controller, as a JAX `Mesh` under `shard_map` is: one
process drives every device of it. `Mesh` holds a tuple of
`torch.device`s (repeats allowed: several shards on one device) and the
axis names; a shard's tensors live on its device, launches on distinct
cards stay asynchronous (the shards run concurrently; on one card in
turn), and what crosses shards is an explicit copy (parallel/dist.py).
It is not built on multi-process torch.distributed: NCCL refuses two
ranks on one card and gloo reduces no more than broadcast / all_reduce
of CUDA tensors, so a multi-rank run could not be held to the flat
likelihood on one card, and `SDE.fit(mesh=...)` stays one call. The JAX
package's multi-host ("dcn", axis) mesh needs several processes and is
not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


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
    """A one-dimensional device mesh: `devices` (a tuple of
    torch.device, one per shard; repeats allowed) along the axis
    `axis_names[0]`. `shape[axis]` is the shard count, as for
    jax.sharding.Mesh."""

    def __init__(self, devices, axis_names=("tracks",)):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != 1 or not self.devices:
            raise ValueError("a Mesh has one axis and at least one device")
        self.shape = {self.axis_names[0]: len(self.devices)}

    @property
    def n_cards(self) -> int:
        """Distinct devices the shards live on."""
        return len(set(self.devices))

    def __repr__(self):
        return f"Mesh({list(map(str, self.devices))}, {self.axis_names})"


def make_mesh(n_devices: Optional[int] = None, axis: str = "tracks",
              device=None) -> Mesh:
    """A mesh over the first `n_devices` visible cards (all of them if
    None), or, with `device` ("cpu", "cuda:0", ...), `n_devices` shards
    (1 if None) on that one device: the counterpart of the JAX tests'
    virtual CPU devices (--xla_force_host_platform_device_count)."""
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


def auto_mesh(axis: str = "tracks", device=None) -> Mesh:
    """A mesh over every device of the kind of `device`: every visible
    card for None or a CUDA device, the one CPU for "cpu"
    (`SDE.fit(mesh="auto")` passes the model's device)."""
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
    into mesh.shape[axis] contiguous shards: a list with one tuple of the
    same type per shard, each on its shard's device."""
    n_shards = mesh.shape[axis]
    leaves = list(tree)
    sizes = shard_sizes(leaves[0].shape[0], n_shards)
    parts = [x.split(sizes) for x in leaves]
    return [type(tree)(*(p[r].to(mesh.devices[r]) for p in parts))
            for r in range(n_shards)]


def batched_loglik(per_track_loglik, packed, *args):
    """The sum over tracks of per_track_loglik(obs_k, times_k, length_k,
    *args) -> 0-d tensor, for a PackedTracks or the shards of
    `shard_batch` (each shard's sum on its device, the total on the first
    shard's). A Python loop over the tracks: a per-track likelihood may
    branch on its data."""
    shards = [packed] if isinstance(packed, PackedTracks) else list(packed)
    out = shards[0].obs.device
    total = []
    for sh in shards:
        vals = [per_track_loglik(o, t, m, *args)
                for o, t, m in zip(sh.obs, sh.times, sh.lengths)]
        if vals:
            total.append(torch.stack(vals).sum().to(out))
    return torch.stack(total).sum()
