"""The env-slice rule and the cross-env reducers: the port's
``tacex_tpu/parallel/mesh.py``.

JAX shards every leaf whose leading dim equals ``num_envs`` and replicates
the rest, which costs it nothing: a replicated leaf stays whole on every
device. Here a rank holds only its own envs, and the shape alone does not
say how to cut a leaf: the Grasp-Lift sensor's 2N pad images are pad-major
(``torch.cat([left, right])``), so a rank's pads are two separate runs of
rows, and a leaf may lead with N by coincidence (8 bodies at 8 envs). So
each state class says how its fields are cut: its class attribute
``ENV_LAYOUT`` names the fields that do not lead with the env axis, and
every other tensor field does (checked when sliced).

The reducers take an ``EnvGroup`` (``parallel/group.py``) and always issue
their collective, at world size 1 too; with ``group=None`` (one process
holding every env) the collective is the identity, so the plain trainers
and envs run the same arithmetic as a rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

ENV = "env"  # leads with the env axis: a rank takes rows [start, stop)
PAD_MAJOR = "pad_major"  # leads with 2N, left pads then right pads: rows [start, stop) of each half
REPLICATED = "replicated"  # no env axis: the same on every rank


def _map_state(tree, leaf_fn, rule: str = ENV):
    """``leaf_fn(tensor, rule)`` over a state (nested frozen dataclasses) or
    a dict of env-leading tensors, with each leaf's rule from its class's
    ``ENV_LAYOUT`` (no entry: ``ENV``); a field under a non-env rule passes
    it to its leaves."""
    if isinstance(tree, torch.Tensor):
        return leaf_fn(tree, rule)
    if isinstance(tree, dict):
        return {k: _map_state(v, leaf_fn, rule) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        layout = getattr(type(tree), "ENV_LAYOUT", {}) if rule == ENV else {}
        fields = {f.name: _map_state(getattr(tree, f.name), leaf_fn, layout.get(f.name, rule))
                  for f in dataclasses.fields(tree)}
        return dataclasses.replace(tree, **fields)
    return tree  # None and host constants


def slice_envs(state, start: int, stop: int, num_envs: int):
    """Envs ``[start, stop)`` of a state (or observation dict) of
    ``num_envs`` envs."""
    big, lo, hi = num_envs, start, stop

    def cut(x, rule):
        if rule == REPLICATED:
            return x
        lead = 2 * big if rule == PAD_MAJOR else big
        if x.ndim == 0 or x.shape[0] != lead:
            raise ValueError(f"a {rule} leaf must lead with {lead} rows, got shape {tuple(x.shape)}")
        if rule == PAD_MAJOR:
            return x.reshape((2, big) + tuple(x.shape[1:]))[:, lo:hi].reshape((-1,) + tuple(x.shape[1:]))
        return x[lo:hi]

    return _map_state(state, cut)


def shard_env_state(state, group):
    """This rank's slice of a global env state (or observation dict)."""
    return slice_envs(state, group.start, group.stop, group.num_envs)


def gather_env_state(state, group):
    """The global state from every rank's slice, in global env order: the
    inverse of ``shard_env_state``."""

    def join(x, rule):
        if rule == REPLICATED:
            return x
        if rule == PAD_MAJOR:
            pads = x.reshape((2, group.local_envs) + tuple(x.shape[1:]))
            return all_gather_envs(pads, group, dim=1).reshape((-1,) + tuple(x.shape[1:]))
        return all_gather_envs(x, group)

    return _map_state(state, join)


# ------------------------------------------------------------------ reducers


def world_size(group) -> int:
    """The number of ranks (1 with no group)."""
    return 1 if group is None else group.world_size


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks (a new tensor; ``x`` itself with no group)."""
    if group is None:
        return x
    out = x.detach().clone().reshape(-1)
    dist.all_reduce(out)
    return out.reshape(x.shape)


def all_reduce_flat(tensors, group) -> list[torch.Tensor]:
    """The sums over the ranks of a list of f32 tensors, as one all-reduce of
    their concatenation: contiguous views of one buffer, with no group too.
    (Autograd gives a convolution's weight gradient channels-last, and the
    foreach kernels that read a list holding one round otherwise than on
    contiguous tensors: one layout keeps one result, with or without a group.)"""
    tensors = list(tensors)
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    if group is not None:
        dist.all_reduce(flat)
    return [s.reshape(t.shape) for s, t in zip(torch.split(flat, [t.numel() for t in tensors]), tensors)]


def mean_over_envs(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of every element of ``x`` (leading with the rank's envs) over
    every rank's envs: a sum divided by the global count. No host read."""
    return all_reduce_sum(x.sum(), group) / (x.numel() * world_size(group))


def moments(x: torch.Tensor, group) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, biased variance) of every element of ``x`` over every rank's
    envs, in two passes as ``torch.var`` takes them."""
    mean = mean_over_envs(x, group)
    return mean, mean_over_envs((x - mean) ** 2, group)


def mean_over_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """The mean over the ranks of per-rank values (each rank's mean over its
    own envs: equal env counts make it the global mean)."""
    return all_reduce_sum(x, group) / world_size(group)


def all_gather_envs(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` joined along ``dim`` (its env axis), in global env order."""
    if group is None:
        return x
    send = x.contiguous()
    if send.dtype == torch.bool:  # not every backend reduces or gathers bool
        send = send.to(torch.uint8)
    parts = [torch.empty_like(send) for _ in range(group.world_size)]
    dist.all_gather(parts, send)
    return torch.cat(parts, dim=dim).to(x.dtype)


def bind_env(env, group) -> int:
    """A trainer's env under ``group`` (None: the plain trainer's): checks
    that it holds the rank's slice, makes its curriculum global, and returns
    the env count over every rank."""
    if group is None:
        return env.cfg.num_envs
    if env.cfg.num_envs != group.local_envs:
        raise ValueError(f"the env holds {env.cfg.num_envs} envs, the rank's slice is {group.local_envs}")
    env.env_group = group
    return group.num_envs


def local_minibatch_rows(perms, n_mb: int, mb_size: int, group, device) -> list[list[torch.Tensor]]:
    """This rank's rows of each minibatch of global permutations.

    ``perms`` (epochs, T N) index the global flattened ``(T, N)`` trajectory
    (row ``t N + n``); minibatch ``i`` of an epoch is ``perm[i mb : (i + 1)
    mb]``. Returns, per epoch and minibatch, the rank's local rows ``t n_local
    + (n - start)`` of its envs in that minibatch, in permutation order: on
    the host, then uploaded in one copy (pinned and asynchronous for a CUDA
    device), so no step reads a device value back. A minibatch may hold none
    of the rank's envs."""
    perms = np.asarray(perms, dtype=np.int64)
    epochs = perms.shape[0]
    used = perms[:, : n_mb * mb_size]
    t, env = np.divmod(used, group.num_envs)
    mine = (env >= group.start) & (env < group.stop)
    rows = torch.from_numpy(np.ascontiguousarray((t * group.local_envs + env - group.start)[mine]))
    counts = mine.reshape(epochs, n_mb, mb_size).sum(-1).ravel().tolist()
    if torch.device(device).type == "cuda":
        rows = rows.pin_memory()
    rows = rows.to(device, non_blocking=True)
    parts = torch.split(rows, counts)
    return [list(parts[e * n_mb : (e + 1) * n_mb]) for e in range(epochs)]
