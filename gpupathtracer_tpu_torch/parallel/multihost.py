"""Process-group set-up, the collectives the renderers use, and frame
assembly.

Counterpart of ``gpupathtracer_tpu/parallel/multihost.py``. A single
process needs none of this; several processes (one per card, or several on
one card under gloo) call ``init_distributed`` first. ``torch.distributed``
is given its address, world size and rank explicitly, or reads them from
the environment (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``).

Under gloo every collective of this package stages its tensors through the
host: gloo's transport cannot read card memory for every operation.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from gpupathtracer_tpu_torch.core.tensors import resolve_device


def init_distributed(init_method=None, world_size=None, rank=None, backend=None, device="cuda") -> None:
    """``init_process_group`` for this process; a no-op for a single
    process. The backend is nccl when ``device`` is the card and gloo on
    the CPU, unless ``backend`` is given. On the card the process's current
    device is set first (``device``'s index, else rank modulo the cards)."""
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if world_size in (None, 1) and init_method is None:
        return
    device = resolve_device(device)
    if device.type == "cuda":
        index = device.index if device.index is not None else (rank or 0) % torch.cuda.device_count()
        torch.cuda.set_device(index)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size, rank=rank)


def _staged(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as a contiguous tensor where the group's backend can read it:
    on the host under gloo, in place otherwise."""
    x = x.detach().contiguous()
    return x.cpu() if dist.get_backend(group) == "gloo" else x


def all_gather(x: torch.Tensor, group=None) -> list[torch.Tensor]:
    """Every rank's ``x`` (same shape on each) in the group's rank order, on
    ``x``'s device."""
    if dist.get_world_size(group) == 1:
        return [x]
    src = _staged(x, group)
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return [o.to(x.device) for o in out]


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """Chunk p of ``x`` (split evenly along dim 0) goes to rank p of the
    group; chunk p of the result came from rank p. On ``x``'s device."""
    src = _staged(x, group)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device)


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``x`` over the group, on ``x``'s device."""
    buf = _staged(x, group).clone()
    dist.all_reduce(buf, group=group)
    return buf.to(x.device)


def broadcast(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Rank ``src``'s ``x`` (``src`` is a rank of the group) on every rank
    of the group, on ``x``'s device; every rank passes a tensor of the same
    shape and dtype."""
    group = group or dist.group.WORLD
    if dist.get_world_size(group) == 1:
        return x
    buf = _staged(x, group).clone()
    dist.broadcast(buf, src=dist.get_global_rank(group, src), group=group)
    return buf.to(x.device)


def shift(xs: dict, group=None) -> dict:
    """Send each tensor of ``xs`` to the next rank of the group and receive
    the previous rank's, in one batch of point-to-point operations (a
    one-rank group keeps its own). On the tensors' devices."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return dict(xs)
    nxt, prv = (dist.get_global_rank(group, (me + k) % n) for k in (1, -1))
    out, ops = {}, []
    for f, x in xs.items():
        src = _staged(x, group)
        out[f] = torch.empty_like(src)
        ops += [dist.P2POp(dist.isend, src, nxt, group), dist.P2POp(dist.irecv, out[f], prv, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return {f: out[f].to(x.device) for f, x in xs.items()}


def gather_image(image: torch.Tensor) -> np.ndarray:
    """The full frame as a host numpy array (``render_frame_distributed``
    returns the full frame on every rank)."""
    return image.detach().cpu().numpy()
