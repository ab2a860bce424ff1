"""The device mesh of a ``-devices N`` build: one process per rank.

Counterpart of ``bcalm_tpu/parallel/pipeline.py:make_mesh`` and of the
collectives the JAX package calls inside its shard_map bodies
(``jax.lax.all_to_all``, ``psum``, ``all_gather`` over the mesh axis).
There, one program sees every device; here each rank is a process that
holds its own shard, and the collectives go through ``torch.distributed``
on the default process group: NCCL on ``cuda:<rank>``, gloo on the CPU.
Nothing is emulated in-process: at world size 1 the collectives still run
(as copies).

Bucket layout: ``exchange`` sends K15's buffer ``(n_dev, C+1, cap)`` as
it is (bucket j, its C channels and its validity as channel C, goes to
rank j; a buffer with no validity channel, ``(n_dev, C, cap)``, with
``with_valid=False``) and returns channel-major ``(C, n_dev, cap)`` with
the validity ``(n_dev, cap)``, bucket j now holding what rank j sent here, as
``all_to_all(split_axis=1, concat_axis=1)`` of the buckets and of their
validity does in the JAX package.  ``all_to_all`` takes channel-major
``(C, n_dev, cap)`` and returns the same shape (the glue's responses).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist


@dataclass
class Mesh:
    n_dev: int
    rank: int
    device: torch.device

    def all_to_all(self, buckets: torch.Tensor) -> torch.Tensor:
        """(C, n_dev, cap) -> (C, n_dev, cap): bucket j to rank j."""
        C, n, cap = buckets.shape
        if n != self.n_dev:
            raise ValueError(f"all_to_all: {n} buckets for {self.n_dev} ranks")
        send = buckets.permute(1, 0, 2).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        return recv.permute(1, 0, 2).contiguous()

    def exchange(self, send: torch.Tensor, with_valid: bool = True):
        """all_to_all of K15's send buffer (n_dev, C+1, cap), or (n_dev, C,
        cap) with no validity channel (with_valid False), as it is, bucket
        j to rank j; returns received() of what arrives: bucket j as rank j
        sent it."""
        if send.shape[0] != self.n_dev:
            raise ValueError(f"exchange: {send.shape[0]} buckets for "
                             f"{self.n_dev} ranks")
        got = torch.empty_like(send)
        dist.all_to_all_single(got, send)
        return received(got, with_valid)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(...) -> (n_dev, ...), rank order."""
        parts = [torch.empty_like(x) for _ in range(self.n_dev)]
        dist.all_gather(parts, x.contiguous())
        return torch.stack(parts)

    def gather_ints(self, values) -> np.ndarray:
        """Host integers of every rank: (n_dev, len(values)) int64."""
        t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                         device=self.device)
        return self.all_gather(t).cpu().numpy()

    def sum_int(self, value) -> int:
        return int(self.gather_ints([value]).sum())


def received(got: torch.Tensor, with_valid: bool = True):
    """The receive side of an exchange, on the received buffer (n_dev, C+1,
    cap), or (n_dev, C, cap) with no validity channel: (recv (C, n_dev, cap)
    channel-major, the validity (n_dev, cap) bool, or None with no
    validity channel).  At n_dev = 1 recv is a view; above, one permute."""
    C = got.shape[1] - int(with_valid)
    recv = got[:, :C].permute(1, 0, 2).contiguous()
    return recv, (got[:, C] != 0) if with_valid else None
