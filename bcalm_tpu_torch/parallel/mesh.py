"""The device mesh of a ``-devices N`` build: one process per rank.

Counterpart of ``bcalm_tpu/parallel/pipeline.py:make_mesh`` and of the
collectives the JAX package calls inside its shard_map bodies
(``jax.lax.all_to_all``, ``psum``, ``all_gather`` over the mesh axis).
There, one program sees every device; here each rank is a process that
holds its own shard, and the collectives go through ``torch.distributed``
on the default process group: NCCL on ``cuda:<rank>``, gloo on the CPU.
Nothing is emulated in-process: at world size 1 the collectives still run
(as copies).

Bucket layout: an exchange takes channel-major buckets ``(C, n_dev, cap)``
(bucket j goes to rank j) and returns the same shape, bucket j now
holding what rank j sent here, as ``all_to_all(split_axis=1,
concat_axis=1)`` does in the JAX package.
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

    def exchange(self, buckets: torch.Tensor, bvalid: torch.Tensor):
        """all_to_all of the buckets (C, n_dev, cap) and their validity
        (n_dev, cap) in one collective; the validity rides as an extra
        channel."""
        C = buckets.shape[0]
        both = torch.cat([buckets, bvalid.to(buckets.dtype)[None]], dim=0)
        recv = self.all_to_all(both)
        return recv[:C], recv[C] != 0

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
