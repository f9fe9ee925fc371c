"""The 1-D device mesh: the port's counterpart of ``adam_tpu/parallel/mesh.py``
and of ``shard_map`` over it.

JAX runs one SPMD program per device under ``shard_map``, and the
collectives (``psum``, ``all_to_all``, ``all_gather``, ``ppermute``) are
XLA ops over ICI.  The port has two implementations of one small
interface, so the same code (``parallel/dist.py``, the streamed run's
``MeshPartitioner``) drives two CPU slots in the tests, two slots on one
card, and N processes:

* :class:`LocalMesh` — one process over a list of pool slots
  (``parallel/device_pool.Slot``).  The per-shard bodies run in a loop,
  one per slot, each inside its slot's scope (device and stream), and the
  collectives are explicit tensor exchanges between the slots' streams.
* :class:`ProcessMesh` — ``torch.distributed``, one rank per device:
  ``gloo`` on the CPU, ``nccl`` on the card.  This process runs one
  shard, its rank's; :func:`initialize_distributed` wraps
  ``init_process_group``.

A collective takes and returns one entry per *local* shard
(:meth:`local_shards`): all ``n`` of them in a :class:`LocalMesh`, the
rank's one in a :class:`ProcessMesh`.  Every per-shard value is a tensor
on that shard's device.  Integer sums run in the tensors' own type, so an
i64 histogram is summed in i64 (ROADMAP trap (c)).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


class LocalMesh:
    """A mesh of ``len(slots)`` shards in this process (module docstring)."""

    def __init__(self, slots: Sequence):
        from adam_tpu_torch.parallel.device_pool import as_slot

        self.slots = [as_slot(s) for s in slots]
        if not self.slots:
            raise ValueError("a mesh needs at least one slot")

    @property
    def n(self) -> int:
        return len(self.slots)

    def local_shards(self) -> list:
        return list(range(self.n))

    def slot(self, k: int):
        return self.slots[k]

    def _move(self, x, src: int, dst: int):
        from adam_tpu_torch.parallel.device_pool import move_to

        return move_to(x, self.slots[src], self.slots[dst])

    def psum(self, xs: list) -> list:
        """Every shard's tensor summed (in its dtype) -> the sum on each
        shard's device."""
        out = []
        for j in range(self.n):
            with self.slots[j].scope():
                acc = self._move(xs[0], 0, j).clone()
                for k in range(1, self.n):
                    acc += self._move(xs[k], k, j)
            out.append(acc)
        return out

    def all_to_all(self, xs: list) -> list:
        """``xs[k][j]`` is what shard ``k`` sends shard ``j`` -> ``out[j][k]``,
        what shard ``j`` received from shard ``k``, on ``j``'s device."""
        return [[self._move(xs[k][j], k, j) for k in range(self.n)]
                for j in range(self.n)]

    def all_gather(self, xs: list) -> list:
        """Every shard's tensor -> on each shard, the list of all of them in
        shard order."""
        return [[self._move(xs[k], k, j) for k in range(self.n)]
                for j in range(self.n)]

    def ppermute(self, xs: list, perm: Sequence[tuple]) -> list:
        """Send shard ``src``'s tensor to shard ``dst`` for each ``(src,
        dst)`` of ``perm`` -> per shard what it received (None when it
        receives nothing)."""
        out: list = [None] * self.n
        for src, dst in perm:
            out[dst] = self._move(xs[src], src, dst)
        return out


class ProcessMesh:
    """A mesh of ``world_size`` processes, this one shard ``rank`` (module
    docstring).  The process group must be initialized
    (:func:`initialize_distributed`); tensors live on ``device`` (the CPU
    under ``gloo``, this rank's card under ``nccl``)."""

    def __init__(self, device=None, group=None):
        import torch.distributed as dist

        from adam_tpu_torch.parallel.device_pool import Slot

        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh needs torch.distributed initialized "
                               "(initialize_distributed)")
        self.group = group
        self.rank = dist.get_rank(group)
        self._n = dist.get_world_size(group)
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if dist.get_backend(group) == "nccl" else torch.device("cpu"))
        self._slot = Slot(self.rank, device)

    @property
    def n(self) -> int:
        return self._n

    def local_shards(self) -> list:
        return [self.rank]

    def slot(self, k: int):
        if k != self.rank:
            raise ValueError(f"shard {k} is not local to rank {self.rank}")
        return self._slot

    def psum(self, xs: list) -> list:
        import torch.distributed as dist

        (x,) = xs
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return [out]

    def _sizes(self, counts: torch.Tensor) -> torch.Tensor:
        """All-to-all of one i64 count per destination."""
        import torch.distributed as dist

        got = torch.empty_like(counts)
        dist.all_to_all_single(got, counts, group=self.group)
        return got

    def all_to_all(self, xs: list) -> list:
        import torch.distributed as dist

        (chunks,) = xs
        dev = self._slot.device
        tail = tuple(chunks[0].shape[1:])
        send_sizes = [int(c.shape[0]) for c in chunks]
        send_n = torch.tensor(send_sizes, dtype=torch.int64, device=dev)
        # adam-tpu: noqa[host-sync] reason=the receive split sizes are an argument of torch.distributed.all_to_all_single, host ints by its API; the JAX package's collectives run at static shapes and fetch nothing here
        recv_n = self._sizes(send_n).cpu().tolist()
        send = torch.cat([c.reshape((-1,) + tail) for c in chunks], 0).contiguous()
        recv = torch.empty((int(sum(recv_n)),) + tail, dtype=send.dtype, device=dev)
        dist.all_to_all_single(recv, send, output_split_sizes=recv_n,
                               input_split_sizes=send_sizes,
                               group=self.group)
        return [list(torch.split(recv, recv_n, 0))]

    def all_gather(self, xs: list) -> list:
        import torch.distributed as dist

        (x,) = xs
        dev = self._slot.device
        n_here = torch.tensor([int(x.shape[0])], dtype=torch.int64, device=dev)
        sizes = [torch.empty_like(n_here) for _ in range(self._n)]
        dist.all_gather(sizes, n_here, group=self.group)
        sizes = [int(s.item()) for s in sizes]
        cap = max(sizes) if sizes else 0
        pad = torch.zeros((cap,) + tuple(x.shape[1:]), dtype=x.dtype, device=dev)
        pad[: x.shape[0]] = x
        bufs = [torch.empty_like(pad) for _ in range(self._n)]
        dist.all_gather(bufs, pad.contiguous(), group=self.group)
        return [[b[:s] for b, s in zip(bufs, sizes)]]

    def ppermute(self, xs: list, perm: Sequence[tuple]) -> list:
        (x,) = xs
        empty = x[:0]
        chunks = [empty] * self._n
        for src, dst in perm:
            if src == self.rank:
                chunks[dst] = x
        recv = self.all_to_all([chunks])[0]
        for src, dst in perm:
            if dst == self.rank:
                return [recv[src]]
        return [None]


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None) -> bool:
    """Join a multi-process mesh: ``torch.distributed.init_process_group``
    with an explicit ``init_method`` (``tcp://localhost:<port>`` or
    ``file://<path>``), world size and rank; ``backend`` defaults to
    ``nccl`` when a card is visible, else ``gloo``.  A no-op returning
    False without an ``init_method`` (one process)."""
    import torch.distributed as dist

    if init_method is None:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True
