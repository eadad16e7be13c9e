"""Data parallelism for the pretrain step on ``torch.distributed``.

Counterpart of ``gcc_tpu/parallel/data_parallel.py``. There the train
step is one traced function over the global batch, and GSPMD splits it
over the mesh's "data" axis from the input shardings, inserting the
gradient and BatchNorm psums itself. Here each rank is one process that
holds its slice of the global batch, in (device, graph) order, and the
step makes the same function explicit with collectives, so a run on D
ranks computes what one device computes on the D·b graphs, up to the
order of its sums:

- BatchNorm (and SELayer) statistics over the global batch: the masked
  sums of ``models/layers.py`` are all-reduced, forward and backward
  (:func:`all_reduce_sum`). Plain DDP would normalize per rank, which is
  another function.
- The loss is the global mean: each rank's share is its rows' sum over
  the global batch size; the gradients are all-reduced (summed) before
  the clip (``training/optim.py``), so the clip sees the global norm and
  Adam and the EMA stay identical on every rank.
- MoCo keys are all-gathered in (device, graph) order and enqueued into
  the replicated queue (the production path, ``packed.py:145-148``); in
  a row-sharded queue (:func:`shard_state`, as ``make_dp_train_step``
  places it) each rank stores K/D rows and the logits see all K through
  an all-gather. E2E in-batch negatives span the global batch: the
  queries are all-gathered with their gradient.
- Dropout masks are drawn for the global batch from the shared
  generator and sliced, so they are the single-device draw.

The collectives run while a :func:`data_parallel` context is active,
even on one rank, and are counted in ``launches``; so are those of the
giant path across ranks (``all_reduce_sum``, :func:`all_reduce_max`,
``all_gather``, ``ppermute``), which take their group as an argument.
``mesh.py``'s ``make_mesh`` has no counterpart: the ranks are the mesh,
and :func:`make_groups` splits them into (data, part) process groups.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """The active data-parallel group: ``world`` ranks, this one ``rank``."""

    group: object
    world: int
    rank: int


_ACTIVE: list[DataParallel] = []


@contextlib.contextmanager
def data_parallel(group=None):
    """Run the train step under data parallelism over ``group`` (the
    default group when None; the process group must be initialized)."""
    if not dist.is_initialized():
        raise RuntimeError("data_parallel needs an initialized process "
                           "group (parallel.multihost.initialize_multihost)")
    ctx = DataParallel(group=group, world=dist.get_world_size(group),
                       rank=dist.get_rank(group))
    _ACTIVE.append(ctx)
    try:
        yield ctx
    finally:
        _ACTIVE.pop()


def current() -> DataParallel | None:
    """The innermost active data-parallel context, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


class _Launches:
    """Collective calls made (each counts one), a plain counter like the
    kernels' ``launches``."""

    def __init__(self):
        self.count = 0


launches = _Launches()


def _all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(x, group=group)
    launches.count += 1
    return x


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    world = dist.get_world_size(group)
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x.contiguous(), group=group)
    launches.count += 1
    return torch.cat(parts)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the gradient of every rank's input is the sum
    of all ranks' output gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone(), ctx.group), None


class _AllGather(torch.autograd.Function):
    """Concatenation over the ranks along dim 0 (equal shapes); the
    gradient of a rank's input is its rows of the summed gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        ctx.rank = dist.get_rank(group)
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce_(g.contiguous().clone(), ctx.group)
        lo = ctx.rank * ctx.rows
        return g[lo:lo + ctx.rows], None


class _ReduceScatter(torch.autograd.Function):
    """Sum over the ranks, each keeping its block of dim 0 (gloo has no
    reduce-scatter: an all-reduce and a slice); the gradient is the
    all-gather of the blocks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        rows = x.shape[0] // world
        return _all_reduce_(x.clone(), group)[rank * rows:
                                               (rank + 1) * rows].clone()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group), None


class _PPermute(torch.autograd.Function):
    """One hop of a ring: send ``x`` to the rank ``shift`` ahead, receive
    the one from ``shift`` behind (the reference's ``ppermute``); the
    gradient travels the other way."""

    @staticmethod
    def forward(ctx, x, shift, group):
        ctx.shift, ctx.group = shift, group
        return _exchange(x, shift, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, -ctx.shift, ctx.group), None, None


def _exchange(x: torch.Tensor, shift: int, group) -> torch.Tensor:
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if world == 1:
        return x.clone()
    # Both buffers contiguous: empty_like keeps a strided x's layout.
    x = x.contiguous()
    out = torch.empty_like(x)
    peer = lambda r: (dist.get_global_rank(group, r)  # noqa: E731
                      if group is not None else r)
    ops = [dist.P2POp(dist.isend, x,
                      peer((rank + shift) % world), group),
           dist.P2POp(dist.irecv, out, peer((rank - shift) % world), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    launches.count += 1
    return out


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``group``, differentiable."""
    return _AllReduceSum.apply(x, group)


@torch.no_grad()
def all_reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise maximum of ``x`` over the ranks of ``group``, without a
    gradient; every rank gets the same bits."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    launches.count += 1
    return out


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0 in rank order,
    differentiable."""
    return _AllGather.apply(x, group)


def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's block of dim 0 of the sum of ``x`` over the ranks,
    differentiable."""
    return _ReduceScatter.apply(x, group)


def ppermute(x: torch.Tensor, shift: int = 1, group=None) -> torch.Tensor:
    """``x`` of the rank ``shift`` behind this one, differentiable."""
    return _PPermute.apply(x, shift, group)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """A sum over the batch, taken over the global batch inside a
    data-parallel step (the identity outside one)."""
    ctx = current()
    return x if ctx is None else all_reduce_sum(x, ctx.group)


@torch.no_grad()
def all_reduce_grads_(params) -> None:
    """Sum the parameters' gradients over the active group, in place, in
    one collective on a flat buffer."""
    ctx = current()
    grads = [p.grad for p in params if p.grad is not None]
    if ctx is None or not grads:
        return
    flat = _all_reduce_(torch.cat([g.reshape(-1) for g in grads]), ctx.group)
    for g, f in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(f.view_as(g))


def shard_state(state, group=None):
    """Place a pretrain state for a data-parallel step
    (``data_parallel.py:30-43``): parameters, optimizer, EMA and counters
    replicated (every rank built them from the same seed); the MoCo queue
    row-sharded, this rank keeping rows [r·K/D, (r+1)·K/D) (the reference's
    ``P("data")``). A state left unplaced keeps its queue replicated, the
    production path's placement. In place; returns ``state``."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    queue = state.queue
    if world == 1 or queue.shards > 1:
        return state
    k = queue.memory.shape[0]
    if k % world:
        raise ValueError(f"queue of {k} rows does not split over "
                         f"{world} ranks")
    rows = k // world
    queue.memory = queue.memory[rank * rows:(rank + 1) * rows].clone()
    queue.shards = world
    return state


def shard_batch(batch, group=None):
    """This rank's slice of a global batch (``data_parallel.py:46-71``):
    of the device axis of a DP-stacked compact wire ((K, D, e_dev) edges
    / (K, D, 3, b) meta, ``PipelineConfig.devices``; D/world devices a
    rank), or of the batch dimension of a padded ``WireBatch`` or of
    ``BatchFeatures``."""
    from gcc_tpu_torch.features.featurize import BatchFeatures
    from gcc_tpu_torch.graph.batch import CompactWireBatch, WireBatch

    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if isinstance(batch, CompactWireBatch):
        if batch.meta.ndim == 4:
            d = batch.meta.shape[1]
            if d % world:
                raise ValueError(f"device axis of {d} does not split over "
                                 f"{world} ranks")
            lo, hi = rank * d // world, (rank + 1) * d // world
            return dataclasses.replace(batch, edges=batch.edges[:, lo:hi],
                                       meta=batch.meta[:, lo:hi])
        # A flat single-segment edge buffer has no device axis to shard.
        raise ValueError(
            "this CompactWireBatch has no device axis: emit it with "
            "PipelineConfig(devices=N) (stacked/routed), use WireBatch "
            "(compact_wire=False), or expand to PaddedSubgraphBatch "
            "before shard_batch.")
    if isinstance(batch, (WireBatch, BatchFeatures)):
        b = batch.node_mask.shape[0] if isinstance(batch, BatchFeatures) \
            else batch.n_nodes.shape[0]
        if b % world:
            raise ValueError(f"batch of {b} does not split over {world} "
                             f"ranks")
        lo, hi = rank * b // world, (rank + 1) * b // world
        if isinstance(batch, BatchFeatures):
            return batch.map(lambda x: x[lo:hi])
        return WireBatch(**{f.name: getattr(batch, f.name)[lo:hi]
                            for f in dataclasses.fields(batch)})
    raise TypeError(f"shard_batch takes a CompactWireBatch with a device "
                    f"axis, a WireBatch or BatchFeatures, not "
                    f"{type(batch).__name__}")


def make_dp_train_step(n_max: int | None = None, group=None):
    """The standard train step under data parallelism
    (``data_parallel.py:97-113``): ``step(state, batch_q, batch_k)`` takes
    this rank's padded ``WireBatch`` slices (:func:`shard_batch`), or its
    features, and returns the step's metrics, the same on every rank. The
    state's queue may be row-sharded (:func:`shard_state`) or
    replicated."""
    from gcc_tpu_torch.graph.batch import WireBatch
    from gcc_tpu_torch.training.pretrain import featurize_pair, train_step

    def step(state, batch_q, batch_k):
        with data_parallel(group):
            if isinstance(batch_q, WireBatch):
                enc = state.cfg.encoder
                batch_q, batch_k = featurize_pair(
                    batch_q, batch_k, enc.positional_embedding_size, n_max,
                    device=state.device, pe_method=enc.pe_method,
                    adj_dtype=enc.adj_dtype, v_dtype=enc.jacobi_v_dtype,
                    guards=enc.pe_guards)
            return train_step(state, batch_q, batch_k)

    return step


def make_groups(data: int, part: int = 1):
    """Process groups of a (data, part) grid over all ranks, rank =
    d·part + p (the reference's ``make_mesh`` layout): this rank's data
    group (the ranks that share its p) and part group (those that share
    its d). Every rank must call it, with the same arguments."""
    world = dist.get_world_size()
    if data * part != world:
        raise ValueError(f"a ({data}, {part}) grid needs {data * part} "
                         f"ranks, the job has {world}")
    me = dist.get_rank()
    data_group = part_group = None
    for p in range(part):
        g = dist.new_group([d * part + p for d in range(data)])
        if me % part == p:
            data_group = g
    for d in range(data):
        g = dist.new_group([d * part + p for p in range(part)])
        if me // part == d:
            part_group = g
    return data_group, part_group


def make_combined_train_step(pg, n_max: int | None = None, data_group=None,
                             part_group=None):
    """The DP train step over ``data_group`` together with a giant graph's
    partitioned aggregation over ``part_group`` (``data_parallel.py:
    74-94``): ``step(state, batch_q, batch_k, h) -> (metrics,
    aggregated)``, where ``h`` is this rank's block of node rows and
    ``pg`` the partition (``parallel/partitioned.py``), of which this
    rank runs its shard (:func:`~gcc_tpu_torch.parallel.partitioned.
    partitioned_aggregate_dist`)."""
    from gcc_tpu_torch.parallel.partitioned import partitioned_aggregate_dist

    dp_step = make_dp_train_step(n_max, data_group)

    def step(state, batch_q, batch_k, h):
        metrics = dp_step(state, batch_q, batch_k)
        return metrics, partitioned_aggregate_dist(pg, h, part_group)

    return step
