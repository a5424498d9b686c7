"""Data and tensor parallelism over processes (counterpart of the JAX
package's `parallel/mesh.py`).

The semantics are the JAX package's. A layout (`Mesh`) is the JAX mesh's
('dp', 'tp') grid, or ('slice', 'dp', 'tp') for `make_multislice_mesh`:
rank r sits at (r // tp, r % tp), as JAX's `devices.reshape(dp, tp)`, and
the batch splits over the data axes ('slice' and 'dp') in row order. Each
rank is a process of one `torch.distributed` group; `launch` sets the
layout up in every rank before its function runs (`setup`): a dp
sub-group for each tp index and a tp sub-group for each data index. The
global batch (`BATCH_SIZE`) is split over the dp ranks (`shard_batch`;
`dp_rank()`, `dp_size()`); the ranks of one tp group hold the same rows
and compute everything but the sharded convolutions alike, as GSPMD
replicates them. Whenever a group is initialised the port's modules act
on the global batch, reducing over the dp group:

  - `models.resnet.BatchNorm` (train mode) all-reduces its per-channel
    sum and sum of squares through `all_reduce_sum`, whose backward sums
    the cotangents over the dp ranks;
  - `losses` divide each rank's numerators by the global denominators
    (`sum_over_ranks`), so each rank's loss is its share of the global one
    and the gradients summed over the dp ranks are the global loss's;
  - `ops.voting` and `ops.voting_soft` take vote draws as the global
    batch's and draw fresh ones for it, then take this rank's
    (`rank_rows`); the adaptive RANSAC loop runs while any slot of any rank
    is not confident (`all_ranks_true`);
  - `metrics` sums the mask scores' counts and the pose metric bank's
    updates;
  - `train.task`'s steps sum the gradients in one all-reduce, sum the logs
    and the metric bank, and draw the global batch's dropout masks; the
    gradients' finiteness and the CC kernel's error flag are reduced over
    the world.

Tensor parallelism (`shard_state_tp`, the JAX rule): every convolution
whose output channels divide `tp` and number at least `min_channels`
keeps this rank's contiguous slice of them, in the network and in the
optimizer state (RAdam's moments, Lookahead's slow weights), and
all-gathers its output over the tp group (`parallel.tp`). `gather_state_tp`
undoes it, for a checkpoint or a caller outside the group.

A group of one rank takes the same path: the smoke runs NCCL that way on
one card. Outside a group every helper here is the identity and nothing
communicates.

`launch` runs a function on N ranks, each a spawned process that joins the
group through a `file://` store in a fresh directory (no fixed TCP port
to collide on), with a timeout on every collective; a rank that fails, or a
deadline that passes, ends every rank, and the failed rank's traceback is
raised in the caller. The multi-host helpers (`make_multislice_mesh`,
`shard_batch_multihost`) act in whatever group the process has joined;
as in the JAX package, there is no rendezvous across machines here.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The JAX package's mesh as a layout of ranks: ('dp', 'tp'), or
    ('slice', 'dp', 'tp') when `slices` is set (`make_multislice_mesh`).
    Rank r sits at (r // (dp tp), (r // tp) % dp, r % tp), as JAX's
    `devices.reshape(slices, dp, tp)`; the batch splits over the data
    index r // tp, which spans the slices."""
    dp: int
    tp: int = 1
    slices: int = 0  # 0: no 'slice' axis

    @property
    def shape(self) -> Dict[str, int]:
        axes = {"slice": self.slices} if self.slices else {}
        return {**axes, "dp": self.dp, "tp": self.tp}

    @property
    def data_ranks(self) -> int:
        """The ranks the batch splits over: 'slice' x 'dp'."""
        return max(self.slices, 1) * self.dp

    @property
    def size(self) -> int:
        return self.data_ranks * self.tp

    def coords(self, r: int) -> Tuple[int, ...]:
        """Rank `r`'s index along each axis of `shape`."""
        tp_index, data = r % self.tp, r // self.tp
        if self.slices:
            return data // self.dp, data % self.dp, tp_index
        return data, tp_index

    def dp_groups(self) -> List[List[int]]:
        """For each tp index, the ranks that hold its shard, in data order."""
        return [[d * self.tp + t for d in range(self.data_ranks)] for t in range(self.tp)]

    def tp_groups(self) -> List[List[int]]:
        """For each data index, the ranks that share its rows."""
        return [[d * self.tp + t for t in range(self.tp)] for d in range(self.data_ranks)]


def _split(n: int, tp: int, dp: Optional[int], what: str) -> int:
    if tp < 1:
        raise ValueError(f"tp={tp}: the 'tp' axis needs at least one rank")
    dp = n // tp if dp is None else dp
    if dp < 1 or dp * tp != n:
        raise ValueError(f"dp={dp} x tp={tp} is not the {n} ranks of {what}")
    return dp


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: int = 1) -> Mesh:
    """The ('dp', 'tp') layout of `n_devices` ranks (default: the group's),
    dp = n_devices // tp unless given; raises unless dp x tp == n_devices."""
    n = world_size() if n_devices is None else n_devices
    return Mesh(_split(n, tp, dp, "the mesh"), tp)


def make_multislice_mesh(n_slices: int, devices_per_slice: int, tp: int = 1) -> Mesh:
    """The ('slice', 'dp', 'tp') layout of `n_slices` x `devices_per_slice`
    ranks, dp = devices_per_slice // tp: the batch splits over ('slice',
    'dp'), the parameters as `shard_state_tp` places them. Inside a group,
    raises if the group has fewer ranks."""
    need = n_slices * devices_per_slice
    if n_slices < 1 or (active() and world_size() < need):
        raise ValueError(f"{n_slices} slices of {devices_per_slice} need {need} ranks; "
                         f"the group has {world_size()}")
    return Mesh(_split(devices_per_slice, tp, None, "a slice"), tp, n_slices)


def default_backend(device) -> str:
    """NCCL for CUDA tensors, gloo for CPU ones."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def active() -> bool:
    """Whether this process is a rank of an initialised process group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank in the world (0 outside a group)."""
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


@dataclasses.dataclass
class _Layout:
    mesh: Mesh
    dp_group: Any  # None: the world
    tp_group: Any  # None: tp == 1


_layout: Optional[_Layout] = None


def setup(mesh_: Mesh, timeout_s: Optional[float] = None) -> None:
    """Lay this group's ranks out as `mesh_` (every rank calls it, with the
    same layout): one dp sub-group for each tp index and one tp sub-group
    for each data index, created in the same order on every rank. With
    tp = 1 the dp group is the world and nothing is created."""
    global _layout
    if not active() or mesh_.size != world_size():
        raise ValueError(f"a layout of {mesh_.size} ranks {mesh_.shape} in a group of "
                         f"{world_size()}")
    dp_group = tp_group = None
    if mesh_.tp > 1:
        kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
        r = rank()
        for ranks in mesh_.dp_groups():
            made = dist.new_group(ranks, **kw)
            dp_group = made if r in ranks else dp_group
        for ranks in mesh_.tp_groups():
            made = dist.new_group(ranks, **kw)
            tp_group = made if r in ranks else tp_group
    _layout = _Layout(mesh_, dp_group, tp_group)


def teardown() -> None:
    """Forget the layout (before the group is destroyed)."""
    global _layout
    _layout = None


def layout() -> Mesh:
    """The layout of this process's group: the one `setup` made, else every
    rank data-parallel (one rank outside a group)."""
    if active() and _layout is not None:
        return _layout.mesh
    return Mesh(world_size(), 1)


def dp_rank() -> int:
    """This rank's data index: which rows of the batch it holds."""
    return rank() // layout().tp


def dp_size() -> int:
    """The ranks the batch splits over."""
    return layout().data_ranks


def tp_rank() -> int:
    return rank() % layout().tp


def tp_size() -> int:
    return layout().tp


def group(over: str = "dp"):
    """The process group of an axis: 'dp' (this rank's dp group), 'tp'
    (its tp group) or 'world' (None, the default group)."""
    if over not in ("dp", "tp", "world"):
        raise ValueError(f"unknown axis {over!r}")
    if over == "world" or _layout is None or not active():
        return None
    return _layout.dp_group if over == "dp" else _layout.tp_group


def axis_size(over: str = "dp") -> int:
    return {"dp": dp_size, "tp": tp_size, "world": world_size}[over]()


def use_rank_device(device) -> torch.device:
    """The device of this rank, made CUDA's current one (NCCL needs it):
    `cuda` without an index is `cuda:<rank>` (one card a rank); an explicit
    card, such as `cuda:0` for ranks that share one, or the CPU, is kept."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def rank_rows(x, dim: int = 0, ranks: Optional[int] = None, r: Optional[int] = None):
    """This rank's rows [r B/n, (r+1) B/n) of a global array or tensor along
    `dim`, r and n the data index and size unless given; B must divide by
    n."""
    n = dp_size() if ranks is None else ranks
    r = dp_rank() if r is None else r
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"a global axis of {size} does not split over {n} ranks")
    local = size // n
    index = [slice(None)] * x.ndim
    index[dim] = slice(r * local, (r + 1) * local)
    return x[tuple(index)]


def shard_batch(batch, ranks: Optional[int] = None, r: Optional[int] = None):
    """This rank's rows of every array of a (nested) global batch; a list
    (such as the samples' paths) is split as the arrays are."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, ranks, r) for k, v in batch.items()}
    if isinstance(batch, list):
        return list(rank_rows(np.asarray(batch, dtype=object), 0, ranks, r))
    return rank_rows(batch, 0, ranks, r)


def _leading_sizes(batch) -> List[int]:
    if isinstance(batch, dict):
        return [n for k in sorted(batch) for n in _leading_sizes(batch[k])]
    return [len(batch)]


def shard_batch_multihost(local_batch):
    """The rows this process supplies, as its shard of a global batch of
    local x `dp_size()` rows in data-index order (the counterpart of JAX's
    `make_array_from_process_local_data`): every rank of the group must
    supply as many rows (the ranks of one tp group, the same ones). On one
    process it equals `shard_batch`."""
    sizes = all_gather_object(_leading_sizes(local_batch), over="world")
    if any(s != sizes[0] for s in sizes):
        raise ValueError(f"the ranks supplied local batches of other sizes: {sizes}")
    return local_batch


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of an axis; the backward sums the cotangents over
    them (each rank's output feeds its own share of the global loss)."""

    @staticmethod
    def forward(ctx, x, over):
        ctx.over = over
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group(over))
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=group(ctx.over))
        return g, None


def all_reduce_sum(x: torch.Tensor, over: str = "dp") -> torch.Tensor:
    """The sum of `x` over the ranks of axis `over`, with gradient."""
    return _AllReduceSum.apply(x, over) if active() else x


@torch.no_grad()
def sum_over_ranks(tensors: Sequence[torch.Tensor], dtype: torch.dtype = torch.float32,
                   over: str = "dp") -> List[torch.Tensor]:
    """Each tensor summed over the ranks of axis `over` (by default the dp
    group: the ranks of one tp group hold the same rows), without gradient,
    in one all-reduce of a buffer of `dtype` (each result takes its input's
    dtype back). Outside a group, the tensors themselves."""
    tensors = list(tensors)
    if not active() or not tensors:
        return tensors
    flat = torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors])
    dist.all_reduce(flat, group=group(over))
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return out


def global_sum(x: torch.Tensor, over: str = "dp") -> torch.Tensor:
    """`x` summed over the ranks of axis `over`, without gradient."""
    return sum_over_ranks([x], over=over)[0]


def all_ranks_true(flag: torch.Tensor, over: str = "dp") -> bool:
    """Whether a boolean scalar is true on every rank of axis `over` (one
    host read)."""
    flag = flag.to(torch.int32).reshape(1)
    if active():
        flag = flag.clone()
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group(over))
    return bool(flag.item())


def _broadcast_(t: torch.Tensor) -> None:
    """Rank 0's values into `t`, in place; a strided view (such as a
    converted checkpoint's permuted tensor) goes through a contiguous copy,
    since a collective reads and writes the storage in its own order."""
    buf = t.contiguous()
    dist.broadcast(buf, 0)
    if buf.data_ptr() != t.data_ptr():
        t.copy_(buf)


@torch.no_grad()
def replicate(state):
    """Rank 0's train state on every rank: the network's parameters and
    buffers, the optimizer state's tensors (broadcast in place) and its
    scalars, the step and the skipped-update count. Returns the state."""
    if not active():
        return state
    for t in itertools.chain(state.net.parameters(), state.net.buffers()):
        _broadcast_(t.detach())
    opt = state.opt_state
    scalars = {}
    for f in dataclasses.fields(opt):
        value = getattr(opt, f.name)
        if isinstance(value, dict):  # in one order on every rank
            for name in sorted(value):
                _broadcast_(value[name])
        else:
            scalars[f.name] = value
    box = [dict(opt=scalars, step=state.step, skipped_updates=state.skipped_updates)]
    dist.broadcast_object_list(box, 0)
    got = box[0]
    return dataclasses.replace(state, opt_state=dataclasses.replace(opt, **got["opt"]),
                               step=got["step"], skipped_updates=got["skipped_updates"])


def _map_opt_tensors(opt, fn):
    """The optimizer state with `fn(name, tensor)` for each of its tensors."""
    return dataclasses.replace(opt, **{
        f.name: {k: fn(k, v) for k, v in getattr(opt, f.name).items()}
        for f in dataclasses.fields(opt) if isinstance(getattr(opt, f.name), dict)})


def shard_state_tp(state, mesh_: Mesh, min_channels: int = 128):
    """The JAX package's `shard_state_tp` on this rank: rank 0's state
    (`replicate`), then every convolution of the network whose output
    channels (dim 0 of torch's [cout, cin, kh, kw] weight; the last axis of
    the JAX kernel) divide tp and number at least `min_channels` keeps this
    rank's contiguous cout / tp slice of its weight and all-gathers its
    output over the tp group (`parallel.tp.TPConv2d`); the same cut of
    RAdam's moments and Lookahead's slow weights. Everything else stays
    replicated. With tp == 1 it is `replicate`. `mesh_` must be this
    group's layout. Returns the state."""
    from fastposecnn_tpu_torch.parallel import tp

    if mesh_.tp > 1 and (not active() or layout() != mesh_):
        raise ValueError(f"a {mesh_.shape} layout needs a group laid out so "
                         f"(`launch(..., layout=...)`); this process has {layout().shape}")
    state = replicate(state)
    if mesh_.tp == 1:
        return state
    sharded = shard_network_tp(state.net, min_channels)
    opt = _map_opt_tensors(state.opt_state, lambda k, v: (
        tp.local_slice(v, mesh_.tp, tp_rank()) if k in sharded else v))
    return dataclasses.replace(state, opt_state=opt)


def shard_network_tp(net: torch.nn.Module, min_channels: int = 128) -> set:
    """`shard_state_tp`'s rule on a network alone, over this group's
    layout, in place (every rank must hold the same weights; nothing is
    broadcast). Returns the sharded weights' names (none when tp == 1)."""
    from fastposecnn_tpu_torch.parallel import tp

    if tp_size() == 1:
        return set()
    return tp.shard_network_(net, tp_size(), tp_rank(), min_channels)


def gather_state_tp(state):
    """The whole train state of a tp-sharded one, on every rank of its tp
    group (each calls it): a copy of the network with plain convolutions of
    the gathered weights, and the optimizer's tensors gathered; `state`
    itself is left as it is. Without sharding, `state`."""
    from fastposecnn_tpu_torch.parallel import tp

    sharded = tp.sharded_names(state.net)
    if not sharded:
        return state
    opt = _map_opt_tensors(state.opt_state,
                           lambda k, v: tp.gather(v) if k in sharded else v)
    return dataclasses.replace(state, net=tp.gathered_network(state.net), opt_state=opt)


def broadcast_object(obj):
    """Rank 0's picklable `obj` on every rank."""
    if not active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, 0)
    return box[0]


def all_gather_object(obj, over: str = "dp") -> List[Any]:
    """Every rank's picklable `obj` over axis `over` (by default the dp
    group: one of each data index), in rank order."""
    if not active():
        return [obj]
    out = [None] * axis_size(over)
    dist.all_gather_object(out, obj, group=group(over))
    return out


def backend() -> Optional[str]:
    return dist.get_backend() if active() else None


# -----------------------------------------------------------------------------
# Launching ranks


def _rank_main(fn, r: int, world: int, backend: str, init_file: str,
               timeout_s: float, threads: Optional[int], layout_: Mesh, args,
               results) -> None:
    # The package's modules read the group from torch.distributed and the
    # layout from `setup`, so a rank is a plain process that joins the group
    # and sets the layout up before calling `fn`.
    try:
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=r,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            setup(layout_, timeout_s)
            out = fn(*args)
        finally:
            teardown()
            dist.destroy_process_group()
        # Plain pickle bytes: the queue's own pickler would share a tensor's
        # storage through a file descriptor that dies with this process.
        results.put((r, True, pickle.dumps(out)))
    except BaseException:  # noqa: BLE001 - reported to the launcher, then exit 1
        results.put((r, False, traceback.format_exc()))
        raise SystemExit(1)


def cpu_threads(ranks: int, device) -> Optional[int]:
    """Intra-op threads for each of `ranks` ranks on `device`: on the CPU,
    the caller's threads shared out (spinning thread pools of ranks that
    oversubscribe the cores slow every rank many times over); None, torch's
    default, on CUDA."""
    if torch.device(device).type != "cpu":
        return None
    return max(1, torch.get_num_threads() // ranks)


def _failures(results, procs, world: int, failed: Dict[int, str],
              grace_s: float = 3.0) -> str:
    """Every failed rank's traceback: the first failure's peers usually fail
    too (their collective loses a peer), so wait a little for theirs."""
    end = time.monotonic() + grace_s
    while time.monotonic() < end and any(p.exitcode is None for p in procs):
        try:
            r, ok, payload = results.get(timeout=0.2)
        except queue.Empty:
            continue
        if not ok:
            failed[r] = payload
    return "\n".join(f"rank {r} of {world} failed:\n{tb}"
                     for r, tb in sorted(failed.items()))


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(timeout=10)


def launch(fn: Callable, world: int, args: Sequence[Any] = (), *, backend: str,
           store_dir: Optional[str] = None, deadline_s: Optional[float] = None,
           threads: Optional[int] = None, layout: Optional[Mesh] = None) -> List[Any]:
    """Run `fn(*args)` on `world` ranks, each a spawned process in one
    process group of `backend` ('gloo' or 'nccl'; named by the caller),
    laid out as `layout` (default: `make_mesh(world)`, data-parallel).
    `fn` must be importable by name (a module-level function); each rank
    returns its result through a queue. The group meets through a
    `file://` store in a fresh directory under `store_dir` (default: the
    system's temporary directory), removed at the end. `threads` sets each
    rank's intra-op threads.

    A rank that raises or dies ends every rank, and its traceback is
    raised here (RuntimeError); `deadline_s` passing (None: no deadline)
    ends them too (TimeoutError). Each collective inside the ranks times out
    after `deadline_s` too (1800 s without one), so a rank whose peer hangs
    fails. Returns the results in rank order."""
    timeout_s = deadline_s if deadline_s is not None else 1800.0
    layout_ = make_mesh(world) if layout is None else layout
    if layout_.size != world:
        raise ValueError(f"a layout of {layout_.size} ranks {layout_.shape} for {world}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="fpcnn_dp_", dir=store_dir)
    init_file = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, name=f"rank-{r}",
                         args=(fn, r, world, backend, init_file, timeout_s, threads,
                               layout_, tuple(args), results))
             for r in range(world)]
    deadline = math.inf if deadline_s is None else time.monotonic() + deadline_s
    got: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        while len(got) < world:
            try:
                r, ok, payload = results.get(timeout=0.2)
            except queue.Empty:
                dead = [(i, p.exitcode) for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in got]
                if dead:
                    try:  # a traceback that was on its way
                        r, ok, payload = results.get(timeout=2.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank {dead[0][0]} of {world} exited with "
                            f"code {dead[0][1]} and no traceback") from None
                elif time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world)) - set(got))} of "
                        f"{world} did not finish within {deadline_s} s") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(_failures(results, procs, world, {r: payload}))
            got[r] = pickle.loads(payload)
        for p in procs:
            p.join(timeout=max(1.0, min(deadline - time.monotonic(), timeout_s)))
        late = [i for i, p in enumerate(procs) if p.exitcode != 0]
        if late:
            raise RuntimeError(f"ranks {late} did not exit cleanly: "
                               f"{[procs[i].exitcode for i in late]}")
    finally:
        _stop(procs)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(world)]
