"""Data parallelism over processes (counterpart of the JAX package's
`parallel/mesh.py`).

The semantics are the JAX package's: the global batch (`BATCH_SIZE`) is
split over the `dp` ranks in row order (`shard_batch`), the parameters are
replicated (`replicate`), BatchNorm normalises over the global batch, and
every loss, log and metric is that of the global batch. JAX gets this from
one program over a device mesh; here each rank is a process of one
`torch.distributed` process group, and the port's modules act on the
global batch whenever a group is initialised:

  - `models.resnet.BatchNorm` (train mode) all-reduces its per-channel
    sum and sum of squares through `all_reduce_sum`, whose backward sums
    the cotangents over the ranks;
  - `losses` divide each rank's numerators by the global denominators
    (`sum_over_ranks`), so each rank's loss is its share of the global one
    and the gradients summed over the ranks are the global loss's;
  - `ops.voting` and `ops.voting_soft` take vote draws as the global
    batch's and draw fresh ones for it, then take this rank's
    (`rank_rows`); the adaptive RANSAC loop runs while any slot of any rank
    is not confident (`all_ranks_true`);
  - `metrics` sums the mask scores' counts and the pose metric bank's
    updates;
  - `train.task`'s steps sum the gradients (with the CC kernel's error
    flag) in one all-reduce, sum the logs and the metric bank, and draw the
    global batch's dropout masks.

A group of one rank takes the same path: the smoke runs NCCL that way on
one card. Outside a group every helper here is the identity and nothing
communicates.

`launch` runs a function on N ranks, each a spawned process that joins the
group through a `file://` store in a fresh directory (no fixed TCP port
to collide on), with a timeout on every collective; a rank that fails, or a
deadline that passes, ends every rank, and the failed rank's traceback is
raised in the caller.

Not ported: tensor parallelism (`NUM_TP > 1`, `shard_state_tp`), and the
multi-host helpers `shard_batch_multihost` and `make_multislice_mesh`
(ROADMAP.md queue A item 13).
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
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ('dp', 'tp') layout of the JAX package's mesh; `tp` is 1."""
    dp: int
    tp: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}


def make_mesh(n_devices: int, tp: int = 1) -> Mesh:
    """`n_devices` data-parallel ranks. Tensor parallelism is not ported."""
    if tp != 1:
        raise NotImplementedError(
            f"tp={tp}: tensor parallelism (NUM_TP > 1, shard_state_tp) is not "
            "ported; see ROADMAP.md queue A item 13")
    if n_devices < 1:
        raise ValueError(f"n_devices={n_devices}")
    return Mesh(n_devices, 1)


def default_backend(device) -> str:
    """NCCL for CUDA tensors, gloo for CPU ones."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def active() -> bool:
    """Whether this process is a rank of an initialised process group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


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
    `dim`; B must divide by n."""
    n = world_size() if ranks is None else ranks
    r = rank() if r is None else r
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


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the cotangents over the ranks
    (each rank's output feeds its own share of the global loss)."""

    @staticmethod
    def forward(ctx, x):
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks, with gradient."""
    return _AllReduceSum.apply(x) if active() else x


@torch.no_grad()
def sum_over_ranks(tensors: Sequence[torch.Tensor],
                   dtype: torch.dtype = torch.float32) -> List[torch.Tensor]:
    """Each tensor summed over the ranks, without gradient, in one
    all-reduce of a buffer of `dtype` (each result takes its input's dtype
    back). Outside a group, the tensors themselves."""
    tensors = list(tensors)
    if not active() or not tensors:
        return tensors
    flat = torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors])
    dist.all_reduce(flat)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return out


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the ranks, without gradient."""
    return sum_over_ranks([x])[0]


def all_ranks_true(flag: torch.Tensor) -> bool:
    """Whether a boolean scalar is true on every rank (one host read)."""
    flag = flag.to(torch.int32).reshape(1)
    if active():
        flag = flag.clone()
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
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


def broadcast_object(obj):
    """Rank 0's picklable `obj` on every rank."""
    if not active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, 0)
    return box[0]


def all_gather_object(obj) -> List[Any]:
    """Every rank's picklable `obj`, in rank order."""
    if not active():
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def backend() -> Optional[str]:
    return dist.get_backend() if active() else None


# -----------------------------------------------------------------------------
# Launching ranks


def _rank_main(fn, r: int, world: int, backend: str, init_file: str,
               timeout_s: float, threads: Optional[int], args, results) -> None:
    # The package's modules read the group from torch.distributed, so a rank
    # is a plain process that joins it before calling `fn`.
    try:
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=r,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(*args)
        finally:
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
    return "\n".join(f"data-parallel rank {r} of {world} failed:\n{tb}"
                     for r, tb in sorted(failed.items()))


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(timeout=10)


def launch(fn: Callable, world: int, args: Sequence[Any] = (), *, backend: str,
           store_dir: Optional[str] = None, deadline_s: Optional[float] = None,
           threads: Optional[int] = None) -> List[Any]:
    """Run `fn(*args)` on `world` ranks, each a spawned process in one
    process group of `backend` ('gloo' or 'nccl'; named by the caller).
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
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="fpcnn_dp_", dir=store_dir)
    init_file = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, name=f"dp-rank-{r}",
                         args=(fn, r, world, backend, init_file, timeout_s, threads,
                               tuple(args), results))
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
                            f"data-parallel rank {dead[0][0]} of {world} exited with "
                            f"code {dead[0][1]} and no traceback") from None
                elif time.monotonic() > deadline:
                    raise TimeoutError(
                        f"data-parallel ranks {sorted(set(range(world)) - set(got))} of "
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
            raise RuntimeError(f"data-parallel ranks {late} did not exit cleanly: "
                               f"{[procs[i].exitcode for i in late]}")
    finally:
        _stop(procs)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(world)]
