"""Rank groups and their launcher: the port's counterpart of the JAX
package's 1-D device mesh with axis ``"p"``.

A JAX ``shard_map`` program runs once per device of the mesh and reduces
over the axis with ``psum``.  Here each device of the mesh is a rank
process: ``launch`` starts G of them, each calls the same function with
its own ``Group``, and ``Group.psum`` is an in-place
``torch.distributed.all_reduce`` (SUM) over the G ranks.

* The backend is always the caller's: ``"gloo"`` for CPU tensors, and for
  CUDA tensors when ranks share a card (gloo stages a CUDA tensor's
  reduction through the host); ``"nccl"`` only with one card per rank
  (NCCL refuses two ranks on one GPU).  Nothing switches backend or device
  on its own: ``rank_layout`` is where a caller picks them.
* The ranks meet through a ``file://`` store in a new temporary directory,
  so that parallel test processes never contend for a TCP port.
* The rank function and its arguments travel by pickle: the function by
  its import path, the arguments through one file in that directory that
  every rank loads.  Under the ``spawn`` start method a rank imports the
  module that holds the function, so it must live in a module that
  imports no JAX (``parallel/runs.py``); a function defined in a test
  file would import JAX into every rank.  Results go back through a
  queue: return host objects (numpy arrays, numbers), not tensors.
* ``launch`` joins every rank under one time limit and raises in the
  parent if a rank raised, timed out or exited non-zero; the other ranks
  are then killed, so a rank left waiting in a collective cannot hang the
  caller.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from parsy_bench_tpu_torch.ops.device import resolve_device

BACKENDS = ("gloo", "nccl")


class RankError(RuntimeError):
    """A rank raised, timed out or exited non-zero."""


@dataclasses.dataclass
class Group:
    """One rank's view of the group: its ``rank`` of ``size``, the
    ``device`` its tensors live on and the ``backend`` of the process
    group.  ``calls`` and ``nbytes`` count the ``psum`` calls and their
    payload bytes since the last ``reset_counts``."""
    rank: int
    size: int
    device: torch.device
    backend: str
    calls: int = 0
    nbytes: int = 0

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group, in place (the JAX ``psum`` over the
        mesh axis), and return it."""
        if not t.is_contiguous():
            raise ValueError("psum takes a contiguous tensor (it reduces "
                             "in place)")
        if t.device != self.device:
            raise ValueError(f"psum of a tensor on {t.device} in a group "
                             f"on {self.device}")
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        self.calls += 1
        self.nbytes += t.numel() * t.element_size()
        return t

    def reset_counts(self) -> None:
        self.calls = 0
        self.nbytes = 0


def group_device(group: Group, device) -> torch.device:
    """An executor's device in ``group``: the one the caller named
    (``ops/device.resolve_device``: CUDA raises where there is none),
    which must be the group's."""
    dev = resolve_device(device)
    if dev != group.device:
        raise ValueError(f"executor on {dev}, its group on {group.device}")
    return dev


def rank_layout(size: int, device) -> tuple:
    """(backend, devices) of ``size`` ranks for work the caller asked to
    run on ``device``: on the CPU gloo with every rank on ``"cpu"``; on a
    card NCCL with one card per rank where the machine has ``size`` cards,
    else gloo with every rank on the first card (NCCL refuses two ranks on
    one GPU).  A CUDA device raises where there is none."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "gloo", [torch.device("cpu")] * size
    if torch.cuda.device_count() >= size:
        return "nccl", [torch.device("cuda", r) for r in range(size)]
    return "gloo", [torch.device("cuda", 0)] * size


def _check_layout(size, backend, devices):
    """The rank devices as torch devices, after the backend's rules."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if size < 1:
        raise ValueError(f"group size {size} < 1")
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * size
    # a CPU tensor's device carries no index: name the CPU without one
    devices = [torch.device(d) if torch.device(d).type != "cpu"
               else torch.device("cpu") for d in devices]
    if len(devices) != size:
        raise ValueError(f"{len(devices)} devices for {size} ranks")
    if any(d.type not in ("cpu", "cuda") for d in devices):
        raise ValueError(f"unsupported devices {devices}: cpu or cuda")
    if any(d.type == "cuda" and d.index is None for d in devices):
        raise ValueError("name each CUDA device with its index (cuda:0)")
    if backend == "nccl" and (any(d.type != "cuda" for d in devices)
                              or len(set(devices)) != size):
        raise ValueError("nccl needs one CUDA device per rank; ranks that "
                         "share a card use gloo")
    return devices


def _rank_main(rank, size, backend, device, tmp, fn, results, timeout):
    """A rank process: join the group, run ``fn(group, *args)``, send back
    ("ok", rank, result) or ("error", rank, traceback)."""
    code = 0
    try:
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        # the host's cores shared among the ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(tmp, "store"),
            world_size=size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        with open(os.path.join(tmp, "args.pkl"), "rb") as f:
            args = pickle.load(f)
        out = fn(Group(rank, size, device, backend), *args)
        results.put(("ok", rank, out))
    except Exception:
        results.put(("error", rank, traceback.format_exc()))
        code = 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    sys.exit(code)


def launch(fn, size: int, backend: str, devices, args=(),
           timeout: float = 600.0) -> list:
    """Run ``fn(group, *args)`` in ``size`` rank processes (spawned) and
    return their results by rank.

    ``fn`` is a module-level function of a module that imports no JAX;
    ``backend`` is ``"gloo"`` or ``"nccl"``; ``devices`` names each rank's
    device (one for all, or a list): ``"cpu"``, or ``"cuda:i"``.  Raises
    ``RankError`` if a rank raised, exited non-zero or the ranks did not
    all finish within ``timeout`` seconds."""
    devices = _check_layout(int(size), backend, devices)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="pbt_ranks_") as tmp:
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump(tuple(args), f, protocol=pickle.HIGHEST_PROTOCOL)
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, size, backend, str(devices[r]), tmp, fn,
                                   results, timeout))
                 for r in range(size)]
        for p in procs:
            p.start()
        try:
            out = _collect(procs, results, time.monotonic() + timeout)
        except BaseException:
            for p in procs:
                if p.is_alive():
                    p.kill()
            raise
        finally:
            # a rank that has sent its result still leaves the group and
            # exits; one that does not within the grace time is killed
            for p in procs:
                p.join(30)
                if p.is_alive():
                    p.kill()
                    p.join(5)
            results.close()
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RankError(f"ranks exited non-zero: {bad}")
    return out


def _collect(procs, results, deadline) -> list:
    """Each rank's result, read from the queue before any join (a rank
    blocks at exit until its result is read)."""
    size = len(procs)
    got: dict = {}
    exited_at: dict = {}
    while len(got) < size:
        if time.monotonic() > deadline:
            missing = sorted(set(range(size)) - set(got))
            raise RankError(f"ranks {missing} did not finish in time")
        try:
            status, rank, out = results.get(timeout=0.2)
        except queue.Empty:
            pass
        else:
            if status != "ok":
                raise RankError(f"rank {rank} of {size} raised:\n{out}")
            got[rank] = out
            continue
        for r, p in enumerate(procs):
            if r in got or p.exitcode is None:
                continue
            if p.exitcode != 0:
                raise RankError(f"rank {r} of {size} exited with code "
                                f"{p.exitcode} and no result")
            # exited 0: its result may still be in the pipe
            exited_at.setdefault(r, time.monotonic())
            if time.monotonic() - exited_at[r] > 10.0:
                raise RankError(f"rank {r} of {size} exited without a "
                                f"result")
    return [got[r] for r in range(size)]
