"""Device meshes and the collectives of the parallel layer (PyTorch port of
the JAX package's ``parallel/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the JAX
package's axis names (``"kf"``, ``"tile"``, ``"map"``).  The port runs SPMD:
one process per rank, every rank calls the same function on the same
replicated inputs and gets back the global result the JAX function returns
to its single caller.  The sharding lives inside the functions of
``parallel/sharded.py`` and ``parallel/shard_bin.py``, which use only
``all_reduce``, ``all_gather`` and ``broadcast``: gloo and NCCL both take
these on CPU and CUDA tensors.

``spawn`` starts the ranks of one world on this host (tests, examples,
``chip_smoke.py``), with the backend given explicitly; ``make_mesh`` builds
the mesh over the initialized default group.  Neither switches backend on
its own: a backend that fails to initialize raises.
"""

from __future__ import annotations

import datetime
import traceback

import numpy as np
import torch
import torch.distributed as dist


def make_mesh(shape=None, axis_names=("kf", "tile"), *, backend=None,
              device="cpu"):
    """A ``DeviceMesh`` of ``shape`` over the initialized default group.

    ``shape=None`` puts every rank on the last axis.  ``device`` is the
    device type of the mesh (``"cpu"`` or ``"cuda"``); each rank's CUDA
    device is the one it has set (``spawn`` sets ``cuda:(rank % count)``).
    ``backend``, when given, must be the default group's backend.
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process "
                           "group: start the ranks with parallel.mesh.spawn "
                           "or torch.distributed.init_process_group")
    if backend is not None and dist.get_backend() != backend:
        raise ValueError(f"the default group's backend is "
                         f"{dist.get_backend()!r}, not {backend!r}")
    n = dist.get_world_size()
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (n,)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n or len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} with axes {axis_names} does "
                         f"not cover the world of {n} ranks")
    dev_type = torch.device(device).type
    return init_device_mesh(dev_type, shape,
                            mesh_dim_names=tuple(axis_names))


def parse_mesh(spec: str):
    """``"kf=2,tile=1"`` -> ``((2, 1), ("kf", "tile"))``."""
    names, shape = [], []
    for part in spec.split(","):
        name, _, size = part.partition("=")
        names.append(name.strip())
        shape.append(int(size))
    return tuple(shape), tuple(names)


def has_axis(mesh, axis) -> bool:
    """Whether ``mesh`` has ``axis`` with more than one rank."""
    check_mesh(mesh)
    return (mesh is not None and bool(axis)
            and axis in (mesh.mesh_dim_names or ())
            and axis_size(mesh, axis) > 1)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_group(mesh, axis: str):
    """``(group, rank, n)``: the process group of ``axis`` on this rank,
    this rank's index along it and the axis's size."""
    if not isinstance(mesh, _device_mesh_type()):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, got "
                        f"{type(mesh).__name__}")
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no axis {axis!r} (axes "
                         f"{mesh.mesh_dim_names})")
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.get_group(dim), mesh.get_local_rank(dim), mesh.size(dim)


def check_mesh(mesh):
    """Raise ``TypeError`` unless ``mesh`` is None or a ``DeviceMesh``."""
    if mesh is not None and not isinstance(mesh, _device_mesh_type()):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, got "
                        f"{type(mesh).__name__}")


def _device_mesh_type():
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh


def comm_device(mesh) -> torch.device:
    """Where a host tensor goes for a collective over ``mesh``: the rank's
    CUDA device on a CUDA mesh (NCCL takes only CUDA tensors), else the
    CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------


def all_reduce(x, group, op=dist.ReduceOp.SUM):
    """The reduction of ``x`` over ``group``, as a new tensor (bool as
    uint8 on the wire)."""
    is_bool = x.dtype == torch.bool
    y = x.detach().to(torch.uint8 if is_bool else x.dtype).clone(
        memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=group)
    return y.to(torch.bool) if is_bool else y


def all_gather(x, group, n: int):
    """Every rank's ``x`` concatenated along dim 0 in rank order (bool as
    uint8 on the wire; no gradient, see :class:`AllGather`)."""
    is_bool = x.dtype == torch.bool
    y = (x.detach().to(torch.uint8) if is_bool else x.detach()).contiguous()
    parts = [torch.empty_like(y) for _ in range(n)]
    dist.all_gather(parts, y, group=group)
    out = torch.cat(parts, 0)
    return out.to(torch.bool) if is_bool else out


class AllGather(torch.autograd.Function):
    """:func:`all_gather` with the SPMD gradient: every rank computes the
    same loss from the gathered result, so the cotangent is the same on
    every rank and the backward takes this rank's slice of it, with no
    collective.  (Summing it over the ranks, as
    ``torch.distributed.nn.functional.all_gather`` does, would make the
    gradient n times too large.)"""

    @staticmethod
    def forward(ctx, x, group, rank, n):
        ctx.rows = (rank * x.shape[0], (rank + 1) * x.shape[0])
        return all_gather(x, group, n)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.rows
        return g[lo:hi], None, None, None


def all_gather_grad(x, group, rank: int, n: int):
    """:class:`AllGather` for a float tensor, :func:`all_gather` for any
    other."""
    if x.is_floating_point():
        return AllGather.apply(x, group, rank, n)
    return all_gather(x, group, n)


# --------------------------------------------------------------------------
# ranks on this host
# --------------------------------------------------------------------------


def host_store(timeout: float = 300.0):
    """A rendezvous store served by this process on localhost, on a port
    that the store's own bind takes from the operating system (port 0), so
    no other world can be handed the same port: a port probed free, closed
    and bound later by a rank can be taken in between by another process
    (several test workers start worlds at once).  Ranks connect to it with
    :func:`connect_store` (the serving process may be one of them)."""
    return dist.TCPStore("localhost", 0, is_master=True,
                         wait_for_workers=False,
                         timeout=datetime.timedelta(seconds=timeout))


def connect_store(port: int, world: int, timeout: float = 300.0):
    """A rank's connection to a :func:`host_store` on ``port``."""
    return dist.TCPStore("localhost", port, world, is_master=False,
                         timeout=datetime.timedelta(seconds=timeout))


def rank_device(rank: int, device_type: str) -> torch.device:
    """A rank's device: ``cuda:(rank % count)`` on CUDA, else the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def _to_host(x):
    """Tensors to numpy (CPU) throughout nested tuples, lists and dicts,
    so that a rank's result crosses the process boundary by value."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(rank, fn, args, world, backend, device_type, port, timeout,
               threads, queue):
    try:
        if threads:
            torch.set_num_threads(threads)
        if device_type == "cuda":
            torch.cuda.set_device(rank_device(rank, device_type))
        dist.init_process_group(
            backend, store=connect_store(port, world, timeout),
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        result = _to_host(fn(rank, world, *args))
        queue.put((rank, True, result))
    except BaseException:   # report every failure, then exit non-zero
        queue.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Ranks:
    """The processes of one world started by :func:`start`; :meth:`join`
    waits for their results."""

    def __init__(self, procs, results, nprocs, backend, timeout, store):
        import time
        self.store = store  # the ranks' rendezvous, served until join ends
        self.procs, self.results = procs, results
        self.nprocs, self.backend, self.timeout = nprocs, backend, timeout
        self.deadline = time.monotonic() + timeout

    def join(self):
        """The ranks' results in rank order (tensors as numpy arrays), or
        ``RuntimeError`` when a rank failed, died or ran out of time
        (the other ranks are stopped first)."""
        import queue as queue_mod
        import time

        procs, nprocs, timeout = self.procs, self.nprocs, self.timeout
        got, error = {}, None
        try:
            while len(got) < nprocs and error is None:
                try:
                    rank, ok, payload = self.results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and not p.is_alive()]
                    if dead:
                        # a last result may still be in flight
                        try:
                            rank, ok, payload = self.results.get(timeout=5.0)
                        except queue_mod.Empty:
                            error = (f"rank {dead[0]} exited with code "
                                     f"{procs[dead[0]].exitcode} and no "
                                     f"result")
                            break
                    elif time.monotonic() > self.deadline:
                        error = (f"timed out after {timeout} s waiting for "
                                 f"ranks "
                                 f"{sorted(set(range(nprocs)) - set(got))}")
                        break
                    else:
                        continue
                if ok:
                    got[rank] = payload
                else:
                    error = f"rank {rank} failed:\n{payload}"
            if error is None:
                for p in procs:
                    p.join(max(1.0, self.deadline - time.monotonic()))
                    if p.is_alive():
                        error = f"a rank did not exit within {timeout} s"
                        break
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(5.0)
                if p.is_alive():
                    p.kill()
                    p.join()
        self.store = None
        if error is not None:
            raise RuntimeError(f"spawn of {nprocs} ranks ({self.backend}): "
                               f"{error}")
        return [got[r] for r in range(nprocs)]


def start(fn, nprocs: int, args=(), *, backend: str, device_type="cpu",
          timeout: float = 300.0, threads: int = None) -> Ranks:
    """Start ``fn(rank, nprocs, *args)`` in ``nprocs`` new processes, one
    world with the default group initialized on ``backend`` (``"gloo"`` or
    ``"nccl"``, never chosen here) that meets at a store this process serves
    on localhost (:func:`host_store`); on CUDA each
    rank first sets ``cuda:(rank % count)``.  ``fn`` must be importable by
    name (a module-level function).  Returns at once; ``.join()`` on the
    result waits for the ranks (:func:`spawn` does both).

    ``timeout`` (seconds, from the start) bounds the rendezvous, every
    collective, and the wait for each rank's result and exit: a rank that
    fails, dies or hangs makes ``join`` raise ``RuntimeError`` (the first
    failing rank's traceback in the message) after the other ranks are
    stopped.  ``threads`` sets each rank's ``torch.set_num_threads``
    (default: this process's threads shared out among the ranks, so that
    they do not starve each other or the processes beside them).
    """
    import torch.multiprocessing as mp

    if threads is None:
        threads = max(1, torch.get_num_threads() // nprocs)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = host_store(timeout)
    procs = [ctx.Process(target=_rank_main,
                         args=(r, fn, tuple(args), nprocs, backend,
                               device_type, store.port, timeout, threads,
                               results),
                         daemon=True)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    return Ranks(procs, results, nprocs, backend, timeout, store)


def spawn(fn, nprocs: int, args=(), **kw):
    """:func:`start` the ranks and join them: their results in rank
    order."""
    return start(fn, nprocs, args, **kw).join()
