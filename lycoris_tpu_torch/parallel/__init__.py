"""lycoris_tpu_torch.parallel -- the multi-device path on ``torch.distributed``
(counterpart of ``lycoris_tpu/parallel``).

One process a rank, each on its own device: call :func:`init_distributed`
once per process (under ``torchrun`` it reads the launcher's environment),
build a ``(data, model)`` mesh with :func:`sharding.make_mesh`, and give it
to ``DiffusionTrainer(mesh=..., shard_base=...)``. :func:`run_world` starts
a world of spawned processes on one host, for tests and dry runs.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time

import torch
import torch.distributed as dist

# the longest any collective of a world started here may wait for its peers
COLLECTIVE_TIMEOUT_S = 300


def backend_for(device) -> str:
    """``nccl`` for the card, ``gloo`` when the caller asks for the CPU."""
    return "gloo" if torch.device(device).type == "cpu" else "nccl"


def init_distributed(coordinator_address=None, num_processes=None, process_id=None,
                     device="cuda") -> torch.device:
    """Join the default process group and return this rank's device.

    The arguments default to torchrun's environment (``MASTER_ADDR``/
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``).
    ``coordinator_address`` is ``host:port`` or an init-method URL
    (``tcp://...``, ``file://...``). The backend is NCCL on the card (each
    rank takes ``cuda:LOCAL_RANK``) and gloo when ``device`` is the CPU.

    Nothing happens when a process group already exists, or when there is
    one process and no launcher environment. A failed initialisation raises
    (the JAX counterpart swallows it).
    """
    dev = torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", 0))
    if dev.type == "cuda":
        dev = torch.device("cuda", local if dev.index is None else dev.index)
    if dist.is_available() and dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        return dev
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else os.environ.get("RANK", 0))
    launched = "WORLD_SIZE" in os.environ or coordinator_address is not None
    if world == 1 and not launched:
        return dev
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev), init_method=init_method, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return dev


def _rank_main(fn, rank, world, init_method, backend, log_path, out_path, args):
    """One spawned rank: stderr to ``log_path``, join the world, run
    ``fn(rank, world, *args)``, save its result to ``out_path``."""
    fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 2)
    os.close(fd)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        torch.save(fn(rank, world, *args), out_path)
    finally:
        dist.destroy_process_group()


def run_world(fn, n: int, *args, backend: str = "gloo", timeout: float = 120.0) -> list:
    """Run ``fn(rank, n, *args)`` in ``n`` processes started by ``spawn``,
    joined in one ``backend`` world through a ``file://`` rendezvous in a
    temporary directory, and return their results by rank (``fn`` and the
    results must pickle; ``fn`` is imported by name in each process).

    Every rank is killed when any one fails or ``timeout`` seconds pass,
    and the error carries the failing rank's stderr tail.
    """
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="lycoris_world_") as tmp:
        init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
        logs = [os.path.join(tmp, f"rank{r}.err") for r in range(n)]
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(n)]
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, n, init_method, backend, logs[r], outs[r], args))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                failed = next((r for r, p in enumerate(procs) if p.exitcode not in (None, 0)),
                              None)
                if failed is not None or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            if failed is None:
                failed = next((r for r, p in enumerate(procs) if p.exitcode not in (None, 0)),
                              None)
            timed_out = failed is None and any(p.is_alive() for p in procs)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10)
        if failed is not None or timed_out:
            r = 0 if failed is None else failed
            with open(logs[r], "rb") as f:
                tail = f.read()[-4000:].decode(errors="replace")
            what = (f"timed out after {timeout:.0f} s" if failed is None
                    else f"rank {r} failed (exit code {procs[r].exitcode})")
            raise RuntimeError(f"run_world: {what}; rank {r}'s stderr:\n{tail}")
        return [torch.load(o, weights_only=False) for o in outs]


from . import sharding  # noqa: E402,F401
