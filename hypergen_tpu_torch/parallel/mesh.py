"""The process layer of a pod: one process per CUDA card, torch.distributed.

Counterpart of ``hypergen_tpu.parallel.mesh``. The JAX package builds a
(db, q) ``Mesh`` over every device of every process; this port shards over
lists of ``torch.device`` inside one process (``parallel.search``,
``parallel.seqpar``), so ``make_mesh`` has no counterpart here. What is
left is the pod: several processes, each with its own card, that agree on a
run token and gather the top-k candidates of `search`.

Start a pod with the JAX package's variables, one process per rank::

    HG_NUM_PROCESSES=N HG_PROCESS_ID=i HG_COORDINATOR=host:port \\
        python -m hypergen_tpu_torch.cli ...

or with ``torchrun`` and ``HG_DIST=1`` (``init_method="env://"`` reads the
RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT that it sets)::

    HG_DIST=1 torchrun --standalone --nproc_per_node N \\
        -m hypergen_tpu_torch.cli ...

The backend follows from the layout before init and is logged; none is
chosen as a fallback after a failure (``choose_backend``). A failed init
raises, so a pod never runs as N one-process runs. ``HG_DIST_TIMEOUT_S``
(default DEFAULT_TIMEOUT_S) bounds the init and every collective.
"""

from __future__ import annotations

import datetime
import logging
import os
import time
from typing import List

import torch
import torch.distributed as dist

log = logging.getLogger("hypergen")

# seconds the init and each collective may wait for the slowest rank
DEFAULT_TIMEOUT_S = 600.0


def choose_backend(device_name: str, local_processes: int, cards: int) -> str:
    """The backend of a layout: ``nccl`` when every process of the host has
    a CUDA card of its own; ``gloo`` for ``-D cpu``, and for CUDA ranks that
    share a card (NCCL refuses two ranks on one GPU; what crosses is a few
    KB of top-k candidates, staged through the host, while the compute
    stays on the card)."""
    if device_name == "cuda" and 0 < local_processes <= cards:
        return "nccl"
    return "gloo"


def _own_card(process_id: int) -> torch.device:
    """The card of a process: LOCAL_RANK when set (torchrun), else the
    process id, modulo the host's card count (ranks share when there are
    fewer cards than processes)."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("-D cuda: no CUDA device is available")
    return torch.device(
        "cuda", int(os.environ.get("LOCAL_RANK", process_id)) % n)


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=float(
        os.environ.get("HG_DIST_TIMEOUT_S", "") or DEFAULT_TIMEOUT_S))


def _init(device_name: str, process_id: int, num_processes: int,
          init_method: str) -> None:
    """Pick the backend from the layout, bind the card, then init. The
    host's process count is LOCAL_WORLD_SIZE when set (torchrun sets it;
    set it on each host of a multi-host launch), else the world size."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    cards = torch.cuda.device_count() if device_name == "cuda" else 0
    backend = choose_backend(device_name, local, cards)
    where = "cpu"
    if device_name == "cuda":
        card = _own_card(process_id)
        torch.cuda.set_device(card)
        where = str(card)
    log.info("pod: process %d/%d on %s, backend %s (%d process(es) and %d "
             "card(s) on this host)", process_id, num_processes, where,
             backend, local, cards)
    t0 = time.monotonic()
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=_timeout())
    log.info("pod: process group started in %.3f s",
             time.monotonic() - t0)


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     device_name: str) -> bool:
    """Explicit pod init over ``tcp://coordinator``; a no-op returning
    False when num_processes <= 1."""
    if num_processes <= 1:
        return False
    _init(device_name, process_id, num_processes, "tcp://" + coordinator)
    return True


def maybe_init_distributed(device_name: str) -> bool:
    """Env-driven pod init for the CLI entry point; True when it started
    the group (the caller then calls finalize).

      HG_NUM_PROCESSES=N HG_PROCESS_ID=i HG_COORDINATOR=host:port  explicit
      HG_DIST=1   init_method="env://" from torchrun's RANK, WORLD_SIZE,
                  MASTER_ADDR and MASTER_PORT

    Otherwise, or when a group already exists, nothing: a one-process run
    pays no coordinator wait."""
    if dist.is_initialized():
        return False
    n = int(os.environ.get("HG_NUM_PROCESSES", "0") or 0)
    if n > 1:
        return init_distributed(
            os.environ.get("HG_COORDINATOR", ""), n,
            int(os.environ.get("HG_PROCESS_ID", "0") or 0), device_name)
    if os.environ.get("HG_DIST", "").lower() in ("1", "auto", "true"):
        _init(device_name, int(os.environ["RANK"]),
              int(os.environ["WORLD_SIZE"]), "env://")
        return True
    return False


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_devices(device_name: str) -> List[torch.device]:
    """The devices of this process: its own card for ``cuda`` (see
    _own_card), else ``[torch.device(device_name)]``."""
    if device_name == "cuda":
        return [_own_card(process_index())]
    return [torch.device(device_name)]


def _collective_device() -> torch.device:
    """Where tensors cross: the process's card under NCCL, the host under
    gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shared_run_token() -> str:
    """A random token agreed by all processes: 8 bytes drawn by process 0
    and broadcast. Tags each run's part files so that a merge never takes
    the parts of an earlier, crashed run in the same directory."""
    if process_count() == 1:
        return os.urandom(8).hex()
    tok = torch.zeros(8, dtype=torch.uint8)
    if process_index() == 0:
        tok = torch.frombuffer(bytearray(os.urandom(8)), dtype=torch.uint8)
    tok = tok.to(_collective_device())
    dist.broadcast(tok, src=0)
    return bytes(tok.cpu().tolist()).hex()


def all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    """Every process's t (the same shape and dtype on each), in rank order,
    on the collective device."""
    t = t.to(_collective_device()).contiguous()
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return out


def finalize() -> None:
    """Tear the group down (the CLI calls this in a finally)."""
    if dist.is_initialized():
        dist.destroy_process_group()
