"""Multi-process runtime: one process per rank, coordinated by
``torch.distributed``.

Port of ``imagined_speech_translation_tpu.parallel.distributed`` with the same
environment contract, so launchers configure it without flags:

* ``IST_COORDINATOR`` (``host:port``), ``IST_NUM_PROCESSES`` and
  ``IST_PROCESS_ID``: the process group's TCP store at
  ``tcp://$IST_COORDINATOR`` (rank 0 serves it), its world size and this
  process's rank;
* ``IST_DISTRIBUTED=1``: torchrun's ``MASTER_ADDR``, ``MASTER_PORT``,
  ``RANK`` and ``WORLD_SIZE`` instead (the counterpart of the JAX module's
  cluster autodetect);
* ``IST_BACKEND``: ``nccl`` or ``gloo``.  Without it (or ``backend=``) the
  backend is ``nccl`` for ranks on the card and ``gloo`` for ranks on the
  CPU.  It is never switched behind the caller's back: NCCL refuses two
  ranks on one card, so there :func:`initialize_distributed` raises and
  names ``IST_BACKEND=gloo``, which reduces through the host.

A rank's card is ``cuda:{process_id % device_count}`` (:func:`rank_device`).
Without any of these variables nothing starts and the single-process path is
untouched.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

BACKENDS = ("nccl", "gloo")


class _Runtime:
    """The process's store and barrier generations (one per process, as
    ``torch.distributed``'s default group is)."""

    store: dist.Store | None = None
    barriers: dict[str, int] = {}


def _env_int(name: str) -> int | None:
    return int(os.environ[name]) if name in os.environ else None


def choose_backend(device: torch.device | str, backend: str | None = None) -> str:
    """``backend``, else ``IST_BACKEND``, else ``nccl`` on cuda and ``gloo``
    on the CPU; raises for a backend that cannot serve ``device``."""
    device = torch.device(device)
    backend = backend or os.environ.get("IST_BACKEND") or (
        "nccl" if device.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: IST_BACKEND is one of {BACKENDS}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend reduces on CUDA cards; CPU ranks need "
                         "IST_BACKEND=gloo")
    return backend


def rank_device(device: torch.device | str = "cuda") -> torch.device:
    """This rank's device: ``cuda:{rank % device_count}`` for ``cuda``, the
    CPU for ``cpu``; raises without a card."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass device='cpu' (--device cpu) for CPU ranks")
    return torch.device("cuda", process_index() % torch.cuda.device_count())


def _card_id(device: torch.device) -> str:
    props = torch.cuda.get_device_properties(device)
    return f"{socket.gethostname()}/{getattr(props, 'uuid', device.index)}"


def _refuse_shared_cards(store: dist.Store, rank: int, world: int, device: torch.device):
    """Raise on every rank if two ranks hold one card (NCCL refuses them)."""
    store.set(f"ist_card/{rank}", _card_id(device))
    cards = [store.get(f"ist_card/{r}").decode() for r in range(world)]
    if len(set(cards)) < world:
        raise RuntimeError(
            f"{world} ranks on {len(set(cards))} card(s): NCCL refuses two ranks on one "
            "card; set IST_BACKEND=gloo to reduce through the host")


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    device: torch.device | str = "cuda",
    timeout_s: float = 1800.0,
) -> bool:
    """Start the process group; returns True if there is more than one rank.

    A no-op that returns False when neither a coordinator nor
    ``IST_DISTRIBUTED`` is configured.  Safe to call more than once: a
    started group is kept.  ``device`` is where the ranks compute (``cuda``
    or ``cpu``); on ``cuda`` the rank's card becomes the current device."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator_address = coordinator_address or os.environ.get("IST_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("IST_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("IST_PROCESS_ID")
    if os.environ.get("IST_DISTRIBUTED", "") in ("1", "true") and coordinator_address is None:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        num_processes = int(os.environ["WORLD_SIZE"]) if num_processes is None else num_processes
        process_id = int(os.environ["RANK"]) if process_id is None else process_id
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a process group needs IST_COORDINATOR, IST_NUM_PROCESSES and "
                         "IST_PROCESS_ID (or IST_DISTRIBUTED=1 under torchrun)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside 0..{num_processes - 1}")
    device = torch.device(device)
    backend = choose_backend(device, backend)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card: pass device='cpu' (--device cpu) for CPU ranks")
        device = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    host, _, port = coordinator_address.rpartition(":")
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0,
                          timeout=timeout)
    if backend == "nccl":
        _refuse_shared_cards(store, process_id, num_processes, device)
    dist.init_process_group(backend, store=store, world_size=num_processes, rank=process_id,
                            timeout=timeout)
    _Runtime.store = store
    logger.info("distributed runtime: process %d/%d, backend %s, device %s", process_id,
                num_processes, backend, device)
    return num_processes > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that owns host-side side effects (metrics files,
    checkpoints, wandb)."""
    return process_index() == 0


def sync_hosts(name: str = "ist_barrier") -> None:
    """Barrier across ranks through the process group (no-op in one
    process); ``name`` labels it in the log."""
    if process_count() > 1:
        logger.debug("barrier %s", name)
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def host_barrier(name: str = "ist_host_barrier", timeout_s: float = 600.0) -> None:
    """Barrier through the store alone, with a timeout: no collective runs,
    so it lines ranks up before the first one.  No-op in one process."""
    if _Runtime.store is None or process_count() == 1:
        return
    gen = _Runtime.barriers.get(name, 0)
    _Runtime.barriers[name] = gen + 1
    key = f"ist_host_barrier/{name}/{gen}"
    if _Runtime.store.add(key, 1) == process_count():
        _Runtime.store.set(f"{key}/done", "1")
    _Runtime.store.wait([f"{key}/done"], datetime.timedelta(seconds=timeout_s))
