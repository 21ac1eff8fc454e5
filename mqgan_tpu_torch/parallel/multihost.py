"""Process groups for multi-process training (counterpart of
``mqgan_tpu/parallel/multihost.py``).

JAX runs one process per host and a mesh over every device of every host;
the port runs one process per rank, each on one device, joined by a
``torch.distributed`` group:

* ``initialize`` builds the group over ``tcp://`` from explicit arguments
  (``--coordinator --num_processes --process_id``), or from a launcher's
  environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``
  as ``torchrun`` sets them). Without either it stays single-process and
  says so, as JAX's falls back; explicit arguments that fail raise.
* The backend follows the devices: NCCL when each rank has its own card,
  gloo on the CPU or when ranks share a card (NCCL refuses two ranks on
  one device). Every group has a finite timeout, so a rank that dies
  fails its peers' collectives instead of hanging them.
* ``launch`` starts one rank per device of a list (which may repeat a
  device) from one parent process, on a free localhost port, and fails
  within its timeout when any rank fails. A SIGTERM or SIGINT to the
  parent asks the ranks to stop (SIGUSR1) and waits for them; a second
  one kills them.
* ``host_info``, ``shard_files_for_host`` and ``replicate_`` (broadcast
  from rank 0: the counterpart of ``globalize_tree`` / ``replicate_tree``);
  ``host_names`` (every rank's host, for the rule that a seq group sits
  inside one host) and ``group_timeout_s`` (the group's timeout, which the
  seq groups made from it keep).
"""

from __future__ import annotations

import datetime
import os
import queue
import signal
import socket
import threading
import time
import traceback
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from mqgan_tpu_torch.parallel.dp import broadcast_, world

GROUP_TIMEOUT_S = 600.0
ENV_KEYS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
HOST_NAME_BYTES = 64
_timeout_s = [GROUP_TIMEOUT_S]  # of the group ``initialize`` made last


def choose_backend(devices: Sequence) -> str:
    """NCCL when every rank has a card of its own, gloo when any rank is on
    the CPU or two ranks share a device."""
    devs = [torch.device(d) for d in devices]
    if any(d.type != "cuda" for d in devs) or len(set(devs)) < len(devs):
        return "gloo"
    return "nccl"


def rank_device(device, rank: int = 0) -> torch.device:
    """The device of this rank: ``device`` as given when it names an index
    or the CPU; a bare "cuda" (or None) is card ``LOCAL_RANK`` (a
    launcher's) or ``rank`` modulo the visible cards."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        n = max(torch.cuda.device_count(), 1)
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)) % n)
    return dev


def _backend_for(dev: torch.device, world_size: int) -> tuple:
    if dev.type != "cuda":
        return "gloo", "CPU ranks"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if local <= torch.cuda.device_count():
        return "nccl", "a card per rank"
    return "gloo", f"{local} ranks share {torch.cuda.device_count()} card(s)"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, device=None,
               backend: str | None = None,
               timeout_s: float = GROUP_TIMEOUT_S) -> bool:
    """Join (or create) the process group; True when this call created
    one, False when there is nothing to join (single-process) or a group
    already exists (``launch``'s). ``coordinator_address`` is
    ``host:port`` or a ``tcp://`` URL (rank 0 listens there)."""
    if dist.is_initialized():
        return False
    explicit = (coordinator_address, num_processes, process_id)
    if any(v is not None for v in explicit):
        if any(v is None for v in explicit):
            raise ValueError("--coordinator, --num_processes and --process_id "
                             "go together (or none: a launcher's RANK, "
                             "WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process_id {process_id} not in [0, "
                             f"{num_processes})")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        rank, size = int(process_id), int(num_processes)
    elif all(k in os.environ for k in ENV_KEYS):
        url = "env://"
        rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        missing = [k for k in ENV_KEYS if k not in os.environ]
        print(f"multihost: single-process mode (no --coordinator, and "
              f"{', '.join(missing)} not in the environment)")
        return False
    dev = rank_device(device, rank)
    why = "as asked"
    if backend is None:
        backend, why = _backend_for(dev, size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    print(f"multihost: rank {rank} of {size} on {dev}, backend {backend} "
          f"({why}), {url}")
    dist.init_process_group(backend, init_method=url, rank=rank,
                            world_size=size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _timeout_s[0] = float(timeout_s)
    return True


def group_timeout_s() -> float:
    """The timeout of the group ``initialize`` made."""
    return _timeout_s[0]


def host_name() -> str:
    return socket.gethostname()


def host_names(device) -> list:
    """Every rank's ``host_name()`` (its first HOST_NAME_BYTES bytes), in
    rank order: each rank writes its own row of a zero table and one SUM
    reduction completes it."""
    rank, n = world()
    raw = host_name().encode()[:HOST_NAME_BYTES]
    table = torch.zeros((n, HOST_NAME_BYTES), dtype=torch.int32, device=device)
    table[rank, :len(raw)] = torch.tensor(list(raw), dtype=torch.int32)
    if n > 1:
        dist.all_reduce(table)
    return [bytes(int(c) for c in row if c).decode(errors="replace")
            for row in table.cpu().tolist()]


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def host_info() -> tuple:
    """(process index, process count), JAX's names for (rank, world)."""
    return world()


def shard_files_for_host(files: Sequence[str]) -> list:
    """This rank's round-robin share of ``files``, for work whose uneven
    shares are harmless (a re-encode). Training does not use it: each rank
    loads its rows of every global batch (``train/data.py`` ``MelLoader``),
    so batches and step counts do not depend on the process count."""
    idx, count = host_info()
    return [f for i, f in enumerate(files) if i % count == idx]


def replicate_(tensors) -> None:
    """Give every rank rank 0's values of ``tensors`` (in place): the
    initial state, so that a rank out of step is impossible."""
    broadcast_(list(tensors), src=0)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(fn, rank, devices, port, backend, group_timeout_s, args, results):
    try:
        dev = torch.device(devices[rank])
        initialize(f"127.0.0.1:{port}", len(devices), rank, device=dev,
                   backend=backend, timeout_s=group_timeout_s)
        out = fn(rank, len(devices), dev, *args)
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - reported to the parent, then exit 1
        results.put((rank, False, traceback.format_exc()))
        results.close()
        results.join_thread()
        os._exit(1)
    shutdown()


def _forward_stop(procs) -> dict:
    """While the ranks run, a SIGTERM or SIGINT to this process sends each
    live rank SIGUSR1 (a request to stop, which the rank's ``fn`` may
    handle: the trainer checkpoints and returns; unhandled, it ends the
    rank) and the parent keeps waiting for them; a second signal raises
    KeyboardInterrupt, and ``launch`` kills the ranks. SIGUSR1 and not the
    signal itself, because a terminal's Ctrl-C or a job's SIGTERM to the
    process group reaches the ranks too, and a rank takes a second SIGINT
    or SIGTERM as a force-quit. Returns the previous handlers ({} off the
    main thread, where signals cannot be set)."""
    if threading.current_thread() is not threading.main_thread():
        return {}
    asked = []

    def stop(signum, frame):
        if asked:
            raise KeyboardInterrupt
        asked.append(signum)
        print(f"launch: signal {signum}: asking the ranks to stop (SIGUSR1) "
              "and waiting for them (signal again to kill them)", flush=True)
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signal.SIGUSR1)

    return {sig: signal.signal(sig, stop) for sig in (signal.SIGTERM, signal.SIGINT)}


def launch(fn: Callable, devices: Sequence, args: tuple = (), *,
           timeout_s: float | None = 600.0,
           group_timeout_s: float | None = None) -> list:
    """Run ``fn(rank, world, device, *args)`` in one spawned process a
    device of ``devices`` (a list may repeat a device: ranks then share it
    over gloo), in one group on a free localhost port; returns the ranks'
    return values (picklable host objects) in rank order. Raises, after
    killing every rank, when a rank fails or ``timeout_s`` passes: a rank
    blocked in a collective with a dead peer never hangs the caller. A
    signal to the caller is passed on to the ranks (``_forward_stop``).
    ``fn`` must be importable by name (a module-level function)."""
    import multiprocessing as mp

    devices = [str(torch.device(d)) for d in devices]
    backend = choose_backend(devices)
    if group_timeout_s is None:
        group_timeout_s = GROUP_TIMEOUT_S if timeout_s is None else timeout_s
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_entry, args=(
        fn, r, devices, port, backend, group_timeout_s, args, results))
        for r in range(len(devices))]
    for p in procs:
        p.start()
    done: dict = {}
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    prev = _forward_stop(procs)
    try:
        while len(done) < len(procs):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"ranks {sorted(set(range(len(procs))) - set(done))} "
                                   f"did not finish within {timeout_s} s")
            try:
                rank, ok, out = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {len(procs)} failed:\n{out}")
            done[rank] = out
        for p in procs:
            p.join(None if deadline is None
                   else max(deadline - time.monotonic(), 1.0))
            if p.exitcode != 0:
                raise RuntimeError(f"a rank exited with code {p.exitcode}")
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, handler)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
    return [done[r] for r in range(len(procs))]
