"""The rank launcher: one cell over several cards, one process a card.

Rank 0 is the harness's own process, so the window's clock, the profiler
and the check stay where a one-card cell has them. Ranks 1..n-1 are
processes of the `spawn` context. Every rank joins one process group
(NCCL on the cards, gloo with `device="cpu"`) through a FileStore in a
temporary directory under TMPDIR, which is removed when the world is
released or fails, and computes on card r: LOCAL_RANK is r, so the
port's `make_mesh()` picks that card.

A traffic kind names a module-level worker function

    worker(rank, size, device, *args) -> a rank's job: unit(), and
                                         optionally spans() and release()

which every rank runs: rank 0 in this process, the others after loading
the function by name from its source file (a traffic kind found by the
harness is a file, not always an importable module). `World.unit()` tells
each worker to run its next unit, runs rank 0's, then waits for every
worker: the collectives the program makes inside a unit pair up across
the ranks. Control messages go over pipes on the host, never through a
device operation, so rank 0's device trace holds the program's work
alone.

Every wait is bounded: set-up by `SETUP_TIMEOUT_S` (a checkout's first
run builds the port's kernels), every unit by `TIMEOUT_S`, which the
process group gets too. A worker dies with rank 0's process. A rank that raises, dies,
hangs or has JAX loaded refuses the run (`harness.Refused`) with its
traceback or the names of the ranks that did not answer, and every
worker is stopped. Under NCCL a host blocked in a collective or in a
device wait cannot be reached from Python, so there a watch thread
reports the fault on standard error, stops the workers and ends the
process with exit code 1 itself; gloo's waits end at the group's
timeout, and the refusal is raised.
"""

from __future__ import annotations

import ctypes
import datetime
import importlib.util
import multiprocessing as mp
import multiprocessing.connection as mpc
import os
import queue
import shutil
import signal
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

from portbench.harness import Refused, forbidden_modules

TIMEOUT_S = 120.0
SETUP_TIMEOUT_S = 1100.0
RELEASE_S = 30.0  # a released worker's time to leave the group and end
PR_SET_PDEATHSIG = 1  # prctl(2)
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# backends whose waits the host cannot leave: a fault ends the process
EXIT_ON_FAULT = {"nccl"}


def peak_bytes(device) -> int:
    """The device's peak of allocated bytes (0 for the CPU)."""
    import torch

    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def rank_device(device_type: str, rank: int):
    import torch

    return torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")


def _settings() -> dict:
    """Rank 0's torch settings, which every worker takes."""
    import torch

    return {"threads": torch.get_num_threads(),
            "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
            "tf32_cudnn": torch.backends.cudnn.allow_tf32}


def _join(rank: int, size: int, device, store: str, timeout_s: float) -> None:
    import torch
    import torch.distributed as dist

    os.environ["LOCAL_RANK"] = str(rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(BACKENDS[device.type], store=dist.FileStore(store, size), rank=rank,
                            world_size=size, timeout=datetime.timedelta(seconds=timeout_s))


def _leave() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _load(where: tuple[str, str]):
    path, name = where
    key = "portbench_rank_" + Path(path).stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, name)


def _die_with(parent: int) -> None:
    """Be killed when rank 0's process ends, also where it is killed while
    this rank waits in a collective or on its card."""
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG)")
    if os.getppid() != parent:  # rank 0 ended before the signal was asked for
        os._exit(1)


def _rank_main(rank: int, size: int, device_type: str, store: str, timeout_s: float, cores,
               settings: dict, where: tuple[str, str], args: tuple, parent: int, conn) -> None:
    """A worker rank: join the group, build the rank's job, then run what
    rank 0 asks for ("unit", "spans", "release") and answer each; on a
    fault, send its traceback."""
    try:
        _die_with(parent)
        if cores:
            os.sched_setaffinity(0, cores)
        import torch

        torch.set_num_threads(settings["threads"])
        torch.backends.cuda.matmul.allow_tf32 = settings["tf32_matmul"]
        torch.backends.cudnn.allow_tf32 = settings["tf32_cudnn"]
        device = rank_device(device_type, rank)
        _join(rank, size, device, store, timeout_s)
        job = _load(where)(rank, size, device, *args)
        conn.send(("ready", forbidden_modules()))
        spans = {}
        while (what := conn.recv()) != "release":
            if what == "unit":
                job.unit()
            elif hasattr(job, "spans"):
                spans = job.spans()
            conn.send(("done", None))
        peak = peak_bytes(device)
        if hasattr(job, "release"):
            job.release()
        conn.send(("released", {"peak": peak, "spans": spans, "forbidden": forbidden_modules()}))
    except Exception:  # the rank's boundary: rank 0 reports it and stops the run
        try:
            conn.send(("error", traceback.format_exc()))
        except OSError:  # rank 0 is gone
            pass
    finally:
        _leave()


def _ranks(ranks) -> str:
    return ", ".join(str(r) for r in sorted(ranks))


class World:
    """`cell.chips` ranks of `worker` (see the module), rank 0 in this
    process. `local` is rank 0's job; after `release()`, `peaks` holds
    each rank's peak of device bytes and `rank_spans` each rank's spans,
    in rank order."""

    def __init__(self, worker, cell, device, args: tuple = ()):
        if "<" in worker.__qualname__ or "." in worker.__qualname__:
            raise ValueError(f"{worker.__qualname__} is not a module-level function")
        import torch

        self.size = int(cell.chips)
        self.device_type = torch.device(device).type
        self.timeout_s = TIMEOUT_S
        setup_s = SETUP_TIMEOUT_S
        self.exit_on_fault = BACKENDS[self.device_type] in EXIT_ON_FAULT
        self.local = None
        self.peaks: list[int] = []
        self.rank_spans: list[dict] = []
        self._local_spans: dict = {}
        self._faults: dict[int, str] = {}
        self._waiting: set[int] = set()
        self._due: float | None = None
        self._answers: queue.Queue = queue.Queue()
        self._released: set[int] = set()
        self._closed = False
        self._store_dir = tempfile.mkdtemp(prefix="portbench_world_")
        store = os.path.join(self._store_dir, "store")
        cores = cell.cores or [None] * self.size
        ctx = mp.get_context("spawn")
        self._conns, self._procs = {}, {}
        where = (worker.__code__.co_filename, worker.__qualname__)
        settings = _settings()
        self._begin(range(1, self.size), setup_s)
        for r in range(1, self.size):
            mine, theirs = ctx.Pipe()
            proc = ctx.Process(target=_rank_main, name=f"portbench-rank-{r}", daemon=True,
                               args=(r, self.size, self.device_type, store, self.timeout_s,
                                     cores[r], settings, where, args, os.getpid(), theirs))
            proc.start()
            theirs.close()
            self._conns[r], self._procs[r] = mine, proc
        self._watch = threading.Thread(target=self._read, name="portbench-ranks", daemon=True)
        self._watch.start()

        def setup():
            device = rank_device(self.device_type, 0)
            _join(0, self.size, device, store, self.timeout_s)
            self.local = worker(0, self.size, device, *args)
            bad = {r: f for r, f in self._collect(setup_s).items() if f}
            if bad:
                raise Refused("forbidden modules loaded: " + "; ".join(
                    f"rank {r}: {', '.join(f)}" for r, f in sorted(bad.items())))

        self._guarded(setup)

    # -- what a traffic kind calls -------------------------------------------

    def unit(self) -> None:
        """One unit on every rank."""
        self._guarded(self._all, "unit", lambda: self.local.unit())

    def spans(self) -> dict:
        """Every rank's job's spans() (their collectives pair up); rank 0's
        are returned, every rank's come back at release."""
        def local():
            self._local_spans = self.local.spans() if hasattr(self.local, "spans") else {}

        self._guarded(self._all, "spans", local)
        return self._local_spans

    def release(self) -> None:
        """Release every rank's job, read each rank's peak, spans and
        loaded modules, and stop every worker."""
        def release():
            self._begin(self._conns, self.timeout_s)
            for conn in self._conns.values():
                conn.send("release")
            peak = peak_bytes(rank_device(self.device_type, 0))
            if hasattr(self.local, "release"):
                self.local.release()
            got = self._collect(self.timeout_s)
            self.peaks = [peak] + [got[r]["peak"] for r in sorted(got)]
            self.rank_spans = [self._local_spans] + [got[r]["spans"] for r in sorted(got)]
            bad = {r: v["forbidden"] for r, v in got.items() if v["forbidden"]}
            if bad:
                raise Refused("forbidden modules loaded: " + "; ".join(
                    f"rank {r}: {', '.join(f)}" for r, f in sorted(bad.items())))

        self._guarded(release)
        self._stop()

    # -- inside ----------------------------------------------------------------

    def _begin(self, ranks, seconds: float) -> None:
        self._waiting = set(ranks)
        self._due = time.monotonic() + seconds

    def _all(self, what: str, local) -> None:
        self._begin(self._conns, self.timeout_s)
        for conn in self._conns.values():
            conn.send(what)
        local()
        self._collect(self.timeout_s)

    def _collect(self, seconds: float) -> dict:
        """Each waiting worker's answer, within `seconds`."""
        got, due = {}, time.monotonic() + seconds
        while len(got) < len(self._conns):
            if self._faults:
                raise Refused(self._report())
            try:
                rank, value = self._answers.get(timeout=min(0.1, max(due - time.monotonic(), 0)))
            except queue.Empty:
                if time.monotonic() >= due:
                    raise Refused(self._report()) from None
                continue
            got[rank] = value
        self._due = None
        return got

    def _read(self) -> None:
        """The watch thread: every worker's answers and faults; where a
        fault cannot be raised in the main thread, the end of the run."""
        while not self._closed:
            conns = {c: r for r, c in self._conns.items() if r not in self._faults
                     and r not in self._released}
            due = self._due
            wait = 0.5 if due is None else min(0.5, max(due - time.monotonic(), 0.0))
            for conn in mpc.wait(list(conns), timeout=wait) if conns else ():
                rank = conns[conn]
                try:
                    what, value = conn.recv()
                except (EOFError, OSError):
                    if self._closed:
                        return
                    proc = self._procs[rank]
                    proc.join(1.0)
                    self._faults[rank] = f"rank {rank} died (exit code {proc.exitcode})"
                    continue
                if what == "error":
                    self._faults[rank] = f"rank {rank} raised:\n{value}"
                    continue
                if what == "released":
                    self._released.add(rank)
                self._waiting.discard(rank)
                self._answers.put((rank, value))
            if not conns:
                time.sleep(wait)
            if self.exit_on_fault and not self._closed and (
                    self._faults or (self._due is not None and time.monotonic() > self._due)):
                print(f"portbench: {self._report()}", file=sys.stderr, flush=True)
                self._stop()
                os._exit(1)

    def _report(self, local: str | None = None) -> str:
        """What went wrong: the workers' faults, rank 0's own traceback, and
        last a line that names each fault and the ranks that did not
        answer in time."""
        faults = dict(self._faults)
        lines = [faults[r] for r in sorted(faults)]
        short = [f"rank {r}: {faults[r].strip().splitlines()[-1][:120]}"
                 if "raised" in faults[r] else faults[r] for r in sorted(faults)]
        hung = self._waiting - set(faults)
        if hung and self._due is not None and time.monotonic() >= self._due:
            short.insert(0, f"rank(s) {_ranks(hung)} did not answer in time ({self.timeout_s} s "
                            "a unit)")
        elif hung:
            short.append(f"rank(s) {_ranks(hung)} had not answered yet")
        if local:
            lines.append(f"rank 0 raised:\n{local}")
            short.append(f"rank 0: {local.strip().splitlines()[-1][:120]}")
        lines.append("in short: " + "; ".join(short or ["the world failed"]))
        return "\n".join(lines)

    def _guarded(self, fn, *args):
        try:
            return fn(*args)
        except Refused:
            self._stop()
            raise
        except Exception:  # rank 0's fault, or a worker's seen through a collective
            local = traceback.format_exc()
            time.sleep(0.5)  # a worker's traceback that caused it may be on its way
            report = self._report(local)
            self._stop()
            raise Refused(report) from None

    def _stop(self) -> None:
        """Stop and join every worker (killing any that does not end within
        `RELEASE_S` of its release), leave the group, remove the store."""
        self._closed = True
        for rank, proc in self._procs.items():
            proc.join(RELEASE_S if rank in self._released else 0)
            if proc.is_alive():
                proc.kill()
                proc.join(10.0)
        if threading.current_thread() is not self._watch:
            self._watch.join(5.0)
            _leave()
        for conn in self._conns.values():
            conn.close()
        self._conns = {}
        shutil.rmtree(self._store_dir, ignore_errors=True)
