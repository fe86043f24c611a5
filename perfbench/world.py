"""A world of ranks for a cell on several cards: the process that runs
the cell is rank 0, and ranks 1 to n - 1 are processes of their own,
one a card.

    with world.World(n, "cuda", "perfbench.traffic.fit_dp", args) as w:
        ...  # rank 0's work: w.rank is its handle

Each rank gets torchrun's variables (``MASTER_ADDR``, ``MASTER_PORT``,
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) and joins
through the program's own ``parallel.distributed.initialize``, which
gives NCCL with a rank a card (gloo on the CPU).  The benchmark's own
exchanges go over a gloo group of their own (``Rank.side``), never
through the program's group.  Rank k > 0 runs ``python3 -m
perfbench.world <spec> k``, which imports ``module`` and calls its
``rank_main(args, rank)``; its output goes to a log of its own.

No rank outlives rank 0 (each asks the kernel for SIGKILL when its parent
ends), and none hangs the run: a watchdog thread in rank 0 ends the run
with exit code 4 and the rank's log tail on standard error when a rank
exits with an error, or when a rank has passed no phase (``Rank.mark``)
for ``stall_s`` seconds: the rank that has passed the fewest is named.
A rank that has loaded a module that must not load
(``harness.forbidden_modules``) once its work is done exits with an
error too, so rank 0 prints no result.
"""

from __future__ import annotations

import ctypes
import dataclasses
import importlib
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from datetime import timedelta
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
#: Seconds a rank may pass no phase before the run is ended.
STALL_S = 240.0
#: Exit code of a run ended by a failed or stalled rank.
EXIT_RANK_FAILED = 4
TAG = "perfbench.world phase "
VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


@dataclasses.dataclass
class Rank:
    """One rank's handle: its index, the world's size, its device, the
    benchmark's gloo group and the call that records a phase passed."""
    index: int
    size: int
    device: object
    side: object
    mark: object


def join(device_type: str, stall_s: float, mark) -> Rank:
    """Joins the world that torchrun's variables describe through the
    program's ``initialize`` and opens the benchmark's gloo group."""
    import torch.distributed as dist

    from ascendpathtracing_tpu_torch.parallel import distributed

    dev = distributed.initialize(device_type)
    side = dist.new_group(backend="gloo", timeout=timedelta(seconds=2 * stall_s))
    return Rank(dist.get_rank(), dist.get_world_size(), dev, side, mark)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _text(path: Path) -> str:
    try:
        return path.read_text(errors="replace")
    except OSError:
        return "(no log)"


class World:
    """Rank 0 here and ranks 1..n-1 spawned (see the module's docstring).
    ``args`` is handed to every other rank's ``rank_main`` as JSON."""

    def __init__(self, n: int, device_type: str, module: str, args: dict,
                 stall_s: float = STALL_S):
        self.n, self.device_type, self.stall_s = n, device_type, float(stall_s)
        self.spec = {"module": module, "args": args, "device": device_type,
                     "stall_s": self.stall_s, "parent": os.getpid()}
        self.procs, self.rank = [], None
        self._seen = {}  # rank -> (phases passed, time of the last)
        self._last_phase = "start"

    # ---------------------------------------------------------- rank 0 ----
    def __enter__(self) -> World:
        self.dir = Path(tempfile.mkdtemp(prefix="perfbench_world_"))
        spec = self.dir / "spec.json"
        spec.write_text(json.dumps(self.spec))
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                   WORLD_SIZE=str(self.n), LOCAL_WORLD_SIZE=str(self.n))
        self._saved = {k: os.environ.get(k) for k in VARS}
        now = time.monotonic()
        self._seen = {k: (0, now) for k in range(self.n)}
        for k in range(1, self.n):
            with open(self.log(k), "wb") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "perfbench.world", str(spec), str(k)],
                    cwd=CHECKOUT, env=dict(env, RANK=str(k), LOCAL_RANK=str(k)),
                    stdin=subprocess.DEVNULL, stdout=log, stderr=subprocess.STDOUT))
        os.environ.update({k: env[k] for k in VARS if k in env}, RANK="0", LOCAL_RANK="0")
        self._stop, self._failing = threading.Event(), threading.Lock()
        self._watch = threading.Thread(target=self._watchdog, name="perfbench-world",
                                       daemon=True)
        self._watch.start()
        try:
            self.rank = join(self.device_type, self.stall_s, self.mark)
        except BaseException:
            self.__exit__(*sys.exc_info())
            raise
        self.mark("joined")
        return self

    def log(self, k: int) -> Path:
        return self.dir / f"rank{k}.log"

    def mark(self, phase: str) -> None:
        """Rank 0 has passed ``phase``."""
        count, _ = self._seen[0]
        self._seen[0] = (count + 1, time.monotonic())
        self._last_phase = phase

    def __exit__(self, exc_type, exc, tb):
        try:
            if exc_type is None:
                self._close()
            else:
                # A peer's death reaches rank 0's collectives before its
                # exit code: wait a little for the code, then name it.
                deadline = time.monotonic() + 2.0
                while not self._failed() and time.monotonic() < deadline:
                    time.sleep(0.05)
                failed = self._failed()
                if failed:
                    self._fail(f"rank {failed[0]} of {self.n} exited with code "
                               f"{self.procs[failed[0] - 1].poll()}", failed,
                               exc_info=(exc_type, exc, tb))
        finally:
            self._stop.set()
            self._kill()
            for key, value in self._saved.items():
                if value is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = value
            shutil.rmtree(self.dir, ignore_errors=True)
        return False

    def _close(self) -> None:
        """Leaves the groups and waits for every other rank to end."""
        import torch.distributed as dist

        self.mark("done")
        dist.destroy_process_group()
        deadline = time.monotonic() + self.stall_s
        while any(p.poll() is None for p in self.procs) and time.monotonic() < deadline:
            time.sleep(0.05)
        self._stop.set()
        self._watch.join()
        late = [k for k, p in enumerate(self.procs, 1) if p.poll() != 0]
        if late:
            code = self.procs[late[0] - 1].poll()
            self._fail(f"rank {late[0]} of {self.n} " + ("did not end after the others"
                       if code is None else f"exited with code {code}"), late)

    def _failed(self) -> list:
        return [k for k, p in enumerate(self.procs, 1) if p.poll() not in (None, 0)]

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            try:
                p.wait(30)
            except subprocess.TimeoutExpired:
                pass

    def _report(self, why: str, ranks) -> str:
        lines = [f"perfbench: {why}"]
        for k in ranks:
            if k == 0:
                lines.append(f"rank 0 (this process): last phase {self._last_phase!r}")
            else:
                lines.append(f"rank {k}'s log (exit code {self.procs[k - 1].poll()}):\n"
                             f"{_text(self.log(k))[-6000:]}")
        return "\n".join(lines)

    def _read_marks(self) -> None:
        for k in range(1, self.n):
            passed = _text(self.log(k)).count(TAG)
            if passed > self._seen[k][0]:
                self._seen[k] = (passed, time.monotonic())

    def _watchdog(self) -> None:
        while not self._stop.wait(0.2):
            failed = self._failed()
            if failed:
                self._fail(f"rank {failed[0]} of {self.n} exited with code "
                           f"{self.procs[failed[0] - 1].poll()}", failed)
            self._read_marks()
            now = time.monotonic()
            running = [0] + [k for k, p in enumerate(self.procs, 1) if p.poll() is None]
            if any(now - self._seen[k][1] > self.stall_s for k in running):
                least = min(self._seen[k][0] for k in running)
                behind = [k for k in running if self._seen[k][0] == least]
                self._fail(f"rank {behind[0]} of {self.n} passed no phase for {self.stall_s:.0f}"
                           f" s (ranks {behind} are behind the others)", behind)

    def _fail(self, why: str, ranks, exc_info=None) -> None:
        """Ends the whole run, from either thread: rank 0's own error if
        any, then the report, last on standard error; every other rank
        killed; exit code ``EXIT_RANK_FAILED``.  The thread that comes
        second waits for the first to end the process."""
        if not self._failing.acquire(blocking=False):
            while True:
                time.sleep(1.0)
        if exc_info is not None:
            traceback.print_exception(*exc_info)
        sys.stderr.write(self._report(why, ranks) + "\n")
        sys.stderr.flush()
        self._kill()
        shutil.rmtree(self.dir, ignore_errors=True)
        os._exit(EXIT_RANK_FAILED)


# ------------------------------------------------------ other ranks ----
def _die_with_parent(parent: int) -> None:
    """SIGKILL this process when its parent ends (Linux), and end now if
    it already has."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, int(signal.SIGKILL))  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(1)


def _print_mark(phase: str) -> None:
    print(f"{TAG}{phase}", flush=True)


def child(spec_path: str, k: int) -> int:
    spec = json.loads(Path(spec_path).read_text())
    _die_with_parent(spec["parent"])
    try:
        import torch.distributed as dist

        from perfbench import harness

        rank = join(spec["device"], spec["stall_s"], _print_mark)
        if rank.index != k:
            raise RuntimeError(f"rank {rank.index} started as rank {k}")
        _print_mark("joined")
        importlib.import_module(spec["module"]).rank_main(spec["args"], rank)
        _print_mark("done")
        dist.destroy_process_group()
        found = harness.forbidden_modules()
        if found:
            print(f"perfbench: rank {k} loaded modules that must not load: {', '.join(found)}",
                  flush=True)
            return 1
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(child(sys.argv[1], int(sys.argv[2])))
