"""Start N ranks of a function on this host, one process each, through the
environment contract of ``parallel/distributed.py`` (``tcp://127.0.0.1``
and a free port), and collect what each returns.

    ranks = start(4, "pkg.module:function", {"arg": 1}, backend="gloo")
    results = ranks.wait()          # [rank 0's return value, ...]

Each child runs ``python -m dgdm_tpu_torch.parallel.launch`` from the root
of this checkout: it sets its thread counts, calls
``maybe_initialize_distributed(backend=...)``, imports and calls the
target with the keyword arguments, pickles the return value into the run's
directory, and destroys its process group. A rank that fails, or a run
that outlasts its timeout, makes ``wait`` stop every child and raise with
the end of each rank's log. ``backend=None`` is NCCL on a GPU host, gloo on
the CPU; ranks that share a card need ``"gloo"``.
"""

from __future__ import annotations

import importlib
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """N running ranks of one target; ``wait`` returns their results."""

    def __init__(self, n: int, target: str, kwargs: Optional[Dict] = None,
                 backend: Optional[str] = None, threads: int = 1,
                 timeout: float = 600.0):
        self.n, self.timeout = n, timeout
        self.dir = tempfile.mkdtemp(prefix="dgdm_ranks_")
        with open(os.path.join(self.dir, "spec.pkl"), "wb") as f:
            pickle.dump({"target": target, "kwargs": kwargs or {},
                         "backend": backend, "threads": threads}, f)
        port = free_port()
        base = {**os.environ,
                "PYTHONPATH": os.pathsep.join(
                    [ROOT] + [p for p in os.environ.get(
                        "PYTHONPATH", "").split(os.pathsep) if p]),
                "OMP_NUM_THREADS": str(threads),
                "OPENBLAS_NUM_THREADS": str(threads),
                "DGDM_COORDINATOR": f"127.0.0.1:{port}",
                "DGDM_NUM_NODES": str(n)}
        self.t0 = time.perf_counter()
        self.procs: List[subprocess.Popen] = []
        self.logs = []
        try:
            for r in range(n):
                log = open(os.path.join(self.dir, f"rank{r}.log"), "w")
                self.logs.append(log)
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "dgdm_tpu_torch.parallel.launch",
                     self.dir, str(r)],
                    cwd=ROOT, env={**base, "NODE_RANK": str(r)},
                    stdout=log, stderr=subprocess.STDOUT))
        except BaseException:
            self._stop()
            raise

    def stop(self) -> None:
        """Kill every rank and remove the run's directory."""
        self._stop()
        shutil.rmtree(self.dir, ignore_errors=True)

    def _stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()
        for log in self.logs:
            log.close()

    def log(self, r: int) -> str:
        with open(os.path.join(self.dir, f"rank{r}.log")) as f:
            return f.read()

    def wait(self) -> List[Any]:
        """Wait for every rank -> their return values in rank order; the
        run's directory is removed. Raises if a rank failed or the run
        outlasted its timeout (stopping every rank first)."""
        try:
            failed = None
            while failed is None and any(p.poll() is None
                                         for p in self.procs):
                if time.perf_counter() - self.t0 > self.timeout:
                    failed = f"timed out after {self.timeout:.0f}s"
                    break
                bad = [r for r, p in enumerate(self.procs)
                       if p.poll() not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited with " \
                             f"{self.procs[bad[0]].returncode}"
                    break
                time.sleep(0.05)
            if failed is None:
                bad = [r for r, p in enumerate(self.procs) if p.returncode]
                if bad:
                    failed = f"rank {bad[0]} exited with " \
                             f"{self.procs[bad[0]].returncode}"
            self._stop()
            if failed is not None:
                tails = "\n".join(f"--- rank {r} ---\n{self.log(r)[-3000:]}"
                                  for r in range(self.n))
                raise RuntimeError(f"{self.n} ranks: {failed}\n{tails}")
            out = []
            for r in range(self.n):
                with open(os.path.join(self.dir, f"rank{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            self._stop()
            shutil.rmtree(self.dir, ignore_errors=True)


def start(n: int, target: str, kwargs: Optional[Dict] = None,
          backend: Optional[str] = None, threads: int = 1,
          timeout: float = 600.0) -> Ranks:
    """Start ``n`` ranks of ``target`` ("module:function") -> ``Ranks``."""
    return Ranks(n, target, kwargs, backend, threads, timeout)


def run(n: int, target: str, kwargs: Optional[Dict] = None, **kw
        ) -> List[Any]:
    """``start(...).wait()``."""
    return start(n, target, kwargs, **kw).wait()


def _child(run_dir: str, r: int) -> None:
    with open(os.path.join(run_dir, "spec.pkl"), "rb") as f:
        spec = pickle.load(f)
    import torch

    from dgdm_tpu_torch.parallel import distributed

    torch.set_num_threads(spec["threads"])
    distributed.maybe_initialize_distributed(verbose=False,
                                             backend=spec["backend"])
    try:
        mod, fn = spec["target"].split(":")
        result = getattr(importlib.import_module(mod), fn)(**spec["kwargs"])
    finally:
        distributed.shutdown()
    tmp = os.path.join(run_dir, f"rank{r}.pkl.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp, os.path.join(run_dir, f"rank{r}.pkl"))


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]))
