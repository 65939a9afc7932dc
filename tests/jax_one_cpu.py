"""Run a function of a test module in a process of its own, on one CPU.

XLA's CPU runtime sizes its intra-op thread pool to the CPUs a process may
use when JAX starts, and its ops wait on the threads of that pool (as
OpenBLAS's do). With the test workers sharing the machine's cores, the
threads another worker keeps off their cores stall every op: a reduced MoE
training step of ``repro`` ran some 30x slower in a loaded test worker
than alone. A process whose affinity is one CPU before JAX and BLAS start
gets pools of one thread and keeps its pace whatever the load.

``start("test_module", "fn", *args)`` starts such a process, which imports
the module and calls ``fn(*args)``; ``.result()`` waits for it and returns
what ``fn`` returned. Arguments and results cross pickled through a
temporary directory: numpy arrays and plain Python values. The test worker
can run its own side meanwhile, and start several children at once. Child
k of worker ``gwN`` of M pytest-xdist workers takes the (N + k M)-th CPU
from the top of the allowed set, so children share a CPU only when there
are more of them than CPUs. ``close()`` stops a child that is still
running and removes its directory.
"""

from __future__ import annotations

import importlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import traceback

# the longest one call may take before result() gives up
JOB_TIMEOUT_S = 600
_started = [0]                          # children this process has started


class Child:
    def __init__(self, module: str, fn: str, args: tuple):
        self._dir = tempfile.mkdtemp(prefix="jax_one_cpu_")
        with open(os.path.join(self._dir, "args.pkl"), "wb") as f:
            pickle.dump((module, fn, args), f)
        cpus = sorted(os.sched_getaffinity(0))
        worker = int(os.environ.get("PYTEST_XDIST_WORKER", "gw0")[2:] or 0)
        workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", 1))
        cpu = cpus[-1 - (worker + _started[0] * workers) % len(cpus)]
        _started[0] += 1
        env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
        self._proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(cpu), self._dir],
            env=env)

    def result(self):
        try:
            try:
                rc = self._proc.wait(timeout=JOB_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
                raise TimeoutError(f"no result in {JOB_TIMEOUT_S} s")
            err = os.path.join(self._dir, "error.txt")
            if rc != 0:
                msg = (open(err).read() if os.path.exists(err)
                       else f"exit code {rc}")
                raise RuntimeError(f"the child process failed:\n{msg}")
            with open(os.path.join(self._dir, "result.pkl"), "rb") as f:
                return pickle.load(f)
        finally:
            self.close()

    def close(self) -> None:
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()
        shutil.rmtree(self._dir, ignore_errors=True)


def start(module: str, fn: str, *args) -> Child:
    return Child(module, fn, args)


def _main(cpu: int, path: str) -> int:
    os.sched_setaffinity(0, {cpu})        # before JAX and BLAS make pools
    try:
        with open(os.path.join(path, "args.pkl"), "rb") as f:
            module, fn, args = pickle.load(f)
        out = getattr(importlib.import_module(module), fn)(*args)
        with open(os.path.join(path, "result.pkl"), "wb") as f:
            pickle.dump(out, f)
        return 0
    except BaseException:
        with open(os.path.join(path, "error.txt"), "w") as f:
            f.write(traceback.format_exc())
        return 1


if __name__ == "__main__":
    sys.exit(_main(int(sys.argv[1]), sys.argv[2]))
