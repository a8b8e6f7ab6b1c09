"""Run a function of ``tests/torch_dist_cases.py`` in several processes
joined by ``torch.distributed`` (gloo, on the CPU), for the port's
distributed parity tests (``tests/test_torch_*sharded*.py``,
``test_torch_multihost.py``, ``test_torch_serve_mesh.py``).  A test
module starts its workers once, in a module fixture, and holds the JAX
package's results (computed meanwhile in the test process) against theirs.

Each worker (``tests/torch_dist_worker.py``) imports the port and no JAX,
runs with one intra-op thread, joins a process group with a timeout,
calls the named function with its rank and the world size, and writes
its return value (or its traceback) to a file.  ``Ranks.result`` waits for
every worker under a timeout, kills the rest when one fails or hangs, and
raises with the failing worker's traceback and output; else it returns
the ranks' values in rank order.
"""

import contextlib
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_dist_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Ranks:
    """``world`` processes calling ``torch_dist_cases.<func>(rank, world,
    *args)``, started at construction; ``result()`` waits for them and
    returns their values, rank 0 first.  ``init=False``: the function
    joins the process group itself (its ``args`` then hold the port)."""

    def __init__(self, func: str, world: int, timeout: float = 300.0,
                 args=(), init: bool = True, port=None):
        self.func, self.world, self.timeout = func, world, timeout
        self.port = port or str(_free_port())
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   CUDA_VISIBLE_DEVICES="")
        self._dir = tempfile.TemporaryDirectory()
        out = self._dir.name
        arg = pickle.dumps(tuple(args)).hex()
        self.logs = [open(os.path.join(out, f"log{rank}.txt"), "w+")
                     for rank in range(world)]
        self.procs = [subprocess.Popen(
            [sys.executable, WORKER, func, str(rank), str(world), self.port,
             out, arg, str(int(timeout)), str(int(init))],
            stdout=self.logs[rank], stderr=subprocess.STDOUT, env=env,
            cwd=os.path.dirname(HERE))
            for rank in range(world)]
        self.deadline = time.monotonic() + timeout
        self._values = None

    def result(self):
        if self._values is None:
            try:
                self._values = self._wait()
            finally:
                self._dir.cleanup()
        return self._values

    def _wait(self):
        func, world, procs = self.func, self.world, self.procs
        late = False
        try:
            # a failed rank leaves the others blocked in a collective:
            # stop waiting at the first failure
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                if time.monotonic() > self.deadline:
                    late = True
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        text = []
        for f in self.logs:
            f.seek(0)
            text.append(f.read())
            f.close()
        if late:
            raise AssertionError(
                f"{func}: a worker did not end within {self.timeout} s:\n"
                + "\n".join(f"--- rank {r} ---\n{t[-2000:]}"
                             for r, t in enumerate(text)))
        results = []
        for rank in range(world):
            path = os.path.join(self._dir.name, f"rank{rank}.pkl")
            results.append((False, None))
            if os.path.exists(path):
                with open(path, "rb") as f:
                    results[rank] = pickle.load(f)
        # report a rank's own traceback before the ranks it left waiting
        for rank in sorted(range(world), key=lambda r: results[r][1] is None):
            ok, value = results[rank]
            if not ok:
                raise AssertionError(
                    f"{func}: rank {rank} failed (exit "
                    f"{procs[rank].returncode}):\n{value or 'no result'}\n"
                    f"{text[rank][-3000:]}")
        return [value for _, value in results]


@contextlib.contextmanager
def one_rank_mesh(name: str):
    """A 1-D CPU DeviceMesh of this one process, in a gloo group of one
    that is destroyed on exit (for the distributed entry points' own
    tests in the test process)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield DeviceMesh("cpu", torch.arange(1), mesh_dim_names=(name,))
    finally:
        dist.destroy_process_group()
