"""Persistent torch.distributed ranks on the CPU for the port's multi-process
tests.

``RankPool(world, tmp_path)`` starts ``world`` interpreters running this file,
each joined to one gloo process group through a ``file://`` init method under
``tmp_path`` (no port to collide on between test workers), torch on one
thread. ``pool.run(fn, *args)`` runs the module-level function ``fn(rank,
*args)`` on every rank at once and returns the ranks' results in rank order;
an exception in any rank raises here with that rank's traceback. A module
starts its pool once and reuses it across its cases, so torch's start-up is
paid once.

Jobs travel as (module, function name, args), pickled; the ranks write their
results to a protocol pipe and everything they print to stderr.

    python tests/torch_ranks.py <rank> <world> <init file>
"""
from __future__ import annotations

import os
import pickle
import select
import struct
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _send(f, obj) -> None:
    data = pickle.dumps(obj)
    f.write(struct.pack("<Q", len(data)) + data)
    f.flush()


def _read_exact(fd: int, n: int, deadline: float) -> bytes:
    out = b""
    while len(out) < n:
        left = deadline - time.monotonic()
        if left <= 0 or not select.select([fd], [], [], left)[0]:
            raise TimeoutError("a rank did not answer in time")
        chunk = os.read(fd, n - len(out))
        if not chunk:
            raise RuntimeError("a rank exited")
        out += chunk
    return out


def _recv(fd: int, deadline: float):
    (n,) = struct.unpack("<Q", _read_exact(fd, 8, deadline))
    return pickle.loads(_read_exact(fd, n, deadline))


class RankPool:
    def __init__(self, world: int, tmp_path, timeout: float = 240.0):
        self.world, self.timeout = world, timeout
        init_file = os.path.join(str(tmp_path), f"group_{world}")
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        env.pop("CUDA_VISIBLE_DEVICES", None)
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world), init_file],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=REPO, env=env)
            for r in range(world)]
        deadline = time.monotonic() + timeout
        for p in self.procs:
            if _recv(p.stdout.fileno(), deadline) != "ready":
                raise RuntimeError("a rank failed to start")

    def run(self, fn, *args) -> list:
        for p in self.procs:
            _send(p.stdin, (fn.__module__, fn.__name__, args))
        deadline = time.monotonic() + self.timeout
        results = [_recv(p.stdout.fileno(), deadline) for p in self.procs]
        for rank, (ok, value) in enumerate(results):
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
        return [value for _, value in results]

    def close(self) -> None:
        for p in self.procs:
            try:
                _send(p.stdin, None)
            except (BrokenPipeError, OSError):
                pass
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def _serve(rank: int, world: int, init_file: str) -> None:
    proto_out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)                       # prints go to stderr, results to the pipe
    proto_in = sys.stdin.buffer
    sys.path[:0] = [REPO, HERE]
    import importlib

    import torch

    torch.set_num_threads(1)
    from caster_dta_torch.parallel import mesh as pmesh

    pmesh.init_distributed(f"file://{init_file}", world, rank, device="cpu", verbose=False)
    _send(proto_out, "ready")
    while True:
        head = proto_in.read(8)
        if len(head) < 8:
            return
        job = pickle.loads(proto_in.read(struct.unpack("<Q", head)[0]))
        if job is None:
            return
        module, name, args = job
        try:
            result = (True, getattr(importlib.import_module(module), name)(rank, *args))
        except Exception:   # reported to the test, which raises it
            result = (False, traceback.format_exc())
        _send(proto_out, result)


if __name__ == "__main__":
    _serve(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
