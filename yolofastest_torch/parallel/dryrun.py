"""The multi-process dry run: N ranks train and resume as one.

    python -m yolofastest_torch.parallel.dryrun [--processes N] [--device cuda|cpu]

The port's counterpart of the JAX package's multi-process dry run
(``__graft_entry__._dryrun_multiprocess`` with ``tools/mp_dryrun_worker.py``).
It starts N processes of :mod:`yolofastest_torch.parallel.worker`, which
join one process group, take two data-parallel steps on their own seeded
batches, save from the live group and resume a fresh Trainer from the save;
every rank must print ``MP_OK rank=<r>`` and ``MP_RESUME_OK rank=<r>``.
On the CPU the ranks use gloo; on a card, NCCL where each rank has a card of
its own, else gloo (NCCL refuses two ranks on one device).  As JAX's dry run
does, from four processes on (an even number) the mesh is ``(N/2, 2)``: the
Trainer splits the 64x96 images' rows over the ``spatial`` axis
(``shard_spatial=True``, the row halos exchanged between the ranks);
otherwise it is the data axis alone.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
from typing import List

RANK_TIMEOUT_S = 600


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multiprocess(n_processes: int = 2, device: str = "cuda") -> List[str]:
    """Run the dry run's ``n_processes`` ranks on ``device``; returns each
    rank's output, and raises if a rank fails or misses its lines."""
    import torch

    backend = "nccl" if device == "cuda" and n_processes <= torch.cuda.device_count() else "gloo"
    port = free_port()
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    with tempfile.TemporaryDirectory(prefix="yf_dryrun_") as td:
        # The ranks meet in collectives, so their output is drained as they
        # run: a pipe left unread while another rank is waited for can fill
        # and stall the group.  Files do not fill.
        logs = [open(os.path.join(td, f"rank{r}.log"), "w+") for r in range(n_processes)]
        procs = []
        try:
            for r in range(n_processes):
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "yolofastest_torch.parallel.worker", str(port),
                     str(r), str(n_processes), os.path.join(td, "ckpt"), "--device", device,
                     "--backend", backend],
                    stdout=logs[r], stderr=subprocess.STDOUT, env=env))
            for p in procs:
                p.wait(timeout=RANK_TIMEOUT_S)
            outs = []
            for r, (p, f) in enumerate(zip(procs, logs)):
                f.seek(0)
                out = f.read()
                outs.append(out)
                if p.returncode != 0:
                    raise RuntimeError(f"dry run rank {r} failed (rc={p.returncode}):\n"
                                       f"{out[-3000:]}")
                for line in (f"MP_OK rank={r}", f"MP_RESUME_OK rank={r}"):
                    if line not in out:
                        raise RuntimeError(f"dry run rank {r} printed no {line!r}:\n{out[-1000:]}")
            return outs
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m yolofastest_torch.parallel.dryrun")
    p.add_argument("--processes", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    for out in dryrun_multiprocess(args.processes, args.device):
        print(out.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
