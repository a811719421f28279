"""What `test_torch_port_serve_data_parallel.py` runs in the ranks of its
worlds. It imports no JAX: the ranks must not.

* `serve_rank` runs in each rank of a gloo world of processes
  (`tools/dryrun_multichip.launch`): several daemons in turn, each
  `serve.main(argv)` as torchrun would run it, with `--device cpu`. Rank 0
  writes its pid (the test stops each daemon with SIGTERM) and every rank
  records what the test checks: how often a rank other than 0 found its
  wait for a request timed out, and, where a daemon names `pause`, the
  worker holds its `pause`-th trajectory until the test lets it go.
* `failing_worker` and `held_leader` are ranks started as torchrun starts
  them (`python -c`, the environment's RANK and WORLD_SIZE): `serve.cli`,
  as `python -m`, with the second trajectory (the first after the warm-up)
  raising on the worker and never ending on rank 0.
"""

import contextlib
import os
import threading
import time
from pathlib import Path

from diffusion_models_collection_tpu_torch import serve
from diffusion_models_collection_tpu_torch.parallel.mesh import (
    process_index,
)

WAIT = 120  # seconds a paused worker waits for the test


def wait_for(path: Path) -> None:
    deadline = time.monotonic() + WAIT
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear")
        time.sleep(0.01)


@contextlib.contextmanager
def patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def serve_daemon(daemon: dict, out: Path) -> dict:
    """One daemon of `serve_rank`: its record on this rank."""
    record = {"timeouts": 0, "trajectories": 0}
    check = serve.ServingWorld.check
    generate = serve.SamplerService._generate_batch

    def counting_check(self):
        # a rank other than 0 looks for a failure after each timed-out wait
        record["timeouts"] += 1
        return check(self)

    def pausing_generate(self, *args, **kwargs):
        record["trajectories"] += 1
        if record["trajectories"] == daemon.get("pause"):
            (out / f"paused_{daemon['name']}").touch()
            wait_for(out / f"go_{daemon['name']}")
        return generate(self, *args, **kwargs)

    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(serve, "CONTROL_TIMEOUT",
                                    daemon["control_timeout"]))
        if process_index() != 0:
            stack.enter_context(patched(serve.ServingWorld, "check",
                                        counting_check))
            stack.enter_context(patched(serve.SamplerService,
                                        "_generate_batch", pausing_generate))
        serve.main(daemon["argv"] + ["--device", "cpu"])
    return record


def serve_rank(daemons, out):
    """(In each rank.) Every daemon of `daemons` in turn; this rank's
    records."""
    out = Path(out)
    if process_index() == 0:
        (out / "pid").write_text(str(os.getpid()))
    return [serve_daemon(daemon, out) for daemon in daemons]


def second_trajectory(argv, action) -> None:
    """`serve.cli(argv)` (`python -m ...serve` under torchrun's
    environment) with `action()` in place of this rank's second
    trajectory, the first after the warm-up."""
    trajectory = serve.SamplerService._trajectory
    calls = []

    def patched(self, *args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            return action()
        return trajectory(self, *args, **kwargs)

    serve.SamplerService._trajectory = patched
    serve.cli(argv)


def failing_worker(argv) -> None:
    """A rank other than 0 whose second trajectory raises."""
    def fail():
        raise RuntimeError("a worker's trajectory failed")
    second_trajectory(argv, fail)


def held_leader(argv) -> None:
    """Rank 0 held in its second trajectory, as a dead peer holds an NCCL
    rank (in the collective, or in a kernel launch once the collectives
    fill the card's queue): it learns of the failure from the store
    alone."""
    second_trajectory(argv, lambda: threading.Event().wait())
