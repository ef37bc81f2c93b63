"""One process of the port's worker-mode tests (not collected by pytest):

    python tests/torch_multihost_worker.py JOBS.json HOST_ID

runs the jobs of ``JOBS.json`` in order, each in a group of its own with
the other host's process, and prints one ``RESULT {json}`` line per job.
Each job's coordinator port is picked when the job starts: host 0 takes a
free port and publishes it in ``JOBS.json.port.I``, which the other hosts
wait for.

* ``{"kind": "cli", "argv": [...]}``: the port's CLI entry point,
  ``cli.main(argv + ["--coordinator", ..., "--host-id", HOST_ID])``; its
  tokens, the `.m` bytes this process read, the sampling seed it used, and
  with ``"record_ids"`` the expert ids of every router call in call order.
  ``"clock_seeds"``: each host's stand-in for its wall-clock seed (the
  draw without ``--seed``). ``"fault": {"host": h, "spec": s}``: fault plan
  ``s`` installed on host h alone; the job then reports the exception it
  raised (``"error"``, None when it returned) and its seconds;
* ``{"kind": "seam", "tp": n, "shapes": [...], "seed": s}``: the
  all-reduce seam under every arm and the all-gather over this host's ranks
  of seeded f32 partials (every global rank's drawn in rank order from one
  numpy generator), their outputs' bytes as uint32.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PORT_WAIT_S = 60.0


def seam_partials(tp: int, shapes: list, seed: int) -> list:
    """[shape index][global rank] f32 partials, as the test process draws them."""
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal(shape).astype(np.float32) for _ in range(tp)] for shape in shapes]


def _bits(t: torch.Tensor) -> list:
    return t.contiguous().view(torch.int32).reshape(-1).tolist()


def coordinator(jobs_path: Path, index: int, host_id: int) -> str:
    """Job ``index``'s ``host:port``: host 0 picks a free port as the job
    starts and publishes it (written whole, then renamed); the others wait
    for it."""
    path = Path(f"{jobs_path}.port.{index}")
    if host_id == 0:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        tmp = path.with_suffix(".tmp")
        tmp.write_text(str(port))
        os.replace(tmp, path)
        return f"127.0.0.1:{port}"
    deadline = time.monotonic() + PORT_WAIT_S
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"host 0 published no port for job {index}")
        time.sleep(0.01)
    return f"127.0.0.1:{path.read_text()}"


def run_seam(job: dict, host_id: int, address: str) -> dict:
    from distributed_llama_tpu_torch.ops import collectives
    from distributed_llama_tpu_torch.parallel.hosts import HostGroup

    out = {}
    with HostGroup(address, job["num_hosts"], host_id) as group:
        mine = group.local_ranks(job["tp"])
        for i, partials in enumerate(seam_partials(job["tp"], job["shapes"], job["seed"])):
            xs = [torch.from_numpy(partials[r]) for r in mine]
            for impl in collectives.IMPLS:
                out[f"{impl}/{i}"] = [_bits(y) for y in collectives.all_reduce(xs, impl, group)]
            out[f"gather/{i}"] = _bits(collectives.all_gather(xs, group))
    return out


def run_cli(job: dict, host_id: int, address: str) -> dict:
    from distributed_llama_tpu_torch.apps import cli
    from distributed_llama_tpu_torch.engine import faults
    from distributed_llama_tpu_torch.models import moe

    ids, orig, orig_seed = [], moe.router_topk, cli._default_seed

    def spy(cfg, xn, router):
        vals, idx = orig(cfg, xn, router)
        ids.append(idx.tolist())
        return vals, idx

    if job.get("record_ids"):
        moe.router_topk = spy
    if "clock_seeds" in job:
        cli._default_seed = lambda args: args.seed if args.seed is not None else job["clock_seeds"][host_id]
    fault = job.get("fault")
    if fault is not None and fault["host"] == host_id:
        faults.install(faults.parse(fault["spec"]))
    argv = job["argv"] + ["--coordinator", address, "--host-id", str(host_id)]
    t0 = time.perf_counter()
    try:
        if fault is None:
            res = cli.main(argv)
        else:
            try:
                cli.main(argv)
                error = None
            except Exception as e:
                error = f"{type(e).__name__}: {e}"
            return {"error": error, "seconds": time.perf_counter() - t0}
    finally:
        moe.router_topk = orig
        cli._default_seed = orig_seed
        faults.clear()
    return {"tokens": res["tokens"], "bytes_read": res["bytes_read"], "seed": res["seed"], "ids": ids}


def main() -> None:
    jobs_path = Path(sys.argv[1])
    jobs = json.loads(jobs_path.read_text())
    host_id = int(sys.argv[2])
    for i, job in enumerate(jobs):
        result = (run_seam if job["kind"] == "seam" else run_cli)(job, host_id, coordinator(jobs_path, i, host_id))
        print("RESULT " + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
