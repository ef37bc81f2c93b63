"""One process of the port's worker-mode tests (not collected by pytest):

    python tests/torch_multihost_worker.py JOBS.json HOST_ID

runs the jobs of ``JOBS.json`` in order, each in a group of its own with
the other hosts' processes (``"num_hosts"``, 2 unless the job says), and
prints one ``RESULT {json}`` line per job.
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
* ``{"kind": "axes", "tp": t, "inner": n, "shapes": [...], "seed": s}``: this host's axis groups of a ``t`` x ``n`` layout
  (:meth:`HostGroup.axis_groups`), their members, the exchanges over the
  inner axis's group (:func:`exchange_outputs` over this host's run of the
  n ranks) and the all-reduce seam under every arm and the all-gather over
  the tp axis's group and over the inner one (:func:`axis_partials`),
  their outputs' bytes;
* ``{"kind": "exchange", "n": n, "seed": s}``: the sequence- and
  expert-parallel exchanges over this host's run of n ranks
  (:func:`exchange_outputs` on :func:`exchange_inputs`), their outputs'
  bytes;
* ``{"kind": "engine", "argv": [...], "prompt": [...], "delta": [...],
  "steps": n}``: an engine built as the CLI's worker mode builds it from
  ``argv`` (the ``generate`` flags), driven by :func:`drive` (a prompt of
  token ids, a delta, greedy tokens on the device); with ``"record_ids"``
  the expert ids and row counts of every router call.
"""

from __future__ import annotations

import hashlib
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


def exchange_inputs(n: int, seed: int) -> dict:
    """Each of n global ranks' seeded inputs of the exchange job, drawn in
    rank order from one generator: K/V chunks [4, 2, 8] bf16 (a bf16
    cache's rows), query rows [4, 4, 8] f32 at the chunk's positions, an
    all_to_all send [n, 3, 5] f32 (its first axis the destination rank),
    rows [4, 6] f32 for the all_gather; and one decode query [1, 4, 8]."""
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    out = {key: [] for key in ("q", "k", "v", "send", "rows")}
    for _ in range(n):
        out["q"].append(f32(4, 4, 8))
        out["k"].append(f32(4, 2, 8).to(torch.bfloat16))
        out["v"].append(f32(4, 2, 8).to(torch.bfloat16))
        out["send"].append(f32(n, 3, 5))
        out["rows"].append(f32(4, 6))
    out["dq"] = f32(1, 4, 8)
    return out


def exchange_outputs(inp: dict, ranks: range, group) -> dict:
    """The exchanges over ``ranks`` (this host's run; all n ranks with no
    group): every ring rotation of the K chunks, the all_gather of the rows
    (:func:`rank_gather`), the all_to_all of the sends, ring attention over
    the chunks, and the decode merge of the query at position 4n-3 over
    the chunks as cache slices. Name -> list of tensors (per local rank, or
    the one result every process holds)."""
    from distributed_llama_tpu_torch.ops import collectives
    from distributed_llama_tpu_torch.parallel import context_parallel as cp

    n = len(inp["k"])

    def mine(key):
        return [inp[key][i] for i in ranks]

    out, held = {}, mine("k")
    for s in range(n - 1):
        held = collectives.ring_rotate(held, group)
        out[f"rotate/{s}"] = held
    out["gather"] = collectives.rank_gather(mine("rows"), group)
    out["all_to_all"] = [torch.stack(r) for r in collectives.all_to_all(mine("send"), n, group)]
    out["ring_attention"] = cp.ring_attention(mine("q"), mine("k"), mine("v"), ranks=ranks, group=group)
    out["merge"] = [cp.sp_decode_attention(inp["dq"][0], mine("k"), mine("v"), 4 * n - 3, ranks, group)]
    return out


def drive(engine, prompt: list, delta: list, steps: int) -> dict:
    """The phase the engine jobs share with their one-process references:
    reset, the prompt (one ring pass under --sp when it is long enough),
    the delta (chunk forwards), then ``steps`` greedy tokens on the device
    after the first. Returns the ids, a hash of the prompt's last logits
    row and the delta's logits, and each forward's dispatch count."""
    engine.reset()
    lp = engine.prefill(prompt)
    dispatches = [engine.last_dispatches()]
    rows = lp[None]
    if delta:
        rows = engine.forward(delta)
        dispatches.append(engine.last_dispatches())
    first = int(np.argmax(rows[-1]))
    tokens = [first] + [int(t) for t in engine.generate_on_device(first, steps, 0.0)]
    digest = hashlib.sha256(lp.tobytes() + (rows.tobytes() if delta else b"")).hexdigest()
    return {"tokens": tokens, "logits_sha256": digest, "dispatches": dispatches,
            "bytes_read": getattr(engine, "bytes_read", None)}


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


def axis_partials(tp: int, inner: int, shapes: list, seed: int) -> dict:
    """The axes job's seeded f32 partials: for each inner rank i the tp
    ranks' partials summed over the tp axis (``("tp", i)``), and for each
    tp rank t the inner ranks' partials summed over the inner axis
    (``("inner", t)``), each drawn by :func:`seam_partials` from a seed of
    its own."""
    out = {("tp", i): seam_partials(tp, shapes, seed + 100 + i) for i in range(inner)}
    out.update({("inner", t): seam_partials(inner, shapes, seed + 200 + t) for t in range(tp)})
    return out


def axis_sums(partials: list, ranks: range, group) -> dict:
    """The seam under every arm and the all-gather of ``partials`` ([shape
    index][rank]) over ``ranks`` (this host's run; all of them with no
    group), their outputs' bytes as uint32."""
    from distributed_llama_tpu_torch.ops import collectives

    out = {}
    for i, parts in enumerate(partials):
        xs = [torch.from_numpy(parts[r]) for r in ranks]
        for impl in collectives.IMPLS:
            out[f"{impl}/{i}"] = [_bits(y) for y in collectives.all_reduce(xs, impl, group)]
        out[f"gather/{i}"] = _bits(collectives.all_gather(xs, group))
    return out


def run_axes(job: dict, host_id: int, address: str) -> dict:
    from distributed_llama_tpu_torch.parallel.hosts import HostGroup

    tp, inner = job["tp"], job["inner"]
    with HostGroup(address, job["num_hosts"], host_id) as group:
        tps, inners = group.axis_runs(tp, inner)
        inner_g, tp_g = group.axis_groups(tp, inner)
        parts = axis_partials(tp, inner, job["shapes"], job["seed"])
        got = exchange_outputs(exchange_inputs(inner, job["seed"] + tps.start), inners, inner_g)
        return {"members": [None if g is None else getattr(g, "members", list(range(group.num_hosts)))
                            for g in (inner_g, tp_g)],
                "exchange": {k: [t.contiguous().view(torch.uint8).reshape(-1).tolist() for t in ts]
                             for k, ts in got.items()},
                "tp": axis_sums(parts[("tp", inners.start)], tps, tp_g),
                "inner": axis_sums(parts[("inner", tps.start)], inners, inner_g)}


def run_exchange(job: dict, host_id: int, address: str) -> dict:
    from distributed_llama_tpu_torch.parallel.hosts import HostGroup

    with HostGroup(address, 2, host_id) as group:
        m = job["n"] // 2
        got = exchange_outputs(exchange_inputs(job["n"], job["seed"]), range(host_id * m, (host_id + 1) * m), group)
    return {k: [t.contiguous().view(torch.uint8).reshape(-1).tolist() for t in ts] for k, ts in got.items()}


def run_engine(job: dict, host_id: int, address: str) -> dict:
    from distributed_llama_tpu_torch.apps import cli
    from distributed_llama_tpu_torch.models import moe
    from distributed_llama_tpu_torch.parallel.hosts import HostGroup

    ids, orig = [], moe.router_topk

    def spy(cfg, xn, router):
        vals, idx = orig(cfg, xn, router)
        ids.append([xn.shape[0], idx.tolist()])
        return vals, idx

    if job.get("record_ids"):
        moe.router_topk = spy
    try:
        n = job.get("num_hosts", 2)
        with HostGroup(address, n, host_id) as group:
            args = cli.build_parser().parse_args(job["argv"] + ["--coordinator", address, "--host-id", str(host_id),
                                                                "--num-hosts", str(n)])
            engine = cli.make_engine(args, hosts=group)[0]
            out = drive(engine, job["prompt"], job["delta"], job["steps"])
    finally:
        moe.router_topk = orig
    return {**out, "ids": ids}


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
        run = {"seam": run_seam, "exchange": run_exchange, "engine": run_engine,
               "axes": run_axes}.get(job["kind"], run_cli)
        result = run(job, host_id, coordinator(jobs_path, i, host_id))
        print("RESULT " + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
