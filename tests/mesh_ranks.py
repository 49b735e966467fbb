"""Rank programs of the mesh runtime's CPU tests
(``tests/test_torch_mesh_trainer.py``,
``tests/test_torch_serving_sharding.py``), spawned by
``torch.multiprocessing.spawn``; this module imports no JAX, so a rank
loads only the port.

A test writes a job file (``torch.save``) into its ``tmp_path`` and spawns
``world`` ranks of one program here; the ranks meet at a ``file://``
rendezvous under that path (never a fixed port: the suite runs several
workers at once) over gloo, run the job and write their results next to
it. Each rank runs on one CPU thread, as the parent's references do.
"""
import contextlib
import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def spawn(program, world: int, workdir, job: dict) -> list:
    """Run ``program(rank, world, workdir)`` on ``world`` ranks; returns
    every rank's result (``rank<r>.pt``)."""
    torch.save(job, os.path.join(workdir, "job.pt"))
    mp.spawn(program, args=(world, str(workdir)), nprocs=world, join=True)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _join(rank: int, world: int, workdir: str) -> dict:
    """Load the job and join the process group: gloo unless the job names
    another backend; with ``device`` "cuda" the rank takes card
    ``rank % cards`` (every rank the one card when there is one)."""
    torch.set_num_threads(1)
    job = torch.load(os.path.join(workdir, "job.pt"), weights_only=False)
    if job.get("device") == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        job.get("backend", "gloo"),
        init_method=f"file://{os.path.join(workdir, 'rdv')}",
        rank=rank, world_size=world)
    return job


def _to(x, device):
    """A state or batch with every tensor on ``device``."""
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, device) for v in x))
    return x


def _host(x):
    """Metrics and states with every tensor detached on the CPU."""
    if torch.is_tensor(x):
        return x.detach().cpu().clone()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_host(v) for v in x))
    return x


def run_steps(rank: int, world: int, workdir: str) -> None:
    """The job's cases on a mesh of ``world`` ranks: each case is (name,
    cfg, hp, whole initial state, worker-split batches); each rank cuts
    its part of the state, steps through the batches with
    ``jit_train_step``, and keeps the metrics and the whole state
    (gathered back) of every step."""
    from repro_torch.distributed import trainer as TT
    from repro_torch.launch.mesh import Mesh

    from repro_torch.kernels import cada_update

    job = _join(rank, world, workdir)
    device = (torch.device("cuda", torch.cuda.current_device())
              if job.get("device") == "cuda" else torch.device("cpu"))
    mesh = Mesh(job["sizes"], job["axes"],
                "cuda" if job.get("backend") == "nccl" else "cpu")
    counted = {"amsgrad": cada_update.fused_amsgrad_flat,
               "batched_diff_sq": cada_update.batched_diff_sq_norm_flat,
               "batched_sq": cada_update.batched_sq_norm_flat,
               "eq3_row_mean": cada_update.eq3_row_mean_flat}
    out = {}
    for name, cfg, hp, state, batches in job["cases"]:
        make, _, _ = TT.jit_train_step(cfg, mesh, hp)
        fs = TT.flat_sharding(cfg, mesh, hp)
        st = TT.shard_train_state(_to(state, device), fs, hp)
        batches = [_to(b, device) for b in batches]
        step = make(batches[0])
        mets, states = [], []
        for f in counted.values():
            f.launches = 0
        for b in batches:
            st, m = step(st, b)
            mets.append(_host(m))
            states.append(_host(TT.unshard_train_state(st, fs, hp)))
        out[name] = {"metrics": mets, "states": states,
                     "local_h": st.h.numel(),
                     "launches": {k: f.launches for k, f in counted.items()}}
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def run_launcher(rank: int, world: int, workdir: str) -> None:
    """``python -m repro_torch.launch.train`` on every rank, the process
    group taken from the reference's environment variables."""
    from repro_torch.launch import train

    job = torch.load(os.path.join(workdir, "job.pt"), weights_only=False)
    torch.set_num_threads(1)
    os.environ.update(REPRO_COORDINATOR="file://" + os.path.join(
        workdir, "rdv"), REPRO_NUM_PROCESSES=str(world),
        REPRO_PROCESS_ID=str(rank))
    history = train.main(job["argv"])     # joins and leaves the group
    torch.save(history, os.path.join(workdir, f"rank{rank}.pt"))


@contextlib.contextmanager
def counted_collectives(counts: dict):
    """Counts each ``all_reduce`` and ``all_gather`` of the process group
    into ``counts`` while inside."""
    saved = {op: getattr(dist, op) for op in ("all_reduce", "all_gather")}

    def counting(op, f):
        def call(*args, **kw):
            counts[op] = counts.get(op, 0) + 1
            return f(*args, **kw)
        return call

    for op, f in saved.items():
        setattr(dist, op, counting(op, f))
    try:
        yield
    finally:
        for op, f in saved.items():
            setattr(dist, op, f)


def _shapes(tree) -> dict:
    from repro_torch.utils.trees import tree_leaves, tree_paths
    return {"/".join(p): tuple(x.shape)
            for p, x in zip(tree_paths(tree), tree_leaves(tree))}


def run_serving(rank: int, world: int, workdir: str) -> None:
    """Tensor-parallel serving (``distributed/serving.py``) of the job's
    cases: each is (name, mesh sizes over (data, model), cfg, whole params
    (numpy, or a tree of tensors), whole prefill inputs, the whole inputs
    of each decode step), on the job's ``device``. Each rank cuts the
    params, runs the prefill step and the decode steps and keeps the whole
    logits, the gathered cache after the prefill and after the last step,
    its shards' shapes, its collectives per step and the kernels'
    launches (in the prefill, in the decode steps).
    Then the shard/gather round trip of the job's ``round_trip`` trees
    (whole parameter trees of the port) on a mesh of its
    ``round_trip_sizes``, and the serving launcher on the world's ranks
    with the job's ``serve_argv``, if any."""
    from repro_torch import convert
    from repro_torch.distributed import serving
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import flash_attention, ssm_scan
    from repro_torch.launch.mesh import Mesh
    from repro_torch.utils.trees import tree_leaves

    job = _join(rank, world, workdir)
    device = (torch.device("cuda", torch.cuda.current_device())
              if job.get("device") == "cuda" else torch.device("cpu"))
    kernels = {"flash_attention": flash_attention.flash_attention,
               "selective_scan": ssm_scan.selective_scan}

    def on_device(inputs):
        return {k: torch.as_tensor(v).to(device) for k, v in inputs.items()}

    out, meshes = {}, {}
    for name, sizes, cfg, params, inputs, steps in job["cases"]:
        if sizes not in meshes:
            meshes[sizes] = Mesh(sizes, ("data", "model"))
        mesh = meshes[sizes]
        whole = (_to(params, device) if torch.is_tensor(tree_leaves(params)[0])
                 else convert.params_from_numpy(params, device))
        sp = SH.shard_params(whole, cfg, mesh)
        del whole
        inputs = on_device(inputs)
        b, seq = inputs.get("tokens", inputs.get("embeds")).shape[:2]
        sds = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
               for k, v in inputs.items()}
        prefill = serving.jit_prefill_step(cfg, mesh, sds)
        decode, cache_sds, _ = serving.jit_decode_step(cfg, mesh, b, seq)
        counts = [{}]
        for f in kernels.values():
            f.launches = 0
        with counted_collectives(counts[0]):
            logits, cache = prefill(sp, inputs)
        per_prefill = {k: f.launches for k, f in kernels.items()}
        res = {"prefill_logits": _host(logits), "param_shapes": _shapes(sp),
               "cache_shapes": {f: tuple(getattr(cache, f).shape)
                                for f in ("k", "v", "conv", "ssm")
                                if getattr(cache, f) is not None},
               "cache_sds": {f: tuple(getattr(cache_sds, f).shape)
                             for f in ("k", "v", "conv", "ssm")
                             if getattr(cache_sds, f) is not None},
               "prefill_cache": _host(SH.gather_cache(cache, cfg, mesh, b)),
               "decode_logits": []}
        for step_inputs in steps:
            counts.append({})
            with counted_collectives(counts[-1]):
                logits, cache = decode(sp, cache, on_device(step_inputs))
            res["decode_logits"].append(_host(logits))
        res["decode_cache"] = _host(SH.gather_cache(cache, cfg, mesh, b))
        res["collectives"] = counts
        res["launches"] = (per_prefill, {k: f.launches - per_prefill[k]
                                         for k, f in kernels.items()})
        out[name] = res
    trips = {}
    mesh = Mesh(job["round_trip_sizes"], ("data", "model"))
    for name, cfg, whole in job["round_trip"]:
        sp = SH.shard_params(whole, cfg, mesh)
        back = SH.gather_params(sp, cfg, mesh)
        trips[name] = {"shapes": _shapes(sp), "equal": all(
            torch.equal(a, b) for a, b in zip(tree_leaves(whole),
                                              tree_leaves(back)))}
    out["round_trip"] = trips
    if job.get("serve_argv"):
        from repro_torch.launch import serve
        res = serve.main(job["serve_argv"])   # on the world's ranks
        out["serve"] = {k: res[k] for k in ("prefill_logits", "logits",
                                            "tokens")}
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()
