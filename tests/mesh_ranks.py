"""Rank programs of the mesh runtime's CPU tests
(``tests/test_torch_mesh_trainer.py``,
``tests/test_torch_serving_sharding.py``, the tensor-parallel trainer's), spawned by
``torch.multiprocessing.spawn``; this module imports no JAX, so a rank
loads only the port.

``tests/test_torch_tp_grads.py`` and ``tests/test_torch_tp_trainer.py``
run the model axis and parameter FSDP in training here too.

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
    cfg, hp, whole initial state, worker-split batches[, (sizes, axes) of
    its own mesh or None[, options]]); each rank cuts its part of the
    state, steps through the batches with ``jit_train_step``, and keeps
    the metrics and the whole state (gathered back) of every step. The
    option ``block_local`` runs the case with a deliberately wrong
    pytree plane (:func:`_block_local_selection`)."""
    from repro_torch.distributed import trainer as TT
    from repro_torch.launch.mesh import Mesh
    from repro_torch.utils.trees import tree_leaves

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
    out, meshes = {}, {}
    for case in job["cases"]:
        name, cfg, hp, state, batches = case[:5]
        undo = (_block_local_selection()
                if len(case) > 6 and case[6].get("block_local") else None)
        if len(case) > 5 and case[5] is not None:   # a mesh of its own
            sizes, axes = case[5]
            if (sizes, axes) not in meshes:
                meshes[sizes, axes] = Mesh(sizes, axes)
            mesh = meshes[sizes, axes]
        make, _, _ = TT.jit_train_step(cfg, mesh, hp)
        fs = TT.state_sharding(cfg, mesh, hp)
        # a list of states: each step starts from its own (reloaded) state
        starts = state if isinstance(state, list) else [state]
        st = TT.shard_train_state(_to(starts[0], device), fs, hp)
        batches = [_to(b, device) for b in batches]
        step = make(batches[0])
        mets, states, counts = [], [], []
        for f in counted.values():
            f.launches = 0
        for k, b in enumerate(batches):
            if k and len(starts) > 1:
                st = TT.shard_train_state(_to(starts[k], device), fs, hp)
            counts.append({})
            with counted_collectives(counts[-1]):
                st, m = step(st, b)
            mets.append(_host(m))
            states.append(_host(TT.unshard_train_state(st, fs, hp)))
        out[name] = {"metrics": mets, "states": states,
                     "local_h": sum(x.numel() for x in tree_leaves(st.h)),
                     "collectives": counts,
                     "param_shapes": _shapes(st.params),
                     "param_storage": _storage_bytes(st.params),
                     "launches": {k: f.launches for k, f in counted.items()}}
        if undo is not None:
            undo()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _block_local_selection():
    """Makes the pytree plane's per-leaf selections wrong on purpose, for
    the test that must catch it: the wire's per-leaf max is not completed
    over the axes that cut the leaf, and top-k selects within the rank's
    block. Returns the undo."""
    from repro_torch.distributed.sharding import TreeSharding
    complete, whole = TreeSharding.complete, TreeSharding.on_whole_worker

    def block_complete(self, parts, specs, op="sum"):
        return list(parts) if op == "max" else complete(self, parts, specs,
                                                        op)

    TreeSharding.complete = block_complete
    TreeSharding.on_whole_worker = lambda self, f, tree: f(tree)

    def undo():
        TreeSharding.complete = complete
        TreeSharding.on_whole_worker = whole
    return undo


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


@contextlib.contextmanager
def logged_collectives(log: list):
    """Logs each ``all_reduce`` and ``all_gather`` of the process group as
    (op, shape of the rank's tensor) into ``log`` while inside."""
    saved = {op: getattr(dist, op) for op in ("all_reduce", "all_gather")}

    def logging(op, f):
        def call(*args, **kw):
            t = args[0] if op == "all_reduce" else args[1]
            log.append((op, tuple(t.shape)))
            return f(*args, **kw)
        return call

    for op, f in saved.items():
        setattr(dist, op, logging(op, f))
    try:
        yield
    finally:
        for op, f in saved.items():
            setattr(dist, op, f)


def run_grads(rank: int, world: int, workdir: str) -> None:
    """The job's cases, each (name, mesh sizes over (data, model), cfg, hp,
    whole params (a tree of tensors), the worker-split batch): each rank
    cuts its shards by ``param_pspecs(cfg, mesh, hp.fsdp, hp.fsdp_axes)``
    and computes its worker's gradient as the mesh runtime does
    (``trainer._mesh_vgrads``: autograd through the collectives, whole
    leaves gathered over the model axis). Keeps the rank's worker, loss,
    whole gradients and shard shapes, the collectives (op, shape) of
    the loss's forward alone and of its value and gradient (before the
    gradients' gathers), and the loss taken from the logits gathered
    whole (``forward``'s serving logits) beside the vocab-parallel one.
    On the job's ``device``."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import trainer as TT
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as TM
    from repro_torch.utils.trees import tree_leaves, tree_paths, \
        tree_unflatten

    job = _join(rank, world, workdir)
    device = (torch.device("cuda", torch.cuda.current_device())
              if job.get("device") == "cuda" else torch.device("cpu"))
    out, meshes = {}, {}
    for name, sizes, cfg, hp, params, batch in job["cases"]:
        if sizes not in meshes:
            meshes[sizes] = Mesh(sizes, ("data", "model"))
        mesh = meshes[sizes]
        fs = TT.flat_sharding(cfg, mesh, hp)
        tp = TT.train_context(cfg, fs)
        layout = TT.flat_layout(cfg, fs.shards)
        shards = SH.cut_tree(_to(params, device), fs.pspecs, mesh)
        wb = TT._local_batch(_to(batch, device), fs, 0)
        row = {k: v[0] for k, v in wb.items()}
        fwd, vg = [], []
        paths, leaves = tree_paths(shards), tree_leaves(shards)
        model = leaves if tp is None else tp.grad_leaves(paths, leaves)[1]
        with torch.no_grad(), logged_collectives(fwd):
            loss, _ = TM.lm_loss(cfg, tree_unflatten(paths, model), row,
                                 train=True, tp=tp)
        gathered = None
        if not tp or not tp.fsdp:
            with torch.no_grad():
                inputs = ({"tokens": row["tokens"][:, :-1]}
                          if "tokens" in row else {"embeds": row["embeds"]})
                labels = row["tokens"][:, 1:] if "tokens" in row \
                    else row["labels"]
                logits, aux = TM.forward(cfg, shards, train=True,
                                         positions=row.get("positions"),
                                         tp=tp, **inputs)
                logp = torch.log_softmax(logits.float(), dim=-1)
                gathered = -torch.gather(logp, -1, labels[..., None]).mean() \
                    + aux
        with logged_collectives(vg):
            TT.make_worker_grad(cfg, hp, tp)(shards, row)
        vgrad, _ = TT._mesh_vgrads(cfg, hp, fs, layout, tp)
        losses, grads = vgrad(shards, wb)
        out[name] = {"worker": mesh.coord(fs.waxis), "loss": _host(losses),
                     "grads": _host(grads), "shard_shapes": _shapes(shards),
                     "forward": fwd, "value_and_grad": vg,
                     "vocab_parallel_loss": _host(loss),
                     "gathered_logits_loss": _host(gathered)}
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _storage_bytes(tree) -> tuple:
    """(bytes of the storages behind ``tree``'s leaves, each counted once;
    bytes of the leaves themselves): equal when no leaf is a view into a
    larger buffer."""
    from repro_torch.utils.trees import tree_leaves
    leaves = tree_leaves(tree)
    storages = {x.untyped_storage().data_ptr(): x.untyped_storage().nbytes()
                for x in leaves}
    return (sum(storages.values()),
            sum(x.numel() * x.element_size() for x in leaves))


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
               "selective_scan": ssm_scan.selective_scan,
               "selective_scan_heads": ssm_scan.selective_scan_heads}

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
