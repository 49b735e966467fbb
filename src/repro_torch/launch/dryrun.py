"""The port's dry run: every (architecture × input shape) combination on a
production mesh, traced on the ``meta`` device, with its roofline terms
(the JAX package's ``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
        [--out rows.jsonl]

The reference lowers and compiles each combo with XLA and reads its terms
from the compiled HLO (``utils/hlo_cost.py``). The port has no compiler in
the loop. It runs rank 0 of the production mesh (``launch/mesh.py``: 256
ranks, or 512 with ``--multi-pod``) in this process, as one rank of a
fake process group of the mesh's world size
(``torch.testing._internal.distributed.fake_pg``: a collective returns at
once and moves nothing), on ``meta`` tensors (shapes and dtypes, no
storage), and counts:

  * operations: ``torch.utils.flop_counter.FlopCounterMode`` over the
    rank's work, plus the serving kernels' shape-only routes
    (``kernels/ops.counting_meta_ops``: flash attention's and the scans'
    operations by formula);
  * collectives: every all-reduce and all-gather, by kind, with the bytes
    a rank sends in a ring (2·(W−1)/W · N for an all-reduce of N bytes
    over W ranks, (W−1) · N for an all-gather of N-byte parts) and whether
    the group stays inside one node of ``NODE_CARDS`` cards;
  * memory: the bytes of the parameters, the training state, the decode
    cache and the inputs a rank holds, its blocks by the sharding tables
    (in place of XLA's ``memory_analysis``, which has no counterpart).

Prefill and decode trace rank 0's whole step (``distributed/serving.py``).
Training traces the rank's worker gradient: one microbatch's forward and
backward under its ``TPContext`` (the model axis, the FSDP gathers inside
the remat region), counted once a microbatch and a gradient evaluation of
the rule, then the gradients' gathers over the model axis. The CADA
round's collectives are reckoned from the layout and the state specs, as
``tools/mesh_state_bytes.py`` reckons the state (:func:`state_bytes` is
both's), since the round reads flags to the host that a meta tensor has
not got; its elementwise work is not counted.

The three times divide by the H100 SXM data sheet's rates
(``launch/mesh.py``): ``t_compute_s`` the operations at the dense bf16
peak, ``t_memory_s`` the bytes a rank holds read once (a floor) at the
HBM rate, ``t_collective_s`` the intra-node bytes at NVLink's rate and the
rest at InfiniBand's. They are computed, not measured. A combo the port
refuses (``NotImplementedError``) is named with its cause; the run exits
non-zero only for a combo that fails otherwise.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs as cfgs
from repro_torch.configs.base import (DECODE, PREFILL, SHAPES,
                                      adapt_for_shape, input_specs)
from repro_torch.core.comm import strategy_for
from repro_torch.distributed import serving
from repro_torch.distributed import trainer as T
from repro_torch.distributed.sharding import (_serving_param_pspecs,
                                              cut_tree, leaf_axes,
                                              model_specs, shard_cache,
                                              spec_axes, uncut_tree)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import (DATA, H100_BF16_FLOPS, H100_HBM_BW,
                                     IB_BW, NODE_CARDS, NVLINK_BW,
                                     make_production_mesh)
from repro_torch.launch.policy import train_policy
from repro_torch.models.config import active_param_count, param_count
from repro_torch.models.model import abstract_params
from repro_torch.utils.trees import tree_leaves, tree_map

_FLAT_F32 = 4


# ------------------------------------------------------------ the world

def fake_world(world: int) -> None:
    """Join a fake process group of ``world`` ranks as rank 0 (in this
    process only; a collective moves nothing). Raises if another group of
    a different size is already the default."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of {dist.get_world_size()}"
                               f" ranks exists; the mesh needs {world}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


class _Collectives:
    """The collectives of a traced region: (kind, bytes a rank sends,
    whether the group stays inside one node) each."""

    def __init__(self):
        self.log: list = []
        self._groups: dict = {}

    def group_info(self, group) -> tuple[int, bool]:
        """(W, inside one node) of a process group (None: the world)."""
        key = id(group)
        if key not in self._groups:
            ranks = dist.get_process_group_ranks(
                group if group is not None else dist.group.WORLD)
            self._groups[key] = (len(ranks), len({r // NODE_CARDS
                                                  for r in ranks}) == 1)
        return self._groups[key]

    def add(self, kind: str, nbytes: float, w: int, intra: bool,
            times: int = 1) -> None:
        if w > 1:
            sent = (2 * (w - 1) / w * nbytes if kind == "all_reduce"
                    else (w - 1) * nbytes)
            self.log.append((kind, sent * times, intra, times))

    @contextlib.contextmanager
    def watch(self, times: int = 1):
        """Log each all-reduce and all-gather issued inside, ``times``
        times over (a region that stands for that many identical ones)."""
        saved = {op: getattr(dist, op) for op in ("all_reduce",
                                                  "all_gather")}

        def logged(op, f):
            def call(*args, **kw):
                t = args[0] if op == "all_reduce" else args[1]
                w, intra = self.group_info(kw.get("group"))
                self.add(op, t.numel() * t.element_size(), w, intra, times)
                return f(*args, **kw)
            return call

        for op, f in saved.items():
            setattr(dist, op, logged(op, f))
        try:
            yield self
        finally:
            for op, f in saved.items():
                setattr(dist, op, f)

    def axes(self, mesh, kind: str, nbytes: float, axes: tuple,
             times: int = 1) -> None:
        """Log a reckoned collective over the ``axes`` group of ``mesh``."""
        axes = tuple(a for a in axes if mesh.shape.get(a, 1) > 1)
        if not axes:
            return
        group = mesh.group(axes)
        w, intra = self.group_info(group)
        self.add(kind, nbytes, w, intra, times)

    def summary(self) -> dict:
        by_kind, counts = {}, {}
        intra = inter = 0.0
        for kind, sent, inside, times in self.log:
            by_kind[kind] = by_kind.get(kind, 0.0) + sent
            counts[kind] = counts.get(kind, 0) + times
            if inside:
                intra += sent
            else:
                inter += sent
        return {"collective_bytes_per_rank": intra + inter,
                "collective_bytes_by_kind": by_kind,
                "collectives": counts,
                "intra_node_bytes_per_rank": intra,
                "inter_node_bytes_per_rank": inter}


# -------------------------------------------------------------- bytes

def _nbytes(x) -> int:
    return x.numel() * x.element_size() if torch.is_tensor(x) else 0


def _share(spec, mesh) -> int:
    """How many ranks' blocks a tensor with ``spec`` is cut into (the mesh
    read through its ``.shape`` only)."""
    return math.prod(mesh.shape.get(a, 1) for a in leaf_axes(spec))


def _block_bytes(x, spec, mesh) -> int:
    """Bytes of the rank's block of ``x`` by ``spec``."""
    return _nbytes(x) // _share(spec, mesh)


def _named(prefix: str, state, specs) -> list:
    """(name, tensor, spec) of every tensor of a state (NamedTuples and
    dicts) and its spec tree."""
    if isinstance(state, dict):
        return [e for k in sorted(state)
                for e in _named(f"{prefix}/{k}", state[k], specs[k])]
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return [e for f, v, sp in zip(state._fields, state, specs)
                for e in _named(f"{prefix}/{f}" if prefix else f, v, sp)]
    return [(prefix, state, specs)] if torch.is_tensor(state) else []


def state_bytes(cfg, mesh, hp) -> dict:
    """The training state a rank of ``trainer.jit_train_step`` holds at
    rest, on either plane, reckoned from ``abstract_train_state`` and
    ``train_state_specs`` (each entry divided by the sizes of the axes its
    spec cuts it over; nothing allocated; the mesh is read through its
    ``.shape`` only). Returns {"by_entry": bytes by
    the entry's first name, "per_rank": their sum, "one_process": the
    whole state's bytes, "n_flat", "m"}."""
    m = mesh.shape[T.worker_axis_name(mesh)]
    state = T.abstract_train_state(cfg, hp, m,
                                   shards=T.flat_state_shards(cfg, mesh, hp))
    specs = T.train_state_specs(cfg, mesh, hp)
    groups: dict = {}
    mine = whole = 0
    for name, t, spec in _named("", state, specs):
        nbytes = _block_bytes(t, spec, mesh)
        group = name.split("/")[0]
        if group == "comm":
            group = name.split("/")[1]
            if group == "extras":
                group = name.split("/")[2]
        groups[group] = groups.get(group, 0) + nbytes
        mine += nbytes
        whole += _nbytes(t)
    return {"by_entry": groups, "per_rank": mine, "one_process": whole,
            "n_flat": T.flat_layout(cfg, T.flat_state_shards(
                cfg, mesh, hp)).n_flat, "m": m}


def _gather_bytes(log, mesh, nbytes: float, src, dst) -> None:
    """Log the gathers :func:`sharding.move` makes taking a leaf of
    ``nbytes`` whole bytes from its block under ``src`` to ``dst``."""
    block = nbytes / mesh.size(leaf_axes(src))
    for a, b in zip(src, dst):
        sa, sb = spec_axes(a), spec_axes(b)
        if sa == sb:
            continue
        w = mesh.size(sa)
        if w > 1:
            log.axes(mesh, "all_gather", block, sa)
            block *= w
        block /= mesh.size(sb)


def _round_collectives(log, cfg, mesh, hp) -> None:
    """The CADA round's collectives on a rank of ``jit_train_step``
    (beyond the gradient evaluations, which are traced), reckoned from the
    layout and the state specs: the flat plane's norms, eq. (3), the
    server step and θ's gathers, or the pytree plane's per-leaf moves and
    gathers."""
    strategy = strategy_for(hp.rule)
    waxis = T.worker_axis_name(mesh)
    m = mesh.shape[waxis]
    params = abstract_params(cfg)
    leaves = tree_leaves(params)
    gated = not (strategy.stateless or strategy.delta_payload)
    bits = strategy.bits_per_entry
    # the losses and (gated rules) the LHS norms, assembled over the rows
    log.axes(mesh, "all_reduce", _FLAT_F32 * m, (waxis,))
    if hp.fused:
        fs = T.flat_sharding(cfg, mesh, hp)
        n = T.flat_layout(cfg, fs.shards).n_flat
        cols = mesh.size(fs.col_axes)
        # θ packed whole from the rank's shards, leaf by leaf
        for x, sp in zip(leaves, tree_leaves(fs.pspecs)):
            _gather_bytes(log, mesh, _nbytes(x), sp, (None,) * len(sp))
        if gated:
            log.axes(mesh, "all_reduce", _FLAT_F32 * m, fs.plane_axes)
        if bits < 32 and fs.col_axes:
            log.axes(mesh, "all_reduce", _FLAT_F32 * (len(leaves) + 1),
                     fs.col_axes)
        if strategy.kind == "topk" and fs.col_axes:
            log.axes(mesh, "all_gather", _FLAT_F32 * n / cols, fs.col_axes)
        evals = 2 if strategy.kind == "local_momentum" else 1
        log.axes(mesh, "all_reduce", _FLAT_F32 * n / cols, (waxis,), evals)
        log.axes(mesh, "all_reduce", _FLAT_F32, fs.axes)
        log.axes(mesh, "all_gather", _FLAT_F32 * n / fs.shards, fs.axes)
        return
    ts = T.tree_sharding(cfg, mesh, hp)
    cada = T._DTYPES[hp.cada_dtype].itemsize
    whole = [(None,) * len(sp) for sp in tree_leaves(ts.psp)]
    for i, x in enumerate(leaves):
        psp, msp = tree_leaves(ts.psp)[i], tree_leaves(ts.msp)[i]
        gsp, gwsp = tree_leaves(ts.gsp)[i], tree_leaves(ts.gwsp)[i]
        inner = tuple(gwsp[1:])
        f32 = x.numel() * _FLAT_F32
        # eq. (3): the workers' rows of the rank's block, gathered
        if not strategy.stateless:
            log.axes(mesh, "all_gather", x.numel() * cada
                     / mesh.size(leaf_axes(inner)), (waxis,))
        else:
            log.axes(mesh, "all_gather", x.numel() * x.element_size()
                     / mesh.size(leaf_axes(inner)), (waxis,))
        # the server step's moves: θ and ∇ to the moments' blocks, θ' back
        _gather_bytes(log, mesh, _nbytes(x), psp, msp)
        _gather_bytes(log, mesh, f32, gsp, msp)
        _gather_bytes(log, mesh, _nbytes(x), msp, psp)
        if strategy.kind == "cada2":
            _gather_bytes(log, mesh, _nbytes(x), psp, tuple(
                tree_leaves(ts.wsp)[i][1:]))
        if strategy.kind == "topk" or strategy.delta_payload:
            _gather_bytes(log, mesh, f32, inner, (None,) * len(inner))
        if strategy.delta_payload:
            _gather_bytes(log, mesh, _nbytes(x), psp, whole[i])
    if gated:
        log.axes(mesh, "all_reduce", _FLAT_F32 * len(leaves), (waxis,))
    log.axes(mesh, "all_reduce", _FLAT_F32 * len(leaves),
             tuple(dict.fromkeys(a for sp in tree_leaves(ts.msp)
                                 for a in leaf_axes(sp))))


# -------------------------------------------------------------- traces

def _trace_train(cfg, shape, mesh, hp, log) -> dict:
    """The rank's gradient evaluations and the round's collectives of one
    training step; returns the operation count and the bytes a rank
    holds."""
    strategy = strategy_for(hp.rule)
    fs = T.state_sharding(cfg, mesh, hp)
    h = hp.rule.local_steps if strategy.delta_payload else 1
    m = mesh.shape[fs.waxis]
    batch = T.worker_split_abstract(input_specs(cfg, shape)["batch"], m, h)
    lead = int(h > 1)
    local = T._local_batch(batch, fs, lead)
    if lead:
        local = {k: v[0] for k, v in local.items()}
    row = {k: v[0] for k, v in local.items()}
    bm = row["tokens" if "tokens" in row else "labels"].shape[0]
    nm = min(hp.microbatches, bm)
    while bm % nm:
        nm -= 1
    size = bm // nm
    micro = {k: (v[:, :size] if k == "positions" else v[:size])
             for k, v in row.items()}
    evals = h if strategy.delta_payload else strategy.grad_evals_per_iter
    # where each evaluation's point is: θ (or cada1's shared snapshot)
    # under the parameters' specs, or the worker's own point (cada2's
    # stale iterate, a delta rule's local parameters) under
    # ``worker_pspecs`` (``trainer.train_context(worker=True)``)
    own = (h if strategy.delta_payload else
           int(strategy.kind == "cada2"))
    flops, kernel_ops = 0, {}
    one_hp = dataclasses.replace(hp, microbatches=1)
    for specs, worker, times in ((fs.pspecs, False, evals - own),
                                 (fs.worker_pspecs, True, own)):
        if not times:
            continue
        ctx = T.train_context(cfg, fs, worker=worker)
        shards = cut_tree(abstract_params(cfg), specs, mesh)
        counter = FlopCounterMode(display=False)
        with counter, log.watch(times=nm * times), \
                ops.counting_meta_ops() as counted:
            _, grads = T.make_worker_grad(cfg, one_hp, ctx)(shards, micro)
        flops += counter.get_total_flops() * nm * times
        for k, v in counted.items():
            kernel_ops[k] = kernel_ops.get(k, 0) + v * nm * times
        with log.watch(times=times):
            uncut_tree(tree_map(lambda g: g[None], grads),
                       model_specs(fs.pspecs), mesh, lead=1)
    if strategy.kind == "cada2" and hp.fused:
        # the worker's ring row gathered over the worker axis where it
        # cuts the ring (``FlatSharding.worker_points``), one row
        for x, a, b in zip(tree_leaves(abstract_params(cfg)),
                           tree_leaves(fs.pspecs),
                           tree_leaves(fs.worker_pspecs)):
            _gather_bytes(log, mesh, _nbytes(x), a, b)
    if fs.waxis != DATA and mesh.shape.get(DATA, 1) > 1:
        # the pod's mean over its data ranks (``trainer._mesh_vgrads``)
        n = T.flat_layout(cfg).n_flat
        log.axes(mesh, "all_reduce", _FLAT_F32 * n, (DATA,), evals)
    _round_collectives(log, cfg, mesh, hp)
    st = state_bytes(cfg, mesh, hp)
    pbytes = sum(_block_bytes(x, sp, mesh) for x, sp in zip(
        tree_leaves(abstract_params(cfg)), tree_leaves(fs.pspecs)))
    return {"flops": flops, "kernel_ops": kernel_ops, "param_bytes": pbytes,
            "state_bytes": st["per_rank"] - pbytes, "cache_bytes": 0,
            "input_bytes": sum(_nbytes(v) for v in local.values()) * h,
            "grad_evals": evals, "microbatches": nm}


def _trace_serve(cfg, shape, mesh, log) -> dict:
    """Rank 0's whole prefill or decode step on meta tensors."""
    sp = cut_tree(abstract_params(cfg), _serving_param_pspecs(cfg, mesh),
                  mesh)
    pbytes = sum(_nbytes(x) for x in tree_leaves(sp))
    counter = FlopCounterMode(display=False)
    if shape.kind == PREFILL:
        specs = input_specs(cfg, shape)
        step = serving.jit_prefill_step(cfg, mesh, specs)
        with counter, log.watch(), ops.counting_meta_ops() as kernel_ops:
            _, cache = step(sp, specs)
        inputs = specs
    else:
        step, cache_sds, inputs = serving.jit_decode_step(
            cfg, mesh, shape.batch, shape.seq)
        cache = shard_cache(cache_sds, cfg, mesh)
        with counter, log.watch(), ops.counting_meta_ops() as kernel_ops:
            step(sp, cache, inputs)
    return {"flops": counter.get_total_flops(), "kernel_ops": kernel_ops,
            "param_bytes": pbytes,
            "state_bytes": 0,
            "cache_bytes": sum(_nbytes(x) for x in cache
                               if torch.is_tensor(x)),
            "input_bytes": sum(_nbytes(v) for v in inputs.values())}


# ---------------------------------------------------------------- rows

def run_combo(arch: str, shape_name: str, *, multi_pod: bool = False,
              rule_kind: str | None = None, model_par: int = 16,
              cfg_override=None, hp_override=None, tag: str = "",
              verbose: bool = True) -> dict:
    """One (arch, shape, production mesh) row: the operation count, the
    collectives, the bytes a rank holds and the three roofline times."""
    t0 = time.time()
    cfg = adapt_for_shape(cfg_override or cfgs.get_config(arch),
                          SHAPES[shape_name])
    shape = SHAPES[shape_name]
    chips = 512 if multi_pod else 256
    fake_world(chips)
    mesh = make_production_mesh(multi_pod=multi_pod, model_par=model_par)
    data = 256 // model_par
    meta = {"arch": arch, "shape": shape_name,
            "mesh": (f"2x{data}x{model_par}" if multi_pod
                     else f"{data}x{model_par}"), "chips": chips}
    if tag:
        meta["tag"] = tag
    log = _Collectives()
    if shape.kind == "train":
        hp = hp_override or train_policy(cfg, mesh, rule_kind)
        meta.update(step="train_step", rule=hp.rule.kind,
                    microbatches=hp.microbatches, cada_dtype=hp.cada_dtype,
                    moments_dtype=hp.moments_dtype, fused=hp.fused)
        got = _trace_train(cfg, shape, mesh, hp, log)
        tokens = shape.batch * shape.seq
        model_flops = 6 * active_param_count(cfg) * tokens
    else:
        meta["step"] = "prefill" if shape.kind == PREFILL else "serve_step"
        if shape.kind == DECODE:
            meta["sliding_window"] = cfg.sliding_window
        got = _trace_serve(cfg, shape, mesh, log)
        tokens = shape.batch * (shape.seq if shape.kind == PREFILL else 1)
        model_flops = 2 * active_param_count(cfg) * tokens
    kernel_ops = got.pop("kernel_ops")
    flops = got.pop("flops") + sum(kernel_ops.values())
    coll = log.summary()
    held = sum(got[k] for k in ("param_bytes", "state_bytes", "cache_bytes",
                                "input_bytes"))
    t_compute = flops / H100_BF16_FLOPS
    t_memory = held / H100_HBM_BW
    t_coll = (coll["intra_node_bytes_per_rank"] / NVLINK_BW
              + coll["inter_node_bytes_per_rank"] / IB_BW)
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    model_per_rank = model_flops / chips
    row = {**meta, "flops_per_rank": flops, "kernel_ops_per_rank":
           kernel_ops, "model_flops_per_rank": model_per_rank,
           "useful_flops_ratio": model_per_rank / flops if flops else 0.0,
           **coll, "t_compute_s": t_compute, "t_memory_s": t_memory,
           "t_collective_s": t_coll, "dominant": dominant,
           "params": param_count(cfg),
           "active_params": active_param_count(cfg),
           **{f"{k}_per_rank": v for k, v in got.items()
              if k.endswith("_bytes")},
           **{k: v for k, v in got.items() if not k.endswith("_bytes")},
           "rates": "H100 SXM data sheet (700 W)",
           "t_trace_s": round(time.time() - t0, 2)}
    if verbose:
        print(f"[dryrun] {arch} × {shape_name} × {row['mesh']} "
              f"({row['step']}): OK  compute={t_compute:.3e}s "
              f"memory={t_memory:.3e}s collective={t_coll:.3e}s "
              f"dominant={dominant} useful={row['useful_flops_ratio']:.2f} "
              f"params/rank={row['param_bytes_per_rank'] / 2**30:.3f} GiB "
              f"state/rank={row['state_bytes_per_rank'] / 2**30:.3f} GiB "
              f"cache/rank={row['cache_bytes_per_rank'] / 2**30:.3f} GiB "
              f"(traced in {row['t_trace_s']:.1f} s)", flush=True)
    return row


def _parse_value(val: str):
    for cast in (int, float):
        try:
            return cast(val)
        except ValueError:
            continue
    return val == "True" if val in ("True", "False") else val


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default=None, help="architecture id")
    p.add_argument("--shape", default=None, choices=list(SHAPES))
    p.add_argument("--all", action="store_true",
                   help="every (arch × shape) combination")
    p.add_argument("--multi-pod", action="store_true",
                   help="2x16x16 (512-rank) mesh instead of 16x16")
    p.add_argument("--rule", default=None,
                   help="a registered rule kind (train_policy's default)")
    p.add_argument("--model-par", type=int, default=16,
                   help="model-axis size (256/model_par becomes data)")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   help="config override field=value (repeatable)")
    p.add_argument("--hp-set", dest="hp_overrides", action="append",
                   default=[],
                   help="TrainHParams override field=value (repeatable)")
    p.add_argument("--out", default=None, help="append JSONL rows here")
    args = p.parse_args(argv)
    if args.all:
        combos = [(a, s) for a in cfgs.list_archs() for s in SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        p.error("--arch and --shape, or --all")
    cfg_kw = dict(kv.split("=", 1) for kv in args.overrides)
    cfg_kw = {k: _parse_value(v) for k, v in cfg_kw.items()}
    rows, refused, failed = [], [], []
    for arch, shape in combos:
        try:
            cfg = cfgs.get_config(arch)
            if cfg_kw:
                cfg = cfg.with_(**cfg_kw)
            hp = None
            if args.hp_overrides:
                fake_world(512 if args.multi_pod else 256)
                hp = train_policy(cfg, make_production_mesh(
                    multi_pod=args.multi_pod, model_par=args.model_par),
                    args.rule)
                kw = {}
                for ov in args.hp_overrides:
                    key, val = ov.split("=", 1)
                    kw[key] = (tuple(a for a in val.split(",") if a)
                               if key.endswith("_axes") else
                               _parse_value(val))
                hp = dataclasses.replace(hp, **kw)
            row = run_combo(arch, shape, multi_pod=args.multi_pod,
                            rule_kind=args.rule, model_par=args.model_par,
                            cfg_override=cfg if cfg_kw else None,
                            hp_override=hp,
                            tag=";".join(args.overrides + args.hp_overrides))
        except NotImplementedError as e:
            refused.append((arch, shape, str(e)))
            print(f"[dryrun] {arch} × {shape}: REFUSED by the port: {e}",
                  flush=True)
            continue
        except Exception:
            failed.append((arch, shape))
            print(f"[dryrun] {arch} × {shape}: FAILED", flush=True)
            traceback.print_exc()
            continue
        rows.append(row)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    print(f"[dryrun] {len(rows)} of {len(combos)} combos traced, "
          f"{len(refused)} refused by the port"
          + "".join(f"\n  refused: {a} × {s}: {why}"
                    for a, s, why in refused), flush=True)
    if failed:
        raise SystemExit(f"{len(failed)} combos failed: {failed}")
    return rows


if __name__ == "__main__":
    main()
