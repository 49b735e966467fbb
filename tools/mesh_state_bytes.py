"""Per-rank bytes of the trainer's state on a mesh, reckoned from the flat
layout and the sharding tables (computed, not measured: nothing is
allocated; the state's tensors lie on the ``meta`` device).

    PYTHONPATH=src python3 tools/mesh_state_bytes.py --arch stablelm-1.6b \\
        --mesh data=4 --state-fsdp-axes data --rule cada2
    PYTHONPATH=src python3 tools/mesh_state_bytes.py --arch falcon-mamba-7b \\
        --layers 2 --mesh data=2,model=2 --fsdp on --dtype float32

Each entry of ``abstract_train_state`` is divided by the product of the
sizes of the mesh axes its ``train_state_specs`` shards it over, which is
what a rank of ``trainer.jit_train_step`` holds at rest: its server slice
of h, v̂ and ∇, its worker's row of the (M, n_flat) planes (cut to its
column slice), and its blocks of the parameters and of the rule's
parameter-shaped extras (cada2's stale-iterate ring) by ``param_pspecs``:
over the model axis, and over the FSDP axes where FSDP is on (``--fsdp
auto`` resolves it by ``wants_fsdp``, as the trainer does). Printed
beside the one-process trainer's state for the same M, with the bytes of
one whole (n_flat,) fp32 plane (a step's transient unit: the packed θ, a
worker's packed gradient), and one JSON line of every number last.
"""
from __future__ import annotations

import argparse
import json
import math

from repro_torch import configs as C
from repro_torch.core.rules import CommRule
from repro_torch.distributed import trainer as T
from repro_torch.utils.trees import tree_leaves, tree_paths


class Shape:
    """A mesh as the tables read it: its ``.shape`` dict."""

    def __init__(self, shape: dict):
        self.shape = shape


def _entries(state, specs) -> dict:
    """{name: (tensor, spec)} of every tensor of the state."""
    out = {"h": (state.h, specs.h), "vhat": (state.vhat, specs.vhat)}
    out.update({"params/" + "/".join(p): (t, sp) for p, t, sp in zip(
        tree_paths(state.params), tree_leaves(state.params),
        tree_leaves(specs.params))})
    if state.comm is not None:
        for field in ("nabla", "worker_grads", "staleness", "diff_hist"):
            out[field] = (getattr(state.comm, field),
                          getattr(specs.comm, field))
        for key, v in state.comm.extras.items():
            sp = specs.comm.extras[key]
            if isinstance(v, dict):
                out.update({f"{key}/" + "/".join(p): (t, s) for p, t, s in
                            zip(tree_paths(v), tree_leaves(v),
                                tree_leaves(sp))})
            else:
                out[key] = (v, sp)
    return out


def _share(spec, mesh) -> int:
    """How many ranks one entry's bytes are split over."""
    axes = [a for d in spec if d is not None
            for a in (d if isinstance(d, tuple) else (d,))]
    return math.prod(mesh.shape[a] for a in axes)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="stablelm-1.6b")
    p.add_argument("--layers", type=int, default=0)
    p.add_argument("--mesh", default="data=4",
                   help="axis=size,... (a model axis of 1 where absent)")
    p.add_argument("--state-fsdp-axes", default="data")
    p.add_argument("--fsdp", choices=("auto", "on", "off"), default="off")
    p.add_argument("--fsdp-axes", default="data")
    p.add_argument("--dtype", default="",
                   help="the parameters' dtype (default: the config's)")
    p.add_argument("--rule", default="cada2")
    args = p.parse_args(argv)
    cfg = C.get_config(args.arch)
    if args.layers:
        cfg = cfg.with_(n_layers=args.layers)
    if args.dtype:
        cfg = cfg.with_(dtype=args.dtype)
    shape = {k: int(v) for k, v in (kv.split("=") for kv in
                                    args.mesh.split(","))}
    mesh = Shape({"model": 1, **shape})
    hp = T.TrainHParams(rule=CommRule(kind=args.rule),
                        fsdp={"auto": None, "on": True,
                              "off": False}[args.fsdp],
                        fsdp_axes=tuple(args.fsdp_axes.split(",")),
                        state_fsdp_axes=tuple(
                            a for a in args.state_fsdp_axes.split(",") if a))
    m = mesh.shape[T.worker_axis_name(mesh)]
    shards = T.flat_state_shards(cfg, mesh, hp)
    state = T.abstract_train_state(cfg, hp, m, shards=shards)
    specs = T.train_state_specs(cfg, mesh, hp)
    groups: dict = {}
    total = whole = 0
    for name, (t, sp) in _entries(state, specs).items():
        nbytes = t.numel() * t.element_size()
        mine = nbytes // _share(sp, mesh)
        group = name.split("/")[0]
        groups[group] = groups.get(group, 0) + mine
        total += mine
        whole += nbytes
    print(f"{cfg.name}, {cfg.n_layers} layers, n_flat "
          f"{state.h.numel():,}; mesh {mesh.shape}, M = {m}, rule "
          f"{args.rule}, state axes {T.flat_state_axes(cfg, mesh, hp)} "
          "(computed from the layout, not measured):")
    for group, nbytes in groups.items():
        print(f"  {group:14s} {nbytes / 1e9:10.3f} GB a rank")
    print(f"  total          {total / 1e9:10.3f} GB a rank at rest; the "
          f"one-process trainer's state for M = {m}: {whole / 1e9:.3f} GB")
    plane = state.h.numel() * 4
    print(f"  one (n_flat,) fp32 plane: {plane / 1e9:.3f} GB")
    row = {"arch": cfg.name, "layers": cfg.n_layers,
           "n_flat": state.h.numel(), "mesh": mesh.shape, "m": m,
           "fsdp": args.fsdp, "dtype": cfg.dtype,
           "per_rank_bytes": total, "one_process_bytes": whole,
           "plane_bytes": plane, "by_entry": groups}
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
