"""Per-rank bytes of the trainer's state on a mesh, reckoned from the
layout and the sharding tables (computed, not measured: nothing is
allocated; the state's tensors lie on the ``meta`` device).

    PYTHONPATH=src python3 tools/mesh_state_bytes.py --arch stablelm-1.6b \\
        --mesh data=4 --state-fsdp-axes data --rule cada2
    PYTHONPATH=src python3 tools/mesh_state_bytes.py --arch falcon-mamba-7b \\
        --layers 2 --mesh data=2,model=2 --fsdp on --dtype float32
    PYTHONPATH=src python3 tools/mesh_state_bytes.py --arch stablelm-1.6b \\
        --layers 2 --mesh data=2,model=2 --pytree --shard-cada-state
    PYTHONPATH=src python3 tools/mesh_state_bytes.py --arch yi-34b \\
        --mesh data=16,model=16 --policy

The reckoning is the dry run's (``repro_torch.launch.dryrun.state_bytes``),
so the two cannot disagree: each entry of ``abstract_train_state`` is
divided by the product of the sizes of the mesh axes its
``train_state_specs`` shards it over, which is what a rank of
``trainer.jit_train_step`` holds at rest. On the flat plane: its server
slice of h, v̂ and ∇, its worker's row of the (M, n_flat) planes (cut to
its column slice), and its blocks of the parameters and of the rule's
parameter-shaped extras (cada2's stale-iterate ring) by ``param_pspecs``:
over the model axis, and over the FSDP axes where FSDP is on (``--fsdp
auto`` resolves it by ``wants_fsdp``, as the trainer does). On the pytree
plane (``--pytree``, ``fused=False``): every leaf by its spec tree, the
moments over ``--state-fsdp-axes``, ∇ and the worker trees over "data"
with ``--shard-cada-state``. Printed beside the one-process trainer's
state for the same M, with the bytes of one whole (n_flat,) fp32 plane (a
step's transient unit: the packed θ, a worker's packed gradient), and one
JSON line of every number last. ``--policy`` takes
``train_policy``'s hyper-parameters for the whole config on the mesh (the
dry run's, ``python -m repro_torch.launch.dryrun``) in place of the
flags.
"""
from __future__ import annotations

import argparse
import json

from repro_torch import configs as C
from repro_torch.core.rules import CommRule
from repro_torch.distributed import trainer as T
from repro_torch.launch.dryrun import state_bytes
from repro_torch.launch.policy import train_policy


class Shape:
    """A mesh as the tables read it: its ``.shape`` dict."""

    def __init__(self, shape: dict):
        self.shape = shape


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
    p.add_argument("--pytree", action="store_true",
                   help="the pytree plane (fused=False)")
    p.add_argument("--shard-cada-state", action="store_true")
    p.add_argument("--policy", action="store_true",
                   help="launch.policy.train_policy's hyper-parameters for "
                        "the whole config on the mesh (the dry run's)")
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
                            a for a in args.state_fsdp_axes.split(",") if a),
                        shard_cada_state=args.shard_cada_state,
                        fused=not args.pytree)
    if args.policy:
        hp = train_policy(C.get_config(args.arch), mesh, args.rule)
    got = state_bytes(cfg, mesh, hp)
    m, n_flat = got["m"], got["n_flat"]
    plane_kind = "the flat plane" if hp.fused else "the pytree plane"
    print(f"{cfg.name}, {cfg.n_layers} layers, n_flat {n_flat:,}; mesh "
          f"{mesh.shape}, M = {m}, rule {args.rule}, {plane_kind}, state "
          f"axes {T.flat_state_axes(cfg, mesh, hp)} (computed from the "
          "layout, not measured):")
    for group, nbytes in got["by_entry"].items():
        print(f"  {group:14s} {nbytes / 1e9:10.3f} GB a rank")
    print(f"  total          {got['per_rank'] / 1e9:10.3f} GB a rank at "
          f"rest; the one-process trainer's state for M = {m}: "
          f"{got['one_process'] / 1e9:.3f} GB")
    plane = n_flat * 4
    print(f"  one (n_flat,) fp32 plane: {plane / 1e9:.3f} GB")
    row = {"arch": cfg.name, "layers": cfg.n_layers, "n_flat": n_flat,
           "mesh": mesh.shape, "m": m,
           "fsdp": "policy" if args.policy else args.fsdp,
           "dtype": cfg.dtype, "fused": hp.fused,
           "per_rank_bytes": got["per_rank"],
           "one_process_bytes": got["one_process"], "plane_bytes": plane,
           "by_entry": got["by_entry"]}
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
