"""Sharding policy: parameter, batch and cache PartitionSpecs per (config,
mesh), and the flat CADA state's sharding on the mesh runtime (the JAX
package's ``distributed/sharding.py``).

The spec functions are tables, equal to the reference's for every config
and mesh shape (a mesh is read through its ``.shape`` dict only):

  * tensor-parallel ("model" axis): attention heads, FFN hidden, MoE
    experts (expert-parallel when n_experts divides the axis, else TP
    inside each expert), Mamba d_inner / SSM heads, and the vocab dim of
    embed/lm_head;
  * FSDP ("data" axis): the non-TP dim of every large 2D+ weight, on when
    the per-shard replicated footprint would exceed ``FSDP_THRESHOLD``
    bytes (grok-1, yi-34b, llama3-405b);
  * every sharding falls back to replication when the dim does not divide
    by the mesh axis;
  * the "pod" axis never shards parameters: pods replicate the model and
    are CADA's workers.

The mesh runtime executes all of them: the worker axis and the flat
state's axes (:class:`FlatSharding`), the per-leaf state of the pytree
plane (:class:`TreeSharding`), the model axis and parameter FSDP in
training (``trainer.jit_train_step``), and the model axis and the batch
over the data axes in serving (``distributed/serving.py``):
:func:`cut_tree`, :func:`shard_params`, :func:`shard_cache` and
:func:`shard_batch` cut the rank's blocks by the tables, and a
:class:`TPContext` carries the collectives the model code completes a
sharded dim with, each with its backward, and the per-layer gathers of
the FSDP dims (:class:`FSDPLeaf`).

:class:`FlatSharding` is both the reference's static description (the
mesh, the worker axis, the state axes) and, on a mesh of ranks
(``launch.mesh.Mesh``), the rank's view of it: which worker rows and
which flat columns its planes hold, which server slice it owns, the cuts
of a global plane to those slices and the gathers back (in place of the
reference's ``constrain_server``/``constrain_worker``, which pin a global
array's layout for the partitioner), and the collectives the shard-local
kernel forms complete their scalars with. :class:`TreeSharding` is the
same for the pytree plane's per-leaf state: the reference's spec trees
(parameters, moments, gradient-shaped and worker-leading state), the
moves of a leaf between them (:func:`move`), and the one collective for
each set of axes that completes a per-leaf sum or max over exactly the
axes that cut each leaf.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core.flat import FlatLayout, spec_dim
from repro_torch.models.config import ModelConfig, param_count
from repro_torch.models.model import (DecodeCache, abstract_params,
                                      init_cache)
from repro_torch.utils.trees import (tree_leaves, tree_map, tree_paths,
                                     tree_unflatten)

FSDP_THRESHOLD = 6e9  # bytes of bf16 params per model shard before FSDP

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class P(tuple):
    """A PartitionSpec: per dimension an axis name, a tuple of axis names
    (sharded over their product) or None (replicated). ``P(*dims)``, as
    ``jax.sharding.PartitionSpec`` is built; it compares as the tuple of
    its dims."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def strip_axis(spec: P, axis: str) -> P:
    """``spec`` with ``axis`` removed from every dim."""
    dims = []
    for d in spec:
        if d == axis:
            dims.append(None)
        elif isinstance(d, tuple):
            kept = tuple(a for a in d if a != axis)
            dims.append(kept if kept else None)
        else:
            dims.append(d)
    return P(*dims)


# ------------------------------------------------------- flat state plane

@dataclass(frozen=True)
class FlatSharding:
    """How the flat state plane shards over a mesh.

    ``axes`` are the mesh axes the (n_flat,) SERVER planes (θ, h, v̂, ∇)
    shard over (ZeRO-style: ``TrainHParams.state_fsdp_axes``,
    ``shard_cada_state`` or the FSDP axes), in their spec order: the
    server shard index is row-major over them. ``waxis`` is the worker
    axis leading the (M, n_flat) planes; their flat dim shards over
    ``col_axes``. On a mesh of ranks each rank holds worker row
    ``coord(waxis)`` (M is the worker axis's size) of its column slice,
    and its server slice.
    """
    mesh: Any
    waxis: str
    axes: tuple
    # the parameter tree's specs (``param_pspecs``), by which the trainer
    # cuts and gathers the parameters and their copies
    pspecs: Any = field(compare=False)

    # ---- the reference's table
    @property
    def col_axes(self) -> tuple:
        """State-shard axes of the FLAT dim of worker planes: the server
        axes minus the worker axis (one spec may not repeat an axis)."""
        return tuple(a for a in self.axes if a != self.waxis)

    @property
    def plane_axes(self) -> tuple:
        """Every mesh axis a worker plane touches (rows + columns)."""
        return tuple(dict.fromkeys((self.waxis,) + self.col_axes))

    @property
    def shards(self) -> int:
        """State-shard count = required divisor of ``FlatLayout.n_flat``."""
        s = 1
        for a in self.axes:
            s *= int(self.mesh.shape[a])
        return s

    @property
    def worker_pspecs(self):
        """The blocks of a point that is the rank's worker's own (cada2's
        stale iterate, a delta rule's local parameters): the parameters'
        specs without the worker axis, so that a per-worker evaluation's
        FSDP gathers stay among its worker's ranks (where the worker axis
        is an FSDP axis, another worker's rank holds another point)."""
        return tree_map(lambda sp: strip_axis(sp, self.waxis), self.pspecs)

    def server_spec(self) -> P:
        """(n_flat,) server-plane PartitionSpec."""
        return P(spec_dim(self.axes))

    def worker_spec(self) -> P:
        """(M, n_flat) worker-plane PartitionSpec."""
        return P(self.waxis, spec_dim(self.col_axes))

    # ---- the rank's view (a mesh of ranks)
    def row_index(self, device) -> torch.Tensor:
        """(1,) int64: the worker row this rank's planes hold."""
        return torch.tensor([self.mesh.coord(self.waxis)], dtype=torch.long,
                            device=device)

    def col_range(self, layout: FlatLayout) -> tuple[int, int]:
        """The flat columns ``[c0, c1)`` of this rank's worker planes."""
        n = layout.n_flat // self.mesh.size(self.col_axes)
        c = self.mesh.index(self.col_axes)
        return c * n, (c + 1) * n

    def server_range(self, layout: FlatLayout) -> tuple[int, int]:
        """The flat entries ``[s0, s1)`` of this rank's server slice."""
        s = self.mesh.index(self.axes)
        return s * layout.shard_len, (s + 1) * layout.shard_len

    def cut_server(self, buf: torch.Tensor, layout: FlatLayout):
        """(..., n_flat) -> this rank's server slice (a contiguous copy
        where it is a strict part, so the whole buffer may be freed)."""
        s0, s1 = self.server_range(layout)
        return buf if s1 - s0 == buf.shape[-1] else buf[..., s0:s1].clone()

    def cut_cols(self, buf: torch.Tensor, layout: FlatLayout):
        """(..., n_flat) -> this rank's column slice (a copy, as above)."""
        c0, c1 = self.col_range(layout)
        return buf if c1 - c0 == buf.shape[-1] else buf[..., c0:c1].clone()

    def cut_rows(self, plane: torch.Tensor, layout: FlatLayout):
        """A global (M, n_flat) plane -> this rank's rows × columns."""
        return self.cut_cols(plane[self.row_index(plane.device)], layout)

    def all_reduce(self, x: torch.Tensor, axes: tuple, op: str = "sum"):
        """``x`` reduced over the ranks that differ only on ``axes`` (a new
        tensor; ``x`` itself when that group is this rank alone)."""
        return all_reduce_over(self.mesh, x, axes, op)

    def gather_cols(self, buf: torch.Tensor) -> torch.Tensor:
        """This rank's column slice of its rows -> the whole rows."""
        return gather_over(self.mesh, buf, self.col_axes)

    def gather_rows(self, plane: torch.Tensor) -> torch.Tensor:
        """This rank's rows × columns -> the whole (M, n_flat) plane."""
        return gather_over(self.mesh, self.gather_cols(plane),
                           (self.waxis,), dim=0)

    def gather_server(self, buf: torch.Tensor) -> torch.Tensor:
        """This rank's server slice -> the whole (n_flat,) plane."""
        return gather_over(self.mesh, buf, self.axes)

    def cols_to_server(self, buf: torch.Tensor, layout: FlatLayout):
        """A buffer over this rank's columns -> its server slice. The slice
        lies inside the columns when the column axes lead the state axes
        (the policies' orders); otherwise the columns are gathered first."""
        c0, c1 = self.col_range(layout)
        s0, s1 = self.server_range(layout)
        if not (c0 <= s0 and s1 <= c1):
            buf, c0 = self.gather_cols(buf), 0
        return buf if s1 - s0 == buf.shape[-1] else buf[s0 - c0:s1 - c0]

    def rows_sum(self, part: torch.Tensor, axes: tuple, m: int | None = None
                 ) -> torch.Tensor:
        """(M,) fp32 from this rank's per-row values: each rank puts its
        rows' values in a zero vector and ONE all-reduce(SUM) over ``axes``
        adds them (over the worker axis this assembles the rows; over the
        column axes it completes each row's partial sums)."""
        m = self.mesh.shape[self.waxis] if m is None else m
        full = torch.zeros((m,), dtype=part.dtype, device=part.device)
        full[self.row_index(part.device)] = part
        return self.all_reduce(full, axes)

    def worker_points(self, ring, slot):
        """The rank's worker's row of the stale-iterate ring (the ring cut
        by the parameters' specs, a leading (R,) axis; ``slot`` every
        worker's (M,) ring row), as the one-row blocks of
        :attr:`worker_pspecs`. Every rank knows every worker's slot, so
        the rows the workers read are gathered over the worker axis, the
        same rows on every rank, and the rank keeps its own."""
        own = slot[self.row_index(slot.device)]
        if all(a == b for a, b in zip(tree_leaves(self.pspecs),
                                      tree_leaves(self.worker_pspecs))):
            return tree_map(lambda x: x.index_select(0, own.long()), ring)
        rows = sorted(set(slot.tolist()))
        idx = torch.tensor(rows, dtype=torch.long, device=slot.device)
        mine = rows.index(int(own[0]))
        return tree_map(
            lambda x, a, b: move(x.index_select(0, idx), P(None, *a),
                                 P(None, *b), self.mesh)[mine:mine + 1],
            ring, self.pspecs, self.worker_pspecs)

    def groups(self) -> None:
        """Make every process group the round uses. ``new_group`` is a
        collective of the whole world, so the mesh runtime calls this on
        every rank before the first step."""
        for axes in ((self.waxis,), self.col_axes, self.axes,
                     self.plane_axes):
            self.mesh.group(axes)


def all_reduce_over(mesh, x: torch.Tensor, axes: tuple, op: str = "sum"
                    ) -> torch.Tensor:
    """``x`` reduced over the ``axes`` group of ``mesh`` (a new tensor;
    ``x`` itself when that group is this rank alone)."""
    group = mesh.group(axes)
    if group is None:
        return x
    out = x.clone()
    dist.all_reduce(out, op=_OPS[op], group=group)
    return out


def gather_over(mesh, x: torch.Tensor, axes: tuple, dim: int = -1
                ) -> torch.Tensor:
    """Concatenate ``x`` along ``dim`` over the ``axes`` group of ``mesh``,
    parts in the row-major order of ``axes`` (``x`` itself when that group
    is this rank alone)."""
    group = mesh.group(axes)
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    order = [mesh.index(axes, r) for r in mesh.group_ranks(axes)]
    return torch.cat([parts[order.index(i)] for i in range(len(parts))],
                     dim=dim)


def _axsize(mesh, name):
    return mesh.shape[name] if name in mesh.shape else 1


def wants_fsdp(cfg: ModelConfig, mesh) -> bool:
    per_shard = 2 * param_count(cfg) / _axsize(mesh, "model")
    return per_shard > FSDP_THRESHOLD


def _map_with_path(rule, tree):
    paths = tree_paths(tree)
    return tree_unflatten(paths, [rule(p, leaf) for p, leaf
                                  in zip(paths, tree_leaves(tree))])


def param_pspecs(cfg: ModelConfig, mesh, fsdp: bool | None = None,
                 fsdp_axes: tuple = ("data",)) -> dict:
    """Dict of P matching ``init_params(cfg)``. ``fsdp_axes``: the mesh
    axes the FSDP dim shards over (("data", "pod") extends it across pods
    for the 314B/405B archs)."""
    if fsdp is None:
        fsdp = wants_fsdp(cfg, mesh)
    msize = _axsize(mesh, "model")

    def m_if(n):  # "model" when divisible, else replicate
        return "model" if (msize > 1 and n % msize == 0) else None

    def f_if(n):  # fsdp axes (largest divisible prefix), else replicate
        if not fsdp:
            return None
        kept, prod = [], 1
        for a in fsdp_axes:
            sz = _axsize(mesh, a)
            if sz > 1 and n % (prod * sz) == 0:
                kept.append(a)
                prod *= sz
        if not kept:
            return None
        return kept[0] if len(kept) == 1 else tuple(kept)

    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.hd
    di, e = cfg.d_inner, cfg.n_experts
    heads_shardable = cfg.n_heads and (cfg.n_heads * hd) % msize == 0 \
        and cfg.n_heads % msize == 0
    kv_shardable = cfg.n_kv_heads and cfg.n_kv_heads % msize == 0
    expert_parallel = e > 0 and e % msize == 0

    def rule(path, leaf):
        name = path[-1]
        stacked = "blocks" in path            # leading n_layers axis
        expert = (leaf.dim() - (1 if stacked else 0)) == 3  # (E, a, b)

        def wrap(spec):
            if stacked:
                return P(*((None,) + tuple(spec)))
            return P(*spec)

        if name == "embed":
            return P(m_if(cfg.vocab), f_if(d))
        if name == "lm_head":
            return P(f_if(d), m_if(cfg.vocab))
        if name in ("final_norm", "ln", "ln1", "ln2"):
            return wrap((None,))
        if name == "wq":
            return wrap((f_if(d), "model" if heads_shardable else None))
        if name in ("wk", "wv"):
            return wrap((f_if(d), "model" if kv_shardable else None))
        if name == "wo":
            return wrap(("model" if heads_shardable else None, f_if(d)))
        if name == "router":
            return wrap((f_if(d), None))
        if name in ("w_gate", "w_up"):
            if expert:
                if expert_parallel:
                    return wrap(("model", f_if(d), None))
                return wrap((None, f_if(d), m_if(ff)))
            return wrap((f_if(d), m_if(ff)))
        if name == "w_down":
            if expert:
                if expert_parallel:
                    return wrap(("model", None, f_if(d)))
                return wrap((None, m_if(ff), f_if(d)))
            return wrap((m_if(ff), f_if(d)))
        # ----- mamba -----
        if name in ("in_x", "in_z"):
            return wrap((f_if(d), m_if(di)))
        if name in ("in_b", "in_c", "in_dt"):
            return wrap((f_if(d), None))
        if name == "conv_w":
            return wrap((None, m_if(di)))
        if name in ("conv_b", "out_norm"):
            return wrap((m_if(di),))
        if name in ("xp_dt", "xp_b", "xp_c"):
            return wrap((m_if(di), None))
        if name == "dt_proj":
            return wrap((None, m_if(di)))
        if name == "dt_bias":
            n0 = leaf.shape[1 if stacked else 0]
            return wrap((m_if(n0),))
        if name in ("A_log", "D"):
            dims = leaf.shape[(1 if stacked else 0):]
            spec = [m_if(dims[0])] + [None] * (len(dims) - 1)
            return wrap(tuple(spec))
        if name == "out_proj":
            return wrap((m_if(di), f_if(d)))
        # default: replicate
        return P(*(None,) * leaf.dim())

    return _map_with_path(rule, abstract_params(cfg))


def _data_axes(mesh):
    """All batch-shardable axes, biggest meshes first: ('pod','data')."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _axes_if(mesh, axes, n):
    """Largest prefix of ``axes`` whose product divides n (else None)."""
    kept = []
    prod = 1
    for a in axes:
        if n % (prod * _axsize(mesh, a)) == 0:
            kept.append(a)
            prod *= _axsize(mesh, a)
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else tuple(kept)


def batch_pspecs(batch_specs: dict, mesh) -> dict:
    """Shard the leading (batch) dim of every batch leaf over the data axes
    (('pod','data') on the multi-pod mesh), guarded by divisibility; M-RoPE
    "positions" (3, B, S) shards its second dim."""
    axes = _data_axes(mesh)

    def rule(path, leaf):
        if "positions" in path:
            return P(None, _axes_if(mesh, axes, leaf.shape[1]),
                     *(None,) * (leaf.dim() - 2))
        return P(_axes_if(mesh, axes, leaf.shape[0]),
                 *(None,) * (leaf.dim() - 1))

    return _map_with_path(rule, batch_specs)


def cache_pspecs(cfg: ModelConfig, cache_specs: DecodeCache, mesh
                 ) -> DecodeCache:
    """Decode-cache sharding, field by field of the ``DecodeCache``.

    k/v: (L, B, W, Hkv, hd); conv: (L, B, K-1, di); ssm: (L, B, ...).
    Batch shards over the data axes (divisibility-guarded); KV heads /
    d_inner / SSM heads over "model". When KV heads don't divide the model
    axis the ring dim W takes the model axis instead. Absent fields stay
    None; the int ``index`` is a 0-d leaf.
    """
    del cfg
    msize = _axsize(mesh, "model")
    daxes = _data_axes(mesh)

    def m_if(n):
        return "model" if (msize > 1 and n % msize == 0) else None

    def rule(name, leaf):
        ndim = leaf.dim() if torch.is_tensor(leaf) else 0
        if name in ("index", "slot_pos"):
            return P(*(None,) * ndim)
        if name in ("k", "v"):
            b_ax = _axes_if(mesh, daxes, leaf.shape[1])
            h_ax = m_if(leaf.shape[3])
            w_ax = None
            if h_ax is None:
                w_ax = m_if(leaf.shape[2])
            return P(None, b_ax, w_ax, h_ax, None)
        if name == "conv":
            return P(None, _axes_if(mesh, daxes, leaf.shape[1]), None,
                     m_if(leaf.shape[3]))
        if name == "ssm":
            spec = [None, _axes_if(mesh, daxes, leaf.shape[1]),
                    m_if(leaf.shape[2])]
            spec += [None] * (ndim - 3)
            return P(*spec)
        return P(*(None,) * ndim)

    return DecodeCache(**{name: None if leaf is None else rule(name, leaf)
                          for name, leaf in cache_specs._asdict().items()})


# ------------------------------------------------ the rank's cuts (serving)

def spec_axes(entry) -> tuple:
    """One dim's spec entry as a tuple of axis names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def cut(x, spec: P, mesh):
    """This rank's block of a whole tensor ``x`` by ``spec``: each sharded
    dim narrowed to the rank's index over its axes. A strict part is a
    contiguous copy, so the whole tensor may be freed; a tensor no axis
    cuts is returned as it is, and so is a non-tensor leaf (the cache's
    int ``index``)."""
    if not torch.is_tensor(x):
        return x
    out = x
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        n = mesh.size(axes)
        if n > 1:
            step = x.shape[dim] // n
            out = out.narrow(dim, mesh.index(axes) * step, step)
    if out is x:
        return x
    return out.clone(memory_format=torch.contiguous_format)


def uncut(x, spec: P, mesh):
    """The whole tensor from every rank's block (:func:`cut`'s inverse):
    one all-gather per sharded dim over its axes."""
    if not torch.is_tensor(x):
        return x
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if mesh.size(axes) > 1:
            x = gather_over(mesh, x, axes, dim)
    return x


def _serving_param_pspecs(cfg: ModelConfig, mesh) -> dict:
    """Serving never uses parameter FSDP (the reference's
    ``_serving_param_pspecs``): tensor parallelism only."""
    return param_pspecs(cfg, mesh, fsdp=False)


def shard_params(params: dict, cfg: ModelConfig, mesh) -> dict:
    """A whole parameter tree -> this rank's shards by
    ``param_pspecs(cfg, mesh, fsdp=False)`` (the counterpart of the
    reference's ``device_put(params, shardings)``)."""
    return cut_tree(params, _serving_param_pspecs(cfg, mesh), mesh)


def gather_params(params: dict, cfg: ModelConfig, mesh) -> dict:
    """This rank's shards -> the whole tree (every rank gets it)."""
    return uncut_tree(params, _serving_param_pspecs(cfg, mesh), mesh)


def shard_cache(cache: DecodeCache, cfg: ModelConfig, mesh) -> DecodeCache:
    """A whole decode cache -> this rank's shards by ``cache_pspecs``
    (``index`` and ``slot_pos`` stay whole)."""
    specs = cache_pspecs(cfg, cache, mesh)
    return DecodeCache(*(None if x is None else cut(x, s, mesh)
                         for x, s in zip(cache, specs)))


def gather_cache(cache: DecodeCache, cfg: ModelConfig, mesh, batch: int
                 ) -> DecodeCache:
    """This rank's cache shards -> the whole cache of ``batch`` sequences
    (for tests and checks: serving never gathers it)."""
    specs = cache_pspecs(cfg, init_cache(cfg, batch, cache.slot_pos.shape[0],
                                         device="meta"), mesh)
    return DecodeCache(*(None if x is None else uncut(x, s, mesh)
                         for x, s in zip(cache, specs)))


def shard_batch(batch: dict, mesh) -> dict:
    """A whole batch -> this rank's rows by ``batch_pspecs`` (over the data
    axes, guarded by divisibility; M-RoPE positions on their second dim)."""
    specs = batch_pspecs(batch, mesh)
    return tree_unflatten(tree_paths(batch), [
        cut(x, s, mesh) for x, s in zip(tree_leaves(batch),
                                        tree_leaves(specs))])


class FSDPLeaf:
    """A parameter leaf sharded over FSDP axes, as the training route reads
    it: ``shard`` (the rank's block) and ``ghost``, a whole-shaped zero
    tensor without storage (a stride-0 view of one scalar) on which
    autograd lands the gathered leaf's gradient. :meth:`TPContext.gather`
    all-gathers ``shard`` along ``dim`` over ``axes`` where the model
    code takes the leaf (per layer, inside the remat region). Indexing
    takes a layer of a stacked leaf (the stacked dim is never FSDP's)."""
    __slots__ = ("shard", "ghost", "dim", "axes")

    def __init__(self, shard, ghost, dim: int, axes: tuple):
        self.shard, self.ghost, self.dim, self.axes = shard, ghost, dim, axes

    def __getitem__(self, i: int) -> "FSDPLeaf":
        return FSDPLeaf(self.shard[i], self.ghost[i], self.dim - 1,
                        self.axes)


def _reduced(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` all-reduced over ``group`` in fp32, back in ``x``'s dtype."""
    out = x.float().clone()
    dist.all_reduce(out, op=_OPS[op], group=group)
    return out.to(x.dtype)


class _AllReduce(torch.autograd.Function):
    """Sum over the group; the backward is the identity (``grad=False``:
    the sum is consumed by work every rank repeats, so each holds the
    whole gradient already) or the same sum (``grad=True``: the sum is
    consumed inside each rank's own shard, so each holds a part)."""

    @staticmethod
    def forward(ctx, x, group, grad: bool):
        ctx.group, ctx.grad = group, grad
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return (_reduced(g, ctx.group) if ctx.grad else g), None, None


class _Enter(torch.autograd.Function):
    """The identity; the backward sums the gradient over the group (the
    entry of a column-parallel block, or a whole leaf used inside each
    rank's shard of the work)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group), None


class _Gather(torch.autograd.Function):
    """The FSDP gather: ``shard`` all-gathered along ``dim`` over ``axes``.
    The gradient goes whole to ``ghost`` (the rank's worker needs its own
    gradient of the whole leaf: on the single-pod mesh every data rank is
    another worker), none to the shard."""

    @staticmethod
    def forward(ctx, shard, ghost, mesh, axes, dim):
        return gather_over(mesh, shard, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return None, g, None, None, None


class _VocabNLL(torch.autograd.Function):
    """Per-token NLL of vocab-parallel logits: the rank holds the logits of
    its block ``[lo, lo + V/m)`` of the vocab. The fp32 max of each row is
    all-reduced (MAX), then Σexp and the label's logit (from the rank
    that owns it) in one fp32 all-reduce (SUM). The backward is the
    rank's block of softmax minus one-hot, with no collective."""

    @staticmethod
    def forward(ctx, logits, labels, lo: int, group):
        z = logits.float()
        top = z.amax(dim=-1, keepdim=True)
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        e = torch.sub(z, top).exp_()    # one (tokens, V/m) fp32 buffer
        ids = labels - lo
        own = (ids >= 0) & (ids < z.shape[-1])
        ids = ids.clamp(0, z.shape[-1] - 1)
        picked = torch.gather(z, -1, ids[..., None])[..., 0]
        sums = torch.stack([e.sum(dim=-1), torch.where(own, picked, 0.0)])
        dist.all_reduce(sums, group=group)
        ctx.save_for_backward(e, sums[0], ids, own)
        ctx.dtype = logits.dtype
        return torch.log(sums[0]) + top[..., 0] - sums[1]

    @staticmethod
    def backward(ctx, g):
        e, total, ids, own = ctx.saved_tensors
        grad = e.div_(total[..., None])     # the saved buffer, reused
        grad.scatter_add_(-1, ids[..., None], -own.to(grad.dtype)[..., None])
        return grad.mul_(g[..., None]).to(ctx.dtype), None, None, None


def _fsdp_dims(spec: P) -> tuple | None:
    """(dim, axes) of a spec's FSDP dim (its one dim over axes other than
    "model"), or None."""
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if axes and "model" not in axes:
            return dim, axes
    return None


def model_specs(specs):
    """A spec tree with only the "model" axis kept: the cuts a gradient
    has once its FSDP dims came back whole."""
    return tree_map(lambda sp: P(*(e if "model" in spec_axes(e) else None
                                   for e in sp)), specs)


def cut_tree(tree, specs, mesh, lead: int = 0):
    """The rank's blocks of a whole tree by a spec tree (:func:`cut` per
    leaf); ``lead`` leading dims (a worker or ring axis) stay whole."""
    pre = (None,) * lead
    return tree_unflatten(tree_paths(tree), [
        cut(x, P(*pre, *s), mesh) for x, s in zip(tree_leaves(tree),
                                                 tree_leaves(specs))])


def uncut_tree(tree, specs, mesh, lead: int = 0):
    """The whole tree from every rank's blocks (:func:`cut_tree`'s
    inverse)."""
    pre = (None,) * lead
    return tree_unflatten(tree_paths(tree), [
        uncut(x, P(*pre, *s), mesh) for x, s in zip(tree_leaves(tree),
                                                   tree_leaves(specs))])


def leaf_axes(spec: P) -> tuple:
    """Every mesh axis that cuts a dim of ``spec``, in the order they
    appear."""
    return tuple(dict.fromkeys(a for e in spec for a in spec_axes(e)))


def move(x, src: P, dst: P, mesh):
    """A tensor's block under ``src`` -> its block under ``dst``: each dim
    whose entries differ is gathered over its ``src`` axes, then cut to
    the rank's part over its ``dst`` axes. A strict part is a contiguous
    copy, so the tensor it came from may be freed; where no dim differs,
    ``x`` itself."""
    out, narrowed = x, False
    for dim, (a, b) in enumerate(zip(src, dst)):
        sa, sb = spec_axes(a), spec_axes(b)
        if sa == sb:
            continue
        if mesh.size(sa) > 1:
            out = gather_over(mesh, out, sa, dim)
        n = mesh.size(sb)
        if n > 1:
            step = out.shape[dim] // n
            out = out.narrow(dim, mesh.index(sb) * step, step)
            narrowed = True
    return (out.clone(memory_format=torch.contiguous_format) if narrowed
            else out)


def one_dim_per_axis(spec: P) -> P:
    """``spec`` with every mesh axis on one dim at most: an axis that
    cuts a dim alone (a tensor-parallel dim) keeps it and leaves the
    tuples of the other dims, and of a tuple repeated elsewhere the first
    dim keeps it. The reference's tables repeat an axis where the FSDP
    axes name "model" (``state_fsdp_axes=("model", "data")``), a spec
    that its ``NamedSharding`` rejects; each axis dropped here leaves a
    dim that the remaining axes still divide."""
    alone = {e for e in spec if isinstance(e, str)}
    seen, dims = set(), []
    for e in spec:
        axes = spec_axes(e)
        if not isinstance(e, str):
            axes = tuple(a for a in axes if a not in alone and a not in seen)
        seen.update(axes)
        dims.append(spec_dim(axes))
    return P(*dims)


def _inner(spec: P) -> P:
    """A worker-leading spec with its worker dim left whole (the rank
    holds one row of it)."""
    return P(None, *spec[1:])


@dataclass(frozen=True)
class TreeSharding:
    """How the pytree plane's per-leaf state shards over a mesh: the
    counterpart of :class:`FlatSharding` for ``fused=False``, built once
    from the spec trees of the reference's pytree ``train_state_specs``:

      * ``psp``: the parameters (``param_pspecs``);
      * ``msp``: the moments h, v̂ (over ``state_fsdp_axes`` where set);
      * ``gsp``: the gradient-shaped CADA state ∇ (over "data" under
        ``shard_cada_state``);
      * ``gwsp``: the worker-leading (M, ...) form of ``gsp``, the worker
        axis leading and stripped from the inner dims (the stale
        gradients and the rules' per-worker trees);
      * ``wsp``: the worker-leading form of ``psp`` (cada2's stale
        iterates).

    On a mesh of ranks each rank holds its blocks under each spec: of a
    worker-leading tree, its worker's row (``coord(waxis)``) cut by the
    inner dims. It gives the moves of a leaf between the specs
    (:func:`move`), the gathers of the workers' rows, and the collectives
    that complete a per-leaf reduction over exactly the axes that cut the
    leaf: a leaf no axis cuts is whole on every rank and its value is
    taken as it is, once.
    """
    mesh: Any
    waxis: str
    psp: Any = field(compare=False)
    msp: Any = field(compare=False)
    gsp: Any = field(compare=False)
    gwsp: Any = field(compare=False)
    wsp: Any = field(compare=False)

    @property
    def pspecs(self):
        """The parameters' specs (the name the trainer's forward reads on
        either plane's sharding)."""
        return self.psp

    @property
    def worker_pspecs(self):
        """The blocks of a point that is the rank's worker's own (a stale
        iterate: ``wsp``'s inner dims; a delta rule's local parameters):
        the parameters' specs without the worker axis, as
        :attr:`FlatSharding.worker_pspecs`."""
        return tree_map(lambda sp: strip_axis(sp, self.waxis), self.psp)

    # ---- collectives
    def all_reduce(self, x: torch.Tensor, axes: tuple, op: str = "sum"):
        return all_reduce_over(self.mesh, x, axes, op)

    def row_index(self, device) -> torch.Tensor:
        """(1,) int64: the worker row this rank's worker trees hold."""
        return torch.tensor([self.mesh.coord(self.waxis)], dtype=torch.long,
                            device=device)

    def plane_rows(self, v: torch.Tensor) -> torch.Tensor:
        """The entries of an (M,) vector that belong to the rank's row."""
        return v[self.row_index(v.device)]

    def rows_sum(self, part: torch.Tensor) -> torch.Tensor:
        """(M,) from this rank's one-row values: each rank puts its row in
        a zero vector and one all-reduce over the worker axis adds them."""
        full = torch.zeros((self.mesh.shape[self.waxis],), dtype=part.dtype,
                           device=part.device)
        full[self.row_index(part.device)] = part
        return self.all_reduce(full, (self.waxis,))

    def complete(self, parts: list, specs: list, op: str = "sum") -> list:
        """Per-leaf partial results (one tensor a leaf, in leaf order, of
        the rank's blocks under ``specs``) -> the whole leaves' results:
        each completed over the axes that cut its leaf, the leaves that
        share those axes in one all-reduce; a leaf no axis cuts is
        returned as it is."""
        groups: dict = {}
        for i, spec in enumerate(specs):
            axes = tuple(a for a in leaf_axes(spec)
                         if self.mesh.shape.get(a, 1) > 1)
            if axes:
                groups.setdefault(tuple(sorted(
                    axes, key=self.mesh.axes.index)), []).append(i)
        out = list(parts)
        for axes, idx in groups.items():
            done = self.all_reduce(torch.cat([parts[i].reshape(-1)
                                              for i in idx]), axes, op)
            for i, part in zip(idx, done.split([parts[i].numel()
                                                for i in idx])):
                out[i] = part.reshape(parts[i].shape)
        return out

    def worker_specs(self) -> list:
        """The specs of the rank's blocks of a worker tree, in leaf order:
        ``gwsp``'s, the worker dim whole (the rank holds one row)."""
        return [_inner(sp) for sp in tree_leaves(self.gwsp)]

    # ---- moves
    def move_tree(self, tree, src, dst, lead: int = 0):
        """Every leaf of ``tree`` from its block under ``src`` to its block
        under ``dst`` (``lead`` leading dims whole)."""
        pre = (None,) * lead
        return tree_map(lambda x, a, b: move(x, P(*pre, *a), P(*pre, *b),
                                             self.mesh), tree, src, dst)

    def whole_params(self, params):
        """The rank's ``psp`` blocks of θ -> the whole parameters."""
        return uncut_tree(params, self.psp, self.mesh)

    def params_to_stale(self, params):
        """The rank's ``psp`` blocks of θ -> its blocks of one stale
        iterate (:attr:`worker_pspecs`, ``wsp``'s inner dims)."""
        return self.move_tree(params, self.psp, self.worker_pspecs)

    def worker_rows(self, tree):
        """The rank's one-row blocks of a worker tree -> every worker's
        rows of the same blocks, (M, ...), gathered over the worker
        axis."""
        return tree_map(lambda x: gather_over(self.mesh, x, (self.waxis,),
                                              0), tree)

    def worker_to_grad(self, tree):
        """Blocks of a worker tree's inner dims (a per-leaf reduction over
        the workers) -> the rank's ``gsp`` blocks: ``gsp`` cuts each dim
        over the inner dims' axes and possibly the worker axis too."""
        return self.move_tree(tree, tree_map(lambda s: P(*s[1:]), self.gwsp),
                              self.gsp)

    def cut_worker(self, tree):
        """One worker's row of whole leaves, (1, ...) -> the rank's blocks
        of it under ``gwsp``."""
        return cut_tree(tree, tree_map(_inner, self.gwsp), self.mesh)

    def whole_worker(self, tree):
        """The rank's ``gwsp`` blocks of its worker's row -> the row's
        whole leaves (gathered over the inner dims' axes)."""
        return uncut_tree(tree, tree_map(_inner, self.gwsp), self.mesh)

    def on_whole_worker(self, f, tree):
        """``f`` of the worker's whole leaves, cut back to the rank's
        blocks: for a per-leaf selection that needs the whole leaf (top-k's
        exact support)."""
        return self.cut_worker(f(self.whole_worker(tree)))

    def whole_size(self, tree, specs) -> int:
        """The element count of the whole tree whose rank's blocks under
        ``specs`` are ``tree``."""
        return sum(x.numel() * self.mesh.size(leaf_axes(sp))
                   for x, sp in zip(tree_leaves(tree), tree_leaves(specs)))

    def groups(self) -> None:
        """Make every process group the pytree round uses, in the same
        order on every rank (``new_group`` is a collective of the
        world)."""
        self.mesh.group((self.waxis,))
        for tree in (self.psp, self.msp, self.gsp, self.gwsp, self.wsp):
            for spec in tree_leaves(tree):
                for entry in spec:
                    self.mesh.group(spec_axes(entry))
                self.mesh.group(leaf_axes(spec))


class TPContext:
    """The rank's place on the ``model`` axis, for the collectives that
    tensor parallelism needs and GSPMD inserts in the reference, and for
    the per-layer gathers of parameter FSDP.

    The model functions take it as ``tp`` (None: one process, no
    collective). They read every count from the local shapes (a tensor
    sharded over the model axis is this rank's block of it) and complete a
    sharded dim through these methods, each of which has a backward, so
    the training route runs them under autograd. Which backward depends
    on who consumes the sum, so the call site picks the method:

      * ``all_reduce``: a row-parallel product's partial sums (``wo``,
        ``w_down``, the MoE combine, Mamba's ``out_proj``) or the
        vocab-parallel lookup, consumed by work every rank repeats: the
        backward is the identity;
      * ``shard_sum``: a sum consumed inside each rank's own shard (the
        sharded norm's Σx², mamba1's ``xp_*``): the backward sums the
        gradient over the model axis too;
      * ``enter``: the identity, whose backward sums the gradient: the
        input of every column-parallel block, and a leaf kept whole but
        used inside the rank's shard (``wk``/``wv`` where the KV heads do
        not divide, mamba2's ``in_b``/``in_c``/``in_dt``, the gates of a
        MoE layer's own experts);
      * ``vocab_nll``: the loss of vocab-parallel logits without gathering
        them; ``all_gather``: the serving logits and a W-sharded ring's
        query heads (no backward: serving only).

    ``batch_axes`` are the mesh axes the batch was cut over
    (``gather_batch`` makes a whole batch of the ranks' rows: the returned
    logits, a MoE layer's global dispatch). Which leaves are sharded is
    read back from the shapes ``shard_params`` cut: a leaf that falls back
    to replication keeps its whole shape and takes no collective.

    ``pspecs`` (training: ``param_pspecs(cfg, mesh, fsdp, fsdp_axes)``)
    names the leaves sharded over FSDP axes: :meth:`grad_leaves` hands the
    model an :class:`FSDPLeaf` for each, and :meth:`gather` gathers them
    where the model takes them.
    """

    def __init__(self, cfg: ModelConfig, mesh, batch_axes: tuple = (),
                 pspecs=None):
        self.mesh = mesh
        self.size = mesh.size(("model",))
        self.index = mesh.coord("model")
        self.group = mesh.group("model")
        self.batch_axes = tuple(batch_axes)
        self.batch_group = mesh.group(self.batch_axes)
        self.fsdp = {}
        if pspecs is not None:
            for path, spec in zip(tree_paths(pspecs), tree_leaves(pspecs)):
                dims = _fsdp_dims(spec)
                if dims is not None:
                    self.fsdp[path] = dims
                    mesh.group(dims[1])     # made in the same order on
                    #                         every rank (``new_group``)
        if (cfg.block == "mamba2" and self.size > 1
                and (cfg.d_inner % self.size == 0)
                != (cfg.ssm_heads % self.size == 0)):
            raise NotImplementedError(
                f"{cfg.name}: d_inner {cfg.d_inner} and {cfg.ssm_heads} SSM "
                f"heads split differently over a model axis of {self.size}")

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` summed (or maxed: serving only, no backward) over the
        model axis, in fp32, returned in ``x``'s dtype (one rounding of the
        fp32 sum). The backward is the identity."""
        if self.group is None:
            return x
        if op != "sum":
            return _reduced(x.detach(), self.group, op)
        return _AllReduce.apply(x, self.group, False)

    def shard_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the model axis as :meth:`all_reduce`; the
        backward sums the gradient over the model axis too."""
        if self.group is None:
            return x
        return _AllReduce.apply(x, self.group, True)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` itself; its gradient is summed over the model axis."""
        if self.group is None:
            return x
        return _Enter.apply(x, self.group)

    def vocab_nll(self, logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
        """fp32 per-token NLL from the rank's block of the logits."""
        return _VocabNLL.apply(logits, labels,
                               self.index * logits.shape[-1], self.group)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' blocks of ``x`` along ``dim``, in model-axis order."""
        return gather_over(self.mesh, x, ("model",), dim)

    def gather_batch(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The whole batch from the ranks' rows along ``dim``."""
        return gather_over(self.mesh, x, self.batch_axes, dim)

    def batch_rows(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's rows of a whole batch along ``dim``."""
        n = self.mesh.size(self.batch_axes)
        if n == 1:
            return x
        step = x.shape[dim] // n
        return x.narrow(dim, self.mesh.index(self.batch_axes) * step, step)

    def grad_leaves(self, paths: list, leaves: list) -> tuple[list, list]:
        """(the tensors autograd differentiates, the leaves the model reads)
        for the rank's parameter shards: a leaf with an FSDP dim is read
        as an :class:`FSDPLeaf` and differentiated through its ghost (the
        gradient comes back whole on the FSDP dim), any other leaf is
        both."""
        req, model = [], []
        for path, x in zip(paths, leaves):
            x = x.detach()
            if path not in self.fsdp:
                x.requires_grad_()
                req.append(x)
                model.append(x)
                continue
            dim, axes = self.fsdp[path]
            shape = list(x.shape)
            shape[dim] *= self.mesh.size(axes)
            ghost = torch.zeros((), dtype=x.dtype, device=x.device).expand(
                shape).requires_grad_()
            req.append(ghost)
            model.append(FSDPLeaf(x, ghost, dim, axes))
        return req, model

    def gather(self, tree):
        """A (sub)tree with every :class:`FSDPLeaf` gathered whole on its
        FSDP dim (the model's blocks over the model axis stay the rank's);
        tensors pass through."""
        if isinstance(tree, dict):
            return {k: self.gather(v) for k, v in tree.items()}
        if isinstance(tree, FSDPLeaf):
            return _Gather.apply(tree.shard, tree.ghost, self.mesh,
                                 tree.axes, tree.dim)
        return tree

    def local_cache_shapes(self, cfg: ModelConfig, shapes: dict) -> dict:
        """Field -> the rank's shape of a decode cache with these whole
        shapes: each dim ``cache_pspecs`` shards over the model axis cut
        (the batch dims stay as given: the caller's rows)."""
        whole = DecodeCache(index=0, slot_pos=torch.empty(
            (1,), device="meta"), **{k: torch.empty(v, device="meta")
                                     for k, v in shapes.items()})
        specs = cache_pspecs(cfg, whole, self.mesh)
        return {k: tuple(n // (self.size if "model" in spec_axes(e) else 1)
                         for n, e in zip(v, getattr(specs, k)))
                for k, v in shapes.items()}
