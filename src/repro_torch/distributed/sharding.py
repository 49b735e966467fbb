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

Of these, the mesh runtime executes the worker axis and the flat state's
axes (:class:`FlatSharding`), and serving (``distributed/serving.py``)
the model axis and the batch over the data axes: :func:`shard_params`,
:func:`shard_cache` and :func:`shard_batch` cut the rank's blocks by the
tables, and a :class:`TPContext` carries the collectives the model code
completes a sharded dim with. Training on the model axis, parameter FSDP
and the pytree plane's per-leaf sharded state are tables only, and the
trainer refuses them by name.

:class:`FlatSharding` is both the reference's static description (the
mesh, the worker axis, the state axes) and, on a mesh of ranks
(``launch.mesh.Mesh``), the rank's view of it: which worker rows and
which flat columns its planes hold, which server slice it owns, the cuts
of a global plane to those slices and the gathers back (in place of the
reference's ``constrain_server``/``constrain_worker``, which pin a global
array's layout for the partitioner), and the collectives the shard-local
kernel forms complete their scalars with.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core.flat import FlatLayout, spec_dim
from repro_torch.models.config import ModelConfig, param_count
from repro_torch.models.model import (DecodeCache, abstract_params,
                                      init_cache)
from repro_torch.utils.trees import tree_leaves, tree_paths, tree_unflatten

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
        group = self.mesh.group(axes)
        if group is None:
            return x
        out = x.clone()
        dist.all_reduce(out, op=_OPS[op], group=group)
        return out

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

    def groups(self) -> None:
        """Make every process group the round uses. ``new_group`` is a
        collective of the whole world, so the mesh runtime calls this on
        every rank before the first step."""
        for axes in ((self.waxis,), self.col_axes, self.axes,
                     self.plane_axes):
            self.mesh.group(axes)


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
    specs = _serving_param_pspecs(cfg, mesh)
    return tree_unflatten(tree_paths(params), [
        cut(x, s, mesh) for x, s in zip(tree_leaves(params),
                                        tree_leaves(specs))])


def gather_params(params: dict, cfg: ModelConfig, mesh) -> dict:
    """This rank's shards -> the whole tree (every rank gets it)."""
    specs = _serving_param_pspecs(cfg, mesh)
    return tree_unflatten(tree_paths(params), [
        uncut(x, s, mesh) for x, s in zip(tree_leaves(params),
                                          tree_leaves(specs))])


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


class TPContext:
    """The rank's place on the ``model`` axis, for the collectives that
    tensor parallelism needs and GSPMD inserts in the reference.

    The model functions take it as ``tp`` (None: one process, no
    collective). They read every count from the local shapes (a tensor
    sharded over the model axis is this rank's block of it) and complete a
    sharded dim through these methods: ``all_reduce`` (partial sums of a
    row-parallel product, the sharded norm's Σx², the vocab-parallel
    lookup) and ``all_gather`` (vocab-parallel logits, the query heads
    of a ring sharded over W). ``batch_axes`` are the mesh axes the batch
    was cut over (``gather_batch`` makes a whole batch of the ranks' rows:
    the returned logits, a MoE layer's global dispatch). Which leaves are
    sharded is ``param_pspecs(cfg, mesh, fsdp=False)``'s, read back from
    the shapes ``shard_params`` cut: a leaf that falls back to replication
    keeps its whole shape and takes no collective.
    """

    def __init__(self, cfg: ModelConfig, mesh, batch_axes: tuple = ()):
        self.mesh = mesh
        self.size = mesh.size(("model",))
        self.index = mesh.coord("model")
        self.group = mesh.group("model")
        self.batch_axes = tuple(batch_axes)
        self.batch_group = mesh.group(self.batch_axes)
        if (cfg.block == "mamba2" and self.size > 1
                and (cfg.d_inner % self.size == 0)
                != (cfg.ssm_heads % self.size == 0)):
            raise NotImplementedError(
                f"{cfg.name}: d_inner {cfg.d_inner} and {cfg.ssm_heads} SSM "
                f"heads split differently over a model axis of {self.size}")

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` summed (or maxed) over the model axis, in fp32, returned in
        ``x``'s dtype (one rounding of the fp32 sum)."""
        if self.group is None:
            return x
        out = x.float().clone()
        dist.all_reduce(out, op=_OPS[op], group=self.group)
        return out.to(x.dtype)

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
