"""Tensor-parallel serving on the CPU: the port's
``distributed/serving.py`` builders on gloo ranks spawned by
``torch.multiprocessing`` (``mesh_ranks.run_serving``), held against the
JAX package's ``jit_prefill_step``/``jit_decode_step`` on its one-device
host mesh.

The smoke configs (fp32), B = 2 prompts of S = 24, the reference's own
parameters carried across by ``convert.params_from_numpy`` and cut by
``shard_params``. The prefill's last logits, the gathered cache after it
and after 8 decode steps (their inputs: the reference's greedy tokens, or
random embeddings for an embedding-input model), and every step's logits,
each within RTOL of its array's scale (max |ref|): the serving band of
PERF.md §2. The port's ranks sum a row-parallel product's partials in
another order than one GEMM, and complete a W-sharded ring's softmax
over the ranks, so elements differ by a few fp32 ULP of their scale.

Two spawns, each case of one mesh shape folded into it:
  * 2 ranks, (data=1, model=2): zamba2 (mamba2 over a sharded d_inner,
    the shared attention block, the tied vocab-parallel embedding),
    falcon-mamba (mamba1's row-parallel ``xp_*``), granite-moe
    (expert-parallel, 2 experts a rank), musicgen (embedding input),
    granite-moe with 3 experts (TP inside each expert), and internlm2
    with vocab and d_ff of 255 (the replicated fallbacks: no collective);
    then the shard/gather round trip of all ten configs' smoke trees;
  * 4 ranks: qwen2-vl at (data=1, model=4) (4 query heads, 2 KV heads: a
    ring sharded over W, M-RoPE positions, embedding input), internlm2
    and granite-moe at (data=2, model=2) (the batch over data, with TP;
    the MoE layer's global dispatch over the gathered batch); then the
    round trip at (data=1, model=4).
Each rank's parameter and cache shards must have the shapes the tables
give, and each step exactly the collectives listed in COLLECTIVES.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_ranks
import repro.configs as JC
from repro.distributed import serving as JS
from repro.launch.mesh import make_host_mesh as jax_host_mesh, set_mesh
from repro.models import model as JM
import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.distributed import serving as TS
from repro_torch.distributed.sharding import cache_pspecs, param_pspecs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import frontends
from repro_torch.models import model as TM
from repro_torch.utils.trees import tree_leaves, tree_paths

torch.set_num_threads(1)

B, S, DECODE_STEPS = 2, 24, 8
RTOL = 1e-5
IMAGE_GRID = (2, 3)
# name: (arch, config change on both packages, mesh (data, model))
CASES = {
    "zamba2": ("zamba2-2.7b", {}, (1, 2)),
    "falcon-mamba": ("falcon-mamba-7b", {}, (1, 2)),
    "granite-moe": ("granite-moe-1b-a400m", {}, (1, 2)),
    "musicgen": ("musicgen-medium", {}, (1, 2)),
    "granite-moe-e3": ("granite-moe-1b-a400m", {"n_experts": 3}, (1, 2)),
    "internlm2-replicated": ("internlm2-1.8b", {"vocab": 255, "d_ff": 255},
                             (1, 2)),
    "qwen2-vl": ("qwen2-vl-2b", {}, (1, 4)),
    "internlm2-data": ("internlm2-1.8b", {}, (2, 2)),
    "granite-moe-data": ("granite-moe-1b-a400m", {}, (2, 2)),
}
SPAWNS = {2: ("zamba2", "falcon-mamba", "granite-moe", "musicgen",
              "granite-moe-e3", "internlm2-replicated"),
          4: ("qwen2-vl", "internlm2-data", "granite-moe-data")}
ROUND_TRIP_SIZES = {2: (1, 2), 4: (1, 4)}
# the serving launcher on the 2 ranks (mesh (data=2, model=1): 2 of the 4
# prompts a rank) and in one process
SERVE_ARGV = ["--arch", "zamba2-2.7b", "--smoke", "--device", "cpu",
              "--batch", "4", "--prompt-len", "16", "--tokens", "6"]
# collectives a rank makes per prefill and per decode step (the same for
# both): all_reduce (the vocab-parallel lookup, each sharded norm's Σx²,
# each row-parallel product; a W-sharded ring's max and sum) and
# all_gather (the vocab-parallel logits, the query heads over a W-sharded
# ring, the batch over data for the logits and a MoE layer's dispatch)
COLLECTIVES = {
    "zamba2": ({"all_reduce": 7, "all_gather": 1},) * 2,
    "falcon-mamba": ({"all_reduce": 5, "all_gather": 1},) * 2,
    "granite-moe": ({"all_reduce": 5, "all_gather": 1},) * 2,
    "musicgen": ({"all_reduce": 4, "all_gather": 1},) * 2,
    "granite-moe-e3": ({"all_reduce": 5, "all_gather": 1},) * 2,
    "internlm2-replicated": ({"all_reduce": 2},) * 2,
    "qwen2-vl": ({"all_reduce": 4, "all_gather": 1},
                 {"all_reduce": 8, "all_gather": 3}),
    "internlm2-data": ({"all_reduce": 5, "all_gather": 2},) * 2,
    "granite-moe-data": ({"all_reduce": 5, "all_gather": 4},) * 2,
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, what):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: max |Δ| {err} > {RTOL} · {scale}"


def _configs(arch, change):
    return (JC.get_smoke_config(arch).with_(remat=False, **change),
            TC.get_smoke_config(arch).with_(**change))


def _reference(arch, change):
    """The JAX package's builders on its host mesh: params, the whole
    inputs of the prefill and of each decode step, the prefill's logits
    and cache, each step's logits and the last cache (numpy)."""
    jcfg, tcfg = _configs(arch, change)
    rng = np.random.default_rng(7)
    if jcfg.embed_input:
        inputs = {"tokens": rng.integers(0, jcfg.vocab, (B, S)).astype(
            np.int32)}
    else:
        inputs = {"embeds": rng.standard_normal(
            (B, S, jcfg.d_model)).astype(np.float32)}
        if jcfg.mrope:
            inputs["positions"] = frontends.mrope_positions(
                B, S, IMAGE_GRID, "cpu").numpy()
    mesh = jax_host_mesh()
    with set_mesh(mesh):
        params = JM.init_params(jcfg, jax.random.PRNGKey(0))
        sds = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                           inputs)
        logits, cache = JS.jit_prefill_step(jcfg, mesh, sds)(params, inputs)
        out = {"params": _np(params), "inputs": inputs,
               "prefill_logits": np.asarray(logits),
               "prefill_cache": _np(cache), "steps": [],
               "decode_logits": []}
        decode, _, _ = JS.jit_decode_step(jcfg, mesh, B, S)
        for _ in range(DECODE_STEPS):
            if jcfg.embed_input:
                step = {"tokens": np.asarray(jnp.argmax(logits, -1)).astype(
                    np.int32)}
            else:
                step = {"embeds": rng.standard_normal(
                    (B, 1, jcfg.d_model)).astype(np.float32)}
            logits, cache = decode(params, cache, step)
            out["steps"].append(step)
            out["decode_logits"].append(np.asarray(logits))
        out["decode_cache"] = _np(cache)
    return tcfg, out


def _spawn(world, tmp_path_factory):
    refs, cases = {}, []
    for name in SPAWNS[world]:
        arch, change, sizes = CASES[name]
        tcfg, ref = _reference(arch, change)
        refs[name] = ref
        cases.append((name, sizes, tcfg, ref["params"], ref["inputs"],
                      ref["steps"]))
    trips = []
    for arch in TC.list_archs():
        cfg = TC.get_smoke_config(arch)
        trips.append((arch, cfg, TM.init_params(cfg, 0, "cpu")))
    ranks = mesh_ranks.spawn(mesh_ranks.run_serving, world,
                             tmp_path_factory.mktemp(f"serve{world}"), {
                                 "cases": cases, "round_trip": trips,
                                 "round_trip_sizes": ROUND_TRIP_SIZES[world],
                                 "serve_argv": SERVE_ARGV if world == 2
                                 else None})
    return refs, ranks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns: case name -> (reference, every rank's result), and the
    round trips under "round_trip<world>"."""
    out = {}
    for world in SPAWNS:
        refs, ranks = _spawn(world, tmp_path_factory)
        for name, ref in refs.items():
            out[name] = (ref, [r[name] for r in ranks])
        out[f"round_trip{world}"] = [r["round_trip"] for r in ranks]
        if world == 2:
            out["serve"] = [r["serve"] for r in ranks]
    return out


def _mesh_like(sizes):
    """What the spec tables read of a mesh: its ``.shape``."""
    return types.SimpleNamespace(shape=dict(zip(("data", "model"), sizes)))


def _local(shape, spec, sizes):
    """A whole shape cut by ``spec`` on a (data, model) mesh of ``sizes``."""
    size = dict(zip(("data", "model"), sizes))
    out = []
    for n, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if entry is None else (entry,) if isinstance(
            entry, str) else entry
        for a in axes:
            n //= size.get(a, 1)
        out.append(n)
    return tuple(out)


def _fields(cache):
    return {f: getattr(cache, f) for f in ("k", "v", "conv", "ssm")
            if getattr(cache, f) is not None}


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_last_logits_match_the_reference(runs, name):
    ref, ranks = runs[name]
    for r in ranks:
        _close(r["prefill_logits"], ref["prefill_logits"], f"{name} logits")
        assert torch.equal(r["prefill_logits"], ranks[0]["prefill_logits"])


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_cache_gathered_matches_the_reference(runs, name):
    ref, ranks = runs[name]
    want = _fields(ref["prefill_cache"])
    got = _fields(ranks[0]["prefill_cache"])
    assert set(got) == set(want)
    for f in want:
        _close(got[f], want[f], f"{name} prefill cache {f}")
    assert ranks[0]["prefill_cache"].index == S
    np.testing.assert_array_equal(ranks[0]["prefill_cache"].slot_pos.numpy(),
                                  ref["prefill_cache"].slot_pos)


@pytest.mark.parametrize("name", list(CASES))
def test_decode_steps_match_the_reference(runs, name):
    ref, ranks = runs[name]
    for r in ranks:
        assert len(r["decode_logits"]) == DECODE_STEPS
        for i, (got, want) in enumerate(zip(r["decode_logits"],
                                            ref["decode_logits"])):
            _close(got, want, f"{name} decode step {i}")
    want = _fields(ref["decode_cache"])
    got = _fields(ranks[0]["decode_cache"])
    for f in want:
        _close(got[f], want[f], f"{name} cache after decode {f}")
    assert ranks[0]["decode_cache"].index == S + DECODE_STEPS


@pytest.mark.parametrize("name", list(CASES))
def test_shards_have_the_tables_shapes(runs, name):
    """Each rank's parameter shards: ``param_pspecs(fsdp=False)``; its cache
    shards: ``cache_pspecs`` of the whole cache (the builder's
    ``cache_sds``, the reference's shapes)."""
    ref, ranks = runs[name]
    arch, change, sizes = CASES[name]
    _, tcfg = _configs(arch, change)
    mesh = _mesh_like(sizes)
    specs = param_pspecs(tcfg, mesh, fsdp=False)
    whole = {"/".join(p): np.shape(x) for p, x in zip(
        tree_paths(ref["params"]), tree_leaves(ref["params"]))}
    want = {p: _local(whole[p], s, sizes) for p, s in zip(
        ("/".join(q) for q in tree_paths(specs)), tree_leaves(specs))}
    cache_whole = {f: tuple(np.shape(x)) for f, x in _fields(
        ref["prefill_cache"]).items()}
    meta = TM.DecodeCache(index=0, slot_pos=torch.empty((S,)), **{
        f: torch.empty(s, device="meta") for f, s in cache_whole.items()})
    cspecs = cache_pspecs(tcfg, meta, mesh)
    cache_want = {f: _local(s, getattr(cspecs, f), sizes)
                  for f, s in cache_whole.items()}
    for r in ranks:
        assert r["param_shapes"] == want
        assert r["cache_shapes"] == cache_want
        assert r["cache_sds"] == cache_whole


@pytest.mark.parametrize("name", list(CASES))
def test_each_step_makes_exactly_its_collectives(runs, name):
    """A sharded dim completes by one collective; a replicated fallback
    (internlm2-replicated's embedding, FFN and head; qwen2-vl's K/V
    projections) takes none."""
    _, ranks = runs[name]
    prefill, decode = COLLECTIVES[name]
    for r in ranks:
        assert r["collectives"][0] == prefill
        assert r["collectives"][1:] == [decode] * DECODE_STEPS


@pytest.mark.parametrize("world", list(SPAWNS))
@pytest.mark.parametrize("arch", TC.list_archs())
def test_shard_params_and_gather_round_trip(runs, world, arch):
    """Every config's smoke tree: each rank's cut has the table's shapes,
    and gathering the cuts gives the whole tree back bit for bit."""
    sizes = ROUND_TRIP_SIZES[world]
    cfg = TC.get_smoke_config(arch)
    specs = param_pspecs(cfg, _mesh_like(sizes), fsdp=False)
    whole = TM.abstract_params(cfg)
    want = {"/".join(p): _local(tuple(x.shape), s, sizes) for p, x, s in zip(
        tree_paths(whole), tree_leaves(whole), tree_leaves(specs))}
    for r in runs[f"round_trip{world}"]:
        assert r[arch]["equal"]
        assert r[arch]["shapes"] == want


def test_serve_launcher_on_two_ranks_equals_one_process(runs):
    """``python -m repro_torch.launch.serve`` under a process group of 2
    (the batch cut over data) against one process: the same greedy
    tokens, every rank the whole logits."""
    from repro_torch.launch import serve
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = serve.main(SERVE_ARGV)
    finally:
        torch.set_num_threads(threads)
    for r in runs["serve"]:
        assert torch.equal(r["tokens"], want["tokens"])
        _close(r["prefill_logits"], want["prefill_logits"].numpy(),
               "launcher prefill logits")
        _close(r["logits"], want["logits"].numpy(), "launcher last logits")


def _port_params(jcfg, tcfg):
    with set_mesh(jax_host_mesh()):
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, convert.params_from_numpy(_np(jp), "cpu")


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "falcon-mamba-7b"])
def test_decode_step_builder_on_one_rank(arch):
    """The reference's builder test, held against its decode step."""
    jcfg, tcfg = _configs(arch, {})
    jp, tp = _port_params(jcfg, tcfg)
    mesh = jax_host_mesh()
    with set_mesh(mesh):
        step, _, _ = JS.jit_decode_step(jcfg, mesh, 2, 16)
        want, _ = step(jp, JM.init_cache(jcfg, 2, 16),
                       {"tokens": jnp.ones((2,), jnp.int32)})
    tstep, cache_sds, inputs_sds = TS.jit_decode_step(tcfg, make_host_mesh(),
                                                      2, 16)
    assert cache_sds.k is None or cache_sds.k.device.type == "meta"
    assert tuple(inputs_sds["tokens"].shape) == (2,)
    logits, cache = tstep(tp, TM.init_cache(tcfg, 2, 16, device="cpu"),
                          {"tokens": torch.ones((2,), dtype=torch.int32)})
    assert logits.shape == (2, tcfg.vocab)
    assert bool(torch.isfinite(logits).all())
    assert cache.index == 1
    _close(logits, want, f"{arch} decode builder")


def test_prefill_step_builder_on_one_rank():
    """The reference's builder test (all-ones tokens: shapes, index,
    finite), then parity on random tokens: identical tokens make every
    position a near-tie for the experts' capacity, where a ULP decides
    which tokens an expert keeps (``tests/test_torch_moe.py``'s
    ROUTE_BAND)."""
    jcfg, tcfg = _configs("granite-moe-1b-a400m", {})
    jp, tp = _port_params(jcfg, tcfg)
    step = TS.jit_prefill_step(tcfg, make_host_mesh(), {
        "tokens": torch.empty((2, 16), dtype=torch.int32, device="meta")})
    logits, cache = step(tp, {"tokens": torch.ones((2, 16),
                                                   dtype=torch.int32)})
    assert logits.shape == (2, tcfg.vocab)
    assert bool(torch.isfinite(logits).all())
    assert cache.index == 16
    inputs = np.random.default_rng(7).integers(
        0, jcfg.vocab, (2, 16)).astype(np.int32)
    mesh = jax_host_mesh()
    with set_mesh(mesh):
        sds = {"tokens": jax.ShapeDtypeStruct((2, 16), jnp.int32)}
        want, _ = JS.jit_prefill_step(jcfg, mesh, sds)(
            jp, {"tokens": inputs})
    logits, _ = step(tp, {"tokens": torch.from_numpy(inputs)})
    _close(logits, want, "granite-moe prefill builder")
