"""The mesh trainer's worker gradients under tensor parallelism and
parameter FSDP, on gloo ranks spawned by ``torch.multiprocessing``
(``mesh_ranks.run_grads``), against ``jax.value_and_grad`` of the JAX
package's ``lm_loss`` and against the port's one-process gradient.

The smoke configs (fp32) of the five block families: internlm2 (dense),
granite-moe (MoE, expert-parallel at 2 experts a rank), falcon-mamba
(mamba1), zamba2 (hybrid mamba2 with the shared attention block, tied
vocab-parallel embedding) and qwen2-vl ({"embeds", "labels",
"positions"} batches with M-RoPE positions). Each at (data=2, model=2)
without FSDP and with ``fsdp=True`` (then with remat, so the per-layer
gathers run inside the checkpointed bodies); M = 2 workers, one a data
rank, each on its (2, 17) slice of a (4, 17) token batch. And, in the same
spawn of 4 ranks: internlm2 at (data=1, model=4) (2 KV heads on 4 ranks:
``wk``/``wv`` whole, each rank's KV heads taken from them), granite-moe
with 3 experts (TP inside each expert), and internlm2 with 3 heads and a
vocab and d_ff of 255 (every leaf replicated at model = 2).

Each rank's gradient of its worker, gathered whole over the model axis,
must equal the other model ranks' bit for bit, and every leaf must lie
within GRAD_TOL of its own scale (max |reference leaf|) of the JAX
gradient and of the port's one-process gradient: a missing or doubled
all-reduce in a backward puts a leaf off by a factor, far outside. Both
sides are fp32 and differ in the order of sums (the ranks add partial
products of their blocks); the measured gaps print with ``pytest -s``.

The collectives of one worker gradient (forward and backward, before the
gathers of the gradients) are counted per rank: none in the replicated
fallback, no all-gather at all without FSDP (the vocab-parallel loss
gathers no logits), and with FSDP only gathers of parameter shards, each
leaf of a layer gathered again in the remat's recompute. Without FSDP
the loss of the vocab-parallel logits must equal, within LOSS_RTOL, the
loss of the same logits gathered whole.
"""
import jax
import numpy as np
import pytest
import torch

import mesh_ranks
import repro.configs as JC
from repro.models import frontends as jfront
from repro.models import model as JM
import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.distributed import trainer as TT
from repro_torch.distributed.sharding import param_pspecs
from repro_torch.utils.trees import tree_leaves, tree_paths

torch.set_num_threads(1)

M, BATCH, SEQ1 = 2, 4, 17
GRAD_TOL = 1e-5     # of each leaf's scale: the LM loss test's band
LOSS_RTOL = 1e-6
REPLICATED = {"vocab": 255, "d_ff": 255, "n_heads": 3, "n_kv_heads": 1,
              "head_dim": 32}
FAMILIES = {"dense": "internlm2-1.8b", "moe": "granite-moe-1b-a400m",
            "mamba1": "falcon-mamba-7b", "hybrid": "zamba2-2.7b",
            "vlm": "qwen2-vl-2b"}
# name: (arch, config change, mesh (data, model), TrainHParams fields)
CASES = {**{f"{fam}-tp": (arch, {}, (2, 2), {})
            for fam, arch in FAMILIES.items()},
         **{f"{fam}-fsdp": (arch, {"remat": True}, (2, 2), {"fsdp": True})
            for fam, arch in FAMILIES.items()},
         "dense-model4": ("internlm2-1.8b", {}, (1, 4), {}),
         "moe-tp-in-experts": ("granite-moe-1b-a400m", {"n_experts": 3},
                               (2, 2), {}),
         "replicated": ("internlm2-1.8b", REPLICATED, (2, 2), {})}


def _batch(jcfg, rng) -> dict:
    """One global numpy batch: tokens, or embeddings, labels and M-RoPE
    positions (a text prefix and a 2 x 3 image) for qwen2-vl."""
    if jcfg.embed_input:
        return {"tokens": rng.integers(0, jcfg.vocab, (BATCH, SEQ1)).astype(
            np.int32)}
    s = SEQ1 - 1
    return {"embeds": rng.normal(size=(BATCH, s, jcfg.d_model)).astype(
                np.float32),
            "labels": rng.integers(0, jcfg.vocab, (BATCH, s)).astype(
                np.int32),
            "positions": np.array(jfront.mrope_positions(BATCH, s, (2, 3)))}


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on one spawn of 4 ranks, and its references: per worker
    the JAX (loss, gradients) and the port's one-process gradients."""
    cases, refs = [], {}
    for i, (name, (arch, change, sizes, hp_kw)) in enumerate(CASES.items()):
        jcfg = JC.get_smoke_config(arch).with_(**change)
        tcfg = TC.get_smoke_config(arch).with_(**change)
        hp = TT.TrainHParams(**hp_kw)
        np_params = jax.tree.map(np.asarray, JM.init_params(
            jcfg, jax.random.PRNGKey(i)))
        params = convert.params_from_numpy(np_params, "cpu")
        split = TT.worker_split(_batch(jcfg, np.random.default_rng(i)), M)
        value_and_grad = jax.jit(jax.value_and_grad(
            lambda p, b: JM.lm_loss(jcfg, p, b)[0]))
        one = TT.make_worker_grad(tcfg, hp)
        refs[name] = []
        for w in range(M):
            wb = {k: v[w] for k, v in split.items()}
            j_loss, j_g = value_and_grad(np_params, wb)
            _, t_g = one(params, _torch(wb))
            refs[name].append((float(j_loss), [np.asarray(g) for g in
                                               jax.tree.leaves(j_g)],
                               tree_leaves(t_g)))
        cases.append((name, sizes, tcfg, hp, params, _torch(split)))
    ranks = mesh_ranks.spawn(mesh_ranks.run_grads, 4,
                             tmp_path_factory.mktemp("tp_grads"),
                             {"cases": cases})
    return ranks, refs, {c[0]: c for c in cases}


def _gap(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got.float().numpy(), np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", list(CASES))
def test_rank_gradients_match_jax_grad_and_one_process(runs, name):
    ranks, refs, _ = runs
    worst = {"jax": 0.0, "one process": 0.0}
    by_worker = {}
    for r in ranks:
        got = r[name]
        w = got["worker"]
        j_loss, j_g, t_g = refs[name][w]
        leaves = tree_leaves(got["grads"])
        if w in by_worker:      # the model ranks of a worker agree exactly
            assert all(torch.equal(a, b) for a, b in
                       zip(leaves, by_worker[w])), name
        by_worker[w] = leaves
        assert float(got["loss"][0]) == pytest.approx(j_loss, rel=LOSS_RTOL)
        paths = tree_paths(got["grads"])
        for path, g, jg, tg in zip(paths, leaves, j_g, t_g):
            assert g.shape[0] == 1 and tuple(g.shape[1:]) == jg.shape, path
            for side, want in (("jax", jg), ("one process", tg.numpy())):
                gap = _gap(g[0], want)
                assert gap <= GRAD_TOL, (name, side, "/".join(path), gap)
                worst[side] = max(worst[side], gap)
    assert sorted(by_worker) == list(range(M)) or name == "dense-model4"
    print(f"\n{name}: largest gradient gap of a leaf's scale: against "
          f"jax.grad {worst['jax']:.3g}, against one process "
          f"{worst['one process']:.3g}")


def _fsdp_block_leaves(cfg, hp, sizes) -> int:
    """FSDP leaves of one stacked layer."""
    stub = type("Stub", (), {"shape": dict(zip(("data", "model"), sizes))})
    specs = param_pspecs(cfg, stub(), hp.fsdp, hp.fsdp_axes)
    return sum(1 for p, s in zip(tree_paths(specs), tree_leaves(specs))
               if p[0] == "blocks" and any(
                   e is not None and "model" not in (e if isinstance(e, tuple)
                                                     else (e,)) for e in s))


@pytest.mark.parametrize("name", list(CASES))
def test_collectives_of_a_worker_gradient(runs, name):
    ranks, _, cases = runs
    _, sizes, cfg, hp, _, _ = cases[name]
    for r in ranks:
        got = r[name]
        fwd = [s for op, s in got["forward"] if op == "all_gather"]
        vg = [s for op, s in got["value_and_grad"] if op == "all_gather"]
        if name == "replicated":
            assert got["forward"] == got["value_and_grad"] == [], name
        elif not hp.fsdp:
            # tensor parallelism alone gathers nothing, the logits neither
            assert fwd == vg == [], (name, fwd)
            assert any(op == "all_reduce" for op, _ in got["forward"])
        else:
            shapes = set(got["shard_shapes"].values())
            shapes |= {s[1:] for s in shapes}     # a layer of a stacked leaf
            assert set(vg) <= shapes, (name, set(vg) - shapes)
            # the recompute of each remat'ed layer gathers its leaves again
            per_layer = _fsdp_block_leaves(cfg, hp, sizes)
            assert per_layer > 0
            assert len(vg) == len(fwd) + cfg.n_layers * per_layer, (
                name, len(vg), len(fwd))


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if not c[3].get("fsdp")])
def test_vocab_parallel_loss_equals_the_gathered_logits_loss(runs, name):
    """The loss of vocab-parallel logits (the max and Σexp completed over
    the model axis, the label's logit from the rank that owns it) against
    the loss of the logits all-gathered whole, on the same shards: the
    same fp32 NLL in another order of sums."""
    ranks, _, _ = runs
    for r in ranks:
        got = r[name]
        assert float(got["vocab_parallel_loss"]) == pytest.approx(
            float(got["gathered_logits_loss"]), rel=LOSS_RTOL), name
