"""The port's continuous-batching scheduler (``distributed/scheduler.py``)
and its two serving examples.

The three tests of ``tests/test_scheduler.py`` run on the port, and the
port's ``DecodeScheduler`` is held against the reference's on the same
weights (the JAX package's smoke-config parameters carried across by
``repro_torch.convert``): internlm2-1.8b and zamba2-2.7b, uneven prompt
lengths, one request with an ``eos_id``, rounds with fewer requests than
slots. Contract: every request's ``out`` equal token for token, ``done``
equal, and ``utilization()`` equal. Both sides compute in fp32 and their
logits differ by a few ULP of scale (``tests/test_torch_lm.py``: ≤ 8e-7),
so the greedy tokens agree unless two logits tie within that gap.
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.distributed.scheduler import DecodeScheduler as JaxScheduler
from repro.distributed.scheduler import Request as JaxRequest
from repro.models import model as JM
import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.distributed.scheduler import DecodeScheduler, Request
from repro_torch.models.model import decode_step, init_params, prefill

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _setup(n_slots=2, max_seq=64):
    cfg = TC.get_smoke_config("internlm2-1.8b")
    params = init_params(cfg, 0, "cpu")
    return cfg, params, DecodeScheduler(cfg, params, n_slots=n_slots,
                                        max_seq=max_seq)


def test_all_requests_complete():
    cfg, _, sched = _setup(n_slots=2)
    rng = np.random.default_rng(0)
    for uid in range(5):
        sched.submit(Request(uid=uid,
                             prompt=rng.integers(0, cfg.vocab, 8,
                                                 dtype=np.int32),
                             max_new=6))
    done = sched.run()
    assert len(done) == 5
    assert all(r.done and len(r.out) == 6 for r in done)


def test_eos_stops_early():
    cfg, _, sched = _setup(n_slots=1)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab, 8, dtype=np.int32)
    # find what the model greedily emits first, then use it as EOS
    probe = Request(uid=0, prompt=prompt.copy(), max_new=1)
    sched.submit(probe)
    sched.run_round()
    first = probe.out[0]
    req = Request(uid=1, prompt=prompt.copy(), max_new=16, eos_id=first)
    sched.submit(req)
    sched.run_round()
    assert req.out[0] == first and len(req.out) == 1


def test_scheduler_matches_unbatched_decode():
    """A request served in a mixed batch produces the same tokens as the
    same request decoded alone (padding/slot isolation)."""
    cfg, params, sched = _setup(n_slots=2, max_seq=64)
    rng = np.random.default_rng(2)
    p1 = rng.integers(0, cfg.vocab, 10, dtype=np.int32)
    p2 = rng.integers(0, cfg.vocab, 10, dtype=np.int32)  # same length
    r1 = Request(uid=0, prompt=p1, max_new=5)
    r2 = Request(uid=1, prompt=p2, max_new=5)
    sched.submit(r1)
    sched.submit(r2)
    sched.run()

    logits, cache = prefill(cfg, params,
                            tokens=torch.as_tensor(p1, dtype=torch.long)[None],
                            max_seq=64)
    outs = []
    nxt = torch.argmax(logits, dim=-1)
    for _ in range(5):
        outs.append(int(nxt[0]))
        logits, cache = decode_step(cfg, params, cache, tokens=nxt)
        nxt = torch.argmax(logits, dim=-1)
    assert r1.out == outs


def _requests(vocab, n, seed, make, eos_uid=None, eos_id=None):
    """``n`` requests of uneven prompt lengths (3-20) and max_new (2-8)
    from a numpy seed, built by ``make`` (either package's Request)."""
    rng = np.random.default_rng(seed)
    out = []
    for uid in range(n):
        prompt = rng.integers(0, vocab, int(rng.integers(3, 21)),
                              dtype=np.int32)
        out.append(make(uid=uid, prompt=prompt,
                        max_new=int(rng.integers(2, 9)),
                        eos_id=eos_id if uid == eos_uid else None))
    return out


def _serve(sched, reqs):
    for r in reqs:
        sched.submit(r)
    return sched.run()


@pytest.mark.parametrize("n_req", [7, 2], ids=["7-requests", "2-requests"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-2.7b"])
def test_scheduler_matches_reference(arch, n_req):
    """4 slots: 7 requests make a round of 4 and one of 3, 2 requests one
    round of 2; one request stops at an ``eos_id`` taken from its own
    greedy output in a first reference run (its third token), so the stop
    lands mid-round."""
    jcfg = JC.get_smoke_config(arch).with_(remat=False)
    tcfg = TC.get_smoke_config(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    n_slots, max_seq, seed, eos_uid = 4, 40, 11, 1

    probe = _serve(JaxScheduler(jcfg, jp, n_slots=n_slots, max_seq=max_seq),
                   _requests(jcfg.vocab, n_req, seed, JaxRequest))
    probe_out = {r.uid: r.out for r in probe}[eos_uid]
    assert len(probe_out) >= 3
    eos = probe_out[2]

    j_sched = JaxScheduler(jcfg, jp, n_slots=n_slots, max_seq=max_seq)
    t_sched = DecodeScheduler(tcfg, tp, n_slots=n_slots, max_seq=max_seq)
    j_done = _serve(j_sched, _requests(jcfg.vocab, n_req, seed, JaxRequest,
                                       eos_uid, eos))
    t_done = _serve(t_sched, _requests(tcfg.vocab, n_req, seed, Request,
                                       eos_uid, eos))
    assert [r.uid for r in t_done] == [r.uid for r in j_done]
    for j, t in zip(j_done, t_done):
        assert t.out == j.out, (t.uid, t.out, j.out)
        assert t.done == j.done
    stopped = {r.uid: r for r in t_done}[eos_uid]
    assert stopped.out[-1] == eos and len(stopped.out) <= 3
    assert t_sched.utilization() == j_sched.utilization()
    assert 0.0 < t_sched.utilization() < 1.0


def test_padding_and_rounds_follow_the_reference():
    """The round's padded batch is the reference's: right-padded with each
    prompt's last token, empty slots all zeros."""
    cfg, _, sched = _setup(n_slots=3)
    reqs = [Request(uid=0, prompt=np.array([5, 6, 7], np.int32)),
            Request(uid=1, prompt=np.array([9], np.int32))]
    np.testing.assert_array_equal(sched.padded_tokens(reqs),
                                  [[5, 6, 7], [9, 9, 9], [0, 0, 0]])


@pytest.mark.parametrize("example", ["serve_decode_torch.py",
                                     "continuous_batching_torch.py"])
def test_example_defaults_to_the_card(example):
    """Without ``--device`` an example asks for the card and, with none
    present, refuses to start instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = importlib.util.spec_from_file_location(
        example[:-3], ROOT / "examples" / example)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main()


@pytest.mark.parametrize("example,expect", [
    ("serve_decode_torch.py", "zamba2-2.7b"),
    ("continuous_batching_torch.py", "served 10 requests"),
])
def test_example_runs_on_cpu(example, expect):
    """The torch examples at their smoke sizes with ``--device cpu``, each
    within a few seconds (a minute's timeout)."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / example), "--device",
         "cpu"], capture_output=True, text=True, timeout=60,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert expect in out.stdout
    assert "(cpu)" in out.stdout or ", cpu)" in out.stdout
