"""The training loop: a closed loop of trainer steps through the
program's ``distributed/trainer.py::make_train_step``, one step object
built once and driven from the seed.

Set-up draws the weights on the card, builds the step and its state, and
drives them through the mix's first steps (``first_steps``), which warm
up every shape; the reference follows those steps. The window then runs
the same object, a step after the other, for ``--seconds``, ending on a
synchronise; ``train_tokens_per_s`` is the tokens of every step of the
window over the window's time. With ``--trace 1`` a traced sub-window of
``trace_steps`` more steps follows.

The mix's parameters: ``rule`` (the communication rule), ``workers`` M,
``global_batch`` sequences of ``seq`` tokens a step, split evenly over
the workers, ``lr``/``b1``/``b2``/``eps`` of the AMSGrad server,
``cada_dtype``/``moments_dtype`` of the planes, ``zipf_a`` of the token
stream.
"""
from __future__ import annotations

import gc
import time

from bench import judge, reference, traffic, weights
from bench.cell import Record

# one step of cada2 launches each of these once, and no other kernel of
# the program: the route the window and the trace are held to
STEP_LAUNCHES = {"fused_amsgrad_flat": 1, "batched_diff_sq_norm_flat": 1,
                 "batched_sq_norm_flat": 0, "diff_sq_norm_flat": 0,
                 "eq3_row_mean_flat": 1, "selective_scan": 0,
                 "selective_scan_heads": 0, "flash_attention": 0}
TRACE_KERNELS = {"amsgrad_kernel": 1, "row_sq_kernel": 1,
                 "row_mean_kernel": 1}


def launch_counts() -> dict:
    from repro_torch.kernels import cada_update, flash_attention, ssm_scan
    fns = {"fused_amsgrad_flat": cada_update.fused_amsgrad_flat,
           "batched_diff_sq_norm_flat": cada_update.batched_diff_sq_norm_flat,
           "batched_sq_norm_flat": cada_update.batched_sq_norm_flat,
           "diff_sq_norm_flat": cada_update.diff_sq_norm_flat,
           "eq3_row_mean_flat": cada_update.eq3_row_mean_flat,
           "selective_scan": ssm_scan.selective_scan,
           "selective_scan_heads": ssm_scan.selective_scan_heads,
           "flash_attention": flash_attention.flash_attention}
    return {k: f.launches for k, f in fns.items()}


def check_route(per_unit: dict, before: dict, after: dict,
                units: int) -> None:
    """Raise unless ``units`` steps or rounds launched ``per_unit`` each
    (launch counts ``before`` and ``after`` them)."""
    got = {k: after[k] - before[k] for k in after}
    want = {k: v * units for k, v in per_unit.items()}
    if got != want:
        raise RuntimeError(f"{units} steps or rounds launched {got}; the "
                           f"route is {want}")


class Program:
    """The system under test: the trainer's step and its state."""

    def __init__(self, cell, device, theta0: dict):
        import torch
        from repro_torch.core import flat as F
        from repro_torch.core.comm import strategy_for
        from repro_torch.core.rules import CommRule
        from repro_torch.distributed import trainer as T
        from repro_torch.models.config import ModelConfig
        tr = cell.traffic
        rule = CommRule(**tr["rule"])
        self.hp = T.TrainHParams(rule=rule, lr=tr["lr"], b1=tr["b1"],
                                 b2=tr["b2"], eps=tr["eps"],
                                 cada_dtype=tr["cada_dtype"],
                                 moments_dtype=tr["moments_dtype"])
        params = weights.unflatten(dict(theta0))
        layout = F.layout_of(params)
        zeros = lambda dt: torch.zeros((layout.n_flat,), dtype=dt,
                                       device=device)
        self.state = T.DistTrainState(
            step=0, params=params, h=zeros(self.hp.moments_torch_dtype),
            vhat=zeros(self.hp.moments_torch_dtype),
            comm=F.init_flat_comm_state(
                strategy_for(rule), layout, params, tr["workers"],
                grad_dtype=self.hp.cada_torch_dtype))
        self.step_fn = T.make_train_step(ModelConfig(**cell.config["model"]),
                                         self.hp, tr["workers"])
        self.layout_of = F.layout_of

    def step(self, batch):
        self.state, met = self.step_fn(self.state, batch)
        return met

    def first_moment(self) -> dict:
        """{leaf: h} of the state's first moment, in fp32."""
        import torch
        lay = self.layout_of(self.state.params)
        h = lay.unpack(self.state.h, dtypes=[torch.float32] * len(lay.paths))
        return weights.flatten(h)

    def params(self) -> dict:
        return weights.flatten(self.state.params)


def feeder(cell, seed: int, device):
    """Step i's batch: the (M, b, S + 1) token rows on the card."""
    import torch
    tr, vocab = cell.traffic, cell.config["model"]["vocab"]

    def feed(i: int):
        rows = torch.from_numpy(traffic.train_batch(tr, vocab, seed, i)).to(
            device)
        return rows.reshape(tr["workers"], -1, rows.shape[-1])
    return feed


def norms(tree: dict, scale: float = 1.0) -> dict:
    import torch
    return {p: torch.linalg.vector_norm(t.float()) * scale
            for p, t in tree.items()}


def program_first_steps(prog: Program, feed, n: int, theta0: dict) -> dict:
    """Drive ``prog`` through the first ``n`` steps; the readings the
    reference is held to."""
    out = {"loss": [], "lhs": [], "rhs": [], "upload": []}
    for i in range(n):
        met = prog.step({"tokens": feed(i)})
        for k, key in (("loss", "loss"), ("lhs", "lhs"), ("rhs", "rhs"),
                       ("upload", "upload_mask")):
            out[k].append(met[key])
        if i == 0:
            out["grad"] = norms(prog.first_moment(), 1.0 / (1 - prog.hp.b1))
    out["change"] = norms({p: t.float() - theta0[p].float()
                           for p, t in prog.params().items()})
    return to_host(out)


def to_host(out: dict) -> dict:
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, list):
            return [conv(x) for x in v]
        if hasattr(v, "tolist"):
            return v.tolist()
        return v
    return conv(out)


def reference_steps(cell, theta0: dict, feed, n: int, num) -> dict:
    """The reference (``num``: float32, or the fp8 control) through the
    same first ``n`` steps."""
    import torch
    from bench.refcada import Cada2Reference
    tr, model = cell.traffic, cell.config["model"]

    def grad_fn(theta, rows):
        leaves = {p: t.detach().requires_grad_() for p, t in theta.items()}
        loss = reference.dense_loss(leaves, model, rows, num)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        return loss.detach(), {p: (torch.zeros_like(leaves[p]) if g is None
                                   else g)
                               for p, g in zip(leaves, grads)}

    ref = Cada2Reference(theta0, {p: t.dtype for p, t in theta0.items()},
                         tr["workers"], tr["rule"],
                         {k: tr[k] for k in ("lr", "b1", "b2", "eps")},
                         grad_fn)
    out = {"loss": [], "lhs": [], "rhs": [], "upload": []}
    for i in range(n):
        rows = feed(i)
        r = ref.step([rows[w] for w in range(tr["workers"])])
        for k in ("loss", "lhs", "rhs", "upload"):
            out[k].append(r[k])
        if i == 0:
            out["grad"] = norms(ref.nabla)
    out["change"] = norms({p: t - theta0[p].float()
                           for p, t in ref.theta.items()})
    return to_host(out)


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        peak: dict) -> Record:
    import torch
    from bench import devtrace
    tr, model = cell.traffic, cell.config["model"]
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    rec = Record(kind="train", model=model, traffic=tr, peak=peak)
    from repro_torch.models.config import ModelConfig
    shapes = weights.program_shapes(ModelConfig(**model))
    stamps = {"imports": time.perf_counter() - t0}
    theta0 = weights.draw(shapes, cell.config["init"], seed, device)
    rec.n_params = sum(t.numel() for t in theta0.values())
    prog = Program(cell, device, theta0)
    feed = feeder(cell, seed, device)
    sync()
    stamps["weights_and_state"] = time.perf_counter() - t0
    first = tr["first_steps"]
    got = program_first_steps(prog, feed, first, theta0)
    sync()
    rec.setup_s = time.perf_counter() - t0
    stamps["first_steps"] = rec.setup_s
    rec.notes["setup"] = stamps

    tokens_per_step = tr["global_batch"] * tr["seq"]
    before = launch_counts()
    losses = []
    i = first
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        losses.append(prog.step({"tokens": feed(i)})["loss"])
        i += 1
    sync()
    rec.window_s = time.perf_counter() - start
    rec.steps = i - first
    if on_card:     # the plain versions off the card count nothing
        check_route(STEP_LAUNCHES, before, launch_counts(), rec.steps)
    rec.attempted = rec.steps
    rec.failed = sum(not bool(torch.isfinite(x)) for x in losses)
    rec.end_to_end = {"train_tokens_per_s":
                      rec.steps * tokens_per_step / rec.window_s,
                      "setup_s": rec.setup_s}
    if trace:
        n = tr["trace_steps"]
        before = launch_counts()

        def traced(span):
            for j in range(n):
                with span("batch"):
                    batch = {"tokens": feed(i + j)}
                with span("step"):
                    prog.step(batch)
        rec.trace = devtrace.capture(traced)
        check_route(STEP_LAUNCHES, before, launch_counts(), n)
        rec.trace.units = {"steps": n}
        for name, per in TRACE_KERNELS.items():
            seen = len(rec.trace.kernels(name))
            if seen != per * n:
                raise devtrace.EmptyTrace(
                    f"the trace holds {seen} {name} launches for {n} steps")
    rec.notes["memory_peak_bytes"] = (
        torch.cuda.max_memory_allocated() if on_card else 0)

    del prog, losses
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    reference.no_tf32()
    want = reference_steps(cell, theta0, feed, first, reference.FP32)
    numbers = judge.train_numbers(got, want)
    rec.notes["readings"] = {"program": got, "reference": want}
    rec.correct, rec.checks = judge.verdict(numbers, cell.limits)
    return rec
