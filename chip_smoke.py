"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then not 0):
  1. card: the card's name and power limit, torch and CUDA versions;
     compute capability 9.0 is required (the kernels are built for sm_90a).
  2. build: every CUDA kernel, from the sources in this checkout.
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes (n_flat = 101,776 and (10, 101,776) planes) and
     at the logreg's n_flat = 48, in fp32 and bf16: error, run-to-run
     identity of the sums, row independence, and for kernel and plain
     version the time per call (CUDA events around 50 back-to-back calls,
     median of 5) and the device time (profiler), beside the bound and,
     where one PyTorch call computes the same function, that call's time.
     The AMSGrad step is bit-equal to its plain version for θ and g in fp32
     and bf16 and moments in fp32 and bf16, also on views that start off
     16 bytes (bit-equal to aligned copies); every CADA kernel runs as one
     launch per call (profiler). The server step and the one-operand norm
     are also timed at LM widths (n = 2^28; (10, 2^24)), where bytes bound
     them. Eq. (3)'s order-fixed row mean is bit-equal to its plain version
     at (10, 101,776) and (1, 101,776), an odd n, a view off 16 bytes, and
     with its zero rows dropped, in fp32 and bf16. The wire compressors
     (plain PyTorch) must give the CPU's bits.
  4. main path: ``CADAEngine`` on the paper MLP 784→128→10 (M=10, batch 12,
     mnist_like(4096), d_max=10, max_delay=50, c=1.0), each rule at its
     reference defaults on FusedAMSGrad(lr=5e-4): 200 rounds each of always
     and cada2, 50 each of lag, cada1, cinn, laq, topk and avp; and
     lag on SGD(0.05) as the paper runs it, 50 rounds. Every gated rule
     must skip an upload and upload again after it: one that does not at
     c = 1 runs again, 60 rounds, at a c where its gate skips
     (``skip_c``). Every kernel's launch count is read around each run and
     must be exact. Then profiles of 20 rounds each of cada2, laq and topk
     (device-busy share, the kernels that take the time).
  5. plain lockstep: 20 cada2 rounds at c = 1 and 20 each of laq and topk
     at their skipping c, each stepped from the kernel run's state by the
     kernels and by the plain versions (``impl="plain"``); each must see a
     skip.
  6. serving path: zamba2-2.7b at full width and depth (54 Mamba2 layers,
     the shared attention block 9 times, 2,340,715,680 bf16 parameters
     drawn on the card from a seed) through ``repro_torch.launch.serve``:
     prefill of 2 random prompts of 2048 tokens, then 32 greedy decode
     steps. Exactly 54 scan and 9 flash launches per prefill and none per
     decode step; prefill ms, decode tokens/s and peak memory; a profile
     of a warm prefill and of decode steps; full-depth logits finite, and
     prefill(S-1) -> decode(1) against prefill(S). Then the first stage (6
     Mamba2 layers and the shared block, full width) run with the kernels
     and with ``impl="plain"``: last logits, SSM/conv states and KV cache
     within a stated band.
  7. training path: the LM trainer (``repro_torch.distributed.trainer``)
     a. stablelm-1.6b at its published width with 4 of its 24 layers (the
        one cut: the (M, n_flat) fp32 planes of the round do not fit 80 GB
        at full depth), 616,581,120 bf16 parameters drawn on the card,
        remat on; cada2 (c = 1, d_max = 10, max_delay = 50), M = 2, lr
        3e-4, 8 steps of 4 × 2048 tokens from ``make_token_batches``.
        Every loss finite, every state tensor on the card, step 0 uploads
        from both workers, exactly one AMSGrad and one two-operand norm
        launch per step and nothing else; per-step time (CUDA events),
        peak memory, and a profile of 2 more steps. Then on the trainer's
        own operands: AMSGrad on its packed θ, h, v̂ and ∇ (θ', h', v̂'
        bit-equal to ``impl="plain"``, Σupd² within SUM_RTOL) and the
        two-operand norm on the next step's (2, n_flat) fresh and second
        planes (within SUM_RTOL), each timed beside its bound.
     b. every rule kind for 3 steps on stablelm's smoke config, M = 2:
        finite losses and the exact launches per kind (the one-operand
        norm for cinn, laq and topk).
  8. the paper's problems, the delta rules and checkpoints:
     a. the paper CNN (54,314 parameters; benchmarks/paper_nn.py:29-41):
        mnist_like(4096), M = 10 equal shards, minibatch 12, d_max 10,
        max_delay 50; adam (always on Adam(5e-4)), cada1 and cada2 on
        Adam(5e-4), lag on SGD(0.05), local_momentum and fedadam with
        H = 8 (local lr 0.05, server lr 5e-4) and cada2 on
        FusedAMSGrad(5e-4), 80 iterations each; a gated rule that never
        skips at c = 1 reruns at the median LHS/RHS of that run. Exact
        launches (eq. (3) once a round, twice for local momentum), state
        on the card, finite losses; losses, uploads, grad evals and ms per
        round printed.
     b. covtype logreg (benchmarks/paper_logreg.py:31,46): covtype_like(),
        M = 20 shards of random sizes, batch 32, lr 0.005, H = 20, d_max
        10, max_delay 100, the same runs for 100 iterations.
     c. cada2 on FusedAMSGrad on the CNN and local_momentum on covtype,
        30 rounds, by the kernels and by impl="plain" from the same state
        each round, held as phase 5 holds its runs.
     d. the same two runs, 20 rounds straight against 10 rounds, a
        checkpoint saved and restored into a fresh state, and 10 more:
        every leaf equal. Where two runs from one state differ (cuDNN's
        convolution backward), 8c and 8d turn on cuDNN's deterministic
        algorithms and say so.
     e. phase 7's model and cut trained by local_momentum and fedadam
        (H = 2 at local lr 0.01, M = 2, 4 × 2048 tokens a step, 4 steps
        each): ms per step, peak memory, exactly one AMSGrad and one
        eq. (3) launch a step (two for local momentum), a profile of one
        more step; then one more step's own (2, n_flat) wire plane, taken
        from eq. (3)'s dispatch inside the step: the step's result and
        the kernel on that plane bit for bit against the plain version,
        timed beside its bound.
  9. the cohort plane (``CADAEngine.init_cohort``/``run_cohort``, the
     trainer's ``make_cohort_train_step``/``run_cohort_train``): the host's
     MemTotal and MemAvailable first, then
     a. every rule kind on the paper MLP at M = 256 workers, C = 32 a
        round, batch 12, 40 rounds of ``sample_cohorts`` (the gated rules
        at phase 4's skipping c, the delta rules at H = 2 on their own
        servers): the pipelined run equals the serial one bit for bit
        (state, every pool plane, every metric), exact launches per
        round, the ``CommLedger`` totals equal the summed bytes_up;
     b. cada2 at M = 10^4, C = 64, mnist_like(20,000) in shards of 2:
        30 rounds serial, pipelined, and pipelined over a memmap pool in a
        directory the phase removes, the three bit-equal; the host pool
        4.07 GB, nothing O(M·n) on the card (no state tensor, and the
        peak rise below the pool's bytes); ms per round, the pipeline
        track, the pinned copy rates, and a profile of 10 pipelined
        rounds (device-busy share, the block copies' time against their
        bytes over those rates, their overlap with kernels);
     c. cada2, cada1, laq and local_momentum at M = 64, C = 16, 20
        rounds, and cada2 again with both engines at fuse_evals=False:
        the cohort plane against the dense plane with the cohort as its
        participation mask, masks and staleness exact, whether the float
        state is bit-equal printed (with each gap's share of its array's
        scale); where it is not, the gradient rows of both evaluation
        forms at C·b against M·b rows, the op of the vmapped evaluation
        that differs (the forward product and the per-worker weight
        gradient at both row counts, with the kernels each launches), and
        one round from the same state with the same gradient rows fed to
        both planes, which must be bit-equal;
     d. phase 7's model and cut through the trainer's cohort step: cada2
        with bf16 CADA state, M = 8 (4 if the host is short, said so),
        C = 2, 4 rounds of 2 × 2048 tokens a cohort member, serial and
        pipelined bit-equal, exactly one AMSGrad, one two-operand norm
        and one eq. (3) launch a step; ms per step, peak memory, the
        pipeline track;
     e. 9b's pipelined trace exported and validated, and a pipelined run
        stopped at round 25 of 9a's schedule: ``metrics_out`` and the
        pool equal the serial oracle's through round 24.
 10. the sim runtime (``repro_torch.sim``), every simulated second computed
     by its clock models, never measured:
     a. every kind through ``simulate`` on the zero profile (paper MLP,
        M = 10, 30 rounds, phase 4's skipping c; the delta rules at H = 2
        on their own servers) against ``CADAEngine.run`` on the same
        batches: every metric, mask, loss and parameter bit for bit,
        exact launches in both;
     b. always, cada2, laq (8-bit) and topk (sparse wire) at c = 1
        priced on lan, wan and hetero, 100 rounds each: simulated time to
        a common target loss, uploads, bytes, host ms per round; local
        momentum with adaptive H (cap 16) on wan and zero: the realized
        mean H;
     c. cada1, cada2 and laq async on hetero (tau 20, 200 server
        versions, each at the median LHS / RHS of its gates in a c = 1
        run), on the device plane and with the host pool, bit-equal;
        exactly one AMSGrad launch per server version, one one-row LHS
        launch per gate, no eq. (3) launch; host ms per gate and a
        profile of 50 gates (device-idle share);
     d. ``simulate(cohort_size=64)`` at M = 10^4 on wan over 9b's problem
        and schedule, 30 rounds, against ``run_cohort``: bit for bit; the
        host pool's bytes against the worker rows on the card;
     e. stablelm-1.6b at full width through ``python -m
        repro_torch.launch.train --runtime sim`` in-process: M = 2, one
        2048-token sequence a worker a round, remat off; cada2 barrier
        for 4 rounds with 3 of 24 layers (4 do not fit: the engine
        evaluates 2 points x 2 workers under one vmap) and async (tau 4)
        for 8 server versions with the host pool and 4 layers: finite
        losses, exactly one AMSGrad launch per round or server version;
        ms per round or gate, peak memory.
 11. the MoE, M-RoPE and embedding-input models, at full width through
     ``repro_torch.launch.serve.generate`` (counts set to 0 just before
     and read just after: exactly one flash launch per layer, all in the
     prefill, nothing else), each with its warm prefill by CUDA events and
     under the profiler (device-busy share, top kernels), decode tokens/s
     and peak memory:
     a. granite-moe-1b-a400m (hf:ibm-granite/granite-3.0-1b-a400m-base),
        all 24 layers, 2 prompts of 2048 tokens, 32 greedy steps, 24 flash
        launches; a second prefill bit-equal to the first (logits and K/V
        cache); a profile of 4 decode steps;
     b. qwen2-vl-2b (arXiv:2409.12191), all 28 layers, the stub vision
        embeddings and the M-RoPE positions of a text prefix and a 16 x 16
        image, 28 flash launches at hd 128 and GQA 12/2; then the flash
        kernel alone at (2, 2048, 12, 2, 128) bf16 against its plain
        version, scaled_dot_product_attention(enable_gqa=True) and its
        bound;
     c. musicgen-medium (arXiv:2306.05284), all 48 layers, the stub audio
        embeddings, 48 flash launches;
     d. grok-1-314b (hf:xai-org/grok-1) at full width with 2 of 64 layers
        (the whole model does not fit one card), 1 prompt of 2048 tokens,
        4 decode steps, 2 flash launches, two prefills bit-equal;
     e. granite-moe-1b-a400m through ``make_train_step`` at full width with
        8 of 24 layers: cada2 (c = 1), M = 2, 4 steps of 2 x 2048 tokens a
        worker, exactly one AMSGrad, one two-operand norm and one eq. (3)
        launch a step, finite losses, the routers' aux loss > 0, step ms
        and peak memory; then one qwen2-vl-2b step at 2 of 28 layers on
        {"embeds", "labels", "positions"} batches, launches exact.
 12. the scheduler, sliding-window decode and the pytree plane (counts
     set to 0 just before and read just after each driven run):
     a. zamba2-2.7b at full width and depth through
        ``repro_torch.distributed.scheduler.DecodeScheduler``: 4 slots at
        max_seq 2048 + 32, 10 requests (prompt lengths 256–2048, max_new
        8–32, from a numpy seed), one stopped by an eos_id: every
        request's tokens equal a direct prefill + greedy decode_step loop
        over its round's padded batch; 54 scan and 9 flash launches per
        round's prefill, none in decode; tokens/s, slot utilization, peak
        memory;
     b. internlm2-1.8b at full width and depth through
        ``adapt_for_shape(cfg, SHAPES["long_500k"])`` (window 8192):
        prefill 1 x 12,288 and 32 greedy steps on the ring cache, one
        windowed flash launch per layer; the windowed kernel at that
        prefill's shape against its plain version, and the fp32 prefill's
        last logits with the kernels against ``impl="plain"``;
     c. every kind on the paper MLP (M = 10, 20 rounds) with
        ``CADAEngine(fused=False)`` in lockstep with ``fused=True``: masks
        and staleness exact, parameters within rtol 1e-4 and atol 1e-6,
        the AMSGrad kernel once a round through ``ops.fused_cada_update``;
     d. phase 7's model and cut through ``make_train_step`` with
        ``TrainHParams(fused=False)`` and ``fused=True``, cada2, 4 steps:
        masks equal, losses within 1e-2 of each other, both step times
        and peak memories.
 13. the mesh runtime (``trainer.jit_train_step`` on a process group): 2
     ranks spawned on the one card (gloo: NCCL refuses two ranks on one
     device), a (data=2, model=1) mesh, M = 2, one worker a rank;
     stablelm-1.6b at phase 7's width with 2 of its 24 layers, cada2 at
     15's c = 10⁴ with ``state_fsdp_axes=("data",)``, 2 steps of phase
     7's batches. Each rank holds half of the server planes and its
     worker's row of the stale plane, and launches exactly one AMSGrad
     (on its half) and one two-operand norm (on its row) a step and no
     eq. (3) kernel (a collective there); counts set to 0 just before and
     read just after. On the first step's operands each rank holds both
     kernels against their plain versions, and times the shard-local
     AMSGrad against a launch at the full plane's size. Rank 0 then runs
     the one-process trainer (fused, M = 2) from the same init and
     batches: masks and losses equal at every step, ‖Δθ‖² within 1e-6,
     θ, h, v̂, ∇ and the stale plane bit-equal. Per rank: step ms, peak
     memory, and each collective's time (gloo through the host, not
     NCCL's). A rank that fails fails the phase.
 14. tensor-parallel serving (``distributed/serving.py``'s
     ``jit_prefill_step``/``jit_decode_step``): 2 ranks spawned on the one
     card over gloo, a (data=1, model=2) mesh, each holding its shards of
     the params (``shard_params``) and of the cache. 14a zamba2-2.7b and
     14b granite-moe-1b-a400m at full width and depth, 2 prompts of 2048,
     16 decode steps teacher-forced on the one-process greedy tokens (run
     by this process first, on the same params and prompts). The driven
     run is bf16 (counts set to 0 just before and read just after: per
     rank 54 scans at 2560 of 5120 channels and 9 flash launches at 16 of
     32 heads per zamba2 prefill, 24 at 8/4 of 16/8 heads per granite-moe
     prefill, none per decode step); a second prefill times it warm (a
     MoE model's must be bit-equal to the first). Then the same in fp32
     on the upcast weights. Against the one-process runs: the prefill's
     last logits, each step's logits and the gathered cache (conv and SSM
     state, K/V), in fp32 within TP_BAND_F32 of scale, in bf16 within
     TP_BF16_FLOORS times bf16's own distance from fp32; the first step
     at which the greedy tokens differ. Per rank: parameter bytes against
     one process's, prefill ms, decode tokens/s, peak memory, each
     collective's count and median/max ms; flash and scan against their
     plain versions at the rank's shapes, timed. A rank that fails fails
     the phase.
 15. the mesh trainer with a model axis and parameter FSDP
     (``trainer.jit_train_step``): 4 ranks spawned on the one card over
     gloo, a (data=2, model=2) mesh, M = 2, each rank on its parameter
     shards (``param_pspecs``) with autograd through the collectives.
     15a stablelm-1.6b at full width with TPT_LAYERS of its 24 layers,
     cada2 at a skipping c, the flat state over ("model", "data"); 15b
     falcon-mamba-7b at full width with 2 of its 64 layers under its
     ``train_policy`` hyper-parameters (``fsdp=True``, 8 microbatches),
     TPT_STEPS steps of 4 × 2048 (15a) or 4 × 512 (15b) tokens. The
     one-process trainer runs first in this process from the same init
     and batches, in fp32 (and, for 15a, in bf16). The driven run is
     fp32 (counts set to 0 just before and read just after: per rank
     one shard-local AMSGrad and one shard-local row-norm launch per
     step, no row-mean kernel: the mesh's eq. (3) is an all-reduce):
     masks equal to one process's, losses and ‖Δθ‖² within TPT_RTOL_F32,
     θ's update and h within TPT_BAND_F32 of scale; then 15a in bf16
     within TPT_BF16_FLOORS times bf16's own distance from fp32, or from
     the fp32 band where that is larger. Per rank: step ms, peak memory,
     parameter bytes, each collective's count, bytes and median ms; the
     AMSGrad, row-norm and row-mean kernels on the step's own shard-local
     operands against their plain versions, timed. A rank that fails
     fails the phase. 15c, in the same spawn: the pytree plane
     (``fused=False``) on 15a's config in fp32 with both state knobs,
     no kernel launched, masks equal to one process's and to 15a's,
     within 15a's fp32 bands; a rank's step ms, peak memory and
     collectives a step by kind.
Phase 3 also holds the selective scan and flash attention against their
plain versions at the serving path's shapes, with their times beside
their device times before their redesign, their bounds and, for flash,
the library call's time: the scan in the served form (Mamba2's A, a
stride-0 view on N: one decay per channel; h_final bit-equal to the same
call with A materialised) and untimed with a general A, also at
falcon-mamba-7b's widths (device time printed); flash in bf16 on the
tensor cores, at a GQA shape and with a window, and in fp32 and bf16 at hd
16 and 64 and zero-padded at hd 48 and 96 (and, in phase 11b, timed at
qwen2-vl's hd 128 with GQA 12/2). Then it prints one JSON line
with every kernel, and last the line
``{"ok": true, "device": {...}}``. With no CUDA device, or outside the
checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs as lm_configs  # noqa: E402
from repro_torch.checkpoint import io as ckpt  # noqa: E402
from repro_torch.core import flat  # noqa: E402
from repro_torch.core.comm import CommState, strategy_for  # noqa: E402
from repro_torch.core.engine import (CADAEngine,  # noqa: E402
                                     CohortEngineState,
                                     cohorts_to_participation,
                                     make_cohort_sampler, make_sampler,
                                     sample_cohorts)
from repro_torch.configs.base import (SHAPES,  # noqa: E402
                                      LONG_CONTEXT_WINDOW, adapt_for_shape)
from repro_torch.core.rules import (KINDS, LOCAL_RULES, RULES,  # noqa: E402
                                    CommRule)
from repro_torch.data import (covtype_like, mnist_like,  # noqa: E402
                              pad_to_matrix, random_sizes_partition,
                              uniform_partition)
from repro_torch.kernels import build, cada_update, ref  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import flash_attention as fa_kernel  # noqa: E402
from repro_torch.kernels import ssm_scan as scan_kernel  # noqa: E402
from repro_torch.distributed import trainer  # noqa: E402
from repro_torch.distributed.scheduler import (DecodeScheduler,  # noqa: E402
                                               Request)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import DATA, MODEL, Mesh  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.train import make_token_batches  # noqa: E402
from repro_torch.models import frontends  # noqa: E402
from repro_torch.models import model as lm  # noqa: E402
from repro_torch.models.config import param_count  # noqa: E402
from repro_torch.obs import (CommLedger, Tracer,  # noqa: E402
                             validate_chrome_trace, write_chrome_trace)
from repro_torch.obs import export as obs_export  # noqa: E402
from repro_torch.models.small import (cnn_init, cnn_loss,  # noqa: E402
                                      logreg_init, logreg_loss, mlp_init,
                                      mlp_loss)
from repro_torch.optim.adam import adam  # noqa: E402
from repro_torch.optim.fused import FusedAMSGrad, FusedState  # noqa: E402
from repro_torch.optim.sgd import sgd  # noqa: E402
from repro_torch.sim import (SimConfig, SimRuntime,  # noqa: E402
                             network_profile, simulate)
from repro_torch.sim.report import final_loss, time_to_target  # noqa: E402
from repro_torch.utils.trees import (tree_leaves, tree_map,  # noqa: E402
                                     tree_paths)

M, BATCH, N_DATA = 10, 12, 4096
DIMS = (784, 128, 10)
# run name: (rule kind, rounds, server optimizer: "fused" or "sgd")
D_MAX, MAX_DELAY = 10, 50
# a rerun at a skipping c outlasts the staleness cap, so a worker that
# stops uploading is made to upload again at the latest in round MAX_DELAY
SKIP_ROUNDS = MAX_DELAY + D_MAX
MAIN_RUNS = {"always": ("always", 200, "fused"),
             "cada2": ("cada2", 200, "fused"),
             "lag": ("lag", 50, "fused"),
             "cada1": ("cada1", 50, "fused"),
             "cinn": ("cinn", 50, "fused"),
             "laq": ("laq", 50, "fused"),
             "topk": ("topk", 50, "fused"),
             "avp": ("avp", 50, "fused"),
             "lag-sgd": ("lag", 50, "sgd")}
DIFF_RULES = ("lag", "cada1", "cada2", "avp")   # gate: batched_diff_sq
SQ_RULES = ("cinn", "laq", "topk")              # gate: batched_sq
LOCKSTEP_ROUNDS = 20
ULP_SCALE = 2.0 ** -20   # elementwise tolerance: 8 ULP at the array's scale
SUM_RTOL = 1e-5          # sums in another order
NORM_RTOL = 1e-6         # the one-operand and scalar norms, ditto
MARGIN_BAND = 1e-5       # gate margin inside which kernel/plain may differ
LIBRARY_NOTE = {
    "amsgrad": "no single PyTorch call computes this step: "
               "torch._fused_adam_ applies bias correction, puts eps outside "
               "the root and returns no sum of squared updates",
    "batched_diff_sq": "no single PyTorch call computes row-wise squared "
                       "distances: pairwise_distance adds eps and takes a "
                       "root, cdist computes every pair of rows",
    "batched_sq": "torch.linalg.vecdot(a, a), timed here",
    "diff_sq": "torch.nn.functional.mse_loss(a, b, reduction='sum'), "
               "timed here",
    "selective_scan": "no single PyTorch call computes a selective scan: "
                      "torch has no linear-recurrence (associative) scan, "
                      "and cumsum/cumprod forms materialise the (G, S, D, "
                      "N) trajectory the kernel exists to avoid",
    "flash_attention": "torch.nn.functional.scaled_dot_product_attention("
                       "is_causal=True, enable_gqa=Hq != Hkv) on "
                       "(B, H, S, hd), timed here",
    "eq3_row_mean": "plane.float().sum(0) * rcp (torch.sum over the rows), "
                    "timed here; not bit-equal to the kernel: torch.sum "
                    "adds the rows in an order of its own, and the fixed "
                    "order is the kernel's contract",
}
# serving path (phase 6): zamba2-2.7b, full width and depth
SERVE_ARCH, SERVE_BATCH, SERVE_SEQ, SERVE_TOKENS = "zamba2-2.7b", 2, 2048, 32
SCAN_RTOL = 1e-5          # scan kernel vs plain, of each array's scale:
#                           fp32; the N-sum's order (its rounding scales
#                           with the terms, and y_t can cancel to near 0)
FLASH_RTOL_F32 = 1e-5     # flash kernel vs plain, fp32: sum orders
FLASH_RTOL_BF16 = 2.0 ** -8   # bf16 output: one bf16 ULP below |o| = 1;
#   where |o| >= 1 the tensor-core kernel (its scores and P differ from the
#   plain version's at the fp32 level) may round to the other bf16
#   neighbour, so an element outside this band must be a single rounding
#   flip: within one bf16 ULP of the plain result computed in fp32
#   (flash_bf16_gaps; PERF.md §6 has the measured counts)
# the two redesigned kernels' device times at the served shapes before
# their redesign (the per-state scan and the CUDA-core flash kernel;
# PERF.md §6, NVIDIA H100 80GB HBM3, 700.00 W)
EARLIER_DEVICE_MS = {"selective_scan": 1.895, "flash_attention": 1.990,
                     # the CADA server step and one-operand norm before
                     # their one-launch redesign (PR 15, run b)
                     "amsgrad": 0.00380, "batched_sq": 0.00455}
LM_N = 2 ** 28           # AMSGrad at an LM width: 7.52 GB moved in fp32
LM_ROW_N = 2 ** 24       # batched_sq (M, 2^24) fp32: 0.671 GB
STAGE_RTOL_F32 = 1e-4     # first stage, fp32, kernels vs plain: the
#                           kernels' ~1e-6 gaps through 7 blocks of fp32
#                           GEMMs and nonlinearities, no rounding to bf16
DECODE_ATOL = DECODE_RTOL = 0.05   # prefill(S-1)+decode vs prefill(S),
#                                    fp32: the reference's test's band
# training path (phase 7): stablelm-1.6b at full width, 4 of 24 layers
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_PARAMS = "stablelm-1.6b", 4, 616_581_120
TRAIN_M, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 4, 2048, 8
TRAIN_PROFILE_STEPS = 2
TRAIN_RULE = dict(c=1.0, d_max=10, max_delay=50)   # examples/train_lm_cada.py
TRAIN_LR = 3e-4
SMOKE_TRAIN_STEPS = 3
# phase 8: the paper's own problems (benchmarks/paper_nn.py:29-41, the CNN;
# benchmarks/paper_logreg.py:31,46, covtype) with the six algorithms of
# their runs and cada2 on the AMSGrad kernel; name: (rule kind, server
# optimizer: "adam", "sgd", "fused" or None for the rule's own)
PAPER_RUNS = {"adam": ("always", "adam"), "cada1": ("cada1", "adam"),
              "cada2": ("cada2", "adam"), "lag": ("lag", "sgd"),
              "local_momentum": ("local_momentum", None),
              "fedadam": ("fedadam", None),
              "cada2-fused": ("cada2", "fused")}
PAPER_SETUPS = {
    "cnn": dict(m=10, batch=12, lr=5e-4, lag_lr=0.05, h=8, d_max=10,
                max_delay=50, iters=80),
    "covtype": dict(m=20, batch=32, lr=0.005, lag_lr=0.1, h=20, d_max=10,
                    max_delay=100, iters=100)}
PAPER_LOCKSTEP_ROUNDS = 30      # 8c
RESUME_ROUNDS = 20              # 8d: 10 rounds, save, restore, 10 more
# 8e: the LM trainer with a delta rule, phase 7's model and cut, H = 2;
# local SGD at the launcher's default 0.1 makes the losses climb at this
# width, at 0.01 they fall (tools/lm_local_lr_probe.py, PERF.md)
DELTA_H, DELTA_STEPS, DELTA_LOCAL_LR = 2, 4, 0.01
EQ3_TRAINER_CALLS = 10
# phase 9: the cohort plane. 9a every kind at the paper MLP's width on
# M = 256 workers, C = 32 a round (the delta rules at H = 2, local lr 0.05,
# FedAdam's server lr 5e-4, as phase 8a runs the CNN); 9b M = 10^4, C = 64
# over mnist_like(20,000) in shards of 2 (the reference's M = 10^4 smoke,
# tests/test_cohort_plane.py:296); 9c cohort against dense at M = 64,
# C = 16; 9d phase 7's model and cut at M = 8, C = 2; 9e a run stopped at
# round COHORT_FAIL_AT of 9a's schedule
COHORT_M, COHORT_C, COHORT_ROUNDS, COHORT_FAIL_AT = 256, 32, 40, 25
COHORT_H, COHORT_LOCAL_LR, COHORT_SERVER_LR = 2, 0.05, 5e-4
FED_M, FED_C, FED_ROUNDS, FED_DATA = 10_000, 64, 30, 20_000
FED_PROFILE_ROUNDS = 10
VS_M, VS_C, VS_ROUNDS = 64, 16, 20
# 9c's accepted band: the stacked evaluation (the engine's default) runs
# the MLP's forward x·W1 as one batched GEMM over 2·C or 2·M per-worker
# points, and cuBLAS takes another kernel for each count (gemmSN_NN at 32
# points, an sm80 xmma ffma GEMM at 128), which sums the 784 products in
# another order; so the float state after VS_ROUNDS rounds may differ by
# this share of each array's scale (measured: 6.6e-7, PERF.md). With
# fuse_evals=False (one GEMM over the stacked rows, shared weights) it
# must be bit-equal
COHORT_DENSE_BAND = 1e-5
VS_RULES = ("cada2", "cada1", "laq", "local_momentum")
LM_COHORT_M, LM_COHORT_C, LM_COHORT_ROUNDS = 8, 2, 4
POOL_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_pool"
# phase 10: the sim runtime. 10a degenerate parity (zero profile) for every
# kind, the delta rules at H = 2 on their own servers; 10b priced runs on
# lan, wan and hetero, and local momentum with adaptive H (cap 16) on wan
# and zero; 10c async on hetero at tau 20, 200 server versions, device
# plane and host pool, a profile of 50 gates; 10d the federated sim at
# M = 10^4 (phase 9b's problem); 10e stablelm-1.6b through the launcher's
# --runtime sim at phase 7's width, M = 2, one 2048-token sequence a worker
# a round, remat off (torch.utils.checkpoint does not compose with the
# engine's torch.func vmap)
SIM_PARITY_ROUNDS, SIM_PRICED_ROUNDS = 30, 100
SIM_PROFILES = ("lan", "wan", "hetero")
SIM_PRICED = {"always": dict(kind="always"), "cada2": dict(kind="cada2"),
              "laq-8bit": dict(kind="laq", quantize_bits=8),
              "topk-sparse": dict(kind="topk", sparse_wire=True)}
SIM_ADAPT_CAP, SIM_ADAPT_ROUNDS = 16, 20
SIM_ASYNC_TAU, SIM_ASYNC_VERSIONS = 20, 200
SIM_ASYNC_RULES = ("cada1", "cada2", "laq")
SIM_PROFILE_GATES, SIM_PROFILE_SKIP = 50, 10
SIM_LM_ROUNDS, SIM_LM_VERSIONS, SIM_LM_TAU = 4, 8, 4
# the barrier run keeps 3 of phase 7's 4 layers: the engine evaluates 2
# points x 2 workers of 2048 tokens under one vmap without remat, which at
# 4 layers needs more than the card's 80 GB
SIM_LM_LAYERS = {"barrier": 3, "async, host pool": TRAIN_LAYERS}
# phase 11: the MoE, M-RoPE and embedding-input models. Serving at full
# width: arch -> (layers kept, 0 = all; prompts; prompt length; greedy
# decode steps); grok-1-314b keeps 2 of its 64 layers (the whole model is
# 628 GB in bf16, the card holds 80). qwen2-vl's prompts take the M-RoPE
# positions of a text prefix and a 16 x 16 image.
MOE_SERVE = {"11a": ("granite-moe-1b-a400m", 0, 2, 2048, 32),
             "11b": ("qwen2-vl-2b", 0, 2, 2048, 32),
             "11c": ("musicgen-medium", 0, 2, 2048, 32),
             "11d": ("grok-1-314b", 2, 1, 2048, 4)}
MROPE_GRID = (16, 16)
# 11e: granite-moe through the trainer at full width with 8 of 24 layers
# (phase 7's 616.6M parameters took 47.6 GiB; 8 layers are 478M), cada2,
# M = 2, 4 steps of 2 x 2048 tokens a worker; then one qwen2-vl-2b step at
# 2 of 28 layers on {"embeds", "labels", "positions"} batches
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = (
    "granite-moe-1b-a400m", 8, 4)
MOE_TRAIN_BATCH = 2 * TRAIN_M
VLM_TRAIN_LAYERS = 2
# phase 12: the scheduler, the input shapes and the pytree plane. 12a the
# continuous-batching scheduler over zamba2-2.7b at full width and depth:
# 4 slots at max_seq 2048 + 32, 10 requests, prompt lengths and max_new
# drawn from a numpy seed, request SCHED_EOS_UID stopped by an eos_id taken
# from its own greedy output (the direct loop's third token)
SCHED_SLOTS, SCHED_REQUESTS, SCHED_MAX_SEQ = 4, 10, 2048 + 32
SCHED_PROMPT, SCHED_NEW, SCHED_EOS_UID = (256, 2048), (8, 32), 1
# 12b internlm2-1.8b at full width and depth through
# adapt_for_shape(long_500k) (window 8192): prefill 1 x 12,288, 32 greedy
# steps on the 8192-slot ring; the prefill's last logits with the kernels
# against impl="plain" in fp32 (the bf16 weights upcast): each layer's
# attention sums 8192 keys in another order, through 24 layers of fp32
# GEMMs; a tenth of phase 6's STAGE_RTOL_F32 per layer
LONG_ARCH, LONG_PROMPT, LONG_STEPS = "internlm2-1.8b", 12_288, 32
LONG_LOGITS_BAND = 1e-3
# 12c the pytree engine (fused=False) against the flat plane in lockstep:
# the paper MLP at M = 10, every kind for 20 rounds at phase 4's skipping
# c (the delta rules as 10a runs them); parameters within the reference's
# contract for this pair (tests/test_flat_plane.py:218-221)
PYTREE_ROUNDS, PYTREE_RTOL, PYTREE_ATOL = 20, 1e-4, 1e-6
# 12d the trainer's pytree plane against its flat plane: phase 7's model
# and cut, cada2, M = 2, 4 steps of 4 x 2048 tokens from one seed, at a c
# that skips: on the H100 both workers upload at steps 0 and 1 (LHS/RHS
# 2.81 and 2.86 at step 1) and skip at 2 and 3 (0.709 and 0.704, then
# 0.307 and 0.302). The planes differ in eq. (3)'s order (a per-leaf mean
# against the order-fixed row mean) and the server step's form, so θ' may
# differ by an fp32 ULP before its bf16 rounding, and a bf16 weight by a
# bf16 step. Bands about ten times the largest gaps read there (PERF.md,
# phase 12d): losses 7.77e-6, ||Δθ||² 4.29e-6, the gate terms 5.77e-6, 97
# weights differing by at most 2 bf16 ULP
PYTREE_TRAIN_STEPS, PYTREE_TRAIN_C = 4, 1000.0
PYTREE_LOSS_BAND, PYTREE_DTHETA_BAND, PYTREE_LHS_BAND = 1e-4, 5e-5, 6e-5
PYTREE_PARAM_ULPS, PYTREE_PARAM_DIFFS = 4.0, 1000
# phase 13: the mesh runtime (trainer.jit_train_step) on the one card: 2
# ranks over gloo (NCCL refuses two ranks on one device; gloo carries the
# CUDA tensors through the host), a (data=2, model=1) mesh, M = 2 (one
# worker a rank); stablelm-1.6b at phase 7's width with MESH_LAYERS of its
# 24 layers (the cut: two ranks and the one-process reference, run by rank
# 0 after the mesh run, share the card's 80 GB), cada2 at MESH_C with
# state_fsdp_axes=("data",), MESH_STEPS steps of phase 7's batches (at
# 12d's c = 1000 the gate first skipped at the fourth step, at 15's
# c = 10⁴ it skips at the second: [[T,T],[F,F]], the skip the check needs
# in half the steps);
# ‖Δθ‖² (two per-shard partial sums against one launch's) within
# MESH_DSQ_RTOL of the one-process trainer's: the kernel sums Σupd² in
# fp32, each thread adding its ~1,000 (a half plane) or ~2,000 (the whole
# plane) elements in sequence, so each launch carries a few 1e-6 of its
# own; measured 3.89e-6 apart (PERF.md, PR 23), and each side's gap to an
# fp64 sum of the same updates is printed at step 0
MESH_LAYERS, MESH_STEPS, MESH_RANKS, MESH_C = 2, 2, 2, 1e4
MESH_DSQ_RTOL = 1e-5
MESH_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_mesh"
# phase 14: tensor-parallel serving (distributed/serving.py's builders) on
# TP_RANKS ranks sharing the one card over gloo, a (data=1, model=2) mesh;
# label -> (arch, prompts, prompt length, greedy decode steps), each at
# full width and depth: 14a zamba2-2.7b (the scan on 2560 of 5120
# channels, 40 of 80 heads; flash on 16 of 32 heads), 14b
# granite-moe-1b-a400m (16 of 32 experts a rank, GQA 16/8 -> 8/4, the
# vocab of 49155 replicated). The driven run is bf16, the served dtype.
# Against the one-process run on the same params and prompts (this
# process, before the spawn), each decode step teacher-forced on the
# one-process bf16 run's greedy tokens:
#   * fp32 (the bf16 weights upcast, both sides): the prefill's last
#     logits, each step's logits and the gathered cache within
#     TP_BAND_F32 of the one-process array's scale. The ranks add a
#     row-parallel product's two fp32 partials where one GEMM sums the
#     whole row, so the gap is the fp32 order of sums through 63 (14a)
#     or 48 (14b) blocks: phase 6's fp32 prefill(S-1) + decode against
#     prefill(S) is 1.1e-5 of scale at this depth, and the band is a
#     hundred times that, 50 times tighter than DECODE_RTOL's 0.05
#     (measured on the H100: 14a at most 1.69e-4, PERF.md);
#   * bf16: each array no further from the one-process bf16 run than
#     TP_BF16_FLOORS times the one-process bf16 run's own distance from
#     the fp32 run. Each of the two bf16 runs is a rounding of the fp32
#     trajectory, and a bf16 ULP flip grows layer by layer (phase 6's
#     first stage: kernels vs plain in bf16 half of bf16's distance from
#     fp32 after 7 blocks), so at full depth the two may decorrelate:
#     then their distance is bounded by the sum of their distances from
#     fp32, two floors, if the ranks' bf16 run is as close to fp32 as the
#     one process's (the fp32 check above holds the arithmetic)
TP_RANKS = 2
TP_SERVE = {"14a": (SERVE_ARCH, 2, 2048, 16),
            "14b": ("granite-moe-1b-a400m", 2, 2048, 16)}
TP_BAND_F32 = 1e-3
# a MoE config's fp32 band: a routing near-tie (top-k of the experts, or an
# expert's top-C of the tokens) that the fp32 order of sums tips gives a
# token another expert set, a discrete change of its hidden state and of
# the K/V it leaves in later layers (the CPU MoE tests' ROUTE_BAND). Set
# after a first run on the H100 showed 14b's fp32 K cache 7.37e-3 of
# scale from one process's (its logits 2.5e-6), at DECODE_RTOL's 0.05,
# the loosest band the logits' check may take
TP_BAND_MOE = DECODE_RTOL
TP_BF16_FLOORS = 2.0
TP_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_tp"
# phase 15: the mesh trainer with a model axis and parameter FSDP on
# TPT_RANKS ranks sharing the one card over gloo, a (data=2, model=2) mesh,
# M = 2 (a worker a data rank, its two model ranks holding halves of the
# sharded leaves); label -> (arch, layers kept, sequence length), each at
# its published width, TPT_STEPS steps of 4 sequences from
# make_token_batches, cada2 at TPT_C (12d's and 13's c = 1000 uploaded at
# all three steps of 15a in fp32 on the H100, PERF.md §6), so that the
# gate both uploads and skips. 15a stablelm-1.6b at TPT_LAYERS
# of 24 layers (the cut: four ranks' states, each with a whole fp32 plane
# of its worker's gradient and the step's whole packed θ, share the 80 GB;
# tools/mesh_state_bytes.py reckons 6.68 GB a rank at rest in fp32 against
# 18.5 GB for one process), the flat state over ("model", "data") (the
# worker planes' columns over "model"); 15b falcon-mamba-7b at 2 of 64
# layers under train_policy's hyper-parameters (fsdp=True, 8 microbatches,
# lr 1e-4; the rule's c set to skip, as 15a's; the flat state over
# ("model", "data") as 15a's, where the policy's would shard it over the
# FSDP axis alone: with whole worker rows a rank needs more than 18 GB,
# the fourth of the card that is its share), so the FSDP leaves are
# gathered per layer inside the remat region and mamba1 runs its TP
# backward; 4 x 512 tokens a step, as the chunked scan's loop over time
# runs one small kernel per step and channel block (launch-bound; 1024
# until 15c joined the phase, whose time this pays for). The
# one-process trainer from the same init and batches runs first in this
# process (fp32, and bf16 for 15a) and is freed before the spawn. Bands
# of the fp32 run: masks exact; losses and ‖Δθ‖² within TPT_RTOL_F32;
# θ's update and h within TPT_BAND_F32 of their scale. The ranks add
# partial products of their blocks where one GEMM sums a whole row, and
# AMSGrad's normalised step carries a gradient's rounding gap
# about five times over into θ's update (the CPU test's 1.0e-5 of scale
# at smoke width); TPT_BAND_F32 is TP_BAND_F32, phase 14's fp32 band. The
# bf16 run (15a) within TPT_BF16_FLOORS times the one-process bf16 run's
# own distance from its fp32 run, as phase 14 holds bf16, where that
# distance is not below the fp32 run's band: a bf16 check is never held
# tighter than the fp32 one on the same quantity. ‖Δθ‖² is the case:
# a sum dominated by AMSGrad's saturated steps, which bf16 barely moves
# (5.65e-5 apart from fp32 in one process, while the ranks' fp32 sums of
# partial products leave 3.3e-6 and their bf16 run 1.3e-4 on the H100,
# PERF.md §6: held to the bare floor, it failed at 2.3 floors)
# TPT_STEPS is 2: at c = 10⁴ the masks are [[T,T],[F,F]], and a third
# step only repeated the skip ([[T,T],[F,F],[F,F]] in 15a and 15b on the
# H100, PERF.md §6); its time pays for 15c.
# 15c: the pytree plane (fused=False) on the same ranks, in the same
# spawn, after 15a and 15b: 15a's stablelm-1.6b at TPT_LAYERS layers in
# fp32, cada2 at TPT_C, the per-leaf state with both state knobs (the
# moments over ("data",) beside the model axis, ∇ over "data" and the
# model axis, the worker trees over the model axis), held against the
# one-process pytree trainer with 15a's fp32 bands; its masks must equal
# 15a's flat-plane masks on the same init and batches, and it launches no
# kernel (its server step and norms are eager per-leaf PyTorch, as the
# reference's)
TPT_RANKS, TPT_STEPS, TPT_LAYERS, TPT_C = 4, 2, 2, 1e4
TPT_MESH = (2, 2)                      # (data, model)
TPT_TRAIN = {"15a": ("stablelm-1.6b", TPT_LAYERS, TRAIN_SEQ),
             "15b": ("falcon-mamba-7b", 2, 512)}
TPT_PYTREE = "15c"
TPT_RUNS = (*TPT_TRAIN, TPT_PYTREE)
TPT_RTOL_F32, TPT_BAND_F32, TPT_BF16_FLOORS = 1e-4, TP_BAND_F32, 2.0
# a rank's cap on its cached memory (GiB) while the ranks step (the whole
# state is drawn one rank at a time, uncapped): four ranks, the parent's
# ~1 GiB and four CUDA contexts then leave ~4 GiB of the card free. 15a's
# fp32 ranks peaked at 16.333 GiB allocated, 18.932 reserved on the H100
# (PERF.md §6); uncapped, four such caches filled the card once
TPT_RANK_GIB = 18.0
TPT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_tpt"
# kinds of device kernel in a trainer step's profile: a kernel goes to the
# first group whose key its name holds (fp32 GEMMs before the rest), and
# to the last group, PyTorch's other eager kernels, when none does
TRAIN_KERNEL_GROUPS = {"amsgrad_kernel": ("amsgrad_kernel",),
                       "row_sq_kernel": ("row_sq_kernel",),
                       "fp32 GEMMs": ("f32f32_f32", "sgemm"),
                       "other GEMMs": ("gemm", "nvjet", "cutlass"),
                       "softmax": ("softmax", "SoftMax"),
                       "reductions": ("reduce_kernel",),
                       "copies and casts": ("copy_kernel",),
                       "other elementwise": ()}


# ------------------------------------------------------------------ card

SXM_NAME = "H100 80GB HBM3"
SXM_RATES = (3.35e12, 67e12)   # bytes/s, fp32 FLOP/s outside the tensor cores
BF16_TC_FLOPS = 989e12         # dense bf16 on the tensor cores (data sheet)
# special-function unit results (exp) per second: 16 per clock per SM, 132
# SMs, at the H100 SXM's 1,980 MHz boost clock (Hopper architecture paper)
SFU_RATE = 16 * 132 * 1.98e9


def card_rates(name: str) -> tuple[float, float]:
    """The H100 SXM's published peaks (NVIDIA's data sheet); raises on any
    other part, whose bounds would need its own rates."""
    if SXM_NAME not in name:
        raise RuntimeError(f"{name!r}: bounds are stated for the "
                           f"{SXM_NAME} (H100 SXM) only")
    return SXM_RATES


def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on "
                         "the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"device {name}  capability {cap}  count "
          f"{torch.cuda.device_count()}")
    if cap != (9, 0):
        raise RuntimeError(f"compute capability {cap}: the kernels are "
                           "built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# ----------------------------------------------------------------- timing

def time_ms(fn, calls: int = 50, repeats: int = 5, warmup: int = 5) -> float:
    """Median over ``repeats`` of the mean time of ``calls`` back-to-back
    calls, by CUDA events (warm L2: the main path's operands fit in it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / calls)
    return statistics.median(per_call)


def device_ms(fn, names: tuple[str, ...] | None = None,
              calls: int = 20) -> float | None:
    """Device time of one call, from the profiler; None when it records no
    device time. With ``names``: the median over the launches it recorded
    of the kernels whose names hold one of them (each such call launches
    one; a median holds when the profiler drops or mistimes a launch; a
    window that recorded none of them is profiled once more); else every
    kernel's time summed over the window, per call."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(1 if names is None else 2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        if names is None:
            tot = sum(getattr(e, "device_time_total", 0)
                      for e in prof.key_averages())
            return tot / calls / 1e3 if tot > 0 else None
        durations = [e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and any(n in e.name for n in names)]
        if durations:
            return statistics.median(durations) / 1e3
    return None


def _us(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms * 1e3:.3f} us"


def _ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


# ---------------------------------------------------------------- kernels

def _max_rel(a, b):
    return float(((a.double() - b.double()).abs()
                  / b.double().abs().clamp_min(1e-30)).max())


def _bound(nbytes: int, flops: int, rates) -> tuple[float, str]:
    """The least time for the work (ms) and what sets it."""
    t_bytes, t_ops = nbytes / rates[0], flops / rates[1]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def one_launch(fn, kernel: str, label: str, calls: int = 5) -> None:
    """Raises unless ``calls`` calls of ``fn`` launched ``kernel`` and no
    other CUDA kernel, at most once per call (profiler events, which may
    miss a launch at the profiler's start but never add one): no second
    pass, no per-call zeroing of the workspace."""
    from torch.profiler import ProfilerActivity, profile
    # a window that recorded nothing says nothing: CUPTI has been seen to
    # return three empty windows in a row on a call that launched each time
    for attempt in range(8):
        if attempt:
            time.sleep(0.2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    if not 1 <= len(names) <= calls or not all(kernel in nm
                                               for nm in names):
        raise RuntimeError(f"{label}: {calls} calls launched {names}")


def _amsgrad_operands(n, theta_dtype, moment_dtype, grad_dtype, gen,
                      offset=0):
    """θ, h, v̂, g of length n; with ``offset`` > 0 each a contiguous view
    that starts that many elements into a larger buffer."""
    def draw(scale, dtype, nonneg=False):
        x = scale * torch.randn(n + offset, generator=gen, device="cuda")
        return (x.abs() if nonneg else x).to(dtype)[offset:]
    return (draw(1.0, theta_dtype), draw(0.1, moment_dtype),
            draw(0.01, moment_dtype, nonneg=True), draw(1.0, grad_dtype))


def _short(dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "fp32"


def check_amsgrad(n: int, moment_dtype, rates, gen, theta_dtype=torch.float32,
                  grad_dtype=torch.float32, offset: int = 0,
                  timed: bool = True, calls: int = 50, operands=None,
                  lr: float = 5e-4) -> dict:
    """The AMSGrad kernel against its plain version: θ', h', v̂' bit for bit,
    Σupd² within SUM_RTOL and the same on two calls, one launch per call.
    The operands are drawn from ``gen``, or are ``operands`` (θ, h, v̂, g,
    whose dtypes the other arguments then name). With ``offset``, the
    operands are views that start off 16 bytes (the scalar loads) and
    Σupd² must also equal, bit for bit, that of aligned copies (the vector
    loads)."""
    theta, h, vhat, grad = operands or _amsgrad_operands(
        n, theta_dtype, moment_dtype, grad_dtype, gen, offset)
    label = (f"amsgrad n={n} theta/g/moments={_short(theta_dtype)}/"
             f"{_short(grad_dtype)}/{_short(moment_dtype)}"
             + (f", views {offset} element(s) off 16 B" if offset else ""))
    k_out = cada_update.fused_amsgrad_flat(theta, h, vhat, grad, lr)
    k_again = cada_update.fused_amsgrad_flat(theta, h, vhat, grad, lr)
    p_out = ref.amsgrad_ref(theta, h, vhat, grad, lr)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(k_out, k_again)):
        raise RuntimeError(f"{label}: two identical calls differ")
    for what, kk, pp in zip(("theta", "h", "vhat"), k_out, p_out):
        if kk.dtype != pp.dtype or not torch.equal(kk, pp):
            raise RuntimeError(
                f"{label}: {what}' is not bit-equal to the plain version's "
                f"(max |err| {float((kk.float() - pp.float()).abs().max())})")
    sq_err = abs(float(k_out[3]) - float(p_out[3]))
    if sq_err > SUM_RTOL * float(p_out[3]):
        raise RuntimeError(f"{label}: sum upd^2 {float(k_out[3])} vs plain "
                           f"{float(p_out[3])}")
    note = ""
    if offset:
        copies = tuple(t.clone() for t in (theta, h, vhat, grad))
        if cada_update.vector_ok(theta, h, vhat, grad) or \
                not cada_update.vector_ok(*copies):
            raise RuntimeError(f"{label}: the views' alignment is not as "
                               "set up")
        aligned = cada_update.fused_amsgrad_flat(*copies, lr)
        if not all(torch.equal(a, b) for a, b in zip(k_out, aligned)):
            raise RuntimeError(f"{label}: differs from aligned copies")
        note = ", every output bit-equal to aligned copies' (vector loads)"

    def kernel():
        return cada_update.fused_amsgrad_flat(theta, h, vhat, grad, lr)

    one_launch(kernel, "amsgrad_kernel", label)
    head = (f"  {label}: theta', h', vhat' bit-equal to plain, sum upd^2 "
            f"{float(k_out[3]):.9g} vs plain {float(p_out[3]):.9g} (rel "
            f"{_max_rel(k_out[3], p_out[3]):.3g}), run-to-run identical, one "
            f"launch per call{note}")
    if not timed:
        print(head)
        return {"max_abs_err": sq_err}
    tsz, msz, gsz = (torch.empty((), dtype=d).element_size()
                     for d in (theta_dtype, moment_dtype, grad_dtype))
    # read θ, h, v̂, g; write θ', h', v̂' and Σupd²
    nbytes = n * (tsz + 2 * msz + gsz) + n * (tsz + 2 * msz) + 4
    # mul/add/max/div/sqrt per element
    bound, bound_by = _bound(nbytes, 14 * n, rates)

    def plain():
        return ref.amsgrad_ref(theta, h, vhat, grad, lr)

    big = calls < 50
    ms = time_ms(kernel, calls=calls, repeats=5 if not big else 3)
    plain_ms = time_ms(plain, calls=calls if not big else 2,
                       repeats=5 if not big else 3, warmup=5 if not big else 1)
    dev = device_ms(kernel, ("amsgrad_kernel",), calls=20 if not big else 5)
    plain_dev = device_ms(plain, calls=20 if not big else 2)
    before = "" if big or theta_dtype != torch.float32 else (
        f"; before the redesign {EARLIER_DEVICE_MS['amsgrad']} ms, PERF.md")
    print(f"{head}; kernel {ms * 1e3:.2f} us/call (device {_us(dev)}"
          f"{before}), plain {plain_ms * 1e3:.2f} us/call (device "
          f"{_us(plain_dev)}), bound {bound * 1e3:.3f} us ({nbytes} B; "
          f"device at {_share(bound, dev)} of it)")
    return {"max_abs_err": sq_err, "ms": ms, "plain_ms": plain_ms,
            "device_ms": dev, "plain_device_ms": plain_dev,
            "bound_ms": bound, "bound_by": bound_by}


def _share(bound: float, dev: float | None) -> str:
    return "not measured" if not dev else f"{100 * bound / dev:.1f}%"


def check_batched(rows: int, n: int, a_dtype, b_dtype, rates, gen,
                  planes=None, calls: int = 50) -> dict:
    """The two-operand row norm (the gate of lag, cada1, cada2 and avp)
    against its plain version on two (rows, n) planes drawn from ``gen``,
    or on ``planes``: rows within SUM_RTOL, the same on two calls, each row
    bit-equal in a launch over fewer rows, one launch per call."""
    if planes is None:
        planes = (torch.randn(rows, n, generator=gen,
                              device="cuda").to(a_dtype),
                  torch.randn(rows, n, generator=gen,
                              device="cuda").to(b_dtype))
    a, b = planes
    lo = min(2, rows - 1)
    k = cada_update.batched_diff_sq_norm_flat(a, b)
    k_again = cada_update.batched_diff_sq_norm_flat(a, b)
    part = cada_update.batched_diff_sq_norm_flat(a[lo:lo + 3].contiguous(),
                                                 b[lo:lo + 3].contiguous())
    p = ref.batched_diff_sq_norm_ref(a, b)
    torch.cuda.synchronize()
    if not torch.equal(k, k_again):
        raise RuntimeError(f"batched ({rows},{n}): two identical calls "
                           "differ")
    if not torch.equal(k[lo:lo + 3], part):
        raise RuntimeError(f"batched ({rows},{n}): rows depend on R")
    err = float((k - p).abs().max())
    rel = _max_rel(k, p)
    if rel > SUM_RTOL:
        raise RuntimeError(f"batched ({rows},{n}): rel err {rel}")
    nbytes = rows * n * (a.element_size() + b.element_size()) + rows * 4
    bound, bound_by = _bound(nbytes, 3 * rows * n, rates)
    def kernel():
        return cada_update.batched_diff_sq_norm_flat(a, b)

    def plain():
        return ref.batched_diff_sq_norm_ref(a, b)

    one_launch(kernel, "row_sq_kernel", f"batched_diff_sq ({rows},{n})")
    reps, dcalls = (5, 20) if calls >= 50 else (3, 5)
    ms = time_ms(kernel, calls=calls, repeats=reps)
    plain_ms = time_ms(plain, calls=calls, repeats=reps)
    dev = device_ms(kernel, ("row_sq_kernel",), calls=dcalls)
    plain_dev = device_ms(plain, calls=dcalls)
    print(f"  batched_diff_sq ({rows},{n}) {str(a_dtype)[6:]}/"
          f"{str(b_dtype)[6:]}: max|err| {err:.3g} (rel {rel:.3g}), "
          f"run-to-run identical, rows independent of R, one launch per "
          f"call; kernel "
          f"{ms * 1e3:.2f} us/call (device {_us(dev)}), plain "
          f"{plain_ms * 1e3:.2f} us/call (device {_us(plain_dev)}), bound "
          f"{bound * 1e3:.3f} us ({nbytes} B; device at {_share(bound, dev)} "
          "of it)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "device_ms": dev, "plain_device_ms": plain_dev,
            "bound_ms": bound, "bound_by": bound_by}


def check_batched_sq(rows: int, n: int, dtype, rates, gen,
                     calls: int = 50) -> dict:
    """The one-operand row norm (cinn/laq/topk's gate): rows bit-equal in
    an (R, n) and a (1, n) launch, the same on two calls, one launch per
    call."""
    a = torch.randn(rows, n, generator=gen, device="cuda").to(dtype)
    k = cada_update.batched_sq_norm_flat(a)
    k_again = cada_update.batched_sq_norm_flat(a)
    part = cada_update.batched_sq_norm_flat(a[2:5].contiguous())
    alone = cada_update.batched_sq_norm_flat(a[3:4].clone())
    p = ref.batched_sq_norm_ref(a)
    torch.cuda.synchronize()
    if not torch.equal(k, k_again):
        raise RuntimeError(f"batched_sq ({rows},{n}): two identical calls "
                           "differ")
    if not (torch.equal(k[2:5], part) and torch.equal(k[3:4], alone)):
        raise RuntimeError(f"batched_sq ({rows},{n}): rows depend on R")
    err, rel = float((k - p).abs().max()), _max_rel(k, p)
    if rel > NORM_RTOL:
        raise RuntimeError(f"batched_sq ({rows},{n}): rel err {rel}")
    nbytes = rows * n * a.element_size() + rows * 4
    bound, bound_by = _bound(nbytes, 2 * rows * n, rates)

    def kernel():
        return cada_update.batched_sq_norm_flat(a)

    def plain():
        return ref.batched_sq_norm_ref(a)

    def library():
        return torch.linalg.vecdot(a, a)

    one_launch(kernel, "row_sq_kernel", f"batched_sq ({rows},{n})")
    big = calls < 50
    reps, dcalls = (3, 5) if big else (5, 20)
    ms = time_ms(kernel, calls=calls, repeats=reps)
    plain_ms = time_ms(plain, calls=calls, repeats=reps)
    lib_ms = time_ms(library, calls=calls, repeats=reps)
    dev = device_ms(kernel, ("row_sq_kernel",), calls=dcalls)
    plain_dev = device_ms(plain, calls=dcalls)
    lib_dev = device_ms(library, calls=dcalls)
    before = "" if big or dtype != torch.float32 else (
        f"; before the redesign {EARLIER_DEVICE_MS['batched_sq']} ms, "
        "PERF.md")
    print(f"  batched_sq ({rows},{n}) {str(dtype)[6:]}: max|err| {err:.3g} "
          f"(rel {rel:.3g}), run-to-run identical, rows independent of R "
          f"((R, n) vs (1, n)), one launch per call; kernel "
          f"{ms * 1e3:.2f} us/call (device {_us(dev)}{before}), plain "
          f"{plain_ms * 1e3:.2f} us/call (device {_us(plain_dev)}), "
          f"torch.linalg.vecdot {lib_ms * 1e3:.2f} us/call (device "
          f"{_us(lib_dev)}), bound {bound * 1e3:.3f} us ({nbytes} B; "
          f"device at {_share(bound, dev)} of it)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "device_ms": dev, "plain_device_ms": plain_dev,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
            "library_device_ms": lib_dev}


def check_diff_sq(n: int, dtype, rates, gen) -> dict:
    """The scalar ‖a − b‖² (the R = 1 launch of the difference norm)."""
    a = torch.randn(n, generator=gen, device="cuda").to(dtype)
    b = torch.randn(n, generator=gen, device="cuda").to(dtype)
    k = cada_update.diff_sq_norm_flat(a, b)
    k_again = cada_update.diff_sq_norm_flat(a, b)
    p = ref.diff_sq_norm_ref(a, b)
    torch.cuda.synchronize()
    if not torch.equal(k, k_again):
        raise RuntimeError(f"diff_sq n={n}: two identical calls differ")
    err, rel = float((k - p).abs()), _max_rel(k, p)
    if rel > NORM_RTOL:
        raise RuntimeError(f"diff_sq n={n}: rel err {rel}")
    nbytes = 2 * n * a.element_size() + 4
    bound, bound_by = _bound(nbytes, 3 * n, rates)

    def kernel():
        return cada_update.diff_sq_norm_flat(a, b)

    def plain():
        return ref.diff_sq_norm_ref(a, b)

    def library():
        return torch.nn.functional.mse_loss(a, b, reduction="sum")

    lib = library()
    lib_rel = _max_rel(lib, p)
    if lib_rel > NORM_RTOL:
        raise RuntimeError(f"diff_sq n={n}: mse_loss(sum) {float(lib)} is "
                           f"not the plain version's {float(p)}")
    one_launch(kernel, "row_sq_kernel", f"diff_sq n={n}")
    ms, plain_ms, lib_ms = time_ms(kernel), time_ms(plain), time_ms(library)
    dev = device_ms(kernel, ("row_sq_kernel",))
    plain_dev, lib_dev = device_ms(plain), device_ms(library)
    print(f"  diff_sq n={n} {str(dtype)[6:]}: {float(k):.9g} vs plain "
          f"{float(p):.9g} (rel {rel:.3g}), run-to-run identical, one launch "
          f"per call; kernel "
          f"{ms * 1e3:.2f} us/call (device {_us(dev)}), plain "
          f"{plain_ms * 1e3:.2f} us/call (device {_us(plain_dev)}), "
          f"mse_loss(sum) {lib_ms * 1e3:.2f} us/call (device {_us(lib_dev)}, "
          f"rel {lib_rel:.3g}), bound {bound * 1e3:.3f} us ({nbytes} B)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "device_ms": dev, "plain_device_ms": plain_dev,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
            "library_device_ms": lib_dev}


def check_eq3(rows: int, n: int, dtype, rates, gen, plane=None,
              timed: bool = True, calls: int = 50, offset: int = 0,
              zero_rows=()) -> dict:
    """Eq. (3)'s row mean against its plain version on an (rows, n) plane
    drawn from ``gen`` or on ``plane``: bit for bit (``torch.equal`` of the
    bits), the same on two calls, one launch per call. With ``zero_rows``
    those rows are zeroed, and the plane with them dropped must give the
    same bits; with ``offset`` the plane is a view that starts that many
    elements into a buffer (off 16 bytes: the scalar loads) and must also
    give an aligned copy's bits."""
    if plane is None:
        buf = torch.randn(rows * n + offset, generator=gen,
                          device="cuda").to(dtype)
        plane = buf[offset:].view(rows, n)
        if zero_rows:
            plane[list(zero_rows)] = 0.0
    label = (f"eq3_row_mean ({rows},{n}) {_short(plane.dtype)}"
             + (f", a view {offset} element(s) off 16 B" if offset else "")
             + (f", rows {list(zero_rows)} zero" if zero_rows else ""))
    k = cada_update.eq3_row_mean_flat(plane, rows)
    k_again = cada_update.eq3_row_mean_flat(plane, rows)
    p = ref.eq3_row_mean_ref(plane, rows)
    torch.cuda.synchronize()
    if not torch.equal(k, k_again):
        raise RuntimeError(f"{label}: two identical calls differ")
    if not torch.equal(k.view(torch.int32), p.view(torch.int32)):
        raise RuntimeError(f"{label}: not bit-equal to the plain version "
                           f"(max |err| {float((k - p).abs().max())})")
    notes = []
    if zero_rows:
        kept = [r for r in range(rows) if r not in zero_rows]
        dropped = cada_update.eq3_row_mean_flat(plane[kept].contiguous(),
                                                rows)
        if not torch.equal(k.view(torch.int32), dropped.view(torch.int32)):
            raise RuntimeError(f"{label}: the plane without its zero rows "
                               "gives other bits")
        notes.append("bit-equal with the zero rows dropped")
    if offset:
        if cada_update.vector_ok(plane):
            raise RuntimeError(f"{label}: the view is aligned")
        if not torch.equal(k, cada_update.eq3_row_mean_flat(plane.clone(),
                                                            rows)):
            raise RuntimeError(f"{label}: differs from an aligned copy")
        notes.append("bit-equal to an aligned copy's")

    def kernel():
        return cada_update.eq3_row_mean_flat(plane, rows)

    one_launch(kernel, "row_mean_kernel", label)
    head = (f"  {label}: bit-equal to plain, run-to-run identical, one "
            "launch per call" + "".join(f", {x}" for x in notes))
    if not timed:
        print(head)
        return {"max_abs_err": 0.0}
    rcp = float(torch.tensor(1.0) / torch.tensor(float(rows)))

    def plain():
        return ref.eq3_row_mean_ref(plane, rows)

    def library():
        return plane.float().sum(0) * rcp

    lib_err = float((library() - p).abs().max())
    nbytes = rows * n * plane.element_size() + 4 * n
    bound, bound_by = _bound(nbytes, rows * n, rates)
    big = calls < 50
    reps, dcalls = (3, 5) if big else (5, 20)
    ms = time_ms(kernel, calls=calls, repeats=reps)
    plain_ms = time_ms(plain, calls=calls, repeats=reps)
    lib_ms = time_ms(library, calls=calls, repeats=reps)
    dev = device_ms(kernel, ("row_mean_kernel",), calls=dcalls)
    plain_dev = device_ms(plain, calls=dcalls)
    lib_dev = device_ms(library, calls=dcalls)
    print(f"{head}; kernel {ms * 1e3:.2f} us/call (device {_us(dev)}), "
          f"plain {plain_ms * 1e3:.2f} us/call (device {_us(plain_dev)}), "
          f"sum(0)*rcp {lib_ms * 1e3:.2f} us/call (device {_us(lib_dev)}; "
          f"max |diff| to plain {lib_err:.3g}), bound {bound * 1e3:.3f} us "
          f"({nbytes} B; device at {_share(bound, dev)} of it)")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "device_ms": dev, "plain_device_ms": plain_dev,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
            "library_device_ms": lib_dev, "library_max_abs_diff": lib_err}


def check_wire(layout, gen) -> None:
    """The wire compressors are plain PyTorch: on the card they must give
    the CPU's bits (quantizer at 8 and 16 bits, top-k, the sparse round
    trip) at the main path's (10, n_flat) shape."""
    x = torch.randn(M, layout.n_flat, generator=gen, device="cuda")
    x[:, layout.n:] = 0.0
    outs = {f"quantize{b}": (
        flat.per_worker_quantize_dequantize_flat(layout, x, b),
        flat.per_worker_quantize_dequantize_flat(layout, x.cpu(), b))
        for b in (8, 16)}
    sp = flat.per_worker_topk_sparsify_flat(layout, x, 0.1)
    outs["topk"] = (sp, flat.per_worker_topk_sparsify_flat(layout, x.cpu(),
                                                            0.1))
    vals, idx = flat.per_worker_topk_extract_flat(layout, sp, 0.1)
    outs["sparse round trip"] = (
        flat.sparse_rows_to_dense(idx, vals, layout.n_flat), sp)
    for name, (card, want) in outs.items():
        if not torch.equal(card.cpu().view(torch.int32),
                           want.cpu().view(torch.int32)):
            raise RuntimeError(f"wire {name}: the card's bits differ")
    print(f"  wire compressors on the card: {', '.join(outs)} bit-equal to "
          "the CPU's")


def phase_kernels(rates, layout) -> dict:
    n_flat = layout.n_flat
    gen = torch.Generator(device="cuda").manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    main = {"amsgrad": check_amsgrad(n_flat, f32, rates, gen)}
    check_amsgrad(n_flat, bf16, rates, gen)
    check_amsgrad(n_flat, f32, rates, gen, theta_dtype=bf16, grad_dtype=bf16)
    for moments in (f32, bf16):
        check_amsgrad(n_flat, moments, rates, gen, theta_dtype=bf16,
                      grad_dtype=bf16, timed=False)
        check_amsgrad(n_flat, moments, rates, gen, theta_dtype=bf16,
                      offset=1, timed=False)
        check_amsgrad(n_flat, moments, rates, gen, offset=1, timed=False)
        for theta_dtype in (f32, bf16):
            check_amsgrad(48, moments, rates, gen, theta_dtype=theta_dtype,
                          grad_dtype=theta_dtype, timed=False)
    main["batched_diff_sq"] = check_batched(M, n_flat, f32, f32, rates, gen)
    check_batched(M, n_flat, bf16, bf16, rates, gen)
    check_batched(M, n_flat, f32, bf16, rates, gen)
    check_batched(M, 48, f32, f32, rates, gen)
    main["batched_sq"] = check_batched_sq(M, n_flat, f32, rates, gen)
    check_batched_sq(M, n_flat, bf16, rates, gen)
    check_batched_sq(M, 48, f32, rates, gen)
    main["diff_sq"] = check_diff_sq(n_flat, f32, rates, gen)
    check_diff_sq(48, f32, rates, gen)
    main["eq3_row_mean"] = check_eq3(M, n_flat, f32, rates, gen)
    check_eq3(M, n_flat, bf16, rates, gen)
    for dtype in (f32, bf16):
        check_eq3(1, n_flat, dtype, rates, gen, timed=False)
        check_eq3(M, n_flat + 1, dtype, rates, gen, timed=False)
        check_eq3(M, n_flat, dtype, rates, gen, timed=False, offset=1)
        check_eq3(M, n_flat, dtype, rates, gen, timed=False,
                  zero_rows=(1, 4, 5, 9))
    check_wire(layout, gen)
    # the two redesigned kernels at LM widths, where bytes bound them
    print(f"  at LM widths (n = {LM_N}; ({M}, {LM_ROW_N}) planes):")
    main["amsgrad"]["lm_width"] = {
        "fp32": check_amsgrad(LM_N, f32, rates, gen, calls=20),
        "bf16 theta and g": check_amsgrad(LM_N, f32, rates, gen,
                                          theta_dtype=bf16, grad_dtype=bf16,
                                          calls=20)}
    main["batched_sq"]["lm_width"] = check_batched_sq(M, LM_ROW_N, f32, rates,
                                                      gen, calls=20)
    torch.cuda.empty_cache()
    return main


# ------------------------------------------- selective scan, flash attention

def _rel_err(got, want) -> float:
    """max |got − want| / max(1, |want|), in fp64."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / want.abs().clamp_min(1.0)).max())


def _scale_err(got, want) -> float:
    """max |got − want| / max |want|, in fp64."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def _scan_a(g: int, d: int, n: int, headdim: int, per_channel: bool, gen):
    """A as the models pass it: Mamba2's (one value per head of
    ``headdim`` channels, a zero-stride view on N) or Mamba1's dense
    (D, N); one block shared by the groups as a zero-stride view over G."""
    dev = "cuda"
    if per_channel:
        heads = -(-d // headdim)
        a_h = -(1.0 + 15.0 * torch.rand(heads, generator=gen, device=dev))
        a2 = torch.repeat_interleave(a_h, headdim)[:d, None].expand(d, n)
    else:
        a2 = -torch.randn(d, n, generator=gen, device=dev).abs()
    return a2.expand(g, d, n)


def check_scan(g: int, s: int, d: int, n: int, headdim: int, rates, gen,
               timed: bool, per_channel: bool) -> dict:
    """The scan kernel against its plain version on the serving path's
    operand types: dt fp32, x/B/C bf16; A per channel (one value per head
    of ``headdim`` channels as a zero-stride view on N, the served Mamba2
    form) or general (dense, Mamba1). The
    per-channel form must also give the h_final of the same call with A
    materialised (the general form) bit for bit, and its y within
    SCAN_RTOL."""
    dev = "cuda"
    dt = (0.1 * torch.randn(g, s, d, generator=gen, device=dev)).abs()
    x = torch.randn(g, s, d, generator=gen, device=dev).bfloat16()
    a = _scan_a(g, d, n, headdim, per_channel, gen)
    b = torch.randn(g, s, n, generator=gen, device=dev).bfloat16()
    c = torch.randn(g, s, n, generator=gen, device=dev).bfloat16()
    form = "per-channel A" if per_channel else "general A"
    shape = (g, s, d, n)
    y, h = scan_kernel.selective_scan(dt, x, a, b, c)
    y2, h2 = scan_kernel.selective_scan(dt, x, a, b, c)
    yp, hp = ref.selective_scan_ref(dt, x, a, b, c)
    torch.cuda.synchronize()
    if not (torch.equal(y, y2) and torch.equal(h, h2)):
        raise RuntimeError(f"scan {shape} {form}: two identical calls "
                           "differ")
    err = max(_scale_err(y, yp), _scale_err(h, hp))
    if err > SCAN_RTOL:
        raise RuntimeError(f"scan {shape} {form}: error {err} > "
                           f"{SCAN_RTOL}")
    label = f"  selective_scan (G,S,D,N)={shape} {form}, x/B/C bf16"
    note = ""
    am = a[0].contiguous().expand(g, d, n)
    if per_channel:
        ym, hm = scan_kernel.selective_scan(dt, x, am, b, c)
        torch.cuda.synchronize()
        if not torch.equal(h, hm):
            raise RuntimeError(f"scan {shape}: h_final differs from the "
                               "materialised-A call")
        y_gap = _scale_err(y, ym)
        if y_gap > SCAN_RTOL:
            raise RuntimeError(f"scan {shape}: y is {y_gap} from the "
                               "materialised-A call")
        note = (f", h_final bit-equal to the materialised-A call (y "
                f"{'bit-equal' if torch.equal(y, ym) else f'{y_gap:.3g}'})")
    abs_err = float(max((y - yp).abs().max(), (h - hp).abs().max()))
    head = (f"{label}: max err {err:.3g} of the plain arrays' scale, "
            f"run-to-run identical{note}")

    def kernel():
        return scan_kernel.selective_scan(dt, x, a, b, c)

    if not timed:
        dev_ms = device_ms(kernel, ("ssm_scan_kernel",), calls=5)
        print(f"{head}; kernel device {_ms(dev_ms)}")
        return {"max_abs_err": abs_err, "device_ms": dev_ms}
    gsd, gsn, elems = g * s * d, g * s * n, g * s * d * n
    # dt fp32, x bf16, A (one value per channel, or per (channel, state)),
    # B/C bf16; y fp32, h_final fp32
    a_bytes = 4 * d * (1 if per_channel else n)
    nbytes = (4 * gsd + 2 * gsd + a_bytes + 2 * 2 * gsn + 4 * gsd
              + 4 * g * d * n)
    # per (g, t, d, n): decay·h + drive, dx·b, h·c: 3 FMA-class operations
    # (6 flops); one exponential per (g, t, d) or per (g, t, d, n)
    n_exp = gsd if per_channel else elems
    t_bytes, t_flops, t_exp = (nbytes / rates[0], 6 * elems / rates[1],
                               n_exp / SFU_RATE)
    bound = max(t_bytes, t_flops, t_exp) * 1e3
    bound_by = "bytes" if t_bytes >= max(t_flops, t_exp) else "operations"

    def plain():
        return ref.selective_scan_ref(dt, x, a, b, c)

    def materialised():
        return scan_kernel.selective_scan(dt, x, am, b, c)

    ms = time_ms(kernel, calls=10, repeats=3)
    plain_ms = time_ms(plain, calls=1, repeats=3, warmup=1)
    dev_ms = device_ms(kernel, ("ssm_scan_kernel",), calls=5)
    plain_dev = device_ms(plain, calls=1)
    extra = ""
    if per_channel:
        mat_dev = device_ms(materialised, ("ssm_scan_kernel",), calls=5)
        extra = (f"; the same call with A materialised (general form) "
                 f"device {_ms(mat_dev)}")
    print(f"{head}; kernel {ms:.3f} ms/call (device {_ms(dev_ms)}; before "
          f"the redesign {EARLIER_DEVICE_MS['selective_scan']} ms, PERF.md), "
          f"plain "
          f"{plain_ms:.3f} ms/call (device {_ms(plain_dev)}), bound "
          f"{bound:.4f} ms by {bound_by} (bytes {t_bytes * 1e3:.4f}, fp32 "
          f"ops {t_flops * 1e3:.4f}, {n_exp:.3g} exp {t_exp * 1e3:.4f} ms)"
          f"{extra}")
    return {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "device_ms": dev_ms, "plain_device_ms": plain_dev,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None}


def _live_pairs(s: int, window: int) -> int:
    """(query, key) pairs a causal (windowed) attention computes."""
    if not window:
        return s * (s + 1) // 2
    return sum(min(i + 1, window) for i in range(s))


def _bf16_ulps(got, want32):
    """|got − want32| in bf16 ULPs of the fp32 value want32, elementwise;
    the ULP of a want32 of 0 is 2⁻¹³³, bf16's least subnormal (the rule of
    ``tests/test_torch_cuda.py``'s ``_within_bf16_flash``)."""
    _, e = torch.frexp(want32)
    ulp = torch.where(want32 == 0, torch.full_like(want32, 2.0 ** -133),
                      torch.ldexp(torch.ones_like(want32), e - 8))
    return (got.float() - want32).abs() / ulp


def flash_bf16_gaps(out, want, want32) -> tuple[float, int, float]:
    """The bf16 flash check: each element within FLASH_RTOL_BF16 of
    max(1, |plain bf16|) or, where not, a single rounding flip — within
    one bf16 ULP of the plain result computed in fp32 from the same bf16
    inputs (``want32``). Returns (max err of max(1, |plain|), elements
    outside that band, their max distance from ``want32`` in bf16 ULP)."""
    rel = ((out.float() - want.float()).abs()
           / want.float().abs().clamp_min(1.0))
    outside = rel > FLASH_RTOL_BF16
    ulps = _bf16_ulps(out, want32)[outside]
    return (float(rel.max()), int(outside.sum()),
            float(ulps.max()) if ulps.numel() else 0.0)


def check_flash(b: int, s: int, hq: int, hkv: int, hd: int, window: int,
                rates, gen, timed: bool, dtype=torch.bfloat16) -> dict:
    """The flash kernel against its plain version, bf16 (the tensor-core
    instance) or fp32 operands; an hd that is not a compiled instance runs
    zero-padded on the next one. When ``timed``, also its times, its bound
    and the library call's time."""
    dev = "cuda"
    q, k, v = (torch.randn(b, s, h, hd, generator=gen, device=dev).to(dtype)
               for h in (hq, hkv, hkv))
    before = fa_kernel.flash_attention.launches
    out = fa_kernel.flash_attention(q, k, v, window=window)
    again = fa_kernel.flash_attention(q, k, v, window=window)
    want = ref.flash_attention_ref(q, k, v, window=window)
    torch.cuda.synchronize()
    inst = fa_kernel.instance_for(hd)
    label = (f"  flash_attention B={b} S={s} Hq={hq} Hkv={hkv} hd={hd}"
             + ("" if inst == hd else f" (padded to {inst})")
             + f" window={window} {_short(dtype)}")
    if fa_kernel.flash_attention.launches != before + 2:
        raise RuntimeError(f"{label}: the kernel did not launch")
    if out.shape != q.shape or out.dtype != dtype:
        raise RuntimeError(f"{label}: output {tuple(out.shape)} {out.dtype}")
    if not torch.equal(out, again):
        raise RuntimeError(f"{label}: two identical calls differ")
    if dtype == torch.float32:
        err = _rel_err(out, want)
        if err > FLASH_RTOL_F32:
            raise RuntimeError(f"{label}: error {err} of max(1,|plain|) > "
                               f"{FLASH_RTOL_F32}")
        gaps = (f"max err {err:.3g} of max(1,|plain|) (band "
                f"{FLASH_RTOL_F32:.3g})")
    else:
        want32 = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                         window=window)
        err, n_out, ulps = flash_bf16_gaps(out, want, want32)
        gaps = (f"max err {err:.3g} of max(1,|plain|); {n_out} elements "
                f"outside {FLASH_RTOL_BF16:.3g}·max(1,|plain|), at most "
                f"{ulps:.3g} bf16 ULP from the fp32 plain result; "
                f"{int((out != want).sum())} of {out.numel()} elements "
                "differ from the plain bf16 output")
        if ulps > 1.0:
            raise RuntimeError(f"{label}: not only single rounding flips: "
                               f"{gaps}")
    abs_err = float((out.float() - want.float()).abs().max())
    head = f"{label}: {gaps}; run-to-run identical"
    if not timed:
        print(head)
        return {"max_abs_err": abs_err}
    flops = 4 * hd * _live_pairs(s, window) * b * hq
    nbytes = 2 * (2 * b * s * hq * hd + 2 * b * s * hkv * hd)
    t_bytes, t_ops = nbytes / rates[0], flops / BF16_TC_FLOPS
    bound = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def kernel():
        return fa_kernel.flash_attention(q, k, v, window=window)

    def plain():
        return ref.flash_attention_ref(q, k, v, window=window)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=hq != hkv)

    lib_err = _rel_err(library().transpose(1, 2), want)
    ms = time_ms(kernel, calls=10, repeats=3)
    plain_ms = time_ms(plain, calls=2, repeats=3, warmup=1)
    lib_ms = time_ms(library, calls=20, repeats=3)
    dev_ms = device_ms(kernel, ("flash_fwd_kernel",), calls=5)
    plain_dev = device_ms(plain, calls=2)
    lib_dev = device_ms(library, calls=5)
    print(f"{head}; kernel {ms:.3f} ms/call (device {_ms(dev_ms)}; before "
          f"the redesign {EARLIER_DEVICE_MS['flash_attention']} ms, PERF.md), "
          f"plain "
          f"{plain_ms:.3f} ms/call (device {_ms(plain_dev)}), "
          f"scaled_dot_product_attention {lib_ms:.4f} ms/call (device "
          f"{_ms(lib_dev)}, err {lib_err:.3g}), bound {bound:.4f} ms by "
          f"{bound_by} ({flops:.3g} flop at 989 TFLOP/s bf16, {nbytes} B)")
    return {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "device_ms": dev_ms, "plain_device_ms": plain_dev,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
            "library_device_ms": lib_dev}


def phase_lm_kernels(rates) -> dict:
    """The scan and flash kernels at the serving path's shapes (zamba2-2.7b,
    B = 2, S = 2048: scan G = 2, D = 5120, N = 64 with Mamba2's A; flash 32
    heads of 80), then at shapes off that path: the scan with a general A,
    also at falcon-mamba-7b's widths (G = 2, S = 512, D = 8192, N = 16)."""
    cfg = lm_configs.get_config(SERVE_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(2)
    hdim = cfg.mamba_headdim
    main = {"selective_scan": check_scan(
        SERVE_BATCH, SERVE_SEQ, cfg.d_inner, cfg.ssm_state, hdim, rates, gen,
        timed=True, per_channel=True)}
    check_scan(3, 333, 520, 16, hdim, rates, gen, timed=False,
               per_channel=False)
    check_scan(3, 333, 520, 16, hdim, rates, gen, timed=False,
               per_channel=True)
    fm = lm_configs.get_config("falcon-mamba-7b")
    check_scan(SERVE_BATCH, 512, fm.d_inner, fm.ssm_state, hdim, rates, gen,
               timed=False, per_channel=False)
    main["flash_attention"] = check_flash(
        SERVE_BATCH, SERVE_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.hd, 0,
        rates, gen, timed=True)
    check_flash(SERVE_BATCH, SERVE_SEQ, 32, 8, 128, 0, rates, gen,
                timed=False)
    check_flash(SERVE_BATCH, 512, cfg.n_heads, cfg.n_kv_heads, cfg.hd, 100,
                rates, gen, timed=False)
    check_flash(1, 333, 4, 2, 32, 0, rates, gen, timed=False)
    # the head dims of the configs still to be served (hd 64: stablelm-1.6b,
    # musicgen-medium, granite-moe; hd 16: yi-34b's smoke config), and two
    # that run zero-padded on the next instance
    for hd, window in ((16, 0), (64, 0), (64, 100)):
        for dtype in (torch.float32, torch.bfloat16):
            check_flash(2, 333, 8, 2, hd, window, rates, gen, timed=False,
                        dtype=dtype)
    check_flash(2, 333, 8, 2, 48, 0, rates, gen, timed=False)
    check_flash(1, 333, 4, 4, 96, 100, rates, gen, timed=False,
                dtype=torch.float32)
    return main


# -------------------------------------------------------------- main path

def _eval_loss(params, x, y) -> float:
    return float(mlp_loss(params, (x, y)))


def _tensors(x) -> list:
    """Every tensor in a state: NamedTuples, dicts and tensors, walked."""
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if isinstance(x, tuple):
        return [t for v in x for t in _tensors(v)]
    return []


def _all_cuda(state) -> bool:
    return all(t.device.type == "cuda" for t in _tensors(state))


WRAPPERS = {"amsgrad": cada_update.fused_amsgrad_flat,
            "batched_diff_sq": cada_update.batched_diff_sq_norm_flat,
            "batched_sq": cada_update.batched_sq_norm_flat,
            "diff_sq": cada_update.diff_sq_norm_flat,
            "eq3_row_mean": cada_update.eq3_row_mean_flat}


def _counts() -> dict:
    return {name: f.launches for name, f in WRAPPERS.items()}


def _reset_counts() -> None:
    for f in WRAPPERS.values():
        f.launches = 0


def setup_main():
    ds = mnist_like(n=N_DATA)
    x = ds.x.reshape(ds.n, -1)
    mtx = pad_to_matrix(uniform_partition(ds.n, M, seed=0))
    sample = make_sampler(x, ds.y, mtx, BATCH)
    gen = torch.Generator(device="cuda").manual_seed(1)
    draws = [sample(gen) for _ in range(max(
        [SKIP_ROUNDS] + [r for _, r, _ in MAIN_RUNS.values()]))]
    batches = tuple(torch.stack(t) for t in zip(*draws))
    params = mlp_init(torch.Generator().manual_seed(0), *DIMS, device="cuda")
    held_out = (torch.as_tensor(x[:1024], device="cuda"),
                torch.as_tensor(ds.y[:1024], device="cuda"))
    return params, batches, held_out


def _engine(kind: str, impl=None, opt: str = "fused",
            c: float = 1.0) -> CADAEngine:
    """The paper MLP's engine for one rule at its reference defaults, on
    FusedAMSGrad(lr=5e-4) or, as the paper runs lag, on SGD(0.05)."""
    optimizer = FusedAMSGrad(lr=5e-4) if opt == "fused" else sgd(0.05)
    return CADAEngine(mlp_loss, optimizer,
                      CommRule(kind=kind, c=c, d_max=D_MAX,
                               max_delay=MAX_DELAY), M,
                      impl=impl)


def expected_launches(kind: str, rounds: int, opt: str) -> dict:
    """Each kernel's launches in ``rounds`` rounds of one run: the server
    step where FusedAMSGrad serves, the rule's gate norm, no diff_sq, and
    eq. (3)'s row mean once a round (twice for local momentum, whose
    momenta are averaged by it too)."""
    return {"amsgrad": rounds if opt == "fused" else 0,
            "batched_diff_sq": rounds if kind in DIFF_RULES else 0,
            "batched_sq": rounds if kind in SQ_RULES else 0,
            "diff_sq": 0,
            "eq3_row_mean": rounds * (2 if kind == "local_momentum" else 1)}


def skip_c(metrics) -> float:
    """The c at which a c = 1 run's gate would skip about half its
    decisions: the median LHS/RHS over its rounds with a full RHS ring
    (before round d_max the ring's sum is partial and the ratio inflated)."""
    ratio = (metrics["lhs"].double()
             / metrics["rhs"].double()[:, None])[D_MAX:]
    return float(ratio[torch.isfinite(ratio)].median())


def resumes(upload_mask) -> bool:
    """Whether some worker of a (rounds, M) mask uploads in a round after
    one it skipped, so that what a skip carries (the stale worker copy, an
    error-feedback residual) is used again."""
    skipped = (~upload_mask).int().cumsum(0) > 0
    return bool((upload_mask[1:] & skipped[:-1]).any())


def drive(name, kind, rounds, opt, c, card, params, batches, held_out,
          loss0, totals, must_fall: bool = True) -> dict:
    """One run of the main path: exact launch counts, state on the card,
    finite parameters and held-out loss, which must fall where
    ``must_fall``. Returns its metrics."""
    eng = _engine(kind, opt=opt, c=c)
    state = eng.init(params)
    run_batches = tuple(b[:rounds] for b in batches)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    state, metrics = eng.run(state, run_batches)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got, want = _counts(), expected_launches(kind, rounds, opt)
    if got != want:
        raise RuntimeError(f"{name}: launches {got}, expected {want}")
    for k, v in got.items():
        totals[k] += v
    if not _all_cuda(state):
        raise RuntimeError(f"{name}: state left the card")
    if not bool(torch.isfinite(state.params_flat).all()):
        raise RuntimeError(f"{name}: non-finite parameters")
    loss1 = _eval_loss(state.params, *held_out)
    if not math.isfinite(loss1) or (must_fall and not loss1 < loss0):
        raise RuntimeError(f"{name}: held-out loss {loss0} -> {loss1} "
                           "is not finite or did not fall")
    uploads = int(metrics["uploads"].sum())
    print(f"  {name} (c={c:.6g}): {rounds} rounds, {rounds / secs:.1f} "
          f"rounds/s on {card}; held-out loss {loss0:.5f} -> {loss1:.5f}; "
          f"uploads {uploads} / {rounds * M}, "
          f"{float(metrics['bytes_up'].sum()) / rounds:.0f} B up per round; "
          "launches " + ", ".join(f"{k} {v}" for k, v in got.items()))
    return metrics


def phase_main(card: str, params, batches, held_out) -> tuple[dict, dict]:
    """Every run of MAIN_RUNS at c = 1. Each gated rule must, somewhere on
    the card, skip an upload and upload again after it (:func:`resumes`):
    where its c = 1 run does not, it runs again for SKIP_ROUNDS rounds at
    :func:`skip_c` of that run. avp's gate is ±inf, so its c comes from
    lag's run, whose LHS is avp's energy ‖fresh − stale‖² (at c = 1 both
    upload every round, so the two runs are the same run). Returns the
    launch totals and the c at which each gated rule resumed.

    Only the c = 1 runs, each rule at its reference defaults, must lower
    the held-out loss. A rerun at a skipping c need not: while a worker
    skips, the server keeps stepping on its stale aggregate, and
    AMSGrad's normalized steps can carry the loss uphill."""
    loss0 = _eval_loss(params, *held_out)
    totals = dict.fromkeys(WRAPPERS, 0)
    uploads, bytes_per_round, ratio_c, skipping_c = {}, {}, {}, {}
    for name, (kind, rounds, opt) in MAIN_RUNS.items():
        metrics = drive(name, kind, rounds, opt, 1.0, card, params, batches,
                        held_out, loss0, totals)
        uploads[name] = int(metrics["uploads"].sum())
        bytes_per_round[name] = float(metrics["bytes_up"].sum()) / rounds
        if kind == "always":
            continue
        if kind != "avp":
            ratio_c[name] = skip_c(metrics)
        if resumes(metrics["upload_mask"]):
            skipping_c[name] = 1.0
            continue
        c = ratio_c["lag" if kind == "avp" else name]
        metrics = drive(f"{name}@skip", kind, SKIP_ROUNDS, opt, c, card,
                        params, batches, held_out, loss0, totals,
                        must_fall=False)
        if not resumes(metrics["upload_mask"]):
            raise RuntimeError(f"{name}: at c = {c} no worker uploaded "
                               "after a skip")
        skipping_c[name] = c
    if not uploads["cada2"] < uploads["always"]:
        raise RuntimeError(f"cada2 uploaded {uploads['cada2']}, not fewer "
                           f"than always's {uploads['always']}")
    for name in ("laq", "topk"):
        if not bytes_per_round[name] < bytes_per_round["always"]:
            raise RuntimeError(
                f"{name} sent {bytes_per_round[name]} B per round, not fewer "
                f"than always's {bytes_per_round['always']}")
    return totals, skipping_c


def profile_engine(label: str, eng, state, batches, rounds: int,
                   top: int = 8) -> None:
    """Where a round's time goes: device-busy share of the wall time over
    ``rounds`` rounds of ``batches`` from ``state``, and the kernels that
    take most of the device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(state, batches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = sorted(prof.key_averages(),
                    key=lambda e: -getattr(e, "device_time_total", 0))
    busy = sum(getattr(e, "device_time_total", 0) for e in events) / 1e6
    print(f"  {label} profile over {rounds} rounds: wall "
          f"{wall * 1e3 / rounds:.3f} ms/round, device busy "
          f"{busy * 1e3 / rounds:.3f} ms/round ({100 * busy / wall:.1f}%, "
          f"idle {100 - 100 * busy / wall:.1f}%),"
          f" {sum(e.count for e in events) / rounds:.0f} kernels/round")
    for e in events[:top]:
        print(f"    {getattr(e, 'device_time_total', 0) / rounds:9.2f} "
              f"us/round  x{e.count / rounds:.0f}  {e.key[:90]}")


def profile_rounds(kind: str, params, batches, rounds: int = 20) -> None:
    """:func:`profile_engine` over ``rounds`` rounds of ``kind`` on the
    paper MLP after 5 warm-up rounds."""
    eng = _engine(kind)
    state, _ = eng.run(eng.init(params), tuple(b[:5] for b in batches))
    profile_engine(kind, eng, state,
                   tuple(b[5:5 + rounds] for b in batches), rounds)


def _state_pairs(sk, sp) -> tuple[list, list]:
    """(exact, close) (name, kernel's, plain's) pairs of two engine
    states: integer state to compare exactly, float state (θ, ∇, the
    worker plane, every tensor of the server optimizer's state and of the
    rule's extras) within 8 ULP at each array's scale."""
    exact = [("staleness", sk.comm.staleness, sp.comm.staleness)]
    close = [("params_flat", sk.params_flat, sp.params_flat),
             ("nabla", sk.comm.nabla, sp.comm.nabla),
             ("worker_grads", sk.comm.worker_grads, sp.comm.worker_grads)]
    close += [(f"opt_state[{i}]", a, b) for i, (a, b) in enumerate(
        zip(_tensors(sk.opt_state), _tensors(sp.opt_state)))]
    for name, v in sk.comm.extras.items():
        for i, (a, b) in enumerate(zip(_tensors(v),
                                       _tensors(sp.comm.extras[name]))):
            (close if a.is_floating_point() else exact).append(
                (f"{name}[{i}]", a, b))
    return exact, close


def lockstep(label: str, eng_k, eng_p, state, batch_at, rounds: int,
             need_skip: bool = True):
    """``rounds`` rounds stepped by the kernels (``eng_k``) and by the
    plain versions (``eng_p``, which must launch nothing) from the same
    state each round, ``batch_at(i)`` the round's batch: masks equal
    outside MARGIN_BAND (at most one in-band flip), integer state equal,
    float state within 8 ULP at each array's scale, the sums (RHS ring,
    finite LHS) within SUM_RTOL. Where ``need_skip``, some gate decision
    must skip, so the state a skip carries is compared too. Returns the
    kernels' last state."""
    flips = skips = 0
    for i in range(rounds):
        b = batch_at(i)
        before = _counts()
        sp, mp = eng_p.step(state, b)
        if _counts() != before:
            raise RuntimeError("impl='plain' launched a kernel")
        sk, mk = eng_k.step(state, b)
        up_k, up_p = mk["upload_mask"], mp["upload_mask"]
        skips += int((~up_k).sum())
        if not torch.equal(up_k, up_p):
            margin = (mp["lhs"] - mp["rhs"]).abs()
            if bool((margin[up_k != up_p] > MARGIN_BAND * mp["rhs"]).any()):
                raise RuntimeError(f"{label} round {i}: masks differ outside "
                                   f"the band: {up_k} vs {up_p}")
            flips += 1
            state = sk
            continue
        exact, close = _state_pairs(sk, sp)
        for name, a, c in exact:
            if not torch.equal(a, c):
                raise RuntimeError(f"{label} round {i}: {name} differs")
        for name, a, c in close:
            if float((a.float() - c.float()).abs().max()) > ULP_SCALE * float(
                    c.float().abs().max()):
                raise RuntimeError(f"{label} round {i}: {name} differs")
        finite = torch.isfinite(mp["lhs"])
        for name, a, c in (("diff_hist", sk.comm.diff_hist,
                            sp.comm.diff_hist),
                           ("lhs", mk["lhs"][finite], mp["lhs"][finite])):
            if a.numel() and _max_rel(a, c) > SUM_RTOL:
                raise RuntimeError(f"{label} round {i}: {name} differs")
        state = sk
    if flips > 1:
        raise RuntimeError(f"{label}: {flips} rounds flipped a gate")
    if need_skip and skips == 0:
        raise RuntimeError(f"{label}: no gate decision skipped")
    print(f"  {label} kernel vs impl='plain': {rounds} rounds in lockstep, "
          f"{skips} skipped uploads, masks, staleness and integer extras "
          f"equal, float state and extras within 8 ULP, {flips} in-band "
          "flips")
    return state


def phase_lockstep(kind: str, gate_c: float, params, batches) -> None:
    """``kind`` at ``gate_c`` on the paper MLP, kernels against the plain
    versions (:func:`lockstep`)."""
    eng_k = _engine(kind, c=gate_c)
    lockstep(f"{kind} (c={gate_c:.6g})", eng_k,
             _engine(kind, impl="plain", c=gate_c), eng_k.init(params),
             lambda i: tuple(t[i] for t in batches), LOCKSTEP_ROUNDS)


# ----------------------------------------------------------- serving path

LM_WRAPPERS = {"selective_scan": scan_kernel.selective_scan,
               "flash_attention": fa_kernel.flash_attention}


def _lm_counts() -> dict:
    return {name: f.launches for name, f in LM_WRAPPERS.items()}


def _reset_all_counts() -> None:
    _reset_counts()
    for f in LM_WRAPPERS.values():
        f.launches = 0


def _profile(fn, label: str, per: int = 1, top: int = 8) -> tuple:
    """Wall time, device-busy share and the kernels that take most of the
    device time over one call of ``fn`` (which ends in a synchronise).
    Returns the device-busy ms per ``per`` and the profiler's events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = sorted(prof.key_averages(),
                    key=lambda e: -getattr(e, "device_time_total", 0))
    busy = sum(getattr(e, "device_time_total", 0) for e in events) / 1e6
    print(f"  {label}: wall {wall * 1e3 / per:.3f} ms, device busy "
          f"{busy * 1e3 / per:.3f} ms ({100 * busy / wall:.1f}%, idle "
          f"{100 - 100 * busy / wall:.1f}%), "
          f"{sum(e.count for e in events) / per:.0f} kernels")
    for e in events[:top]:
        print(f"    {getattr(e, 'device_time_total', 0) / 1e3 / per:10.3f} "
              f"ms  x{e.count / per:.0f}  {e.key[:90]}")
    return busy * 1e3 / per, events


def _band(got, want, band: float, what: str) -> float:
    """max |got − want| as a share of max |want|; raises above ``band``."""
    got, want = got.double(), want.double()
    share = float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))
    if share > band:
        raise RuntimeError(f"{what}: max |diff| is {share:.3g} of the "
                           f"plain run's scale, above {band:.3g}")
    return share


def _upcast(tree):
    """A copy of a parameter tree with every tensor in fp32."""
    if isinstance(tree, dict):
        return {k: _upcast(v) for k, v in tree.items()}
    return tree.float()


def phase_serve(card: str) -> dict:
    """zamba2-2.7b at full width and depth through the serving entry
    point, B = 2 prompts of S = 2048 random tokens, 32 greedy steps. All
    kernel counts are set to 0 just before and read just after: exactly
    54 scans and 9 flash launches (one prefill), nothing else."""
    cfg = lm_configs.get_config(SERVE_ARCH)
    b, s, steps = SERVE_BATCH, SERVE_SEQ, SERVE_TOKENS
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, 0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _tensors(params))
    if n_params != param_count(cfg):
        raise RuntimeError(f"{n_params} parameters, not {param_count(cfg)}")
    print(f"  {cfg.name} ({cfg.source}): {n_params:,} parameters in "
          f"{cfg.dtype}, drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    prompts = serve.random_prompts(cfg, b, s, 1, "cuda")
    n_attn = cfg.n_layers // cfg.attn_every
    want = {"selective_scan": cfg.n_layers, "flash_attention": n_attn}

    torch.cuda.synchronize()
    _reset_all_counts()
    out = serve.generate(cfg, params, prompts, steps)
    torch.cuda.synchronize()
    got = {**_counts(), **_lm_counts()}
    expect = {**dict.fromkeys(WRAPPERS, 0), **want}
    if got != expect:
        raise RuntimeError(f"serving path: launches {got}, expected {expect}")
    peak = torch.cuda.max_memory_allocated()
    logits, toks = out["prefill_logits"], out["tokens"]
    if logits.shape != (b, cfg.vocab) or toks.shape != (b, steps):
        raise RuntimeError(f"shapes {tuple(logits.shape)}, "
                           f"{tuple(toks.shape)}")
    if not (bool(torch.isfinite(logits.float()).all()) and bool(
            torch.isfinite(out["logits"].float()).all())):
        raise RuntimeError("non-finite logits at full depth")
    if not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
        raise RuntimeError("decoded token ids out of range")
    print(f"  prefill {b}x{s} (first call): {out['prefill_s'] * 1e3:.2f} ms; "
          f"{steps} greedy decode steps in {out['decode_s'] * 1e3:.2f} ms "
          f"({steps * b / out['decode_s']:.2f} tokens/s); peak memory "
          f"{peak / 2**30:.3f} GiB; launches scan {got['selective_scan']}, "
          f"flash {got['flash_attention']} (others 0) on {card}")
    print(f"  logits finite, |max| {float(logits.float().abs().max()):.4f}; "
          f"tokens[0][:8] {toks[0][:8].tolist()}")

    # warm prefill: events around it, then its profile
    max_seq = s + steps
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    _, cache = lm.prefill(cfg, params, prompts, max_seq=max_seq)
    end.record()
    end.synchronize()
    print(f"  prefill {b}x{s} (warm, CUDA events): "
          f"{start.elapsed_time(end):.2f} ms")
    _profile(lambda: lm.prefill(cfg, params, prompts, max_seq=max_seq),
             f"prefill {b}x{s} profile")

    def decode4():
        c = cache
        tok = prompts[:, -1]
        for _ in range(4):
            lg, c = lm.decode_step(cfg, params, c, tok)
            tok = torch.argmax(lg, dim=-1)

    _profile(decode4, "decode step profile (4 steps, per step)", per=4)

    # prefill(S-1) -> decode(1) against prefill(S), the reference's check
    # (tests/test_models_smoke.py, on fp32 configs, rtol = atol = 0.05): in
    # fp32 at full width and depth, the bf16 model's weights upcast. Each
    # call launches exactly what the path says. The served bf16 routes are
    # printed beside it, with their distances from the fp32 logits.
    _reset_all_counts()
    _, short = lm.prefill(cfg, params, prompts[:, :-1], max_seq=s)
    per_prefill = _lm_counts()
    last, _ = lm.decode_step(cfg, params, short, prompts[:, -1])
    torch.cuda.synchronize()
    if per_prefill != want or _lm_counts() != want:
        raise RuntimeError(f"a prefill launched {per_prefill}, a decode "
                           f"step then {_lm_counts()}; expected {want} and "
                           "nothing more")
    del short
    cfg32 = cfg.with_(dtype="float32")
    params32 = _upcast(params)
    full32, _ = lm.prefill(cfg32, params32, prompts, max_seq=s)
    _, short32 = lm.prefill(cfg32, params32, prompts[:, :-1], max_seq=s)
    last32, _ = lm.decode_step(cfg32, params32, short32, prompts[:, -1])
    torch.cuda.synchronize()
    del params32, short32
    diff = (last32 - full32).abs()
    if not bool(torch.isfinite(full32).all()) or bool(
            (diff > DECODE_ATOL + DECODE_RTOL * full32.abs()).any()):
        raise RuntimeError(f"fp32 prefill(S-1)+decode vs prefill(S): max "
                           f"|diff| {float(diff.max())} outside atol "
                           f"{DECODE_ATOL} + rtol {DECODE_RTOL}")
    bf16_pair = float((last.float() - logits.float()).abs().max())
    print(f"  fp32, full width and depth: prefill({s - 1}) + decode(1) vs "
          f"prefill({s}): max |diff| {float(diff.max()):.6f} of logits "
          f"|max| {float(full32.abs().max()):.4f} (band atol {DECODE_ATOL} "
          f"+ rtol {DECODE_RTOL}); argmax equal "
          f"{bool(torch.equal(last32.argmax(-1), full32.argmax(-1)))}")
    print(f"  bf16 (served): the same pair max |diff| {bf16_pair:.4f}, "
          f"argmax equal "
          f"{bool(torch.equal(last.argmax(-1), logits.argmax(-1)))}; "
          f"distance from the fp32 prefill({s}) logits: prefill "
          f"{float((logits.float() - full32).abs().max()):.4f}, "
          f"prefill + decode {float((last.float() - full32).abs().max()):.4f}"
          f"; per prefill {per_prefill}, per decode step 0")
    del params, out, cache

    # the first stage at full width: kernels vs plain, in fp32 (the bf16
    # weights upcast) within STAGE_RTOL_F32 of each array's scale; in bf16,
    # the served dtype, no further apart than bf16 itself moves the plain
    # run from the fp32 one (bf16 turns the kernels' fp32-level gaps into
    # whole-ULP flips that grow layer by layer; see PERF.md)
    stage = cfg.with_(n_layers=cfg.attn_every)
    sp = lm.init_params(stage, 3)
    runs = {}
    for tag, c, p_ in (("bf16", stage, sp),
                       ("fp32", stage.with_(dtype="float32"), _upcast(sp))):
        for impl in (None, "plain"):
            lg, kc = lm.prefill(c, p_, prompts, max_seq=max_seq, impl=impl)
            runs[tag, impl] = {"logits": lg, **{
                f: getattr(kc, f) for f in ("k", "v", "conv", "ssm")}}
    torch.cuda.synchronize()
    f32_shares, bf16_shares = {}, {}
    for name in runs["fp32", None]:
        f32_shares[name] = _band(runs["fp32", None][name],
                                 runs["fp32", "plain"][name], STAGE_RTOL_F32,
                                 f"stage fp32 {name}")
        floor = _band(runs["bf16", "plain"][name],
                      runs["fp32", "plain"][name], float("inf"), "")
        bf16_shares[name] = (_band(runs["bf16", None][name],
                                   runs["bf16", "plain"][name], floor,
                                   f"stage bf16 {name} (vs bf16's own "
                                   "distance from fp32)"), floor)
    print(f"  first stage ({stage.n_layers} Mamba2 layers + the shared "
          "block, full width), kernels vs impl='plain', max |diff| as a "
          "share of the plain array's scale: fp32 " + ", ".join(
              f"{k} {v:.3g}" for k, v in f32_shares.items())
          + f" (band {STAGE_RTOL_F32:.3g}); bf16 " + ", ".join(
              f"{k} {v:.3g} (bf16 vs fp32: {fl:.3g})"
              for k, (v, fl) in bf16_shares.items()))
    return {name: got[name] for name in LM_WRAPPERS}


# ---------------------------------------------------------- training path

def _train_counts() -> dict:
    return {**_counts(), **_lm_counts()}


def _train_launches(kind: str, steps: int) -> dict:
    """Each kernel's launches in ``steps`` trainer steps of one rule: the
    server step every step, the rule's gate norm, eq. (3) as in the engine
    except for a stateless rule (always: the trainer's lean step takes the
    plain mean of the fresh gradients), nothing of serving (the training
    route's attention and scan are plain PyTorch)."""
    want = expected_launches(kind, steps, "fused")
    if strategy_for(CommRule(kind=kind)).stateless:
        want["eq3_row_mean"] = 0
    return {**want, **dict.fromkeys(LM_WRAPPERS, 0)}


def _batch_on_card(tokens) -> dict:
    return trainer.worker_split({"tokens": torch.from_numpy(tokens).to(
        device="cuda", dtype=torch.long)}, TRAIN_M)


def phase_train(card: str, rates) -> tuple[dict, dict]:
    """7a: stablelm-1.6b at full width (4 of 24 layers), cada2, M = 2, 8
    steps of 4 × 2048 tokens; the counts set to 0 just before and read just
    after: exactly one AMSGrad and one two-operand norm launch per step.
    Then the kernels on the trainer's own operands. 7b: every rule kind for
    3 steps at smoke size. Returns the launches of both runs and the
    kernels' times at the trainer's size."""
    cfg = lm_configs.get_config(TRAIN_ARCH).with_(n_layers=TRAIN_LAYERS)
    hp = trainer.TrainHParams(rule=CommRule(kind="cada2", **TRAIN_RULE),
                              lr=TRAIN_LR)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = trainer.init_train_state(cfg, hp, TRAIN_M, 0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _tensors(state.params))
    if not n_params == param_count(cfg) == TRAIN_PARAMS:
        raise RuntimeError(f"{n_params} parameters, not {TRAIN_PARAMS}")
    layout = flat.layout_of(state.params)
    print(f"  {cfg.name} ({cfg.source}) at full width, {cfg.n_layers} of "
          f"24 layers: {n_params:,} parameters in {cfg.dtype} (n_flat "
          f"{layout.n_flat:,}), remat {cfg.remat}, drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s; cada2 {TRAIN_RULE}, M = "
          f"{TRAIN_M}, lr {TRAIN_LR}, {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens")
    step = trainer.make_train_step(cfg, hp, TRAIN_M)
    tokens = make_token_batches(cfg, global_batch=TRAIN_BATCH,
                                seq=TRAIN_SEQ,
                                steps=TRAIN_STEPS + TRAIN_PROFILE_STEPS + 1)
    torch.cuda.synchronize()
    _reset_all_counts()
    step_ms, losses = [], []
    for i in range(TRAIN_STEPS):
        batch = _batch_on_card(tokens[i])
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state, mets = step(state, batch)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(mets["loss"]))
        up = mets["upload_mask"]
        print(f"  step {i}: loss {losses[-1]:.6f}, uploads "
              f"{int(mets['uploads'])}/{TRAIN_M} {up.tolist()}, "
              f"{step_ms[-1]:.2f} ms")
        if i == 0 and not bool(up.all()):
            raise RuntimeError("step 0: not every worker uploaded")
    got, want = _train_counts(), _train_launches("cada2", TRAIN_STEPS)
    if got != want:
        raise RuntimeError(f"training path: launches {got}, expected {want}")
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite losses {losses}")
    if not _all_cuda(state):
        raise RuntimeError("the trainer's state left the card")
    steady = statistics.median(step_ms[1:])
    print(f"  {TRAIN_STEPS} steps: losses finite ({losses[0]:.4f} -> "
          f"{losses[-1]:.4f}); step time median {steady:.2f} ms after the "
          f"first ({step_ms[0]:.2f} ms); peak memory {peak / 2**30:.3f} GiB; "
          "launches " + ", ".join(f"{k} {v}" for k, v in got.items())
          + f" on {card}")

    def two_steps():
        nonlocal state
        for i in range(TRAIN_STEPS, TRAIN_STEPS + TRAIN_PROFILE_STEPS):
            state, _ = step(state, _batch_on_card(tokens[i]))

    busy, events = _profile(two_steps, f"trainer step profile "
                            f"({TRAIN_PROFILE_STEPS} steps, per step)",
                            per=TRAIN_PROFILE_STEPS, top=10)
    groups = dict.fromkeys(TRAIN_KERNEL_GROUPS, 0.0)
    for e in events:
        group = next((g for g, keys in TRAIN_KERNEL_GROUPS.items()
                      if any(k in e.key for k in keys)),
                     "other elementwise")
        groups[group] += getattr(e, "device_time_total", 0) / 1e3 \
            / TRAIN_PROFILE_STEPS
    print(f"  device busy {busy:.3f} ms per step under the profiler against "
          f"{steady:.2f} ms per step by CUDA events without it "
          f"({100 * busy / steady:.1f}% busy); by kind, ms per step: "
          + ", ".join(f"{g} {v:.3f}" for g, v in groups.items()))

    # the kernels on the trainer's own operands: the next step's planes,
    # then the server step on the state it reached
    print("  the two kernels on the trainer's own operands:")
    vgrad, vgrad_per = trainer.make_vgrads(cfg, hp)
    _, fresh, second = flat.eval_two_point(
        strategy_for(hp.rule), layout, state.comm.extras, state.params,
        _batch_on_card(tokens[-1]), TRAIN_M, vgrad=vgrad,
        vgrad_per=vgrad_per, fuse_evals=False)
    sizes = {"batched_diff_sq": check_batched(
        TRAIN_M, layout.n_flat, fresh.dtype, second.dtype, rates, None,
        planes=(fresh, second), calls=8)}
    del fresh, second
    operands = (layout.pack(state.params), state.h, state.vhat,
                flat.nabla_f32(state.comm))
    del state
    torch.cuda.empty_cache()
    sizes["amsgrad"] = check_amsgrad(
        layout.n_flat, operands[1].dtype, rates, None,
        theta_dtype=operands[0].dtype, grad_dtype=operands[3].dtype,
        calls=8, operands=operands, lr=TRAIN_LR)
    del operands
    torch.cuda.empty_cache()

    # 7b: every rule kind at smoke size through the same trainer
    smoke = lm_configs.get_smoke_config(TRAIN_ARCH)
    toks = make_token_batches(smoke, global_batch=TRAIN_BATCH, seq=32,
                              steps=SMOKE_TRAIN_STEPS)
    totals = dict(got)
    per_kind = {}
    for kind in RULES:
        hp_k = trainer.TrainHParams(rule=CommRule(kind=kind, **TRAIN_RULE),
                                    lr=TRAIN_LR)
        st = trainer.init_train_state(smoke, hp_k, TRAIN_M, 0)
        step_k = trainer.make_train_step(smoke, hp_k, TRAIN_M)
        torch.cuda.synchronize()
        _reset_all_counts()
        k_losses = []
        for i in range(SMOKE_TRAIN_STEPS):
            st, mets = step_k(st, _batch_on_card(toks[i]))
            k_losses.append(float(mets["loss"]))
        got_k = _train_counts()
        want_k = _train_launches(kind, SMOKE_TRAIN_STEPS)
        if got_k != want_k:
            raise RuntimeError(f"{kind} at smoke size: launches {got_k}, "
                               f"expected {want_k}")
        if not all(math.isfinite(v) for v in k_losses) or not _all_cuda(st):
            raise RuntimeError(f"{kind} at smoke size: losses {k_losses} "
                               "or the state left the card")
        for k, v in got_k.items():
            totals[k] += v
        per_kind[kind] = got_k
    print(f"  every rule kind, {SMOKE_TRAIN_STEPS} steps at "
          f"{smoke.name} size, M = {TRAIN_M}: losses finite, launches exact "
          "(" + "; ".join(f"{kind} amsgrad {c['amsgrad']}, diff "
                          f"{c['batched_diff_sq']}, sq {c['batched_sq']}"
                          for kind, c in per_kind.items()) + ")")
    return totals, sizes


# ------------------------------------------------ the paper's problems

CKPT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"


def setup_paper(name: str) -> dict:
    """The paper's setup ``name`` on the card: its data, partition, model
    (drawn from seed 0), sampler and the draws of its runs (seed 1): the
    CNN on mnist_like(4096) over 10 equal shards, or logistic regression on
    covtype_like() over 20 shards of random sizes."""
    su = PAPER_SETUPS[name]
    if name == "cnn":
        ds = mnist_like(n=N_DATA)
        shards = uniform_partition(ds.n, su["m"], seed=0)
        params = cnn_init(torch.Generator().manual_seed(0), ds.n_classes,
                          device="cuda")
        loss_fn = cnn_loss
    else:
        ds = covtype_like()
        shards = random_sizes_partition(ds.n, su["m"], seed=0)
        params = logreg_init(None, ds.x.shape[1], ds.n_classes,
                             device="cuda")
        loss_fn = logreg_loss
    sample = make_sampler(ds.x, ds.y, pad_to_matrix(shards), su["batch"])
    gen = torch.Generator(device="cuda").manual_seed(1)
    # enough single-iteration draws for the longest run: the iterations,
    # or a rerun at a skipping c that outlasts the staleness cap
    draws = [sample(gen) for _ in range(max(su["iters"], su["max_delay"]
                                            + su["d_max"]))]
    return {**su, "name": name, "params": params, "loss": loss_fn,
            "draws": tuple(torch.stack(t) for t in zip(*draws)),
            "held_out": (torch.as_tensor(ds.x[:1024], device="cuda"),
                         torch.as_tensor(ds.y[:1024], device="cuda")),
            "sizes": sorted(len(x) for x in shards), "n": ds.n}


def _paper_engine(p: dict, run: str, c: float = 1.0,
                  impl=None) -> CADAEngine:
    """The engine of one of PAPER_RUNS on setup ``p``, as
    ``benchmarks/common.py::run_engine_algo`` builds it: Adam or the
    AMSGrad kernel at the setup's lr, lag on SGD at its lag_lr, the delta
    rules with H local steps at lag_lr and their own servers at lr."""
    kind, opt = PAPER_RUNS[run]
    optimizer = {"adam": lambda: adam(p["lr"]),
                 "sgd": lambda: sgd(p["lag_lr"]),
                 "fused": lambda: FusedAMSGrad(lr=p["lr"]),
                 None: lambda: None}[opt]()
    rule = CommRule(kind=kind, c=c, d_max=p["d_max"],
                    max_delay=p["max_delay"],
                    local_steps=p["h"] if kind in LOCAL_RULES else 1,
                    local_lr=p["lag_lr"], server_lr=p["lr"])
    return CADAEngine(p["loss"], optimizer, rule, p["m"], impl=impl)


def _round_batch(p: dict, run: str, i: int):
    """Round i's batch: draw i, or for a delta rule the H draws of its
    round, (H, M, b, ...) (the draws cycle past the last)."""
    draws = p["draws"]
    if PAPER_RUNS[run][0] in LOCAL_RULES:
        h = p["h"]
        j = i % (draws[0].shape[0] // h)
        return tuple(t[j * h:(j + 1) * h] for t in draws)
    return tuple(t[i % draws[0].shape[0]] for t in draws)


def _paper_batches(p: dict, run: str, rounds: int, start: int = 0):
    return tuple(torch.stack(t) for t in zip(
        *(_round_batch(p, run, i) for i in range(start, start + rounds))))


def _paper_rounds(p: dict, run: str) -> int:
    """Rounds of the setup's iterations: H iterations a round for a delta
    rule."""
    local = PAPER_RUNS[run][0] in LOCAL_RULES
    return p["iters"] // p["h"] if local else p["iters"]


def drive_paper(p: dict, run: str, rounds: int, c: float, card: str,
                totals: dict, label: str | None = None) -> dict:
    """One run on the card: exact launches, state on the card, finite
    losses and parameters. Prints the losses, uploads, grad evals and ms
    per round; returns the metrics."""
    kind, opt = PAPER_RUNS[run]
    label = label or run
    eng = _paper_engine(p, run, c)
    state = eng.init(p["params"])
    batches = _paper_batches(p, run, rounds)
    loss0 = float(p["loss"](state.params, p["held_out"]))
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    state, mets = eng.run(state, batches)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got, want = _counts(), expected_launches(kind, rounds, opt)
    if got != want:
        raise RuntimeError(f"{p['name']} {label}: launches {got}, expected "
                           f"{want}")
    for k, v in got.items():
        totals[k] += v
    if not _all_cuda(state):
        raise RuntimeError(f"{p['name']} {label}: state left the card")
    losses = mets["loss"]
    loss1 = float(p["loss"](state.params, p["held_out"]))
    if not (bool(torch.isfinite(losses).all())
            and bool(torch.isfinite(state.params_flat).all())
            and math.isfinite(loss1)):
        raise RuntimeError(f"{p['name']} {label}: non-finite losses or "
                           "parameters")
    local = kind in LOCAL_RULES
    iters = rounds * (p["h"] if local else 1)
    print(f"  {p['name']} {label} (c={c:.6g}): {rounds} rounds, {iters} "
          f"iterations, {secs * 1e3 / rounds:.2f} ms/round on {card}; loss "
          f"{float(losses[0]):.5f} -> {float(losses[-1]):.5f}, held-out "
          f"{loss0:.5f} -> {loss1:.5f}; uploads "
          f"{int(mets['uploads'].sum())} / {rounds * p['m']}, grad evals "
          f"{int(mets['grad_evals'].sum())}; launches "
          + ", ".join(f"{k} {v}" for k, v in got.items()))
    return mets


def phase_paper(p: dict, card: str, totals: dict) -> dict:
    """8a / 8b: every run of PAPER_RUNS on setup ``p`` at c = 1 for the
    setup's iterations. A gated rule that never skips an upload and
    uploads again after it reruns for max_delay + d_max rounds at
    :func:`skip_c` of its c = 1 run, where it must. Returns each gated
    run's :func:`skip_c`, the c at which about half its decisions skip
    once the RHS ring is full."""
    ratio_c = {}
    for run, (kind, _) in PAPER_RUNS.items():
        mets = drive_paper(p, run, _paper_rounds(p, run), 1.0, card, totals)
        if kind == "always" or kind in LOCAL_RULES:
            if not bool(mets["upload_mask"].all()):
                raise RuntimeError(f"{p['name']} {run}: a worker skipped")
            continue
        ratio_c[run] = c = skip_c(mets)
        if resumes(mets["upload_mask"]):
            continue
        mets = drive_paper(p, run, p["max_delay"] + p["d_max"], c, card,
                           totals, label=f"{run}@skip")
        if not resumes(mets["upload_mask"]):
            raise RuntimeError(f"{p['name']} {run}: at c = {c} no worker "
                               "uploaded after a skip")
    return ratio_c


def _leaf_diffs(a, b) -> list[str]:
    """Paths at which two states differ (tensors by torch.equal)."""
    pa, la = ckpt._flatten_with_paths(a)
    pb, lb = ckpt._flatten_with_paths(b)
    if pa != pb:
        return ["the structure"]
    return [p for p, x, y in zip(pa, la, lb)
            if (not torch.equal(x, y) if torch.is_tensor(x) else x != y)]


def resume_check(p: dict, run: str, c: float) -> None:
    """8d: ``run`` on setup ``p`` for RESUME_ROUNDS rounds straight, and
    for half of them, saved (``repro_torch.checkpoint``), restored into a
    fresh state and run the other half on the same batches: every leaf
    of the two final states equal."""
    eng = _paper_engine(p, run, c)
    half = RESUME_ROUNDS // 2
    first = _paper_batches(p, run, half)
    second = _paper_batches(p, run, half, start=half)
    both = tuple(torch.cat([a, b]) for a, b in zip(first, second))
    straight, _ = eng.run(eng.init(p["params"]), both)
    mid, _ = eng.run(eng.init(p["params"]), first)
    path = CKPT_DIR / f"{p['name']}-{run}" / f"step_{half}"
    ckpt.save(str(path), mid, step=mid.step, flat_meta=eng._layout)
    back, step = ckpt.restore(str(path), eng.init(p["params"]))
    if step != half or back.step != half or not _all_cuda(back):
        raise RuntimeError(f"{p['name']} {run}: restored step {step}, "
                           "or the state is not on the card")
    if _leaf_diffs(back, mid):
        raise RuntimeError(f"{p['name']} {run}: the restored state differs "
                           f"at {_leaf_diffs(back, mid)}")
    resumed, _ = eng.run(back, second)
    diffs = _leaf_diffs(resumed, straight)
    if diffs:
        raise RuntimeError(f"{p['name']} {run}: {RESUME_ROUNDS} rounds "
                           f"straight and resumed after {half} differ at "
                           f"{diffs}")
    n_leaves = len(ckpt._flatten_with_paths(straight)[1])
    print(f"  {p['name']} {run} (c={c:.6g}): {RESUME_ROUNDS} rounds straight "
          f"and {half} + save/restore + {half} equal in all {n_leaves} "
          "leaves")


def _repeat_diffs(p: dict, run: str, c: float) -> list[str]:
    """Where two runs of RESUME_ROUNDS rounds from the same state differ
    (cuDNN may pick a convolution backward whose sums are taken in a
    run-dependent order)."""
    eng = _paper_engine(p, run, c)
    batches = _paper_batches(p, run, RESUME_ROUNDS)
    a, _ = eng.run(eng.init(p["params"]), batches)
    b, _ = eng.run(eng.init(p["params"]), batches)
    return _leaf_diffs(a, b)


def _batch_on_card_h(tokens, h: int) -> dict:
    return trainer.worker_split({"tokens": torch.from_numpy(tokens).to(
        device="cuda", dtype=torch.long)}, TRAIN_M, local_steps=h)


def delta_run(cfg, tokens, kind: str, local_lr: float, steps: int):
    """``steps`` trainer steps of the delta rule ``kind`` on ``cfg`` from a
    fresh state (H = DELTA_H local steps at ``local_lr``, M = TRAIN_M, the
    AMSGrad server step at TRAIN_LR), step i on ``tokens[i]``, every
    launch count set to 0 just before the first step. Raises where a
    worker skipped. Returns (hparams, state, step, losses, ms per step)."""
    hp = trainer.TrainHParams(rule=CommRule(kind=kind, local_steps=DELTA_H,
                                            local_lr=local_lr, **TRAIN_RULE),
                              lr=TRAIN_LR)
    state = trainer.init_train_state(cfg, hp, TRAIN_M, 0)
    step = trainer.make_train_step(cfg, hp, TRAIN_M)
    torch.cuda.synchronize()
    _reset_all_counts()
    step_ms, losses = [], []
    for i in range(steps):
        batch = _batch_on_card_h(tokens[i], DELTA_H)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state, mets = step(state, batch)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(mets["loss"]))
        if not bool(mets["upload_mask"].all()):
            raise RuntimeError(f"{kind} step {i}: a worker skipped")
    return hp, state, step, losses, step_ms


def step_wire(step, state, batch):
    """One more trainer step, with eq. (3)'s dispatch wrapped for its
    length: returns (the new state, the (M, n_flat) wire plane that the
    step fed to eq. (3), and what the kernel gave the step for it)."""
    real, seen = kops.eq3_row_mean, []

    def capture(plane, m_total, *, impl=None, shard=None):
        out = real(plane, m_total, impl=impl, shard=shard)
        if m_total == TRAIN_M and not seen:   # the wire; momenta take 1
            seen.append((plane, out))
        return out

    kops.eq3_row_mean = capture
    try:
        state, _ = step(state, batch)
    finally:
        kops.eq3_row_mean = real
    if not seen:
        raise RuntimeError("the step never called eq. (3) on its wire")
    return (state, *seen[0])


def phase_train_delta(card: str, rates) -> tuple[dict, dict]:
    """8e: phase 7's model and cut (stablelm-1.6b at full width, 4 of 24
    layers) trained by local_momentum and fedadam, H = 2 local steps at
    local lr DELTA_LOCAL_LR, M = 2, 4 × 2048 tokens a step (b_m = 1),
    DELTA_STEPS steps each, and a profile of one more step; the
    counts set to 0 just before each run and read just after: one AMSGrad
    launch a step, eq. (3) once a step (twice for local momentum), no row
    norm. Then one more step whose own (2, n_flat) wire plane is taken
    from eq. (3)'s dispatch: the step's result and the kernel, on that
    plane, bit for bit against the plain version. Returns the launches
    and the kernel's numbers at that size."""
    cfg = lm_configs.get_config(TRAIN_ARCH).with_(n_layers=TRAIN_LAYERS)
    tokens = make_token_batches(cfg, global_batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                steps=DELTA_STEPS + 2)
    totals = dict.fromkeys({**WRAPPERS, **LM_WRAPPERS}, 0)
    size = None
    for kind in LOCAL_RULES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _, state, step, losses, step_ms = delta_run(
            cfg, tokens, kind, DELTA_LOCAL_LR, DELTA_STEPS)
        got, want = _train_counts(), _train_launches(kind, DELTA_STEPS)
        if got != want:
            raise RuntimeError(f"8e {kind}: launches {got}, expected {want}")
        for k, v in got.items():
            totals[k] += v
        peak = torch.cuda.max_memory_allocated()
        if not all(math.isfinite(v) for v in losses) or not _all_cuda(state):
            raise RuntimeError(f"8e {kind}: losses {losses}, or the state "
                               "left the card")
        def one_step():
            nonlocal state
            state, _ = step(state, _batch_on_card_h(tokens[DELTA_STEPS],
                                                    DELTA_H))

        print(f"  {cfg.name}, {cfg.n_layers} of 24 layers, {kind} H = "
              f"{DELTA_H}, M = {TRAIN_M}, {DELTA_STEPS} steps of "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens: losses "
              + ", ".join(f"{v:.4f}" for v in losses)
              + f"; ms per step " + ", ".join(f"{v:.2f}" for v in step_ms)
              + f" (median after the first "
              f"{statistics.median(step_ms[1:]):.2f}); peak memory "
              f"{peak / 2**30:.3f} GiB; launches "
              + ", ".join(f"{k} {v}" for k, v in got.items()) + f" on {card}")
        _profile(one_step, f"{kind} step profile (one step)", top=6)
        if size is None:
            state, wire, out = step_wire(
                step, state, _batch_on_card_h(tokens[DELTA_STEPS + 1],
                                              DELTA_H))
            want = ref.eq3_row_mean_ref(wire, TRAIN_M)
            if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
                raise RuntimeError(
                    f"8e {kind}: the step's eq. (3) result differs from the "
                    f"plain version on its own wire plane (max |err| "
                    f"{float((out - want).abs().max())})")
            del out, want
            torch.cuda.empty_cache()
            print(f"  eq. (3) on the ({TRAIN_M}, {wire.shape[1]}) wire plane "
                  f"that a {kind} step fed it: the step's result bit-equal "
                  "to the plain version's")
            size = check_eq3(TRAIN_M, wire.shape[1], wire.dtype, rates, None,
                             plane=wire, calls=EQ3_TRAINER_CALLS)
            del wire
        del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return totals, size


def phase_paper_all(card: str, rates) -> tuple[dict, dict]:
    """Phase 8: 8a the CNN and 8b covtype with the six algorithms and
    cada2 on the AMSGrad kernel; 8c kernels against plain end to end; 8d
    resume from a checkpoint; 8e the LM trainer with the delta rules.
    Returns the launches and eq. (3)'s numbers at the trainer's size."""
    totals = dict.fromkeys({**WRAPPERS, **LM_WRAPPERS}, 0)
    cnn, cov = setup_paper("cnn"), setup_paper("covtype")
    n_cnn = sum(t.numel() for t in _tensors(cnn["params"]))
    print(f"  8a paper CNN (benchmarks/paper_nn.py): {n_cnn:,} parameters, "
          f"mnist_like({cnn['n']}), M = {cnn['m']} equal shards, batch "
          f"{cnn['batch']}, d_max {cnn['d_max']}, max_delay "
          f"{cnn['max_delay']}, H = {cnn['h']} for the delta rules")
    if n_cnn != 54_314:
        raise RuntimeError(f"the CNN has {n_cnn} parameters, not 54,314")
    ratio_cnn = phase_paper(cnn, card, totals)
    print(f"  8b paper covtype logreg (benchmarks/paper_logreg.py): "
          f"covtype_like({cov['n']}), M = {cov['m']} shards of sizes "
          f"{cov['sizes'][0]}..{cov['sizes'][-1]}, batch {cov['batch']}, "
          f"lr {cov['lr']}, H = {cov['h']}, d_max {cov['d_max']}, "
          f"max_delay {cov['max_delay']}")
    phase_paper(cov, card, totals)
    # where a round's time goes: cada2 on the kernel (10 rounds) and the
    # delta rules (2 rounds of H local steps) on the CNN, after 2 rounds
    for run, rounds in (("cada2-fused", 10), ("local_momentum", 2),
                        ("fedadam", 2)):
        eng = _paper_engine(cnn, run)
        state, _ = eng.run(eng.init(cnn["params"]),
                           _paper_batches(cnn, run, 2))
        profile_engine(f"cnn {run}", eng, state,
                       _paper_batches(cnn, run, rounds, start=2), rounds,
                       top=5)

    print("  8c kernels against impl='plain', end to end:")
    # cada2 at the c where about half its decisions skip, so the state a
    # skip carries is compared within the 30 rounds
    checked = ((cnn, "cada2-fused", ratio_cnn["cada2-fused"]),
               (cov, "local_momentum", 1.0))
    for p, run, c in checked:
        diffs = _repeat_diffs(p, run, c)
        if diffs:
            print(f"  two runs of {p['name']} {run} from one state differ "
                  f"at {diffs[:4]}: cuDNN's deterministic algorithms on for "
                  "8c and 8d")
            torch.backends.cudnn.deterministic = True
            diffs = _repeat_diffs(p, run, c)
            if diffs:
                raise RuntimeError(f"{p['name']} {run}: two runs still "
                                   f"differ at {diffs[:4]}")
    try:
        for p, run, c in checked:
            eng_k = _paper_engine(p, run, c)
            lockstep(f"{p['name']} {run} (c={c:.6g})", eng_k,
                     _paper_engine(p, run, c, impl="plain"),
                     eng_k.init(p["params"]),
                     lambda i, p=p, run=run: _round_batch(p, run, i),
                     PAPER_LOCKSTEP_ROUNDS,
                     need_skip=PAPER_RUNS[run][0] not in LOCAL_RULES)
        print("  8d resume from a checkpoint:")
        for p, run, c in checked:
            resume_check(p, run, c)
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    del cnn, cov
    print("  8e the LM trainer with the delta rules at full width:")
    train_totals, size = phase_train_delta(card, rates)
    for k, v in train_totals.items():
        totals[k] += v
    return totals, size


# --------------------------------------------------------- the cohort plane

def _mem_gib() -> tuple[float, float]:
    """(MemTotal, MemAvailable) of the host in GiB, from /proc/meminfo."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            info[key] = int(val.split()[0]) * 1024
    return info["MemTotal"] / 2**30, info["MemAvailable"] / 2**30


def _same_run(a, b, label: str) -> None:
    """Two cohort runs' (state, pool, metrics) bit for bit: every state
    tensor, every pool plane, every metric; raises naming the first
    difference."""
    (sa, pa, ma), (sb, pb, mb) = a, b
    if sa.step != sb.step or len(ma) != len(mb):
        raise RuntimeError(f"{label}: steps {sa.step}/{sb.step}, "
                           f"{len(ma)}/{len(mb)} rounds of metrics")
    ta, tb = _tensors(sa), _tensors(sb)
    if len(ta) != len(tb):
        raise RuntimeError(f"{label}: states of different structure")
    for i, (x, y) in enumerate(zip(ta, tb)):
        if not torch.equal(x, y):
            raise RuntimeError(f"{label}: state tensor {i} {tuple(x.shape)} "
                               "differs")
    for name in pa.plane_order:
        if not torch.equal(pa.planes[name], pb.planes[name]):
            raise RuntimeError(f"{label}: pool plane {name} differs")
    for i, (x, y) in enumerate(zip(ma, mb)):
        for key in x:
            if not np.array_equal(x[key], y[key]):
                raise RuntimeError(f"{label}: metric {key} of round {i} "
                                   "differs")


def _cohort_rule(kind: str, c: float) -> CommRule:
    kw = (dict(local_steps=COHORT_H, local_lr=COHORT_LOCAL_LR,
               server_lr=COHORT_SERVER_LR) if kind in LOCAL_RULES else {})
    return CommRule(kind=kind, c=c, d_max=D_MAX, max_delay=MAX_DELAY, **kw)


def _cohort_engine(kind: str, m: int, c: float,
                   fuse_evals: bool | None = None) -> CADAEngine:
    """The paper MLP's engine at M = ``m``: FusedAMSGrad(5e-4) for the
    gradient rules, their own servers for the delta rules; ``fuse_evals``
    as ``CADAEngine`` takes it (None: the engine's default, stacked)."""
    return CADAEngine(mlp_loss, (None if kind in LOCAL_RULES
                                 else FusedAMSGrad(lr=5e-4)),
                      _cohort_rule(kind, c), m, fuse_evals=fuse_evals)


def setup_cohort(m: int, c: int, rounds: int, n_data: int, seed: int,
                 h: int = 1):
    """mnist_like(n_data) in M equal shards, the paper MLP drawn from seed
    0, a (rounds, C) cohort schedule from ``seed`` and each round's cohort
    batch (BATCH samples a worker, (H, C, ...) for H > 1) drawn on the
    card from ``make_cohort_sampler`` before any run, so every run of a
    comparison takes the same batches."""
    ds = mnist_like(n=n_data)
    x = ds.x.reshape(ds.n, -1)
    mtx = pad_to_matrix(uniform_partition(ds.n, m, seed=0))
    sample = make_cohort_sampler(x, ds.y, mtx, BATCH)
    cohorts = sample_cohorts(m, c, rounds, seed=seed)
    cohorts_dev = torch.as_tensor(cohorts, dtype=torch.long, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batches = []
    for i in range(rounds):
        draws = [sample(gen, cohorts_dev[i]) for _ in range(h)]
        batches.append(draws[0] if h == 1 else tuple(
            torch.stack(t) for t in zip(*draws)))
    params = mlp_init(torch.Generator().manual_seed(0), *DIMS,
                      device="cuda")
    return dict(params=params, cohorts=cohorts, batches=batches,
                mtx_shape=mtx.shape)


def drive_cohort(eng, p: dict, pipeline: bool, rounds: int | None = None,
                 **kw):
    """One cohort run from a fresh state over ``p``'s schedule, every
    launch count set to 0 just before and read just after. Returns
    ((state, pool, metrics), launches, seconds)."""
    rounds = rounds or len(p["cohorts"])
    state, pool = eng.init_cohort(p["params"], **kw.pop("init", {}))
    torch.cuda.synchronize()
    _reset_all_counts()
    t0 = time.perf_counter()
    state, mets = eng.run_cohort(state, pool, p["batches"][:rounds],
                                 p["cohorts"][:rounds], pipeline=pipeline,
                                 **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return (state, pool, mets), _counts(), secs


def phase_cohort_kinds(card: str, skipping_c: dict, totals: dict) -> dict:
    """9a: every rule kind on the engine's cohort plane at the paper MLP's
    width (M = 256, C = 32, 40 rounds), serial and pipelined: bit for bit
    equal, exact launches per round, ledger totals equal to the summed
    bytes_up. Returns the cada2 runs' (setup, serial run) for 9e."""
    p = setup_cohort(COHORT_M, COHORT_C, COHORT_ROUNDS, N_DATA, seed=11)
    pd = setup_cohort(COHORT_M, COHORT_C, COHORT_ROUNDS, N_DATA, seed=11,
                      h=COHORT_H)
    print(f"  9a paper MLP {DIMS} (n_flat {flat.layout_of(p['params']).n_flat:,}),"
          f" mnist_like({N_DATA}) in {COHORT_M} shards, C = {COHORT_C}, "
          f"batch {BATCH}, {COHORT_ROUNDS} rounds of sample_cohorts; the "
          f"delta rules H = {COHORT_H} on their own servers")
    # warm-up: the first cohort run allocates the pinned slots and the
    # allocator's blocks; no run below is timed with them
    drive_cohort(_cohort_engine("always", COHORT_M, 1.0), p, False, rounds=2)
    keep = None
    for kind in KINDS:
        c = skipping_c.get(kind, 1.0)
        setup = pd if kind in LOCAL_RULES else p
        runs, secs = {}, {}
        for pipeline in (False, True):
            eng = _cohort_engine(kind, COHORT_M, c)
            runs[pipeline], got, secs[pipeline] = drive_cohort(
                eng, setup, pipeline)
            want = expected_launches(
                kind, COHORT_ROUNDS,
                "own" if kind in LOCAL_RULES else "fused")
            if got != want:
                raise RuntimeError(f"9a {kind} pipeline={pipeline}: "
                                   f"launches {got}, expected {want}")
            for k, v in got.items():
                totals[k] += v
            mets = runs[pipeline][2]
            led = CommLedger.for_strategy(eng.strategy)
            for met in mets:
                led.observe_round(met)
            if (led.uploads != sum(int(m["uploads"]) for m in mets)
                    or led.bytes_up != sum(float(m["bytes_up"])
                                           for m in mets)):
                raise RuntimeError(f"9a {kind}: the ledger's totals differ "
                                   "from the summed round metrics")
            if not all(math.isfinite(float(m["loss"])) for m in mets):
                raise RuntimeError(f"9a {kind}: non-finite loss")
            if not _all_cuda(runs[pipeline][0]):
                raise RuntimeError(f"9a {kind}: the state left the card")
        _same_run(runs[True], runs[False], f"9a {kind} pipelined vs serial")
        mets = runs[True][2]
        uploads = sum(int(m["uploads"]) for m in mets)
        print(f"  {kind} (c={c:.6g}): pipelined = serial bit for bit; "
              f"{uploads} uploads, {COHORT_ROUNDS * COHORT_C - uploads} "
              f"skips, {led.bytes_up:.0f} B up (ledger = metrics); ms per "
              f"round serial {secs[False] * 1e3 / COHORT_ROUNDS:.3f}, "
              f"pipelined {secs[True] * 1e3 / COHORT_ROUNDS:.3f}; launches "
              "per run " + ", ".join(f"{k} {v}" for k, v in got.items())
              + f" on {card}")
        if kind == "cada2":
            keep = (p, c, runs[False])
        del runs
    return keep


def pcie_rates() -> tuple[float, float]:
    """Pinned host ↔ card copy rates in bytes/s (256 MiB, CUDA events,
    median of 5)."""
    n = 1 << 26
    host = torch.empty(n, dtype=torch.float32, pin_memory=True)
    dev = torch.empty(n, dtype=torch.float32, device="cuda")
    h2d = time_ms(lambda: dev.copy_(host, non_blocking=True), calls=3,
                  repeats=5, warmup=2)
    d2h = time_ms(lambda: host.copy_(dev, non_blocking=True), calls=3,
                  repeats=5, warmup=2)
    return 4 * n / (h2d * 1e-3), 4 * n / (d2h * 1e-3)


def _intervals(events, pred) -> list:
    return sorted((e.time_range.start, e.time_range.end) for e in events
                  if pred(e.name))


def _merge(iv: list) -> list:
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap_us(iv: list, union: list) -> float:
    """Microseconds of the intervals ``iv`` that lie inside ``union``."""
    tot = 0.0
    for s, e in iv:
        for us, ue in union:
            if ue <= s:
                continue
            if us >= e:
                break
            tot += min(e, ue) - max(s, us)
    return tot


def profile_cohort(eng, p: dict, rounds: int, row_bytes: int,
                   rates: tuple, card: str) -> None:
    """A profile of ``rounds`` pipelined rounds (after the state of a
    fresh init): device-busy share, the H2D and D2H copies' time against
    their bytes over the measured PCIe rates, and how much of the copy
    time overlaps a kernel."""
    from torch.profiler import ProfilerActivity, profile
    state, pool = eng.init_cohort(p["params"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run_cohort(state, pool, p["batches"][:rounds],
                       p["cohorts"][:rounds], pipeline=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    h2d = _intervals(evs, lambda n: "HtoD" in n)
    d2h = _intervals(evs, lambda n: "DtoH" in n)
    kern = _merge(_intervals(evs, lambda n: "Memcpy" not in n
                             and "Memset" not in n))
    busy = sum(e - s for s, e in _merge(sorted(h2d + d2h + [
        tuple(k) for k in kern])))
    kbusy = sum(e - s for s, e in kern)
    # the block copies: the ``rounds`` longest of each direction (the rest
    # are the schedule's upload and the metrics' fetches)
    blocks = {"H2D": sorted(h2d, key=lambda iv: iv[0] - iv[1])[:rounds],
              "D2H": sorted(d2h, key=lambda iv: iv[0] - iv[1])[:rounds]}
    print(f"  9b profile of {rounds} pipelined rounds: wall "
          f"{wall * 1e3 / rounds:.3f} ms/round, device busy (kernels and "
          f"copies) {busy / 1e3 / rounds:.3f} ms/round "
          f"({100 * busy / 1e6 / wall:.1f}%, idle "
          f"{100 - 100 * busy / 1e6 / wall:.1f}%), kernels alone "
          f"{kbusy / 1e3 / rounds:.3f} ms/round on {card}")
    for (name, iv), rate in zip(blocks.items(), rates):
        per = [e - s for s, e in iv]
        if not per:
            raise RuntimeError(f"9b: the profiler recorded no {name} copy")
        print(f"    {name} block copies: {len(per)}, median "
              f"{statistics.median(per) / 1e3:.4f} ms for {row_bytes:,} B "
              f"(over the measured {rate / 1e9:.2f} GB/s: "
              f"{row_bytes / rate * 1e3:.4f} ms); "
              f"{100 * _overlap_us(iv, kern) / sum(per):.1f}% of their time "
              "overlaps a kernel")


def phase_federated(card: str, c_cada2: float, totals: dict) -> Tracer:
    """9b: cada2 on FusedAMSGrad at M = 10⁴, C = 64, the paper MLP on
    mnist_like(20,000) in shards of 2; 30 rounds serial, pipelined, and
    pipelined over a memmap pool in a directory the phase removes: the
    three bit-equal, nothing O(M·n) on the card. Returns the pipelined
    RAM run's trace."""
    p = setup_cohort(FED_M, FED_C, FED_ROUNDS, FED_DATA, seed=21)
    n_flat = flat.layout_of(p["params"]).n_flat
    if p["mtx_shape"] != (FED_M, FED_DATA // FED_M):
        raise RuntimeError(f"9b: shards {p['mtx_shape']}")
    rates = pcie_rates()
    print(f"  9b federated: M = {FED_M:,}, C = {FED_C}, mnist_like"
          f"({FED_DATA:,}) in shards of {FED_DATA // FED_M}, batch {BATCH}, "
          f"cada2 (c={c_cada2:.6g}) on FusedAMSGrad(5e-4), {FED_ROUNDS} "
          f"rounds; pinned copies measured at {rates[0] / 1e9:.2f} GB/s "
          f"H2D, {rates[1] / 1e9:.2f} GB/s D2H on {card}")
    trace = Tracer()
    runs, secs = {}, {}
    POOL_DIR.mkdir(parents=True, exist_ok=True)
    try:
        for label, pipeline, kw in (
                ("serial", False, {}),
                ("pipelined", True, {"trace": trace}),
                ("pipelined, memmap", True,
                 {"init": {"pool_storage": "memmap",
                           "pool_path": str(POOL_DIR)}})):
            eng = _cohort_engine("cada2", FED_M, c_cada2)
            gc.collect()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            run, got, secs[label] = drive_cohort(eng, p, pipeline, **kw)
            rise = torch.cuda.max_memory_allocated() - base
            state, pool, mets = run
            want = expected_launches("cada2", FED_ROUNDS, "fused")
            if got != want:
                raise RuntimeError(f"9b {label}: launches {got}, expected "
                                   f"{want}")
            for k, v in got.items():
                totals[k] += v
            if pool.device_row_bytes(FED_C) != FED_C * n_flat * 4:
                raise RuntimeError("9b: device_row_bytes")
            if pool.nbytes != FED_M * n_flat * 4:
                raise RuntimeError("9b: the pool's bytes")
            planes = [t for t in _tensors(state) if t.dim() >= 2
                      and t.shape[0] == FED_M and t.shape[-1] == n_flat]
            if planes or rise >= pool.nbytes:
                raise RuntimeError(f"9b {label}: an O(M·n) tensor on the "
                                   f"card ({planes}, peak rise {rise} B)")
            if int(mets[0]["uploads"]) != FED_C or not all(
                    math.isfinite(float(m["loss"])) for m in mets):
                raise RuntimeError(f"9b {label}: round 0 uploads "
                                   f"{int(mets[0]['uploads'])}, or a loss "
                                   "is not finite")
            print(f"    {label}: {secs[label] * 1e3 / FED_ROUNDS:.3f} ms per "
                  f"round; pool {pool.nbytes:,} B ({pool.storage}, resident "
                  f"{pool.resident_nbytes:,} B, mapped "
                  f"{pool.mapped_nbytes:,} B), a round's rows "
                  f"{pool.device_row_bytes(FED_C):,} B; peak device memory "
                  f"rise {rise / 2**20:.1f} MiB; uploads "
                  f"{sum(int(m['uploads']) for m in mets)} on {card}")
            runs[label] = run
            if label != "serial":
                _same_run(run, runs["serial"], f"9b {label} vs serial")
            del run, state, pool, mets
            if label != "serial":
                runs.pop(label)
                gc.collect()
    finally:
        shutil.rmtree(POOL_DIR, ignore_errors=True)
    print("    the three runs are bit-equal (state, pool, metrics)")
    agg = trace.aggregate("pipeline")
    print("    pipeline track (host clock) of the pipelined run: " + "; ".join(
        f"{name} x{a['count']} {a['total_s'] * 1e3 / a['count']:.3f} ms "
        f"mean, {a['max_s'] * 1e3:.3f} max" for name, a in agg.items())
        + f" on {card}")
    del runs
    gc.collect()
    profile_cohort(_cohort_engine("cada2", FED_M, c_cada2), p,
                   FED_PROFILE_ROUNDS, FED_C * n_flat * 4, rates, card)
    return trace


def _dense_to_cohort(eng, st):
    """A dense engine state as the cohort plane's (state, pool): the
    worker planes to a host pool, the rest as it is."""
    pooled = eng.strategy.pooled_extras()
    planes = {"worker_grads": st.comm.worker_grads.cpu()}
    planes.update({n: st.comm.extras[n].cpu() for n in pooled})
    server = flat.CohortServerState(
        nabla=st.comm.nabla, staleness=st.comm.staleness,
        diff_hist=st.comm.diff_hist,
        extras={k: v for k, v in st.comm.extras.items() if k not in pooled})
    pool = flat.WorkerPool(planes)
    eng._adopt_pool(pool)
    return CohortEngineState(step=st.step, params=st.params,
                             opt_state=st.opt_state, server=server,
                             params_flat=st.params_flat), pool


def _recording(fn, log):
    def f(params, batch):
        out = fn(params, batch)
        log.append(out)
        return out
    return f


def _replaying(log, idx):
    calls = iter(log)

    def f(params, batch):
        losses, grads = next(calls)
        return losses[idx], {k: v[idx] for k, v in grads.items()}
    return f


def _gap_share(a, b) -> float:
    """max |a − b| as a share of max |b|."""
    d = float((a.double() - b.double()).abs().max())
    return d / max(float(b.double().abs().max()), 1e-30)


def _diff_report(pairs) -> list[str]:
    """'name max|Δ| (share of max|b|)' of the pairs that are not
    bit-equal."""
    return [f"{name} {float((a.double() - b.double()).abs().max()):.3g} "
            f"({_gap_share(a, b):.3g} of scale)"
            for name, a, b in pairs if not torch.equal(a, b)]


def _kernel_names(fn) -> list[str]:
    """The device kernels one call of ``fn`` launches, by name (the call
    once before, so that no first-call set-up is counted; a window that
    recorded no kernel is profiled once more)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return sorted(set(names))


def _row_count_probe(eng, params, x, y, co, idx) -> None:
    """Which op of the stacked evaluation gives other bits for the
    cohort's workers at C·b rows than at M·b rows. The stacked evaluation
    runs ``vgrad_per`` over 2·M (or 2·C) per-worker points, so each of
    the MLP's products is a batched GEMM over the points: the evaluation
    at θ for every point leaf by leaf, then its products on the same rows
    (the forward x·W1 and h·W2, and the weight gradient xᵀ·δ), each with
    the device kernels it launches at both point counts."""
    m, c = x.shape[0], len(co)
    x2, y2 = torch.cat([x, x]), torch.cat([y, y])
    xc2, yc2 = torch.cat([x[co], x[co]]), torch.cat([y[co], y[co]])
    rows = torch.cat([idx, idx + m])

    def per(n):
        return {k: v.expand((n,) + v.shape).contiguous()
                for k, v in params.items()}

    losses_m, g_m = eng._vgrad_per(per(2 * m), (x2, y2))
    losses_c, g_c = eng._vgrad_per(per(2 * c), (xc2, yc2))
    leaves = (["losses"] if not torch.equal(losses_m[rows], losses_c)
              else [])
    leaves += [k for k in g_m if not torch.equal(g_m[k][rows], g_c[k])]
    print(f"    vgrad_per at 2·{c} points of {x.shape[1]} rows against "
          f"2·{m}: " + (f"{', '.join(leaves)} differ" if leaves
                        else "bit-equal"))
    gen = torch.Generator(device="cuda").manual_seed(33)
    w1, w2 = params["w1"], params["w2"]
    delta = torch.randn(x2.shape[:2] + (w1.shape[1],), generator=gen,
                        device="cuda")
    hid = torch.randn(x2.shape[:2] + (w1.shape[1],), generator=gen,
                      device="cuda")
    ops_ = {
        "forward x·W1 per point (b x 784 @ 784 x 128)":
            lambda pick: torch.bmm(pick(x2), per(len(pick(x2)))["w1"]),
        "forward h·W2 per point (b x 128 @ 128 x 10)":
            lambda pick: torch.bmm(pick(hid), w2.expand(
                (len(pick(hid)),) + w2.shape).contiguous()),
        "weight gradient xᵀ·δ per point (784 x b @ b x 128)":
            lambda pick: torch.bmm(pick(x2).transpose(1, 2), pick(delta))}
    del w1
    for name, op in ops_.items():
        full = op(lambda t: t)
        part = op(lambda t: t[rows])
        same = torch.equal(full[rows], part)
        gap = float((full[rows] - part).abs().max())
        k_m = _kernel_names(lambda: op(lambda t: t))
        k_c = _kernel_names(lambda: op(lambda t: t[rows]))
        print(f"    {name}: " + ("bit-equal" if same else
                                 f"differs, max |Δ| {gap:.3g}")
              + f"; kernels at {2 * m} points {k_m}"
              + (" (the same)" if k_m == k_c else
                 f", at {2 * c} {k_c}"))


def phase_cohort_vs_dense(card: str, skipping_c: dict) -> dict:
    """9c: cada2, cada1, laq and local_momentum at M = 64, C = 16, 20
    rounds, and cada2 with both engines at fuse_evals=False: the cohort
    plane against the dense plane with the cohort as its participation
    mask. Masks and staleness must match (a flip only
    within MARGIN_BAND of the gate, after which the runs differ); whether
    the float state is bit-equal is reported. Where it is not: the
    gradient rows of the C·b-row call against the same workers' rows of
    the M·b-row call, and one round from the same state with the SAME
    gradient rows fed to both planes, which must be bit-equal."""
    found = {}
    for kind, evals in [(k, None) for k in VS_RULES] + [("cada2", False)]:
        c = skipping_c.get(kind, 1.0)
        tag = kind if evals is None else f"{kind}, fuse_evals=False"
        h = COHORT_H if kind in LOCAL_RULES else 1
        p = setup_cohort(VS_M, VS_C, VS_ROUNDS, N_DATA, seed=31, h=h)
        # the dense plane's batches: the cohort's rows in place, the other
        # workers' rows from a second draw (offline, they upload nothing)
        gen = torch.Generator(device="cuda").manual_seed(32)
        x_all = torch.randn((VS_ROUNDS, h, VS_M, BATCH, DIMS[0]),
                            generator=gen, device="cuda")
        y_all = torch.randint(0, DIMS[-1], (VS_ROUNDS, h, VS_M, BATCH),
                              generator=gen, device="cuda",
                              dtype=p["batches"][0][1].dtype)
        for i, co in enumerate(p["cohorts"]):
            bx, by = p["batches"][i]
            x_all[i][:, co] = bx if h > 1 else bx[None]
            y_all[i][:, co] = by if h > 1 else by[None]
        dense_batches = ((x_all, y_all) if h > 1 else (x_all[:, 0],
                                                        y_all[:, 0]))
        part = torch.as_tensor(cohorts_to_participation(p["cohorts"], VS_M),
                               device="cuda")
        eng_d = _cohort_engine(kind, VS_M, c, evals)
        st_d, m_d = eng_d.run(eng_d.init(p["params"]), dense_batches,
                              participation=part)
        eng_c = _cohort_engine(kind, VS_M, c, evals)
        (st_c, pool, m_c), _, _ = drive_cohort(eng_c, p, pipeline=True)
        rounds_equal = VS_ROUNDS
        for i, mm in enumerate(m_c):
            co = p["cohorts"][i]
            dm = m_d["upload_mask"][i].cpu().numpy()
            off = np.ones(VS_M, bool)
            off[co] = False
            if dm[off].any():
                raise RuntimeError(f"9c {tag}: the dense plane uploaded "
                                   f"outside the cohort in round {i}")
            stale_ok = np.array_equal(mm["staleness"],
                                      m_d["staleness"][i].cpu().numpy()[co])
            if np.array_equal(mm["upload_mask"], dm[co]) and stale_ok:
                continue
            flipped = mm["upload_mask"] != dm[co]
            margin = np.abs(m_d["lhs"][i].cpu().numpy()[co]
                            - float(m_d["rhs"][i]))
            if not stale_ok or (margin[flipped]
                                > MARGIN_BAND * float(m_d["rhs"][i])).any():
                raise RuntimeError(f"9c {tag}: round {i} masks or "
                                   "staleness differ outside the margin "
                                   "band")
            rounds_equal = i
            break
        dev = st_d.params_flat.device
        pairs = [("params_flat", st_c.params_flat, st_d.params_flat),
                 ("nabla", st_c.server.nabla, st_d.comm.nabla),
                 ("worker_grads", pool.planes["worker_grads"].to(dev),
                  st_d.comm.worker_grads)]
        pairs += [(n, pool.planes[n].to(dev), st_d.comm.extras[n])
                  for n in eng_c.strategy.pooled_extras()]
        diffs = _diff_report(pairs) if rounds_equal == VS_ROUNDS else []
        verdict = ("bit-equal" if rounds_equal == VS_ROUNDS and not diffs
                   else "NOT bit-equal")
        print(f"  9c {tag} (c={c:.6g}), M = {VS_M}, C = {VS_C}, "
              f"{VS_ROUNDS} rounds: masks and staleness "
              + ("exact" if rounds_equal == VS_ROUNDS
                 else f"exact through round {rounds_equal - 1}, then an "
                      "in-band gate flip")
              + f"; float state {verdict}"
              + (f" ({', '.join(diffs)})" if diffs else ""))
        found[tag] = verdict
        if verdict == "bit-equal":
            continue
        if evals is False:
            raise RuntimeError(f"9c {tag}: the gathered evaluation must "
                               "keep the cohort plane bit-equal to the "
                               "dense plane")
        worst = max(_gap_share(a, b) for _, a, b in pairs)
        if rounds_equal == VS_ROUNDS and worst > COHORT_DENSE_BAND:
            raise RuntimeError(f"9c {tag}: float state {worst:.3g} of "
                               f"scale apart, above {COHORT_DENSE_BAND}")
        # the first op that differs: the gradient rows of the round's
        # evaluation at C·b rows against the same workers' rows at M·b,
        # in the form the engine runs and in the other
        r = VS_ROUNDS // 2
        co = p["cohorts"][r]
        idx = torch.as_tensor(co, dtype=torch.long, device=dev)
        xb, yb = (t[r] if h == 1 else t[r][0] for t in dense_batches)
        layout = flat.layout_of(st_d.params)
        for fuse in (True, False):
            _, f_m, s_m = flat.eval_two_point(
                eng_d.strategy, layout, st_d.comm.extras, st_d.params,
                (xb, yb), VS_M, vgrad=eng_d._vgrad,
                vgrad_per=eng_d._vgrad_per, fuse_evals=fuse)
            _, f_c, s_c = flat.eval_two_point(
                eng_d.strategy, layout, st_d.comm.extras, st_d.params,
                (xb[co], yb[co]), VS_C, vgrad=eng_d._vgrad,
                vgrad_per=eng_d._vgrad_per, fuse_evals=fuse, cohort=idx)
            rows = [("fresh", f_m[idx], f_c)]
            if s_m is not None:
                rows.append(("second", s_m[idx], s_c))
            print(f"    {'stacked' if fuse else 'gathered'} evaluation "
                  f"(the engine's is {'stacked' if eng_d._fuse_evals else 'gathered'}),"
                  f" {VS_C}·{BATCH} rows against the same workers' rows of "
                  f"{VS_M}·{BATCH}: " + ", ".join(
                      f"{n} " + ("bit-equal" if torch.equal(a, b) else
                                 f"differs (max |Δ| "
                                 f"{float((a - b).abs().max()):.3g})")
                      for n, a, b in rows))
        if evals is None:
            _row_count_probe(eng_d, st_d.params, xb, yb, co, idx)
        # the round's own part, on the same gradient rows
        eng_d2 = _cohort_engine(kind, VS_M, c)
        eng_d2._fuse_evals = False
        st0, _ = eng_d2.run(eng_d2.init(p["params"]),
                            tuple(t[:r] for t in dense_batches),
                            participation=part[:r])
        eng_c2 = _cohort_engine(kind, VS_M, c)
        eng_c2._fuse_evals = False
        st0_c, pool0 = _dense_to_cohort(eng_c2, st0)
        log_v, log_p = [], []
        eng_d2._vgrad = _recording(eng_d2._vgrad, log_v)
        eng_d2._vgrad_per = _recording(eng_d2._vgrad_per, log_p)
        st1, md = eng_d2.step(st0, tuple(t[r] for t in dense_batches),
                              participation=part[r])
        eng_c2._vgrad = _replaying(log_v, idx)
        eng_c2._vgrad_per = _replaying(log_p, idx)
        st1_c, mc = eng_c2.step_cohort(st0_c, pool0, p["batches"][r], co)
        pairs = [("upload_mask", mc["upload_mask"], md["upload_mask"][idx]),
                 ("lhs", mc["lhs"], md["lhs"][idx]),
                 ("eq. (3) nabla", st1_c.server.nabla, st1.comm.nabla),
                 ("server params_flat", st1_c.params_flat, st1.params_flat),
                 ("pool worker_grads",
                  pool0.planes["worker_grads"].to(dev),
                  st1.comm.worker_grads)]
        pairs += [(f"server {i}", a, b) for i, (a, b) in enumerate(
            zip(_tensors(st1_c.opt_state), _tensors(st1.opt_state)))]
        pairs += [(f"pool {n}", pool0.planes[n].to(dev), st1.comm.extras[n])
                  for n in eng_c2.strategy.pooled_extras()]
        bad = _diff_report(pairs)
        if bad:
            raise RuntimeError(f"9c {tag}: on the same gradient rows the "
                               f"cohort round differs from the dense one: "
                               f"{bad}")
        print(f"    round {r} from the same state with the same gradient "
              "rows fed to both planes: LHS, eq. (3)'s ∇, the server "
              "step's outputs and the pool rows bit-equal")
    return found


def _to_host(x):
    """A state's tensors copied to the host, its structure kept."""
    if torch.is_tensor(x):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_host(v) for v in x))
    return x


class _Planes:
    """A pool's planes without its staging slots."""

    def __init__(self, pool):
        self.plane_order, self.planes = pool.plane_order, dict(pool.planes)


def phase_lm_cohort(card: str, totals: dict) -> None:
    """9d: phase 7's model and cut (stablelm-1.6b at full width, 4 of 24
    layers) through the trainer's cohort step: cada2 with bf16 CADA state,
    M = 8 workers in a host pool (4 when the host has too little memory
    available, said so), C = 2, 4 rounds of 2 × 2048 tokens per cohort
    member, serial and pipelined, bit-equal; exactly one AMSGrad, one
    two-operand norm and one eq. (3) launch per step."""
    cfg = lm_configs.get_config(TRAIN_ARCH).with_(n_layers=TRAIN_LAYERS)
    hp = trainer.TrainHParams(rule=CommRule(kind="cada2", **TRAIN_RULE),
                              lr=TRAIN_LR, cada_dtype="bfloat16")
    row = TRAIN_PARAMS * 2                     # one bf16 row of a plane
    m = LM_COHORT_M
    total, avail = _mem_gib()
    need = (m * row + 2 * LM_COHORT_C * row) / 2**30
    if avail < need * 1.5:
        print(f"  9d: MemAvailable {avail:.1f} GiB is short of 1.5 x the "
              f"{need:.1f} GiB that M = {m} needs on the host; M = 4")
        m = 4
    rounds = LM_COHORT_ROUNDS
    tokens = make_token_batches(cfg, global_batch=LM_COHORT_C * 2,
                                seq=TRAIN_SEQ, steps=rounds)
    batches = [trainer.worker_split({"tokens": torch.from_numpy(t).to(
        device="cuda", dtype=torch.long)}, LM_COHORT_C) for t in tokens]
    cohorts = sample_cohorts(m, LM_COHORT_C, rounds, seed=41)
    print(f"  9d {cfg.name} at full width, {cfg.n_layers} of 24 layers "
          f"(n_flat {TRAIN_PARAMS:,}), cada2 {TRAIN_RULE}, bf16 CADA state, "
          f"M = {m}, C = {LM_COHORT_C}, {rounds} rounds of "
          f"{LM_COHORT_C} x 2 x {TRAIN_SEQ} tokens; host pool "
          f"{m * row / 1e9:.2f} GB, pinned staging "
          f"{2 * LM_COHORT_C * row / 1e9:.2f} GB, cada2's ring of "
          f"{min(m, MAX_DELAY) + 1} rows {(min(m, MAX_DELAY) + 1) * row / 1e9:.2f} "
          f"GB on the card; cohorts {cohorts.tolist()}")
    step = trainer.make_cohort_train_step(cfg, hp, m)
    runs = {}
    for pipeline in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, pool = trainer.init_cohort_train_state(cfg, hp, m, 0)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        trace = Tracer()
        _reset_all_counts()
        t0 = time.perf_counter()
        state, mets = trainer.run_cohort_train(
            step, state, pool, batches, cohorts, pipeline=pipeline,
            trace=trace)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = _train_counts()
        want = _train_launches("cada2", rounds)
        if got != want:
            raise RuntimeError(f"9d pipeline={pipeline}: launches {got}, "
                               f"expected {want}")
        for k, v in got.items():
            totals[k] += v
        losses = [float(mm["loss"]) for mm in mets]
        if not all(math.isfinite(v) for v in losses) or not _all_cuda(state):
            raise RuntimeError(f"9d: losses {losses}, or the state left "
                               "the card")
        if int(mets[0]["uploads"]) != LM_COHORT_C:
            raise RuntimeError("9d: round 0 did not upload its cohort")
        agg = trace.aggregate("pipeline")
        print(f"    {'pipelined' if pipeline else 'serial'}: "
              f"{secs * 1e3 / rounds:.1f} ms per step (init {t_init:.2f} s);"
              f" losses " + ", ".join(f"{v:.4f}" for v in losses)
              + f"; uploads {[int(mm['uploads']) for mm in mets]}; peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f}"
              f" GiB; pinned staging {pool.resident_nbytes - pool.nbytes:,} B;"
              " pipeline track (host clock) " + "; ".join(
                  f"{n} x{a['count']} {a['total_s'] * 1e3 / a['count']:.1f} "
                  "ms mean" for n, a in agg.items())
              + "; launches " + ", ".join(f"{k} {v}" for k, v in got.items()
                                          if v) + f" on {card}")
        # the host keeps each run's result: the card holds one run at a time
        runs[pipeline] = (_to_host(state), _Planes(pool), mets)
        del state, pool, mets
    _same_run(runs[True], runs[False], "9d pipelined vs serial")
    print("    pipelined = serial bit for bit (state, host pool, metrics)")
    del runs
    gc.collect()
    torch.cuda.empty_cache()


def phase_telemetry(trace: Tracer, keep) -> None:
    """9e: 9b's pipelined trace exported and validated; a pipelined run
    that raises at round COHORT_FAIL_AT leaves ``metrics_out`` and the
    pool equal to the serial oracle's through the last completed round."""
    path = Path(__file__).resolve().parent / "build" / "chip_smoke_cohort_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    obj = write_chrome_trace(trace, str(path),
                             meta={"runtime": "cohort", "m": FED_M,
                                   "c": FED_C})
    n = validate_chrome_trace(obj)
    if obs_export.main(["--validate", str(path)]) != 0:
        raise RuntimeError("9e: the exported trace does not validate")
    print(f"  9e the pipelined 9b run's trace: {n} events, valid "
          f"({path.name})")
    p, c, (st_s, pool_s, mets_s) = keep
    j = COHORT_FAIL_AT

    class Stop(RuntimeError):
        pass

    def failing(i, cohort):
        if i == j:
            raise Stop
        return p["batches"][i]

    eng = _cohort_engine("cada2", COHORT_M, c)
    state, pool = eng.init_cohort(p["params"])
    out: list = []
    try:
        eng.run_cohort(state, pool, failing, p["cohorts"], pipeline=True,
                       metrics_every=4, metrics_out=out)
    except Stop:
        pass
    else:
        raise RuntimeError("9e: the run did not raise")
    (_, pool_t, mets_t), _, _ = drive_cohort(_cohort_engine(
        "cada2", COHORT_M, c), p, pipeline=False, rounds=j)
    if len(out) != j:
        raise RuntimeError(f"9e: metrics_out holds {len(out)} rounds, "
                           f"not {j}")
    for i, (a, b) in enumerate(zip(out, mets_t)):
        for key in a:
            if not np.array_equal(a[key], b[key]):
                raise RuntimeError(f"9e: metrics_out[{i}][{key}] differs")
    for name in pool.plane_order:
        if not torch.equal(pool.planes[name], pool_t.planes[name]):
            raise RuntimeError(f"9e: pool plane {name} differs from the "
                               f"serial oracle's after {j} rounds")
    print(f"  9e a pipelined cada2 run raising at round {j} of "
          f"{COHORT_ROUNDS}: metrics_out holds rounds 0..{j - 1}, equal "
          "to the serial oracle's, and the pool equals its pool after "
          f"{j} rounds")


def phase_cohort(card: str, skipping_c: dict) -> dict:
    """Phase 9: the cohort plane on the card (9a–9e). Returns the
    launches of its main-path runs."""
    total, avail = _mem_gib()
    print(f"  host memory (/proc/meminfo): MemTotal {total:.1f} GiB, "
          f"MemAvailable {avail:.1f} GiB")
    totals = dict.fromkeys({**WRAPPERS, **LM_WRAPPERS}, 0)
    keep = phase_cohort_kinds(card, skipping_c, totals)
    trace = phase_federated(card, skipping_c.get("cada2", 1.0), totals)
    phase_cohort_vs_dense(card, skipping_c)
    phase_telemetry(trace, keep)
    del keep
    gc.collect()
    torch.cuda.empty_cache()
    phase_lm_cohort(card, totals)
    return totals


# ---------------------------------------------------------- the sim runtime

def _sim_rule(kind: str, c: float, **kw) -> CommRule:
    """Phase 4's rule at ``c``; the delta rules as 9a runs them (H = 2,
    local lr 0.05, FedAdam's server lr 5e-4)."""
    if kind in LOCAL_RULES:
        return _cohort_rule(kind, c)
    return CommRule(kind=kind, c=c, d_max=D_MAX, max_delay=MAX_DELAY, **kw)


def _local_batches(batches, rounds: int, h: int):
    """(rounds, H, M, b, ...) batches from phase 4's (R, M, b, ...) draws."""
    return tuple(b[:rounds * h].reshape((rounds, h) + tuple(b.shape[1:]))
                 for b in batches)


def _sim_diffs(res, fst, mets) -> list[str]:
    """What differs between a sim run and the engine's run: every metric
    the engine returns, the sim's own mask/staleness/loss series and every
    final parameter."""
    bad = [k for k, v in mets.items()
           if not np.array_equal(res.metrics[k], v.cpu().numpy())]
    if not np.array_equal(res.upload_masks, mets["upload_mask"].cpu()
                          .numpy()):
        bad.append("upload_masks")
    if not np.array_equal(res.staleness, mets["staleness"].cpu().numpy()):
        bad.append("staleness")
    if not np.array_equal(res.losses, mets["loss"].double().cpu().numpy()):
        bad.append("losses")
    bad += [f"param {k}" for k in fst.params
            if not torch.equal(res.final_params[k], fst.params[k])]
    return bad


def phase_sim_parity(card: str, params, batches, skipping_c: dict,
                     totals: dict) -> None:
    """10a: every kind through ``simulate`` on the zero profile against
    ``CADAEngine.run`` on the same batches: bit for bit (every metric,
    the masks, staleness, losses and every parameter), exact launches in
    both. Only the sim's launches enter the totals (the engine's run is
    the oracle)."""
    r = SIM_PARITY_ROUNDS
    print(f"  10a degenerate parity, the zero profile: paper MLP, M = {M}, "
          f"{r} rounds a kind (the delta rules at H = {COHORT_H}), each "
          "gated rule at phase 4's skipping c")
    # warm-up (the allocator's first blocks): not timed, not counted
    simulate(mlp_loss, _sim_rule("always", 1.0), params,
             tuple(x[:2] for x in batches), n_workers=M, network="zero",
             optimizer=FusedAMSGrad(lr=5e-4))
    for kind in KINDS:
        c = skipping_c.get(kind, 1.0)
        rule = _sim_rule(kind, c)
        local = kind in LOCAL_RULES
        opt = None if local else FusedAMSGrad(lr=5e-4)
        b = (_local_batches(batches, r, COHORT_H) if local
             else tuple(x[:r] for x in batches))
        want = {**expected_launches(kind, r, "own" if local else "fused"),
                **dict.fromkeys(LM_WRAPPERS, 0)}
        torch.cuda.synchronize()
        _reset_all_counts()
        t0 = time.perf_counter()
        res = simulate(mlp_loss, rule, params, b, n_workers=M,
                       network="zero", optimizer=opt)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = _train_counts()
        eng = CADAEngine(mlp_loss, opt, rule, M)
        _reset_all_counts()
        fst, mets = eng.run(eng.init(params), b)
        torch.cuda.synchronize()
        got_eng = _train_counts()
        if got != want or got_eng != want:
            raise RuntimeError(f"10a {kind}: launches sim {got}, engine "
                               f"{got_eng}, expected {want}")
        for k, v in got.items():
            totals[k] += v
        bad = _sim_diffs(res, fst, mets)
        if bad:
            raise RuntimeError(f"10a {kind}: the sim differs from the "
                               f"engine in {bad}")
        if not np.isfinite(res.losses).all():
            raise RuntimeError(f"10a {kind}: a loss is not finite")
        print(f"    {kind} (c={c:.6g}): sim = engine bit for bit; uploads "
              f"{res.uploads} / {r * M}; {secs * 1e3 / r:.3f} host ms per "
              "round; launches " + ", ".join(f"{k} {v}" for k, v in
                                             got.items() if v)
              + f" on {card}")


def _mlp_draws(n: int, seed: int):
    """``n`` draws of phase 4's sampler (mnist_like(4096), M = 10 equal
    shards, batch 12), stacked: ((n, M, b, 784), (n, M, b))."""
    ds = mnist_like(n=N_DATA)
    x = ds.x.reshape(ds.n, -1)
    mtx = pad_to_matrix(uniform_partition(ds.n, M, seed=0))
    sample = make_sampler(x, ds.y, mtx, BATCH)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    draws = [sample(gen) for _ in range(n)]
    return tuple(torch.stack(t) for t in zip(*draws))


def phase_sim_priced(card: str, params, batches, totals: dict) -> None:
    """10b: always, cada2, laq (8-bit) and topk (sparse wire) priced on
    lan, wan and hetero, 100 rounds each; local momentum with adaptive H
    (cap 16) on wan and zero. Simulated seconds are the sim's clock
    models' output, not measurements; host ms per round is measured
    (host clock around a synchronised run)."""
    r = SIM_PRICED_ROUNDS
    b = tuple(x[:r] for x in batches)
    print(f"  10b priced barrier runs: paper MLP, M = {M}, {r} rounds, "
          "c = 1; SIMULATED seconds come from the clock models (computed, "
          f"not measured); host ms per round measured on {card}")
    target = None
    for name, rkw in SIM_PRICED.items():
        kind = rkw["kind"]
        # one c for every rule, as phase 4's reference runs and the
        # reference's network sweep take one
        rule = _sim_rule(kind, 1.0,
                         **{k: v for k, v in rkw.items() if k != "kind"})
        for prof in SIM_PROFILES:
            torch.cuda.synchronize()
            _reset_all_counts()
            t0 = time.perf_counter()
            res = simulate(mlp_loss, rule, params, b, n_workers=M,
                           network=prof, optimizer=FusedAMSGrad(lr=5e-4))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = _train_counts()
            want = {**expected_launches(kind, r, "fused"),
                    **dict.fromkeys(LM_WRAPPERS, 0)}
            if got != want:
                raise RuntimeError(f"10b {name}/{prof}: launches {got}, "
                                   f"expected {want}")
            for k, v in got.items():
                totals[k] += v
            if not np.isfinite(res.losses).all():
                raise RuntimeError(f"10b {name}/{prof}: non-finite loss")
            if target is None:
                # the level always reaches over its last 20 rounds on lan,
                # +5%: every run is priced to the same loss
                target = 1.05 * final_loss(res)
                print(f"    target loss {target:.5f} (always on lan, the "
                      "mean of its last 20 rounds + 5%)")
            ttt = time_to_target(res, target)
            print(f"    {name}/{prof}: time to target "
                  + ("not reached" if ttt is None
                     else f"{ttt:.6f} simulated s")
                  + f", {res.wall_s:.6f} simulated s for {r} rounds; "
                  f"uploads {res.uploads} / {r * M}, {res.bytes_up:.0f} B "
                  f"up, {res.bytes_down:.0f} B down; "
                  f"{secs * 1e3 / r:.3f} host ms per round")
    ra, cap = SIM_ADAPT_ROUNDS, SIM_ADAPT_CAP
    ab = _local_batches(_mlp_draws(ra * cap, seed=7), ra, cap)
    rule = CommRule(kind="local_momentum", c=1.0, d_max=D_MAX,
                    max_delay=MAX_DELAY, adapt_local_steps=True,
                    local_steps_max=cap, local_lr=COHORT_LOCAL_LR)
    hs = {}
    for prof in ("wan", "zero"):
        torch.cuda.synchronize()
        _reset_all_counts()
        t0 = time.perf_counter()
        res = simulate(mlp_loss, rule, params, ab, n_workers=M,
                       network=prof)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = _train_counts()
        want = {**expected_launches("local_momentum", ra, "own"),
                **dict.fromkeys(LM_WRAPPERS, 0)}
        if got != want:
            raise RuntimeError(f"10b adaptive H/{prof}: launches {got}, "
                               f"expected {want}")
        for k, v in got.items():
            totals[k] += v
        h = res.metrics["local_steps"]
        hs[prof] = h
        if not np.isfinite(res.losses).all():
            raise RuntimeError(f"10b adaptive H/{prof}: non-finite loss")
        print(f"    local_momentum, adaptive H (cap {cap}) on {prof}: "
              f"realized mean H {h.mean():.3f} (last round "
              f"{h[-1].mean():.2f}), grad evals {res.grad_evals}, "
              f"{res.wall_s:.6f} simulated s for {ra} rounds, "
              f"{secs * 1e3 / ra:.3f} host ms per round")
    if not (hs["wan"][-1] > hs["wan"][0]).all() or (hs["zero"][1:] != 1).any():
        raise RuntimeError("10b: H did not grow on wan and collapse to 1 "
                           "on zero")


class _GateHooks(SimRuntime):
    """The async sim with its gates observed: with ``record`` each gate's
    LHS / RHS lands in ``ratios``; with ``window`` = (first, end) a
    profiler runs over those gates (counted as they are called)."""

    def __init__(self, *a, record: bool = False, window=None, **kw):
        super().__init__(*a, **kw)
        self.record, self.window = record, window
        self.ratios: list[float] = []
        self.prof = self.wall = None
        self.done = False

    def _build_gate(self, tau):
        from torch.profiler import ProfilerActivity, profile
        gate = super()._build_gate(tau)
        count = [0]

        def observed(*args):
            if self.window and count[0] == self.window[0]:
                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.start()
                self.wall = time.perf_counter()
            if self.window and count[0] == self.window[1]:
                torch.cuda.synchronize()
                self.wall = time.perf_counter() - self.wall
                self.prof.stop()
                self.done = True
            count[0] += 1
            out = gate(*args)
            if self.record:
                lhs, rhs = float(out[5]), float(out[6])
                # an empty RHS ring (the first gates) has no ratio
                self.ratios.append(lhs / rhs if rhs > 0 else math.inf)
            return out

        return observed


def phase_sim_async(card: str, params, batches, skipping_c: dict,
                    totals: dict) -> None:
    """10c: cada1, cada2 and laq async on hetero (tau 20, 200 server
    versions), on the device plane and with the host pool, bit-equal;
    exactly one AMSGrad launch per server version, one one-row LHS launch
    per gate and no eq. (3) launch; host ms per gate; a profile of 50
    gates (device-idle share). Each rule runs at the median LHS / RHS of
    its gates in a c = 1 run (phase 4's skip_c in async form: an
    arrival's step is lr / M, so the RHS is far below a synchronous
    round's and phase 4's c uploads at every gate)."""
    v = SIM_ASYNC_VERSIONS
    b = tuple(x[:v] for x in batches)
    cfg = SimConfig(network=network_profile("hetero", M), mode="async",
                    async_tau=SIM_ASYNC_TAU)
    print(f"  10c async on hetero: paper MLP, M = {M}, tau "
          f"{SIM_ASYNC_TAU}, {v} server versions, FusedAMSGrad(5e-4) at "
          "lr / M per arrival; each rule at the median LHS / RHS of its "
          "gates in a c = 1 run")
    async_c = {}
    for kind in SIM_ASYNC_RULES:
        cal = _GateHooks(mlp_loss, _sim_rule(kind, 1.0), M, cfg,
                         record=True, optimizer=FusedAMSGrad(lr=5e-4))
        cal.run(params, b)
        r = np.asarray(cal.ratios)
        c = async_c[kind] = float(np.median(r[np.isfinite(r)]))
        rule = _sim_rule(kind, c)
        runs = {}
        for host_pool in (False, True):
            torch.cuda.synchronize()
            _reset_all_counts()
            t0 = time.perf_counter()
            res = simulate(mlp_loss, rule, params, b, n_workers=M,
                           network="hetero", mode="async",
                           async_tau=SIM_ASYNC_TAU, host_pool=host_pool,
                           optimizer=FusedAMSGrad(lr=5e-4))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            gates = len(res.losses)
            got = _train_counts()
            want = {**dict.fromkeys(got, 0), "amsgrad": res.steps,
                    ("batched_diff_sq" if kind in DIFF_RULES
                     else "batched_sq"): gates}
            if got != want or res.steps != v:
                raise RuntimeError(f"10c {kind} host_pool={host_pool}: "
                                   f"{res.steps} versions, launches {got}, "
                                   f"expected {want}")
            for k, n in got.items():
                totals[k] += n
            if not np.isfinite(res.losses).all():
                raise RuntimeError(f"10c {kind}: non-finite loss")
            runs[host_pool] = res
            print(f"    {kind} (c={c:.6g}) "
                  f"{'host pool' if host_pool else 'device plane'}: "
                  f"{gates} gates, {res.uploads} uploads, max staleness "
                  f"{res.max_staleness}, {res.wall_s:.6f} simulated s; "
                  f"{secs * 1e3 / gates:.3f} host ms per gate"
                  + (f"; pool {res.ledger['pool_nbytes']:,} B, parked rows "
                     f"at most {res.ledger['async_pending_max']}"
                     if host_pool else "") + f" on {card}")
        a, p = runs[False], runs[True]
        same = (np.array_equal(a.losses, p.losses)
                and np.array_equal(a.loss_times, p.loss_times)
                and a.uploads == p.uploads and a.wall_s == p.wall_s
                and all(torch.equal(a.final_params[k], p.final_params[k])
                        for k in a.final_params))
        if not same:
            raise RuntimeError(f"10c {kind}: the host pool differs from "
                               "the device plane")
        print("      host pool = device plane bit for bit")
    rt = _GateHooks(mlp_loss, _sim_rule("cada2", async_c["cada2"]), M, cfg,
                    window=(SIM_PROFILE_SKIP,
                            SIM_PROFILE_SKIP + SIM_PROFILE_GATES),
                    optimizer=FusedAMSGrad(lr=5e-4))
    rt.run(params, b)
    if not rt.done:
        raise RuntimeError("10c: the profiled run had too few gates")
    evs = [e for e in rt.prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e - s for s, e in _merge(_intervals(evs, lambda n: True)))
    print(f"    profile of {SIM_PROFILE_GATES} cada2 gates (device plane, "
          f"after {SIM_PROFILE_SKIP}): {rt.wall * 1e3 / SIM_PROFILE_GATES:.3f}"
          f" host ms per gate, device busy {busy / 1e3 / SIM_PROFILE_GATES:.4f}"
          f" ms per gate ({100 * busy / 1e6 / rt.wall:.1f}%, idle "
          f"{100 - 100 * busy / 1e6 / rt.wall:.1f}%), "
          f"{len(evs) / SIM_PROFILE_GATES:.0f} device events per gate")


def phase_sim_federated(card: str, c_cada2: float, totals: dict) -> None:
    """10d: ``simulate(cohort_size=64)`` at M = 10⁴ on wan over phase 9b's
    problem (its cohort schedule, seed 21), 30 rounds, against
    ``CADAEngine.run_cohort`` over the same schedule and batches: bit for
    bit."""
    p = setup_cohort(FED_M, FED_C, FED_ROUNDS, FED_DATA, seed=21)
    rule = _sim_rule("cada2", c_cada2)
    torch.cuda.synchronize()
    _reset_all_counts()
    t0 = time.perf_counter()
    res = simulate(mlp_loss, rule, p["params"],
                   lambda k, _cohort: p["batches"][k], n_workers=FED_M,
                   network="wan", cohort_size=FED_C, rounds=FED_ROUNDS,
                   seed=21, optimizer=FusedAMSGrad(lr=5e-4))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = _train_counts()
    want = {**expected_launches("cada2", FED_ROUNDS, "fused"),
            **dict.fromkeys(LM_WRAPPERS, 0)}
    if got != want:
        raise RuntimeError(f"10d: launches {got}, expected {want}")
    for k, v in got.items():
        totals[k] += v
    if not np.array_equal(res.metrics["cohorts"], p["cohorts"]):
        raise RuntimeError("10d: the sim sampled other cohorts")
    eng = _cohort_engine("cada2", FED_M, c_cada2)
    state, pool = eng.init_cohort(p["params"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, mets = eng.run_cohort(state, pool, p["batches"], p["cohorts"])
    torch.cuda.synchronize()
    eng_secs = time.perf_counter() - t0
    bad = [k for k in state.params
           if not torch.equal(res.final_params[k], state.params[k])]
    for i, m in enumerate(mets):
        if not (np.array_equal(res.upload_masks[i], m["upload_mask"])
                and np.array_equal(res.staleness[i], m["staleness"])
                and res.losses[i] == float(m["loss"])):
            bad.append(f"round {i}")
    if bad:
        raise RuntimeError(f"10d: the federated sim differs from "
                           f"run_cohort in {bad}")
    met = res.metrics
    print(f"  10d federated sim: M = {FED_M:,}, C = {FED_C}, wan, "
          f"{FED_ROUNDS} rounds = run_cohort bit for bit; host pool "
          f"{met['host_pool_bytes']:,} B against "
          f"{met['device_worker_plane_bytes']:,} B of worker rows on the "
          f"card a round; uploads {res.uploads}, {res.wall_s:.6f} "
          f"simulated s; {secs * 1e3 / FED_ROUNDS:.3f} host ms per round "
          f"with the pool's set-up, run_cohort alone "
          f"{eng_secs * 1e3 / FED_ROUNDS:.3f}, on {card}")
    del p, pool, state
    gc.collect()


class _Timed:
    """Times each ``SimRuntime.run`` (host clock, synchronised) while
    active."""

    def __enter__(self):
        self.secs, orig = [], SimRuntime.run
        self._orig = orig

        def run(rt, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(rt, *a, **kw)
            torch.cuda.synchronize()
            self.secs.append(time.perf_counter() - t0)
            return out

        SimRuntime.run = run
        return self

    def __exit__(self, *exc):
        SimRuntime.run = self._orig


def phase_sim_lm(card: str, totals: dict, layers: dict | None = None,
                 runs=("barrier", "async, host pool")) -> None:
    """10e: stablelm-1.6b at its published width with 4 of 24 layers
    (phase 7's cut) through ``python -m repro_torch.launch.train --runtime
    sim`` in-process: M = 2, one 2048-token sequence a worker a round,
    cada2 barrier for 4 rounds, then async (tau 4) for 8 server versions
    with the host pool. Finite losses; exactly one AMSGrad launch per
    round or server version (and the rule's norm per round or gate, eq.
    (3) once a barrier round, never async); ms per round or gate and peak
    memory."""
    layers = layers or SIM_LM_LAYERS
    base = ["--arch", TRAIN_ARCH, "--runtime", "sim", "--network", "wan",
            "--workers", str(TRAIN_M), "--global-batch", str(TRAIN_M),
            "--seq", str(TRAIN_SEQ), "--rule", "cada2", "--lr",
            str(TRAIN_LR)]
    print(f"  10e {TRAIN_ARCH} at full width through the launcher's "
          f"--runtime sim: M = {TRAIN_M}, one {TRAIN_SEQ}-token sequence a "
          "worker a round, remat off")
    for label, extra, n in (
            ("barrier", ["--steps", str(SIM_LM_ROUNDS)], SIM_LM_ROUNDS),
            ("async, host pool", ["--steps", str(SIM_LM_VERSIONS),
                                  "--async-tau", str(SIM_LM_TAU),
                                  "--host-pool"], SIM_LM_VERSIONS)):
        if label not in runs:
            continue
        extra = extra + ["--layers", str(layers[label])]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_all_counts()
        with _Timed() as timed:
            (row,) = train_cli.main(base + extra)
        got = _train_counts()
        gates = row["grad_evals"] // 2 if label != "barrier" else n
        want = {**dict.fromkeys(got, 0), "amsgrad": n,
                "batched_diff_sq": gates,
                "eq3_row_mean": n if label == "barrier" else 0}
        if got != want or row["steps"] != n:
            raise RuntimeError(f"10e {label}: {row['steps']} steps, "
                               f"launches {got}, expected {want}")
        for k, v in got.items():
            totals[k] += v
        if row["final_loss"] is None or not math.isfinite(row["final_loss"]):
            raise RuntimeError(f"10e {label}: loss {row['final_loss']}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        per = "round" if label == "barrier" else "gate"
        print(f"    {label}, {layers[label]} of 24 layers: {n} server "
              f"steps, {gates} gates, uploads "
              f"{row['uploads']}, final loss {row['final_loss']:.4f}; "
              f"{timed.secs[0] * 1e3 / gates:.1f} ms per {per} (the sim's "
              f"run, host clock); peak device memory {peak:.3f} GiB on "
              f"{card}")
    gc.collect()
    torch.cuda.empty_cache()


def phase_sim(card: str, params, batches, skipping_c: dict) -> dict:
    """Phase 10: the sim runtime on the card (10a–10e). Returns the
    launches of its sim runs."""
    totals = dict.fromkeys({**WRAPPERS, **LM_WRAPPERS}, 0)
    for label, fn in (("10a", lambda: phase_sim_parity(
                          card, params, batches, skipping_c, totals)),
                      ("10b", lambda: phase_sim_priced(
                          card, params, batches, totals)),
                      ("10c", lambda: phase_sim_async(
                          card, params, batches, skipping_c, totals)),
                      ("10d", lambda: phase_sim_federated(
                          card, skipping_c.get("cada2", 1.0), totals)),
                      ("10e", lambda: phase_sim_lm(card, totals))):
        t0 = time.perf_counter()
        fn()
        print(f"    {label} took {time.perf_counter() - t0:.1f} s")
    return totals


# ------------------------------------- MoE, M-RoPE and embedding inputs

def phase_moe_serve(card: str, label: str, rates) -> dict:
    """One of 11a–11d: the config at full width (the depth cut of
    MOE_SERVE where it has one) through ``serve.generate``: random prompts
    (token ids, or the stub frontends' embeddings), qwen2-vl's M-RoPE
    positions of an image plan, greedy decode steps. The counts set to 0
    just before and read just after: exactly one flash launch per layer
    (the prefill's), nothing else. Then a warm prefill by CUDA events and
    under the profiler; a MoE model's prefill twice, its logits and cache
    bit-equal; the flash kernel at the prefill's shape against its plain
    version. Returns the flash launches and the qwen2-vl shape's flash
    check."""
    arch, layers, b, s, steps = MOE_SERVE[label]
    cfg = lm_configs.get_config(arch)
    full_layers = cfg.n_layers
    if layers:
        cfg = cfg.with_(n_layers=layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, 0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _tensors(params))
    if n_params != param_count(cfg):
        raise RuntimeError(f"{label}: {n_params} parameters, not "
                           f"{param_count(cfg)}")
    cut = (f"{cfg.n_layers} of {full_layers} layers" if layers
           else f"all {full_layers} layers")
    print(f"  {label} {cfg.name} ({cfg.source}) at full width, {cut}: "
          f"{n_params:,} parameters in {cfg.dtype}, drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s; d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, "
          + (f"{cfg.n_experts} experts top-{cfg.top_k} ({cfg.mlp_act}, "
             f"d_ff {cfg.d_ff})" if cfg.block == "moe"
             else f"dense {cfg.mlp_act} d_ff {cfg.d_ff}")
          + ("" if cfg.embed_input else ", embedding input")
          + (f", M-RoPE {cfg.mrope_sections_}" if cfg.mrope else ""))
    prompts = serve.random_prompts(cfg, b, s, 1, "cuda")
    positions = (frontends.mrope_positions(b, s, MROPE_GRID) if cfg.mrope
                 else None)
    want = {"flash_attention": cfg.n_layers, "selective_scan": 0}

    torch.cuda.synchronize()
    _reset_all_counts()
    out = serve.generate(cfg, params, prompts, steps, positions=positions)
    torch.cuda.synchronize()
    got = {**_counts(), **_lm_counts()}
    expect = {**dict.fromkeys(WRAPPERS, 0), **want}
    if got != expect:
        raise RuntimeError(f"{label}: launches {got}, expected {expect}")
    peak = torch.cuda.max_memory_allocated()
    logits, toks = out["prefill_logits"], out["tokens"]
    if logits.shape != (b, cfg.vocab) or toks.shape != (b, steps):
        raise RuntimeError(f"{label}: shapes {tuple(logits.shape)}, "
                           f"{tuple(toks.shape)}")
    if not (bool(torch.isfinite(logits.float()).all()) and bool(
            torch.isfinite(out["logits"].float()).all())):
        raise RuntimeError(f"{label}: non-finite logits")
    if not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
        raise RuntimeError(f"{label}: decoded token ids out of range")
    print(f"    prefill {b}x{s} (first call) {out['prefill_s'] * 1e3:.2f} "
          f"ms; {steps} greedy decode steps in "
          f"{out['decode_s'] * 1e3:.2f} ms ({steps * b / out['decode_s']:.2f}"
          f" tokens/s); peak memory {peak / 2**30:.3f} GiB; launches flash "
          f"{got['flash_attention']} in the prefill, 0 in decode, others 0 "
          f"on {card}")
    print(f"    logits finite, |max| {float(logits.float().abs().max()):.4f};"
          f" tokens[0][:8] {toks[0][:8].tolist()}")
    del out

    inputs, step_input = serve.serving_inputs(cfg, prompts, positions)
    max_seq = s + steps
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    first, cache = lm.prefill(cfg, params, max_seq=max_seq, **inputs)
    end.record()
    end.synchronize()
    warm = start.elapsed_time(end)
    if cfg.block == "moe":
        again, cache2 = lm.prefill(cfg, params, max_seq=max_seq, **inputs)
        torch.cuda.synchronize()
        if not (torch.equal(first, again) and torch.equal(cache.k, cache2.k)
                and torch.equal(cache.v, cache2.v)):
            raise RuntimeError(f"{label}: two prefills of the same prompts "
                               "differ")
        del cache2, again
    busy, _ = _profile(lambda: lm.prefill(cfg, params, max_seq=max_seq,
                                          **inputs),
                       f"{label} warm prefill {b}x{s}: {warm:.2f} ms by CUDA "
                       "events; profile", top=6)
    if cfg.block == "moe":
        print("    a second prefill of the same prompts: logits and K/V "
              "cache bit-equal")

    def decode4():
        c = cache
        tok = torch.argmax(first, dim=-1)
        for _ in range(min(4, steps)):
            lg, c = lm.decode_step(cfg, params, c, **step_input(tok))
            tok = torch.argmax(lg, dim=-1)

    if label == "11a":
        _profile(decode4, f"{label} decode step profile (4 steps, per step)",
                 per=4, top=4)
    result = {"flash_attention": got["flash_attention"]}
    del params, cache, first
    gc.collect()
    torch.cuda.empty_cache()
    # the flash kernel alone at this config's prefill shape, against its
    # plain version; timed at qwen2-vl's (hd 128, GQA 12/2)
    gen = torch.Generator(device="cuda").manual_seed(11)
    flash = check_flash(b, s, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                        cfg.sliding_window, rates, gen,
                        timed=label == "11b")
    if label == "11b":
        result["qwen2_vl_shape"] = flash
    return result


def _moe_train_batch(cfg, i: int, gen) -> dict:
    """The trainer's global batch of step ``i``: the reference's token
    stream, or for an embedding-input model the stub frontend's
    embeddings, random labels and (M-RoPE) the image plan's positions."""
    if cfg.embed_input:
        toks = make_token_batches(cfg, global_batch=MOE_TRAIN_BATCH,
                                  seq=TRAIN_SEQ, steps=i + 1)[i]
        return {"tokens": torch.from_numpy(toks).to(device="cuda",
                                                    dtype=torch.long)}
    b, s = MOE_TRAIN_BATCH, TRAIN_SEQ
    batch = {"embeds": frontends.vision_embeds(cfg, gen, b, s),
             "labels": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                     device="cuda")}
    if cfg.mrope:
        batch["positions"] = frontends.mrope_positions(b, s, MROPE_GRID)
    return batch


def phase_moe_train(card: str) -> dict:
    """11e: granite-moe-1b-a400m at full width with 8 of 24 layers through
    ``make_train_step``: cada2 (c = 1), M = 2, 4 steps of 2 x 2048 tokens a
    worker; the counts set to 0 just before and read just after: exactly
    one AMSGrad, one two-operand norm and one eq. (3) launch a step, no
    serving kernel. Losses finite, the routers' aux loss > 0; step ms and
    peak memory. Then one step of qwen2-vl-2b at 2 of 28 layers on
    {"embeds", "labels", "positions"} batches, launches exact. Returns the
    launches."""
    totals = dict.fromkeys({**WRAPPERS, **LM_WRAPPERS}, 0)
    hp = trainer.TrainHParams(rule=CommRule(kind="cada2", **TRAIN_RULE),
                              lr=TRAIN_LR)
    for arch, layers, steps in ((MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS,
                                 MOE_TRAIN_STEPS),
                                ("qwen2-vl-2b", VLM_TRAIN_LAYERS, 1)):
        base = lm_configs.get_config(arch)
        cfg = base.with_(n_layers=layers)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = trainer.init_train_state(cfg, hp, TRAIN_M, 0)
        n_params = sum(t.numel() for t in _tensors(state.params))
        if n_params != param_count(cfg):
            raise RuntimeError(f"11e {arch}: {n_params} parameters")
        step = trainer.make_train_step(cfg, hp, TRAIN_M)
        gen = torch.Generator(device="cuda").manual_seed(12)
        batches = [trainer.worker_split(_moe_train_batch(cfg, i, gen),
                                        TRAIN_M) for i in range(steps)]
        torch.cuda.synchronize()
        _reset_all_counts()
        step_ms, losses = [], []
        for i in range(steps):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            state, mets = step(state, batches[i])
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            losses.append(float(mets["loss"]))
        got, want = _train_counts(), _train_launches("cada2", steps)
        if got != want:
            raise RuntimeError(f"11e {arch}: launches {got}, expected "
                               f"{want}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not all(math.isfinite(v) for v in losses) or not _all_cuda(state):
            raise RuntimeError(f"11e {arch}: losses {losses} or the state "
                               "left the card")
        with torch.no_grad():
            wb = {k: v[0] for k, v in batches[0].items()}
            _, m0 = lm.lm_loss(cfg, state.params, wb, train=True)
        aux = float(m0["aux"])
        if cfg.block == "moe" and not (math.isfinite(aux) and aux > 0):
            raise RuntimeError(f"11e {arch}: aux loss {aux}")
        for k, v in got.items():
            totals[k] += v
        steady = statistics.median(step_ms[1:] or step_ms)
        print(f"  11e {cfg.name} at full width, {layers} of {base.n_layers} "
              f"layers: {n_params:,} parameters, cada2 {TRAIN_RULE}, M = "
              f"{TRAIN_M}, {steps} step(s) of {MOE_TRAIN_BATCH // TRAIN_M} x "
              f"{TRAIN_SEQ} tokens a worker"
              + ("" if cfg.embed_input else
                 " ({embeds, labels, positions} batches)")
              + f": losses {[round(v, 4) for v in losses]}, aux "
              f"{aux:.6f}; step {steady:.2f} ms (first {step_ms[0]:.2f}); "
              f"peak memory {peak:.3f} GiB; launches "
              + ", ".join(f"{k} {v}" for k, v in got.items())
              + f" on {card}")
        del state, batches, step
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def phase_moe(card: str, rates) -> tuple[dict, dict]:
    """Phase 11 (11a–11e). Returns the launches of its driven runs and the
    flash kernel's check at qwen2-vl's shape."""
    totals = dict.fromkeys({**WRAPPERS, **LM_WRAPPERS}, 0)
    shape = {}
    for label in MOE_SERVE:
        t0 = time.perf_counter()
        res = phase_moe_serve(card, label, rates)
        totals["flash_attention"] += res["flash_attention"]
        if "qwen2_vl_shape" in res:
            shape = res["qwen2_vl_shape"]
        print(f"    {label} took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for k, v in phase_moe_train(card).items():
        totals[k] += v
    print(f"    11e took {time.perf_counter() - t0:.1f} s")
    return totals, shape


# ----------------------------------------------------------------- phase 12

def phase_scheduler(card: str, rates) -> dict:
    """12a: zamba2-2.7b at full width and depth through ``DecodeScheduler``
    (SCHED_SLOTS slots, max_seq SCHED_MAX_SEQ), SCHED_REQUESTS requests in
    rounds of SCHED_SLOTS. First, outside the counted run, each round's
    padded batch through a direct ``prefill`` + greedy ``decode_step``
    loop at the same max_seq; request SCHED_EOS_UID's third token is its
    eos_id. Then the counts set to 0 just before and read just after the
    scheduler's run: one prefill a round, 54 scans and 9 flash launches
    each, nothing in decode. Every request's tokens equal the direct
    loop's, cut at its max_new or its eos. The direct loop runs the same
    kernels, so last the scan and flash kernels are held against their
    plain versions at each round's padded prefill shape. Returns the
    launches."""
    cfg = lm_configs.get_config(SERVE_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    params = lm.init_params(cfg, 0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _tensors(params))
    if n_params != param_count(cfg):
        raise RuntimeError(f"12a: {n_params} parameters")
    rng = np.random.default_rng(12)
    lens = rng.integers(SCHED_PROMPT[0], SCHED_PROMPT[1] + 1, SCHED_REQUESTS)
    news = rng.integers(SCHED_NEW[0], SCHED_NEW[1] + 1, SCHED_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, int(n), dtype=np.int32)
               for n in lens]

    def requests(eos=None):
        return [Request(uid=i, prompt=prompts[i], max_new=int(news[i]),
                        eos_id=eos if i == SCHED_EOS_UID else None)
                for i in range(SCHED_REQUESTS)]

    sched = DecodeScheduler(cfg, params, n_slots=SCHED_SLOTS,
                            max_seq=SCHED_MAX_SEQ)
    reqs = requests()
    rounds = [reqs[i:i + SCHED_SLOTS]
              for i in range(0, SCHED_REQUESTS, SCHED_SLOTS)]
    direct = {}
    t0 = time.perf_counter()
    for batch in rounds:
        toks = torch.as_tensor(sched.padded_tokens(batch), dtype=torch.long,
                               device="cuda")
        logits, cache = lm.prefill(cfg, params, tokens=toks,
                                   max_seq=SCHED_MAX_SEQ)
        nxt = torch.argmax(logits, dim=-1)
        seq = [nxt]
        for _ in range(max(r.max_new for r in batch) - 1):
            logits, cache = lm.decode_step(cfg, params, cache, tokens=nxt)
            nxt = torch.argmax(logits, dim=-1)
            seq.append(nxt)
        out = torch.stack(seq, dim=1).cpu()
        for i, r in enumerate(batch):
            direct[r.uid] = out[i].tolist()
        del cache
    direct_s = time.perf_counter() - t0
    eos = direct[SCHED_EOS_UID][2]

    def expected(uid: int) -> list:
        seq = direct[uid][:int(news[uid])]
        if uid == SCHED_EOS_UID:
            seq = seq[:seq.index(eos) + 1]
        return seq

    for r in requests(eos):
        sched.submit(r)
    want = {**dict.fromkeys(WRAPPERS, 0),
            "selective_scan": cfg.n_layers * len(rounds),
            "flash_attention": cfg.n_layers // cfg.attn_every * len(rounds)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    t0 = time.perf_counter()
    done = sched.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = {**_counts(), **_lm_counts()}
    if got != want:
        raise RuntimeError(f"12a: launches {got}, expected {want}")
    peak = torch.cuda.max_memory_allocated()
    if [r.uid for r in done] != list(range(SCHED_REQUESTS)):
        raise RuntimeError(f"12a: served {[r.uid for r in done]}")
    bad = [r.uid for r in done if not r.done or r.out != expected(r.uid)]
    if bad:
        raise RuntimeError(f"12a: requests {bad} differ from the direct "
                           "loop over their padded batch")
    stopped = done[SCHED_EOS_UID]
    if len(stopped.out) >= int(news[SCHED_EOS_UID]):
        raise RuntimeError("12a: the eos_id did not stop its request early")
    tokens = sum(len(r.out) for r in done)
    print(f"  12a {cfg.name} at full width and depth ({n_params:,} "
          f"parameters, {cfg.dtype}) through DecodeScheduler: "
          f"{SCHED_REQUESTS} requests, prompts {lens.tolist()}, max_new "
          f"{news.tolist()}, {SCHED_SLOTS} slots, max_seq {SCHED_MAX_SEQ}, "
          f"{len(rounds)} rounds; request {SCHED_EOS_UID} stopped by eos_id "
          f"{eos} after {len(stopped.out)} of {int(news[SCHED_EOS_UID])}")
    print(f"    every request's tokens = the direct prefill + greedy "
          f"decode_step loop over its round's padded batch (run first, "
          f"{direct_s:.2f} s); {tokens} tokens in {secs:.2f} s "
          f"({tokens / secs:.2f} tokens/s), slot utilization "
          f"{sched.utilization():.4f}; peak memory {peak / 2**30:.3f} GiB; "
          f"launches scan {got['selective_scan']}, flash "
          f"{got['flash_attention']} ({cfg.n_layers} and "
          f"{cfg.n_layers // cfg.attn_every} a round's prefill, none in "
          f"decode), others 0 on {card}")
    del params, sched
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(12)
    for shape in sorted({(SCHED_SLOTS, max(len(r.prompt) for r in batch))
                         for batch in rounds}):
        check_scan(*shape, cfg.d_inner, cfg.ssm_state, cfg.mamba_headdim,
                   rates, gen, timed=False, per_channel=True)
        check_flash(*shape, cfg.n_heads, cfg.n_kv_heads, cfg.hd, 0, rates,
                    gen, timed=False)
    return {"selective_scan": got["selective_scan"],
            "flash_attention": got["flash_attention"]}


def phase_long_window(card: str, rates) -> dict:
    """12b: internlm2-1.8b at full width and depth, sliding-window decode
    through ``adapt_for_shape(cfg, SHAPES["long_500k"])``: prefill 1 x
    LONG_PROMPT through ``serve.generate`` and LONG_STEPS greedy steps on
    the window's ring cache, counts set to 0 just before and read just
    after (one windowed flash launch per layer, in the prefill). Then the
    windowed flash kernel at the prefill's shape against its plain
    version, and the prefill's last logits in fp32 with the kernels
    against ``impl="plain"``. Returns the launches."""
    base = lm_configs.get_config(LONG_ARCH)
    cfg = adapt_for_shape(base, SHAPES["long_500k"])
    w = cfg.sliding_window
    if w != LONG_CONTEXT_WINDOW or base.sliding_window:
        raise RuntimeError(f"12b: adapt_for_shape gave window {w}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, 0)
    n_params = sum(t.numel() for t in _tensors(params))
    if n_params != param_count(cfg):
        raise RuntimeError(f"12b: {n_params} parameters")
    gen = torch.Generator(device="cuda").manual_seed(13)
    toks = torch.randint(0, cfg.vocab, (1, LONG_PROMPT), generator=gen,
                         device="cuda")
    max_seq = LONG_PROMPT + LONG_STEPS
    want = {**dict.fromkeys(WRAPPERS, 0), "selective_scan": 0,
            "flash_attention": cfg.n_layers}
    torch.cuda.synchronize()
    _reset_all_counts()
    out = serve.generate(cfg, params, toks, LONG_STEPS)
    torch.cuda.synchronize()
    got = {**_counts(), **_lm_counts()}
    if got != want:
        raise RuntimeError(f"12b: launches {got}, expected {want}")
    peak = torch.cuda.max_memory_allocated()
    cache = out["cache"]
    pos = cache.slot_pos
    if not (pos.shape[0] == w and int(pos.min()) == max_seq - w
            and int(pos.max()) == max_seq - 1 and cache.index == max_seq):
        raise RuntimeError(f"12b: ring {pos.shape[0]} slots, positions "
                           f"{int(pos.min())}..{int(pos.max())}")
    logits = out["prefill_logits"]
    if not (bool(torch.isfinite(logits.float()).all()) and bool(
            torch.isfinite(out["logits"].float()).all())):
        raise RuntimeError("12b: non-finite logits")
    print(f"  12b {cfg.name} ({cfg.source}) at full width and depth "
          f"({n_params:,} parameters, {cfg.dtype}) through adapt_for_shape"
          f"(long_500k): sliding_window {w}; prefill 1x{LONG_PROMPT} "
          f"{out['prefill_s'] * 1e3:.2f} ms (first call), {LONG_STEPS} greedy"
          f" steps in {out['decode_s'] * 1e3:.2f} ms "
          f"({LONG_STEPS / out['decode_s']:.2f} tokens/s) on the {w}-slot "
          f"ring (positions {int(pos.min())}..{int(pos.max())} after); "
          f"peak memory {peak / 2**30:.3f} GiB; launches flash "
          f"{got['flash_attention']} (the prefill's, windowed), others 0 on "
          f"{card}")
    del out, cache
    gc.collect()
    torch.cuda.empty_cache()
    flash = check_flash(1, LONG_PROMPT, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                        w, rates, gen, timed=False)
    cfg32 = cfg.with_(dtype="float32")
    params32 = _upcast(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    k_logits, _ = lm.prefill(cfg32, params32, toks, max_seq=max_seq)
    p_logits, _ = lm.prefill(cfg32, params32, toks, max_seq=max_seq,
                             impl="plain")
    torch.cuda.synchronize()
    share = _band(k_logits, p_logits, LONG_LOGITS_BAND,
                  "12b fp32 prefill logits, kernels vs plain")
    print(f"    fp32 prefill's last logits, kernels vs impl=\"plain\": "
          f"max |diff| {share:.3g} of the plain run's scale (band "
          f"{LONG_LOGITS_BAND}); argmax equal: "
          f"{bool(torch.equal(k_logits.argmax(-1), p_logits.argmax(-1)))}")
    del params32, k_logits, p_logits
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention": got["flash_attention"],
            "window_shape": flash}


def _pytree_state(layout, st):
    """The pytree engine's state holding a flat-plane ``EngineState``'s
    values: ∇, the worker copies and the per-worker planes unpacked leaf
    by leaf, cada2's ring gathered to the dense stale iterates
    ``ring[slot]`` (the pytree plane's form), AMSGrad's moments unpacked
    in fp32; a protocol optimizer's state is per leaf on both planes."""
    comm = st.comm
    extras = {}
    for k, v in comm.extras.items():
        if k == "ring":
            slot = comm.extras["slot"].long()
            extras["worker_params"] = {n: x.index_select(0, slot)
                                       for n, x in v.items()}
        elif k in ("worker_delta", "residual", "momenta"):
            extras[k] = layout.unpack_worker(v)
        elif k not in ("slot", "ring_version"):
            extras[k] = v
    opt = st.opt_state
    if isinstance(opt, FusedState):
        f32 = (torch.float32,) * len(layout.dtypes)
        opt = FusedState(count=opt.count, h=layout.unpack(opt.h, f32),
                         vhat=layout.unpack(opt.vhat, f32))
    return st._replace(
        opt_state=opt, params_flat=None,
        comm=CommState(nabla=layout.unpack(comm.nabla),
                       worker_grads=layout.unpack_worker(comm.worker_grads),
                       staleness=comm.staleness, diff_hist=comm.diff_hist,
                       extras=extras))


def check_fused_cada_update(params, gen, lr: float = 5e-4) -> None:
    """``ops.fused_cada_update``, the pytree plane's entry into the AMSGrad
    kernel, on the paper MLP's tree against ``impl="plain"``: the leaves
    packed into one fp32 buffer padded to a multiple of 1024, one launch
    over it, θ', h', v̂' bit for bit in every leaf, Σupd² within
    SUM_RTOL. Outside the counted runs."""
    def draw(scale, nonneg=False):
        def leaf(p):
            x = scale * torch.randn(p.shape, generator=gen, device="cuda")
            return x.abs() if nonneg else x
        return tree_map(leaf, params)
    h, vhat, grads = draw(0.1), draw(0.01, nonneg=True), draw(1.0)
    before = cada_update.fused_amsgrad_flat.launches
    k_out = kops.fused_cada_update(params, h, vhat, grads, lr)
    torch.cuda.synchronize()
    if cada_update.fused_amsgrad_flat.launches != before + 1:
        raise RuntimeError("fused_cada_update: not one kernel launch")
    p_out = kops.fused_cada_update(params, h, vhat, grads, lr, impl="plain")
    n_flat = sum(x.numel() for x in tree_leaves(params))
    n_pad = -(-n_flat // 1024) * 1024
    label = (f"  fused_cada_update on the MLP tree ({len(params)} leaves, "
             f"{n_flat} elements padded to {n_pad})")
    for what, kk, pp in zip(("theta", "h", "vhat"), k_out, p_out):
        for key in kk:
            if kk[key].dtype != pp[key].dtype or not torch.equal(kk[key],
                                                                 pp[key]):
                raise RuntimeError(f"{label}: {what}'[{key}] is not "
                                   "bit-equal to the plain version's")
    rel = abs(float(k_out[3]) - float(p_out[3])) / float(p_out[3])
    if rel > SUM_RTOL:
        raise RuntimeError(f"{label}: sum upd^2 {float(k_out[3])} vs plain "
                           f"{float(p_out[3])}")
    print(f"{label}: one launch; theta', h', vhat' bit-equal to "
          f"impl=\"plain\" in every leaf, sum upd^2 rel {rel:.3g} (band "
          f"{SUM_RTOL})")


def phase_pytree_engine(card: str, params, batches, skipping_c: dict
                        ) -> dict:
    """12c: every kind on the paper MLP (M = 10, PYTREE_ROUNDS rounds, the
    gated rules at phase 4's skipping c, the delta rules as 10a runs them)
    through ``CADAEngine(fused=True)`` and ``CADAEngine(fused=False)`` in
    lockstep: each round the pytree engine starts from the flat engine's
    state (``_pytree_state``) and both step on the same batch, the counts
    set to 0 just before and read just after each step. The flat plane's
    launches as phase 4's; the pytree plane's one AMSGrad launch a round
    through ``ops.fused_cada_update`` where FusedAMSGrad serves, and
    nothing else (its LHS and eq. (3) are per-leaf PyTorch, as in the
    reference). Each round's masks and staleness equal, its parameters
    within PYTREE_RTOL / PYTREE_ATOL. (Free-running, a b-bit wire parts
    the planes: eq. (3)'s two orders give θ an ULP apart, and where
    x/scale·L lies that close to a .5 the quantizers round to neighbouring
    levels.) Returns the launches."""
    r = PYTREE_ROUNDS
    totals = dict.fromkeys({**WRAPPERS, **LM_WRAPPERS}, 0)
    check_fused_cada_update(params,
                            torch.Generator(device="cuda").manual_seed(14))
    print(f"  12c the pytree engine (fused=False) against the flat plane in "
          f"lockstep: paper MLP, M = {M}, {r} rounds a kind")
    for kind in KINDS:
        c = skipping_c.get(kind, 1.0)
        rule = _sim_rule(kind, c)
        local = kind in LOCAL_RULES
        opt = None if local else FusedAMSGrad(lr=5e-4)
        b = (_local_batches(batches, r, COHORT_H) if local
             else tuple(x[:r] for x in batches))
        eng_f = CADAEngine(mlp_loss, opt, rule, M)
        eng_p = CADAEngine(mlp_loss, opt, rule, M, fused=False)
        st = eng_f.init(params)
        layout = eng_f._layout
        got = {True: dict.fromkeys(totals, 0), False: dict.fromkeys(totals, 0)}
        secs = {True: [], False: []}
        uploads, gap = 0, 0.0
        for i in range(r):
            batch = tuple(x[i] for x in b)
            out = {}
            for fused, eng, start in ((False, eng_p, _pytree_state(layout, st)),
                                      (True, eng_f, st)):
                torch.cuda.synchronize()
                _reset_all_counts()
                t0 = time.perf_counter()
                out[fused] = eng.step(start, batch)
                torch.cuda.synchronize()
                secs[fused].append(time.perf_counter() - t0)
                for k, v in _train_counts().items():
                    got[fused][k] += v
            (s_f, m_f), (s_p, m_p) = out[True], out[False]
            for key in ("upload_mask", "staleness"):
                if not torch.equal(m_f[key], m_p[key]):
                    raise RuntimeError(f"12c {kind} round {i}: {key} flat "
                                       f"{m_f[key].tolist()}, pytree "
                                       f"{m_p[key].tolist()}")
            for key in s_f.params:
                a, p = s_f.params[key], s_p.params[key]
                if not torch.allclose(p, a, rtol=PYTREE_RTOL,
                                      atol=PYTREE_ATOL):
                    raise RuntimeError(
                        f"12c {kind} round {i}: params[{key}] outside rtol "
                        f"{PYTREE_RTOL}, atol {PYTREE_ATOL}")
                gap = max(gap, float((p - a).abs().max()))
            if not (_all_cuda(s_f) and _all_cuda(s_p)):
                raise RuntimeError(f"12c {kind}: state left the card")
            uploads += int(m_f["uploads"])
            st = s_f
        want = {True: {**expected_launches(kind, r, "own" if local
                                           else "fused"),
                       **dict.fromkeys(LM_WRAPPERS, 0)},
                False: {**dict.fromkeys(totals, 0),
                        "amsgrad": 0 if local else r}}
        if got != want:
            raise RuntimeError(f"12c {kind}: launches {got}, expected {want}")
        for plane in got.values():
            for k, v in plane.items():
                totals[k] += v
        print(f"    {kind} (c={c:.6g}): every round's masks and staleness "
              f"equal, params max |diff| {gap:.3g}; uploads {uploads} / "
              f"{r * M}; host ms per round (median) flat "
              f"{statistics.median(secs[True]) * 1e3:.3f}, pytree "
              f"{statistics.median(secs[False]) * 1e3:.3f} (first "
              f"{secs[False][0] * 1e3:.1f}); pytree launches amsgrad "
              f"{got[False]['amsgrad']} (fused_cada_update), others 0")
    return totals


def phase_pytree_trainer(card: str) -> dict:
    """12d: phase 7's model and cut through ``make_train_step`` with
    ``fused=True`` and ``fused=False``, cada2 at c = PYTREE_TRAIN_C, M = 2,
    PYTREE_TRAIN_STEPS steps of 4 x 2048 tokens, the same seed and
    batches; counts set to 0 just before and read just after each run (the
    flat step's kernels as phase 7's, none on the pytree step: its server
    step is eager per-leaf PyTorch, as the reference's). Masks equal, with
    at least one skipped upload; each step's loss and ||Δθ||² within
    PYTREE_LOSS_BAND / PYTREE_DTHETA_BAND of the flat run's, each
    worker's gate terms (LHS, RHS) within PYTREE_LHS_BAND; after the run
    at most PYTREE_PARAM_DIFFS bf16 weights differ, each by at most
    PYTREE_PARAM_ULPS bf16 ULP (of the weight's magnitude, or of the step
    size TRAIN_LR where that is larger). Returns the launches."""
    cfg = lm_configs.get_config(TRAIN_ARCH).with_(n_layers=TRAIN_LAYERS)
    tokens = make_token_batches(cfg, global_batch=TRAIN_BATCH,
                                seq=TRAIN_SEQ, steps=PYTREE_TRAIN_STEPS)
    rule = CommRule(kind="cada2", **{**TRAIN_RULE, "c": PYTREE_TRAIN_C})
    totals = dict.fromkeys({**WRAPPERS, **LM_WRAPPERS}, 0)
    runs, final = {}, {}
    for fused in (True, False):
        hp = trainer.TrainHParams(rule=rule, lr=TRAIN_LR, fused=fused)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = trainer.init_train_state(cfg, hp, TRAIN_M, 0)
        step = trainer.make_train_step(cfg, hp, TRAIN_M)
        want = (_train_launches("cada2", PYTREE_TRAIN_STEPS) if fused
                else dict.fromkeys(totals, 0))
        torch.cuda.synchronize()
        _reset_all_counts()
        step_ms, losses, dsq, masks, gate, ratios = [], [], [], [], [], []
        for i in range(PYTREE_TRAIN_STEPS):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            state, mets = step(state, _batch_on_card(tokens[i]))
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            losses.append(float(mets["loss"]))
            dsq.append(float(mets["dtheta_sq"]))
            masks.append(mets["upload_mask"].tolist())
            gate += mets["lhs"].reshape(-1).tolist()
            gate += mets["rhs"].reshape(-1).tolist()
            ratios.append([round(x, 4) for x in (mets["lhs"]
                                                 / mets["rhs"]).tolist()])
        got = _train_counts()
        if got != want:
            raise RuntimeError(f"12d fused={fused}: launches {got}, "
                               f"expected {want}")
        if not all(math.isfinite(v) for v in losses + dsq) or not _all_cuda(
                state):
            raise RuntimeError(f"12d fused={fused}: losses {losses}, "
                               f"||dtheta||^2 {dsq} or the state left the "
                               "card")
        for k, v in got.items():
            totals[k] += v
        runs[fused] = (losses, dsq, masks, gate, ratios,
                       statistics.median(step_ms[1:]), step_ms[0],
                       torch.cuda.max_memory_allocated())
        final[fused] = state.params
        del state, step
    (l_f, d_f, k_f, g_f, ratios, ms_f, first_f, peak_f), (
        l_p, d_p, k_p, g_p, _, ms_p, first_p, peak_p) = (runs[True],
                                                          runs[False])
    loss_gap = max(abs(a - b) / abs(a) for a, b in zip(l_f, l_p))
    dsq_gap = max(abs(a - b) / a for a, b in zip(d_f, d_p))
    gate_gap = max(abs(a - b) / abs(a) if a else abs(b)
                   for a, b in zip(g_f, g_p))
    ulps, n_diff = 0.0, 0
    for key in tree_paths(final[True]):
        a, p = (_leaf(final[x], key) for x in (True, False))
        ulps = max(ulps, _bf16_ulps_apart(a, p, TRAIN_LR))
        n_diff += int((a != p).sum())
    n = sum(x.numel() for x in tree_leaves(final[True]))
    skips = sum(not u for row in k_f for u in row)
    print(f"  12d {cfg.name} at full width, {TRAIN_LAYERS} of 24 layers, "
          f"cada2 {dict(TRAIN_RULE, c=PYTREE_TRAIN_C)}, M = {TRAIN_M}, "
          f"{PYTREE_TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens: masks flat {k_f}, pytree {k_p} ({skips} skipped "
          f"uploads); flat lhs/rhs by step {ratios}; lhs and rhs of the "
          f"two planes at most {gate_gap:.3g} apart (band "
          f"{PYTREE_LHS_BAND})")
    print(f"    losses flat {l_f}, pytree {l_p} (largest gap {loss_gap:.3g} "
          f"of the flat loss, band {PYTREE_LOSS_BAND}); ||dtheta||^2 flat "
          f"{d_f}, pytree {d_p} (largest gap {dsq_gap:.3g}, band "
          f"{PYTREE_DTHETA_BAND}); bf16 parameters after the run: {n_diff} "
          f"of {n} differ, by at most {ulps:.3g} bf16 ULP of max(|weight|, "
          f"lr) (bands {PYTREE_PARAM_DIFFS} weights, {PYTREE_PARAM_ULPS} "
          "ULP)")
    print(f"    step median after the first: flat {ms_f:.2f} ms (first "
          f"{first_f:.2f}), pytree {ms_p:.2f} ms (first {first_p:.2f}); peak"
          f" memory flat {peak_f / 2**30:.3f} GiB, pytree "
          f"{peak_p / 2**30:.3f} GiB; launches of the flat step amsgrad, "
          f"batched_diff_sq and eq3_row_mean {PYTREE_TRAIN_STEPS} each, of "
          f"the pytree step none, on {card}")
    if k_f != k_p or not skips:
        raise RuntimeError(f"12d: masks flat {k_f}, pytree {k_p}: not "
                           "equal, or no upload skipped")
    if (loss_gap > PYTREE_LOSS_BAND or dsq_gap > PYTREE_DTHETA_BAND
            or gate_gap > PYTREE_LHS_BAND):
        raise RuntimeError(f"12d: losses {loss_gap:.3g}, ||dtheta||^2 "
                           f"{dsq_gap:.3g} or the gate terms {gate_gap:.3g} "
                           "apart, above their bands")
    if ulps > PYTREE_PARAM_ULPS or n_diff > PYTREE_PARAM_DIFFS:
        raise RuntimeError(f"12d: {n_diff} weights differ, by at most "
                           f"{ulps} bf16 ULP, above the bands")
    del final
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def _bf16_ulps_apart(a, b, floor: float) -> float:
    """max |a − b| in bf16 ULPs of the larger magnitude, elementwise, that
    magnitude taken at least ``floor`` (a weight that a step moved through
    zero is as exact as the step, not as its own size)."""
    a, b = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()).clamp_min(floor))
    gap = (a - b).abs()
    return float(torch.where(gap == 0, 0.0, gap / torch.ldexp(
        torch.ones_like(gap), e - 8)).max())


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def phase_slice11(card: str, rates, params, batches, skipping_c: dict
                  ) -> tuple[dict, dict]:
    """Phase 12 (12a–12d). Returns the launches of its driven runs and the
    windowed flash kernel's check at 12b's prefill shape."""
    totals = dict.fromkeys({**WRAPPERS, **LM_WRAPPERS}, 0)
    t0 = time.perf_counter()
    for k, v in phase_scheduler(card, rates).items():
        totals[k] += v
    print(f"    12a took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    long = phase_long_window(card, rates)
    totals["flash_attention"] += long["flash_attention"]
    print(f"    12b took {time.perf_counter() - t0:.1f} s")
    for label, fn in (("12c", lambda: phase_pytree_engine(
            card, params, batches, skipping_c)),
                      ("12d", lambda: phase_pytree_trainer(card))):
        t0 = time.perf_counter()
        for k, v in fn().items():
            totals[k] += v
        print(f"    {label} took {time.perf_counter() - t0:.1f} s")
    return totals, long["window_shape"]


# ------------------------------------------------------- the mesh runtime

@contextlib.contextmanager
def _first_operands(rec: dict, row_mean: bool = False):
    """Records the operands the step's first call of the AMSGrad and the
    two-operand norm dispatch (``kernels/ops.py``, shard-local: the rank's
    slices) hands its kernel, as host copies (the card keeps only the
    run's own memory): the tensors and the step's hyper-parameters, not
    the dispatch options. ``row_mean``: eq. (3)'s too (the rank's rows of
    the wire)."""
    names = {"amsgrad": "fused_amsgrad_flat",
             "batched_diff_sq": "batched_diff_sq_norm"}
    if row_mean:
        names["eq3_row_mean"] = "eq3_row_mean"
    saved = {name: getattr(kops, attr) for name, attr in names.items()}

    def recording(name, f):
        def call(*args, **kw):
            if name not in rec:
                rec[name] = ([a.to("cpu", copy=True) if torch.is_tensor(a)
                              else a for a in args],
                             {k: v for k, v in kw.items()
                              if k not in ("impl", "shard")})
            return f(*args, **kw)
        return call

    for name, attr in names.items():
        setattr(kops, attr, recording(name, saved[name]))
    try:
        yield
    finally:
        for name, attr in names.items():
            setattr(kops, attr, saved[name])


@contextlib.contextmanager
def _timed_collectives(log: list):
    """Each all_reduce and all_gather of the process group timed on the
    host's clock between two synchronisations of the card, as (op, bytes,
    ms): gloo stages CUDA tensors through the host."""
    import torch.distributed as dist
    saved = {op: getattr(dist, op) for op in ("all_reduce", "all_gather")}

    def timed(op, f):
        def call(*args, **kw):
            t = args[0] if op == "all_reduce" else args[1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = f(*args, **kw)
            torch.cuda.synchronize()
            log.append((op, t.numel() * t.element_size(),
                        (time.perf_counter() - t0) * 1e3))
            return out
        return call

    for op, f in saved.items():
        setattr(dist, op, timed(op, f))
    try:
        yield
    finally:
        for op, f in saved.items():
            setattr(dist, op, f)


def _mesh_rank(rank: int, workdir: str) -> None:
    """One rank of phase 13 (spawned): the gloo process group on the one
    card, the run, its results as ``rank<r>.json``."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.load("cada_update")       # built by the parent: loaded, not built
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "rdv"),
        rank=rank, world_size=MESH_RANKS)
    out = mesh_rank_run(rank)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def mesh_rank_run(rank: int) -> dict:
    """13 on one rank: the mesh runtime's MESH_STEPS steps (counts set to 0
    just before and read just after; the first step's shard-local kernel
    operands and every collective recorded). The ranks gather the whole
    state, and rank 0 runs the one-process trainer from the same init and
    batches, which must give the same masks and θ, h, v̂, ∇ and stale
    plane bit for bit. Then, one rank after the other (the card to
    itself), the two kernels on the recorded operands against their
    plain versions, and the AMSGrad kernel timed on them and at the full
    plane's size."""
    import torch.distributed as dist
    cfg = lm_configs.get_config(TRAIN_ARCH).with_(n_layers=MESH_LAYERS)
    rule = CommRule(kind="cada2", **{**TRAIN_RULE, "c": MESH_C})
    hp = trainer.TrainHParams(rule=rule, lr=TRAIN_LR,
                              state_fsdp_axes=(DATA,))
    mesh = Mesh((MESH_RANKS, 1), (DATA, MODEL))
    make, _, m = trainer.jit_train_step(cfg, mesh, hp)
    fs = trainer.flat_sharding(cfg, mesh, hp)
    tokens = make_token_batches(cfg, global_batch=TRAIN_BATCH,
                                seq=TRAIN_SEQ, steps=MESH_STEPS)
    torch.cuda.reset_peak_memory_stats()
    whole = trainer.init_train_state(cfg, hp, m, 0, shards=fs.shards)
    n_flat = whole.h.numel()
    state = trainer.shard_train_state(whole, fs, hp)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    step = make(_batch_on_card(tokens[0]))
    rec, coll, step_ms, masks, dsq, losses = {}, [], [], [], [], []
    with _first_operands(rec), _timed_collectives(coll):
        torch.cuda.synchronize()
        _reset_all_counts()
        for i in range(MESH_STEPS):
            t0 = time.perf_counter()
            state, mets = step(state, _batch_on_card(tokens[i]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            masks.append(mets["upload_mask"].tolist())
            dsq.append(float(mets["dtheta_sq"]))
            losses.append(float(mets["loss"]))
        launches = _train_counts()
    peak = torch.cuda.max_memory_allocated()
    if not _all_cuda(state):
        raise RuntimeError(f"13 rank {rank}: the state left the card")
    out = {"rank": rank, "n_flat": n_flat, "local_h": state.h.numel(),
           "local_rows": list(state.comm.worker_grads.shape),
           "step_ms": step_ms, "peak_gib": peak / 2**30, "masks": masks,
           "dsq": dsq, "losses": losses, "launches": launches}
    by_op: dict = {}
    for op, nbytes, ms in coll:
        by_op.setdefault(f"{op} {nbytes} B", []).append(ms)
    out["collectives"] = {k: [len(v), statistics.median(v), max(v)]
                          for k, v in by_op.items()}
    print(f"    rank {rank}: {MESH_STEPS} steps, ms {out['step_ms']}, masks "
          f"{masks}, peak {out['peak_gib']:.3f} GiB", flush=True)
    # step 0's ||dtheta||^2 in fp64: the rank's updates, summed over ranks
    (t, h, v, g, lr), kw = rec["amsgrad"]
    _, h2, v2, _ = ref.amsgrad_ref(t.cuda(), h.cuda(), v.cuda(), g.cuda(),
                                   lr, **kw)
    # each update as both routes compute it (fp32), squared and summed in
    # fp64
    upd = (-lr * h2.float() / torch.sqrt(kw["eps"] + v2.float())).double()
    exact = torch.sum(upd * upd).reshape(1)
    del upd, h2, v2
    dist.all_reduce(exact)
    out["dsq0_fp64"] = float(exact)

    whole = trainer.unshard_train_state(state, fs, hp)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        out["reference"] = _mesh_reference(cfg, hp, m, fs.shards, tokens,
                                           whole, masks, dsq, losses,
                                           out["dsq0_fp64"])
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    for r in range(MESH_RANKS):
        if r == rank:
            out.update(_mesh_kernels(rank, rec))
        dist.barrier()
    return out


def _mesh_kernels(rank: int, rec: dict) -> dict:
    """The shard-local operands of the first step back on the card: each
    kernel against its plain version, the AMSGrad kernel's device time on
    them and on operands of the full plane's size."""
    out = {}
    (t, h, v, g, lr), kw = rec.pop("amsgrad")
    t, h, v, g = (x.cuda() for x in (t, h, v, g))
    k_out = cada_update.fused_amsgrad_flat(t, h, v, g, lr, **kw)
    p_out = ref.amsgrad_ref(t, h, v, g, lr, **kw)
    if not all(torch.equal(a, b) for a, b in zip(k_out[:3], p_out[:3])):
        raise RuntimeError(f"13 rank {rank}: the shard-local AMSGrad step "
                           "is not bit-equal to its plain version")
    sq_err = abs(float(k_out[3]) - float(p_out[3]))
    if sq_err > SUM_RTOL * float(p_out[3]):
        raise RuntimeError(f"13 rank {rank}: sum upd^2 {float(k_out[3])} "
                           f"vs plain {float(p_out[3])}")
    del k_out, p_out
    local_ms = device_ms(lambda: cada_update.fused_amsgrad_flat(
        t, h, v, g, lr, **kw), ("amsgrad_kernel",), calls=5)
    full = [torch.cat([x, x]) for x in (t, h, v, g)]
    out["amsgrad"] = {
        "n": t.numel(), "n_full": full[0].numel(), "max_abs_err": sq_err,
        "device_ms": local_ms,
        "full_device_ms": device_ms(lambda: cada_update.fused_amsgrad_flat(
            *full, lr, **kw), ("amsgrad_kernel",), calls=5)}
    del full, t, h, v, g
    torch.cuda.empty_cache()
    a, b = (x.cuda() for x in rec.pop("batched_diff_sq")[0])
    k_n = cada_update.batched_diff_sq_norm_flat(a, b)
    p_n = ref.batched_diff_sq_norm_ref(a, b)
    rel = _max_rel(k_n, p_n)
    if rel > SUM_RTOL:
        raise RuntimeError(f"13 rank {rank}: the row norm's rel err {rel}")
    out["batched_diff_sq"] = {
        "shape": list(a.shape), "max_abs_err": float((k_n - p_n).abs().max()),
        "device_ms": device_ms(lambda: cada_update.batched_diff_sq_norm_flat(
            a, b), ("row_sq_kernel",), calls=5)}
    del a, b
    torch.cuda.empty_cache()
    return out


def _mesh_reference(cfg, hp, m, shards, tokens, whole, masks, dsq,
                    losses, exact0: float) -> dict:
    """The one-process trainer (fused, M workers on one process) from the
    same init and batches as the mesh run: masks and losses equal at every
    step, ‖Δθ‖² within MESH_DSQ_RTOL, and θ, h, v̂, ∇ and the stale plane
    equal bit for bit after the run; raises otherwise, naming every array
    that differs with its largest gap."""
    state = trainer.init_train_state(cfg, hp, m, 0, shards=shards)
    step = trainer.make_train_step(cfg, hp, m, shards=shards)
    r_masks, r_dsq, r_losses, ms = [], [], [], []
    for i in range(MESH_STEPS):
        t0 = time.perf_counter()
        state, mets = step(state, _batch_on_card(tokens[i]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        r_masks.append(mets["upload_mask"].tolist())
        r_dsq.append(float(mets["dtheta_sq"]))
        r_losses.append(float(mets["loss"]))
    pairs = [("h", whole.h, state.h), ("vhat", whole.vhat, state.vhat),
             ("nabla", whole.comm.nabla, state.comm.nabla),
             ("worker_grads", whole.comm.worker_grads,
              state.comm.worker_grads)]
    pairs += [(f"theta {'/'.join(k)}", _leaf(whole.params, k),
               _leaf(state.params, k)) for k in tree_paths(state.params)]
    differ = {name: float((a.float() - b.float()).abs().max())
              for name, a, b in pairs if not torch.equal(a, b)}
    dsq_gap = max(abs(a - b) / b for a, b in zip(dsq, r_dsq))
    out = {"masks": r_masks, "dsq": r_dsq, "losses": r_losses,
           "step_ms": ms, "dsq_gap": dsq_gap, "differ": differ,
           "arrays": len(pairs)}
    out["dsq0_fp64_gap"] = {"mesh": abs(dsq[0] - exact0) / exact0,
                             "one_process": abs(r_dsq[0] - exact0) / exact0}
    if masks != r_masks or losses != r_losses:
        raise RuntimeError(f"13: masks {masks} / losses {losses} on the "
                           f"mesh, {r_masks} / {r_losses} in one process")
    if dsq_gap > MESH_DSQ_RTOL:
        raise RuntimeError(f"13: ||dtheta||^2 {dsq} on the mesh, {r_dsq} "
                           f"in one process ({dsq_gap:.3g} apart)")
    if differ:
        raise RuntimeError(f"13: not bit-equal to the one-process trainer: "
                           f"{differ}")
    return out


def phase_mesh(card: str) -> dict:
    """Phase 13: MESH_RANKS ranks spawned (the ``spawn`` start method, the
    kernels built by this process before), each failing the phase if it
    fails. Prints each rank's run and returns the launches of the driven
    runs summed over the ranks."""
    import torch.multiprocessing as mp
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mp.start_processes(_mesh_rank, args=(str(MESH_DIR),), nprocs=MESH_RANKS,
                       join=True, start_method="spawn")
    wall = time.perf_counter() - t0
    results = []
    for r in range(MESH_RANKS):
        with open(MESH_DIR / f"rank{r}.json") as f:
            results.append(json.load(f))
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    want = {**dict.fromkeys({**WRAPPERS, **LM_WRAPPERS}, 0),
            "amsgrad": MESH_STEPS, "batched_diff_sq": MESH_STEPS}
    totals = dict.fromkeys(want, 0)
    first = results[0]
    rule = dict(TRAIN_RULE, c=MESH_C)
    print(f"  13 {TRAIN_ARCH} at full width, {MESH_LAYERS} of 24 layers "
          f"(n_flat {first['n_flat']:,}), cada2 {rule}, state_fsdp_axes "
          f"('data',), mesh (data={MESH_RANKS}, model=1), "
          f"M = {MESH_RANKS}, {MESH_STEPS} steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens; {MESH_RANKS} ranks on one card over gloo, "
          f"spawned and joined in {wall:.1f} s, on {card}")
    for res in results:
        if res["launches"] != want:
            raise RuntimeError(f"13 rank {res['rank']}: launches "
                               f"{res['launches']}, expected {want}")
        if res["masks"] != first["masks"] or res["dsq"] != first["dsq"]:
            raise RuntimeError("13: the ranks' metrics differ")
        for k, v in res["launches"].items():
            totals[k] += v
        am, nm = res["amsgrad"], res["batched_diff_sq"]
        print(f"    rank {res['rank']}: server slice {res['local_h']:,} of "
              f"{res['n_flat']:,}, stale plane {res['local_rows']}; step "
              f"ms {[round(x, 1) for x in res['step_ms']]} (host clock, "
              f"collectives included); peak memory "
              f"{res['peak_gib']:.3f} GiB; launches amsgrad "
              f"{res['launches']['amsgrad']}, batched_diff_sq "
              f"{res['launches']['batched_diff_sq']}, eq3_row_mean "
              f"{res['launches']['eq3_row_mean']}")
        print(f"      shard-local AMSGrad n = {am['n']:,}: bit-equal to "
              f"plain, sum upd^2 |err| {am['max_abs_err']:.3g}; device "
              f"{_ms(am['device_ms'])} against {_ms(am['full_device_ms'])} "
              f"for the full plane's n = {am['n_full']:,}; row norm "
              f"{nm['shape']} |err| {nm['max_abs_err']:.3g}, device "
              f"{_ms(nm['device_ms'])}")
        print("      collectives (gloo through the host, not NCCL; count, "
              "median ms, max ms): " + "; ".join(
                  f"{k} x{c} {med:.2f} / {mx:.2f}"
                  for k, (c, med, mx) in res["collectives"].items()))
    r = first["reference"]
    print(f"    masks {first['masks']}, losses {first['losses']}: equal to "
          f"the one-process trainer's; ||dtheta||^2 mesh {first['dsq']}, "
          f"one process {r['dsq']} (largest gap {r['dsq_gap']:.3g}, band "
          f"{MESH_DSQ_RTOL}; at step 0 against the fp64 sum of the same "
          f"updates {first['dsq0_fp64']:.9g}: mesh "
          f"{r['dsq0_fp64_gap']['mesh']:.3g}, one process "
          f"{r['dsq0_fp64_gap']['one_process']:.3g}); theta, h, vhat, "
          f"nabla and the stale plane "
          f"({r['arrays']} arrays) bit-equal; one-process step ms "
          f"{[round(x, 1) for x in r['step_ms']]}")
    if all(all(row) for row in first["masks"]) or not any(
            any(row) for row in first["masks"]):
        raise RuntimeError(f"13: masks {first['masks']}: no step skipped, "
                           "or none uploaded")
    return totals


# ------------------------------------------------ tensor-parallel serving

def _tp_one_process(cfg, params, prompts, inputs: list, max_seq: int
                    ) -> dict:
    """One process: the prefill's last logits and cache (host copies) and
    the logits of each decode step fed ``inputs`` in turn."""
    logits, cache = lm.prefill(cfg, params, prompts, max_seq=max_seq)
    out = {"prefill_logits": logits.cpu(), "logits": [],
           "cache": {f: getattr(cache, f).cpu() for f in ("k", "v", "conv",
                                                         "ssm")
                     if getattr(cache, f) is not None}}
    for tok in inputs:
        logits, cache = lm.decode_step(cfg, params, cache, tok.cuda())
        out["logits"].append(logits.cpu())
    return out


def _tp_reference(label: str) -> dict:
    """The one-process runs of a phase-14 config, in this process before
    the spawn: params from seed 0 and prompts from seed 1 drawn on the
    card (the ranks draw the same), prefill at a width of S + steps, then
    greedy decode in bf16; the same prefill and steps (fed the bf16 run's
    tokens) in fp32 on the upcast weights. Saves for the ranks the
    per-leaf fp64 sums of the params, the step inputs and each bf16
    array's distance from its fp32 run (``<label>_small.pt``), and both
    runs' logits and caches (``<label>.pt``, rank 0's); returns the
    parameter bytes and the bf16 warm prefill's ms."""
    arch, b, s, steps = TP_SERVE[label]
    cfg = lm_configs.get_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    params = lm.init_params(cfg, 0)
    prompts = serve.random_prompts(cfg, b, s, 1, "cuda")
    logits, cache = lm.prefill(cfg, params, prompts, max_seq=s + steps)
    inputs, tok = [], torch.argmax(logits, dim=-1)
    for _ in range(steps):
        inputs.append(tok.cpu())
        logits, cache = lm.decode_step(cfg, params, cache, tok)
        tok = torch.argmax(logits, dim=-1)
    del cache
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    lm.prefill(cfg, params, prompts, max_seq=s + steps)
    end.record()
    end.synchronize()
    runs = {"bf16": _tp_one_process(cfg, params, prompts, inputs, s + steps),
            "fp32": _tp_one_process(cfg.with_(dtype="float32"),
                                    _upcast(params), prompts, inputs,
                                    s + steps)}
    f32 = _tp_arrays(runs["fp32"])
    floors = {name: _band(a, f32[name], float("inf"), "")
              for name, a in _tp_arrays(runs["bf16"]).items()}
    torch.save({"sums": [float(t.double().sum())
                         for t in tree_leaves(params)],
                "inputs": inputs, "floors": floors},
               TP_DIR / f"{label}_small.pt")
    torch.save(runs, TP_DIR / f"{label}.pt")
    out = {"param_bytes": sum(t.numel() * t.element_size()
                              for t in tree_leaves(params)),
           "warm_ms": start.elapsed_time(end)}
    del params, prompts, runs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _tp_arrays(run: dict) -> dict:
    """A run's compared arrays by name: the prefill's logits, each cache
    field, each decode step's logits."""
    return {"prefill logits": run["prefill_logits"],
            **{f"cache {f}": v for f, v in run["cache"].items()},
            **{f"step {i}": v for i, v in enumerate(run["logits"])}}


def _tp_rank(rank: int, workdir: str) -> None:
    """One rank of phase 14 (spawned): the gloo process group on the one
    card, both configs, the results as ``rank<r>.json``."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name in ("ssm_scan", "flash_attention"):
        build.load(name)         # built by the parent: loaded, not built
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "rdv"),
        rank=rank, world_size=TP_RANKS)
    mesh = Mesh((1, TP_RANKS), (DATA, MODEL))
    rates = card_rates(torch.cuda.get_device_name(0))
    out = {label: tp_rank_run(rank, label, mesh, rates)
           for label in TP_SERVE}
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _tp_serve(cfg, mesh, params, prompts, inputs: list, steps: int,
              coll: list | None = None) -> dict:
    """The builders' prefill (at S + steps) and a decode step fed each of
    ``inputs``, on this rank's ``params`` shards: the whole logits, the
    gathered cache after the prefill, the first prefill's host ms, the
    decode tokens/s and the collectives per prefill (each collective
    timed into ``coll`` when given; the gather of the cache is not)."""
    from repro_torch.distributed import serving
    from repro_torch.distributed.sharding import gather_cache
    b, s = prompts.shape
    prefill = serving.jit_prefill_step(cfg, mesh, {"tokens": torch.empty(
        prompts.shape, dtype=prompts.dtype, device="meta")},
        max_seq=s + steps)
    decode, _, _ = serving.jit_decode_step(cfg, mesh, b, s + steps)
    log = [] if coll is None else coll
    timing = _timed_collectives(log) if coll is not None \
        else contextlib.nullcontext()
    torch.cuda.synchronize()
    with timing:
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
    out = {"prefill_logits": logits, "prefill_ms": prefill_ms,
           "n_prefill_coll": len(log), "per_prefill": {
               **_counts(), **_lm_counts()}, "logits": []}
    whole = gather_cache(cache, cfg, mesh, b)
    out["cache"] = {f: getattr(whole, f) for f in ("k", "v", "conv", "ssm")
                    if getattr(whole, f) is not None}
    del whole
    timing = _timed_collectives(log) if coll is not None \
        else contextlib.nullcontext()
    with timing:
        t0 = time.perf_counter()
        for tok in inputs:
            lg, cache = decode(params, cache, {"tokens": tok.cuda()})
            out["logits"].append(lg)
        torch.cuda.synchronize()
        out["tokens_per_s"] = steps * b / (time.perf_counter() - t0)
    out["prefill"] = prefill
    return out


def tp_rank_run(rank: int, label: str, mesh, rates) -> dict:
    """14a or 14b on one rank: the whole params drawn and cut to the rank's
    shards (``shard_params``); the driven run in bf16 through the builders
    (the counts set to 0 just before and read just after; every collective
    timed); a warm prefill by CUDA events (a MoE model's must give the
    first one's bits); then the same in fp32 on the upcast weights. Rank 0
    holds each run against the one-process runs (TP_BAND_F32; bf16 within
    TP_BF16_FLOORS of bf16's own distance from fp32). Then, one rank
    after the other (the card to itself), the flash and scan kernels at
    the rank's shapes against their plain versions, timed."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import shard_params
    arch, b, s, steps = TP_SERVE[label]
    cfg = lm_configs.get_config(arch)
    small = torch.load(TP_DIR / f"{label}_small.pt")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    whole = lm.init_params(cfg, 0)
    if [float(t.double().sum()) for t in tree_leaves(whole)] != \
            small["sums"]:
        raise RuntimeError(f"{label} rank {rank}: the params drawn differ "
                           "from the one-process run's")
    params = shard_params(whole, cfg, mesh)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    attn_p = params["shared"]["attn"] if cfg.attn_every else \
        params["blocks"]["attn"]
    shapes = {"heads": attn_p["wq"].shape[-1] // cfg.hd,
              "kv_heads": attn_p["wk"].shape[-1] // cfg.hd}
    if cfg.block == "mamba2":
        shapes["d_inner"] = params["blocks"]["in_x"].shape[-1]
    if cfg.block == "moe":
        shapes["experts"] = params["blocks"]["mlp"]["w_up"].shape[1]
    prompts = serve.random_prompts(cfg, b, s, 1, "cuda")
    coll: list = []
    _reset_all_counts()
    run = _tp_serve(cfg, mesh, params, prompts, small["inputs"], steps, coll)
    launches = {**_counts(), **_lm_counts()}
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    again, cache2 = run["prefill"](params, {"tokens": prompts})
    end.record()
    end.synchronize()
    same = torch.equal(again, run["prefill_logits"])
    if cfg.block == "moe":
        third, cache3 = run["prefill"](params, {"tokens": prompts})
        same = (same and torch.equal(third, again)
                and torch.equal(cache2.k, cache3.k)
                and torch.equal(cache2.v, cache3.v))
        del third, cache3
        if not same:
            raise RuntimeError(f"{label} rank {rank}: two prefills of the "
                               "same prompts differ")
    del again, cache2
    peak = torch.cuda.max_memory_allocated()
    local_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
    tokens = [torch.argmax(run["prefill_logits"], -1)] + [
        torch.argmax(lg, -1) for lg in run["logits"]]
    differ = [i for i, (a, w) in enumerate(zip(tokens[:-1],
                                               small["inputs"]))
              if not torch.equal(a.cpu(), w)]
    by_op: dict = {}
    for i, (op, nbytes, ms) in enumerate(coll):
        where = "prefill" if i < run["n_prefill_coll"] else "decode"
        by_op.setdefault(f"{where} {op} {nbytes} B", []).append(ms)
    out = {"rank": rank, "shapes": shapes, "per_prefill": run["per_prefill"],
           "launches": launches, "prefill_ms": run["prefill_ms"],
           "warm_prefill_ms": start.elapsed_time(end),
           "decode_tokens_per_s": run["tokens_per_s"],
           "peak_gib": peak / 2**30, "param_bytes": local_bytes,
           "first_token_diff": differ[0] if differ else None,
           "prefill_bits_same": same,
           "logits_sum": float(run["prefill_logits"].double().sum()),
           "collectives": {k: [len(v), statistics.median(v), max(v)]
                           for k, v in by_op.items()},
           "collectives_per_prefill": run["n_prefill_coll"],
           "collectives_per_step": (len(coll) - run["n_prefill_coll"])
           / steps}
    runs = {"bf16": {k: run[k] for k in ("prefill_logits", "cache",
                                         "logits")}}
    del run, params
    gc.collect()
    torch.cuda.empty_cache()
    whole = _upcast(lm.init_params(cfg, 0))
    params = shard_params(whole, cfg, mesh)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    run = _tp_serve(cfg.with_(dtype="float32"), mesh, params, prompts,
                    small["inputs"], steps)
    runs["fp32"] = {k: run[k] for k in ("prefill_logits", "cache",
                                        "logits")}
    del run, params
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        out["floors"] = small["floors"]
        out.update(_tp_compare(label, cfg, runs))
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    for r in range(TP_RANKS):
        if r == rank:
            gen = torch.Generator(device="cuda").manual_seed(14)
            out["flash_attention"] = check_flash(
                b, s, shapes["heads"], shapes["kv_heads"], cfg.hd,
                cfg.sliding_window, rates, gen, timed=True)
            if cfg.block == "mamba2":
                out["selective_scan"] = check_scan(
                    b, s, shapes["d_inner"], cfg.ssm_state,
                    cfg.mamba_headdim, rates, gen, timed=True,
                    per_channel=True)
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def _tp_compare(label: str, cfg, runs: dict) -> dict:
    """Rank 0's comparison of the ranks' fp32 and bf16 runs with the
    one-process runs: every array's largest gap as a share of the
    one-process array's scale, and in fp32 the count of elements above
    TP_BAND_F32 of it; printed at once, then each held to its band (fp32:
    TP_BAND_F32, a MoE config's TP_BAND_MOE; bf16: TP_BF16_FLOORS times
    bf16's own distance from fp32). Raises naming every array outside."""
    ref = torch.load(TP_DIR / f"{label}.pt")
    floors = torch.load(TP_DIR / f"{label}_small.pt")["floors"]
    shares, above, outside = {}, {}, []
    for dt in ("fp32", "bf16"):
        want = _tp_arrays(ref[dt])
        shares[dt] = {}
        for name, got in _tp_arrays(runs[dt]).items():
            w = want[name].cuda().double()
            gap = (got.double() - w).abs()
            scale = float(w.abs().max().clamp_min(1e-30))
            shares[dt][name] = float(gap.max()) / scale
            if dt == "fp32":
                above[name] = int((gap > TP_BAND_F32 * scale).sum())
            band = ((TP_BAND_MOE if cfg.block == "moe" else TP_BAND_F32)
                    if dt == "fp32" else TP_BF16_FLOORS * floors[name])
            if shares[dt][name] > band:
                outside.append(f"{dt} {name} {shares[dt][name]:.4g} > "
                               f"{band:.4g}")
    print(f"    {label} rank 0 against one process: fp32 "
          + ", ".join(f"{k} {v:.3g}" + (f" ({above[k]} elements above "
                                        f"{TP_BAND_F32})" if above[k] else "")
                      for k, v in shares["fp32"].items())
          + "; bf16 " + ", ".join(f"{k} {v:.3g} (floor {floors[k]:.3g})"
                                  for k, v in shares["bf16"].items()),
          flush=True)
    if outside:
        raise RuntimeError(f"{label}: outside the bands: {outside}")
    return {"shares": shares, "above": above}


def _worst(shares: dict, prefix: str) -> str:
    items = {k: v for k, v in shares.items() if k.startswith(prefix)}
    k = max(items, key=items.get)
    return f"{items[k]:.4g} ({k})"


def phase_tp(card: str) -> tuple[dict, dict]:
    """Phase 14: the one-process runs here, then TP_RANKS ranks spawned
    (the ``spawn`` start method, the kernels built by this process
    before), each failing the phase if it fails. Prints each rank's run;
    returns the launches of the driven runs summed over the ranks and
    rank 0's kernel checks at 14a's shapes."""
    import torch.multiprocessing as mp
    shutil.rmtree(TP_DIR, ignore_errors=True)
    TP_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    one = {label: _tp_reference(label) for label in TP_SERVE}
    print(f"  the one-process runs (bf16 and fp32) in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mp.start_processes(_tp_rank, args=(str(TP_DIR),), nprocs=TP_RANKS,
                       join=True, start_method="spawn")
    wall = time.perf_counter() - t0
    results = []
    for r in range(TP_RANKS):
        with open(TP_DIR / f"rank{r}.json") as f:
            results.append(json.load(f))
    shutil.rmtree(TP_DIR, ignore_errors=True)
    totals = dict.fromkeys({**WRAPPERS, **LM_WRAPPERS}, 0)
    print(f"  {TP_RANKS} ranks on one card over gloo (through the host, not "
          f"NCCL), mesh (data=1, model={TP_RANKS}), spawned and joined in "
          f"{wall:.1f} s, on {card}; every all-reduce in fp32")
    for label, (arch, b, s, steps) in TP_SERVE.items():
        cfg = lm_configs.get_config(arch)
        n_attn = (cfg.n_layers // cfg.attn_every if cfg.attn_every
                  else cfg.n_layers)
        want = {**dict.fromkeys({**WRAPPERS, **LM_WRAPPERS}, 0),
                "flash_attention": n_attn,
                "selective_scan": cfg.n_layers if cfg.block == "mamba2"
                else 0}
        first = results[0][label]
        print(f"  {label} {cfg.name} at full width and depth, {b} x {s} "
              f"prompts, {steps} decode steps teacher-forced on the "
              f"one-process bf16 tokens; one process: "
              f"{one[label]['param_bytes']:,} parameter bytes, warm bf16 "
              f"prefill {one[label]['warm_ms']:.2f} ms (CUDA events)")
        for res in (r[label] for r in results):
            if res["per_prefill"] != want or res["launches"] != want:
                raise RuntimeError(
                    f"{label} rank {res['rank']}: launches per prefill "
                    f"{res['per_prefill']}, in all {res['launches']}; "
                    f"expected {want} in the prefill and none in decode")
            if res["logits_sum"] != first["logits_sum"]:
                raise RuntimeError(f"{label}: the ranks' logits differ")
            for k, v in res["launches"].items():
                totals[k] += v
            print(f"    rank {res['rank']}: local {res['shapes']}; "
                  f"{res['param_bytes']:,} parameter bytes "
                  f"({res['param_bytes'] / one[label]['param_bytes']:.4f} of "
                  f"one process); launches per prefill flash "
                  f"{res['per_prefill']['flash_attention']}, scan "
                  f"{res['per_prefill']['selective_scan']}, 0 in decode; "
                  f"bf16 prefill {res['prefill_ms']:.2f} ms first call (host"
                  f" clock), {res['warm_prefill_ms']:.2f} ms warm (CUDA "
                  f"events), a second prefill bit-equal "
                  f"{res['prefill_bits_same']}; decode "
                  f"{res['decode_tokens_per_s']:.2f} tokens/s; peak memory "
                  f"{res['peak_gib']:.3f} GiB; "
                  f"{res['collectives_per_prefill']} collectives per "
                  f"prefill, {res['collectives_per_step']:.0f} per decode "
                  f"step")
            print("      collectives (count, median ms, max ms): " + "; ".join(
                f"{k} x{c} {med:.3f} / {mx:.3f}"
                for k, (c, med, mx) in res["collectives"].items()))
        sh = first["shares"]
        floors = first["floors"]
        band = TP_BAND_MOE if cfg.block == "moe" else TP_BAND_F32
        print(f"    against one process, the largest share of the "
              f"one-process array's scale: fp32 (band {band}; "
              f"{sum(first['above'].values())} elements above "
              f"{TP_BAND_F32} in all) "
              f"prefill logits {sh['fp32']['prefill logits']:.4g}, decode "
              f"{_worst(sh['fp32'], 'step')}, cache "
              f"{_worst(sh['fp32'], 'cache')}; bf16 (band "
              f"{TP_BF16_FLOORS} x bf16's own distance from fp32) prefill "
              f"logits {sh['bf16']['prefill logits']:.4g} (floor "
              f"{floors['prefill logits']:.4g}), decode "
              f"{_worst(sh['bf16'], 'step')}, cache "
              f"{_worst(sh['bf16'], 'cache')}; floors: decode "
              f"{_worst(floors, 'step')}, cache {_worst(floors, 'cache')}; "
              f"bf16 greedy tokens first differ at "
              + ("no step" if first["first_token_diff"] is None else
                 f"token {first['first_token_diff']} (0 = the prefill's)"))
    kernels = {k: results[0]["14a"][k] for k in LM_WRAPPERS}
    return totals, kernels


# ------------------------------------- the mesh trainer's model axis, FSDP

def _tpt_stub():
    """TPT_MESH as the sharding tables read a mesh: its ``.shape``."""
    return type("MeshShape", (), {"shape": dict(zip((DATA, MODEL),
                                                    TPT_MESH))})()


def _tpt_setup(label: str):
    """(cfg at the phase's depth, hyper-parameters, token batches) of 15a,
    15b or 15c, on any mesh of TPT_MESH's shape."""
    from dataclasses import replace
    from repro_torch.launch.policy import train_policy
    arch, layers, seq = TPT_TRAIN["15a" if label == TPT_PYTREE else label]
    cfg = lm_configs.get_config(arch).with_(n_layers=layers)
    rule = CommRule(kind="cada2", **{**TRAIN_RULE, "c": TPT_C})
    stub = _tpt_stub()
    if label == "15a":
        hp = trainer.TrainHParams(rule=rule, lr=TRAIN_LR,
                                  state_fsdp_axes=(MODEL, DATA))
    elif label == TPT_PYTREE:
        hp = trainer.TrainHParams(rule=rule, lr=TRAIN_LR, fused=False,
                                  state_fsdp_axes=(DATA,),
                                  shard_cada_state=True)
    else:   # the policy of the whole model, not of its depth cut
        hp = replace(train_policy(lm_configs.get_config(arch), stub),
                     rule=rule, state_fsdp_axes=(MODEL, DATA))
    tokens = make_token_batches(cfg, global_batch=TRAIN_BATCH, seq=seq,
                                steps=TPT_STEPS)
    return cfg, hp, tokens, trainer.flat_state_shards(cfg, stub, hp)


def _tpt_dtypes(label: str) -> tuple:
    return ("float32", "bfloat16") if label == "15a" else ("float32",)


def _tpt_reference(label: str) -> dict:
    """The one-process trainer of 15a, 15b or 15c in this process, before
    the spawn: TPT_STEPS steps from seed 0 in each dtype of the phase. Saves
    for rank 0 each run's masks, losses, ‖Δθ‖², θ's update and h (host
    copies, ``<label>.pt``); returns the step ms and, for bf16, its
    distance from the fp32 run (the floors of the ranks' bf16 run)."""
    cfg, hp, tokens, shards = _tpt_setup(label)
    runs, ms = {}, {}
    for dt in _tpt_dtypes(label):
        gc.collect()
        torch.cuda.empty_cache()
        c = cfg.with_(dtype=dt)
        state = trainer.init_train_state(c, hp, TRAIN_M, 0, shards=shards)
        layout = flat.layout_of(state.params, shards=shards)
        theta0 = layout.pack(state.params)
        step = trainer.make_train_step(c, hp, TRAIN_M, shards=shards)
        run = {"masks": [], "losses": [], "dsq": []}
        ms[dt] = []
        for i in range(TPT_STEPS):
            t0 = time.perf_counter()
            state, mets = step(state, _batch_on_card(tokens[i]))
            torch.cuda.synchronize()
            ms[dt].append((time.perf_counter() - t0) * 1e3)
            run["masks"].append(mets["upload_mask"].tolist())
            run["losses"].append(float(mets["loss"]))
            run["dsq"].append(float(mets["dtheta_sq"]))
        run["update"] = (layout.pack(state.params) - theta0).cpu()
        run["h"] = (state.h if torch.is_tensor(state.h)
                    else layout.pack(state.h)).float().cpu()
        runs[dt] = run
        del state, step, theta0
    floors = {}
    if "bfloat16" in runs:
        floors = _tpt_gaps(runs["bfloat16"], runs["float32"])
    torch.save(runs, TPT_DIR / f"{label}.pt")
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    return {"ms": ms, "floors": floors}


def _tpt_gaps(got: dict, want: dict) -> dict:
    """The gaps of a run from another: losses and ‖Δθ‖² relative, θ's
    update and h as a share of ``want``'s scale."""
    out = {key: max(abs(a - b) / abs(b) for a, b in zip(got[key],
                                                        want[key]))
           for key in ("losses", "dsq")}
    for key in ("update", "h"):
        a, b = got[key].to(want[key].device), want[key]
        out[key] = float((a.double() - b.double()).abs().max()
                         / b.double().abs().max().clamp_min(1e-30))
    return out


def _tpt_rank(rank: int, workdir: str) -> None:
    """One rank of phase 15 (spawned): the gloo process group on the one
    card, both configs, the results as ``rank<r>.json``. The allocator
    grows its segments in place (four ranks share the card's memory, and
    a rank's plane-sized buffers change size from step to step)."""
    import torch.distributed as dist
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.load("cada_update")       # built by the parent: loaded, not built
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "rdv"),
        rank=rank, world_size=TPT_RANKS)
    mesh = Mesh(TPT_MESH, (DATA, MODEL))
    out = {label: tpt_rank_run(rank, label, mesh) for label in TPT_RUNS}
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _tpt_drive(rank: int, cfg, hp, mesh, tokens, rec=None) -> dict:
    """TPT_STEPS steps of the mesh trainer on this rank: the whole state
    drawn from seed 0 one rank at a time (the card holds one whole state
    beside the ranks' shards) and cut to the rank's; each collective timed
    and, with ``rec``, the shard-local kernels' first operands recorded.
    Returns the run (θ's update and h gathered whole, on the host of rank
    0 only) and the launches counted from just before to just after."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import uncut_tree
    fs = trainer.state_sharding(cfg, mesh, hp)
    shards = trainer.flat_state_shards(cfg, mesh, hp)
    make, _, m = trainer.jit_train_step(cfg, mesh, hp)
    for r in range(TPT_RANKS):
        if r == rank:
            whole = trainer.init_train_state(cfg, hp, m, 0, shards=shards)
            layout = flat.layout_of(whole.params, shards=shards)
            theta0 = layout.pack(whole.params).cpu() if rank == 0 else None
            state = trainer.shard_train_state(whole, fs, hp)
            del whole
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    # while the four ranks step, each one's cache is capped (it releases
    # its free blocks before it grows past the cap), so that their caches
    # cannot fill the card together; a whole state drawn above needs more
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.set_per_process_memory_fraction(TPT_RANK_GIB * 2**30 / total)
    step = make(_batch_on_card(tokens[0]))
    torch.cuda.reset_peak_memory_stats()
    coll: list = []
    run = {"masks": [], "losses": [], "dsq": [], "step_ms": []}
    with (_first_operands(rec, row_mean=True) if rec is not None
          else contextlib.nullcontext()), _timed_collectives(coll):
        torch.cuda.synchronize()
        _reset_all_counts()
        for i in range(TPT_STEPS):
            t0 = time.perf_counter()
            state, mets = step(state, _batch_on_card(tokens[i]))
            torch.cuda.synchronize()
            run["step_ms"].append((time.perf_counter() - t0) * 1e3)
            run["masks"].append(mets["upload_mask"].tolist())
            run["losses"].append(float(mets["loss"]))
            run["dsq"].append(float(mets["dtheta_sq"]))
            run.setdefault("lhs_rhs", []).append(
                (mets["lhs"] / mets["rhs"]).tolist())
        launches = _train_counts()
    run["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    run["peak_reserved_gib"] = torch.cuda.max_memory_reserved() / 2**30
    if not _all_cuda(state):
        raise RuntimeError(f"15 rank {rank}: the state left the card")
    run["param_bytes"] = sum(t.numel() * t.element_size()
                             for t in tree_leaves(state.params))
    run["local_h"] = sum(t.numel() for t in tree_leaves(state.h))
    by_op: dict = {}
    kinds: dict = {}
    for op, nbytes, ms in coll:
        by_op.setdefault(f"{op} {nbytes} B", []).append(ms)
        kind = kinds.setdefault(op, [0, 0, 0.0])
        kind[0], kind[1], kind[2] = kind[0] + 1, kind[1] + nbytes, \
            kind[2] + ms
    run["collectives"] = {k: [len(v), statistics.median(v), max(v)]
                          for k, v in by_op.items()}
    # a step's collectives by kind: count, bytes of the rank's tensors, ms
    run["step_collectives"] = {k: [c / TPT_STEPS, b / TPT_STEPS,
                                   ms / TPT_STEPS]
                               for k, (c, b, ms) in kinds.items()}
    run["collective_ms"] = sum(ms for _, _, ms in coll)
    params = uncut_tree(state.params, fs.pspecs, mesh)
    h = (fs.gather_server(state.h) if hp.fused
         else layout.pack(uncut_tree(state.h, fs.msp, mesh)))
    if rank == 0:
        run["update"] = layout.pack(params).cpu() - theta0
        run["h"] = h.float().cpu()
    del state, params, h
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(1.0)
    return run, launches


def tpt_rank_run(rank: int, label: str, mesh) -> dict:
    """15a, 15b or 15c on one rank: the driven fp32 run (on the flat
    plane the shard-local kernels' operands recorded), then 15a's bf16
    run; rank 0 holds each against the one-process runs. Then, on the
    flat plane, one rank after the other (the card to itself), the
    AMSGrad, row-norm and row-mean kernels on the fp32 run's first
    shard-local operands against their plain versions."""
    import torch.distributed as dist
    cfg, hp, tokens, _ = _tpt_setup(label)
    rec: dict = {}
    out = {"rank": rank}
    for dt in _tpt_dtypes(label):
        run, launches = _tpt_drive(rank, cfg.with_(dtype=dt), hp, mesh,
                                   tokens, rec if dt == "float32"
                                   and hp.fused else None)
        print(f"    {label} rank {rank} {dt}: step ms "
              f"{[round(x, 1) for x in run['step_ms']]}, masks "
              f"{run['masks']}, peak {run['peak_gib']:.3f} GiB (reserved "
              f"{run['peak_reserved_gib']:.3f})", flush=True)
        if dt == "float32":
            out["launches"] = launches
        out[dt] = {k: v for k, v in run.items() if k not in ("update", "h")}
        if rank == 0:
            ref = torch.load(TPT_DIR / f"{label}.pt")[dt]
            out[dt]["gaps"] = _tpt_gaps(run, ref)
            out[dt]["ref_masks"] = ref["masks"]
            del ref
        del run
        gc.collect()
    if not hp.fused:
        return out
    for r in range(TPT_RANKS):
        if r == rank:
            out.update(_tpt_kernels(rank, rec))
        dist.barrier()
    return out


def _tpt_kernels(rank: int, rec: dict) -> dict:
    """The first step's shard-local operands back on the card: AMSGrad
    (bit-equal to plain), the two-operand row norm and the row mean of the
    rank's wire rows, each against its plain version and timed (device
    ms)."""
    out = {}
    (t, h, v, g, lr), kw = rec.pop("amsgrad")
    t, h, v, g = (x.cuda() for x in (t, h, v, g))
    k_out = cada_update.fused_amsgrad_flat(t, h, v, g, lr, **kw)
    p_out = ref.amsgrad_ref(t, h, v, g, lr, **kw)
    if not all(torch.equal(a, b) for a, b in zip(k_out[:3], p_out[:3])):
        raise RuntimeError(f"15 rank {rank}: the shard-local AMSGrad step "
                           "is not bit-equal to its plain version")
    err = abs(float(k_out[3]) - float(p_out[3]))
    if err > SUM_RTOL * float(p_out[3]):
        raise RuntimeError(f"15 rank {rank}: sum upd^2 {float(k_out[3])} "
                           f"vs plain {float(p_out[3])}")
    out["amsgrad"] = {"n": t.numel(), "max_abs_err": err,
                      "device_ms": device_ms(
                          lambda: cada_update.fused_amsgrad_flat(
                              t, h, v, g, lr, **kw), ("amsgrad_kernel",),
                          calls=5)}
    del k_out, p_out, t, h, v, g
    torch.cuda.empty_cache()
    a, b = (x.cuda() for x in rec.pop("batched_diff_sq")[0])
    k_n = cada_update.batched_diff_sq_norm_flat(a, b)
    p_n = ref.batched_diff_sq_norm_ref(a, b)
    if _max_rel(k_n, p_n) > SUM_RTOL:
        raise RuntimeError(f"15 rank {rank}: the row norm's rel err "
                           f"{_max_rel(k_n, p_n)}")
    out["batched_diff_sq"] = {
        "shape": list(a.shape), "max_abs_err": float((k_n - p_n).abs().max()),
        "device_ms": device_ms(lambda: cada_update.batched_diff_sq_norm_flat(
            a, b), ("row_sq_kernel",), calls=5)}
    del a, b
    (plane, m_total), _ = rec.pop("eq3_row_mean")
    plane = plane.cuda()
    k_m = cada_update.eq3_row_mean_flat(plane, m_total)
    p_m = ref.eq3_row_mean_ref(plane, m_total)
    if not torch.equal(k_m, p_m):
        raise RuntimeError(f"15 rank {rank}: the row mean of the rank's "
                           "wire is not bit-equal to its plain version")
    out["eq3_row_mean"] = {
        "shape": list(plane.shape), "max_abs_err": 0.0,
        "device_ms": device_ms(lambda: cada_update.eq3_row_mean_flat(
            plane, m_total), ("row_mean_kernel",), calls=5)}
    del plane, k_m, p_m
    torch.cuda.empty_cache()
    return out


def phase_tpt(card: str) -> dict:
    """Phase 15: the one-process runs here, then TPT_RANKS ranks spawned
    (the ``spawn`` start method, the kernels built by this process
    before), each failing the phase if it fails. Prints each rank's run;
    returns the launches of the driven runs summed over the ranks."""
    import torch.multiprocessing as mp
    shutil.rmtree(TPT_DIR, ignore_errors=True)
    TPT_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    one = {}
    for label in TPT_RUNS:
        one[label] = _tpt_reference(label)
        print(f"  {label} one process: step ms " + ", ".join(
            f"{dt} {[round(x, 1) for x in v]}"
            for dt, v in one[label]["ms"].items()), flush=True)
    print(f"  the one-process runs in {time.perf_counter() - t0:.1f} s",
          flush=True)
    free, total = torch.cuda.mem_get_info()
    print(f"  before the spawn: {(total - free) / 2**30:.3f} of "
          f"{total / 2**30:.3f} GiB of the card in use, "
          f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved by this "
          "process", flush=True)
    t0 = time.perf_counter()
    mp.start_processes(_tpt_rank, args=(str(TPT_DIR),), nprocs=TPT_RANKS,
                       join=True, start_method="spawn")
    wall = time.perf_counter() - t0
    results = []
    for r in range(TPT_RANKS):
        with open(TPT_DIR / f"rank{r}.json") as f:
            results.append(json.load(f))
    shutil.rmtree(TPT_DIR, ignore_errors=True)
    want = {**dict.fromkeys({**WRAPPERS, **LM_WRAPPERS}, 0),
            "amsgrad": TPT_STEPS, "batched_diff_sq": TPT_STEPS}
    totals = dict.fromkeys(want, 0)
    print(f"  {TPT_RANKS} ranks on one card over gloo (through the host, "
          f"not NCCL), mesh (data={TPT_MESH[0]}, model={TPT_MESH[1]}), "
          f"M = {TPT_MESH[0]}, spawned and joined in {wall:.1f} s, on "
          f"{card}")
    for label, (arch, layers, seq) in TPT_TRAIN.items():
        cfg, hp, _, shards = _tpt_setup(label)
        first = results[0][label]
        f32 = first["float32"]
        print(f"  {label} {arch} at full width, {layers} of "
              f"{lm_configs.get_config(arch).n_layers} layers "
              f"({param_count(cfg):,} parameters), cada2 c = "
              f"{hp.rule.c}, fsdp {hp.fsdp}, microbatches "
              f"{hp.microbatches}, state axes "
              f"{trainer.flat_state_axes(cfg, _tpt_stub(), hp)}"
              f", {TPT_STEPS} steps of {TRAIN_BATCH} x {seq} tokens")
        for res in (r[label] for r in results):
            if res["launches"] != want:
                raise RuntimeError(f"15 {label} rank {res['rank']}: "
                                   f"launches {res['launches']}, expected "
                                   f"{want}")
            for dt in _tpt_dtypes(label):
                if (res[dt]["masks"] != first[dt]["masks"]
                        or res[dt]["losses"] != first[dt]["losses"]):
                    raise RuntimeError(f"15 {label}: the ranks' {dt} "
                                       "metrics differ")
            for k, v in res["launches"].items():
                totals[k] += v
            run = res["float32"]
            print(f"    rank {res['rank']}: {run['param_bytes']:,} "
                  f"parameter bytes, server slice {run['local_h']:,}; fp32 "
                  f"step ms {[round(x, 1) for x in run['step_ms']]} (host "
                  f"clock; {run['collective_ms']:.1f} ms in collectives); "
                  f"peak memory {run['peak_gib']:.3f} GiB (reserved "
                  f"{run['peak_reserved_gib']:.3f}); launches "
                  f"amsgrad {res['launches']['amsgrad']}, batched_diff_sq "
                  f"{res['launches']['batched_diff_sq']}, eq3_row_mean "
                  f"{res['launches']['eq3_row_mean']} (an all-reduce on "
                  f"the mesh)")
            am, nm, rm = (res[k] for k in ("amsgrad", "batched_diff_sq",
                                           "eq3_row_mean"))
            print(f"      shard-local kernels vs plain: AMSGrad n = "
                  f"{am['n']:,} bit-equal (sum upd^2 |err| "
                  f"{am['max_abs_err']:.3g}), device {_ms(am['device_ms'])};"
                  f" row norm {nm['shape']} |err| {nm['max_abs_err']:.3g}, "
                  f"device {_ms(nm['device_ms'])}; row mean {rm['shape']} "
                  f"bit-equal, device {_ms(rm['device_ms'])}")
            print("      collectives (count, median ms, max ms): "
                  + "; ".join(f"{k} x{c} {med:.2f} / {mx:.2f}"
                              for k, (c, med, mx)
                              in run["collectives"].items()))
        for dt in _tpt_dtypes(label):
            run = first[dt]
            gaps = run["gaps"]
            if run["masks"] != run["ref_masks"]:
                raise RuntimeError(f"15 {label} {dt}: masks {run['masks']} "
                                   f"on the mesh, {run['ref_masks']} in one "
                                   "process")
            f32 = {"losses": TPT_RTOL_F32, "dsq": TPT_RTOL_F32,
                   "update": TPT_BAND_F32, "h": TPT_BAND_F32}
            bands = f32 if dt == "float32" else {
                k: TPT_BF16_FLOORS * max(v, f32[k])
                for k, v in one[label]["floors"].items()}
            ratios = [[round(x, 3) for x in r] for r in run["lhs_rhs"]]
            print(f"    {dt}: masks {run['masks']} equal to one process's "
                  f"(LHS/RHS {ratios}); losses {run['losses']}; gaps to "
                  "one process "
                  + ", ".join(f"{k} {gaps[k]:.3g} (band {bands[k]:.3g})"
                              for k in bands))
            outside = {k: gaps[k] for k in bands if gaps[k] > bands[k]}
            if outside:
                raise RuntimeError(f"15 {label} {dt}: outside the bands: "
                                   f"{outside}")
        masks = first["float32"]["masks"]
        if all(all(row) for row in masks) or not any(any(r) for r in masks):
            raise RuntimeError(f"15 {label}: masks {masks}: no step "
                               "skipped, or none uploaded")
    _tpt_pytree_report(card, results, dict.fromkeys(want, 0))
    return totals


def _tpt_pytree_report(card: str, results: list, zero: dict) -> None:
    """15c's checks and lines: no kernel launched, the ranks' metrics
    equal, masks equal to one process's and to 15a's flat-plane masks,
    the fp32 gaps within 15a's bands; a rank's step ms, peak memory and
    collectives a step by kind."""
    label = TPT_PYTREE
    cfg, hp, _, _ = _tpt_setup(label)
    first = results[0][label]["float32"]
    print(f"  {label} the pytree plane (fused=False): stablelm-1.6b at full "
          f"width, {cfg.n_layers} layers, fp32, cada2 c = {hp.rule.c}, "
          f"state_fsdp_axes {hp.state_fsdp_axes}, shard_cada_state "
          f"{hp.shard_cada_state}, {TPT_STEPS} steps, on {card}")
    for res in (r[label] for r in results):
        run = res["float32"]
        if res["launches"] != zero:
            raise RuntimeError(f"15c rank {res['rank']}: the pytree plane "
                               f"launched kernels {res['launches']}")
        if (run["masks"] != first["masks"]
                or run["losses"] != first["losses"]
                or run["dsq"] != first["dsq"]):
            raise RuntimeError("15c: the ranks' metrics differ")
        print(f"    rank {res['rank']}: {run['param_bytes']:,} parameter "
              f"bytes, moments {run['local_h']:,} entries; step ms "
              f"{[round(x, 1) for x in run['step_ms']]} (host clock; "
              f"{run['collective_ms']:.1f} ms in collectives); peak "
              f"{run['peak_gib']:.3f} GiB (reserved "
              f"{run['peak_reserved_gib']:.3f}); no kernel launched")
        print("      collectives a step (count, MB of the rank's tensors, "
              "ms): " + "; ".join(
                  f"{k} x{c:g} {b / 1e6:.1f} MB {ms:.1f} ms"
                  for k, (c, b, ms) in run["step_collectives"].items()))
    flat_masks = results[0]["15a"]["float32"]["masks"]
    if first["masks"] != first["ref_masks"]:
        raise RuntimeError(f"15c: masks {first['masks']} on the mesh, "
                           f"{first['ref_masks']} in one process")
    if first["masks"] != flat_masks:
        raise RuntimeError(f"15c: masks {first['masks']}, the flat plane's "
                           f"(15a) {flat_masks}")
    bands = {"losses": TPT_RTOL_F32, "dsq": TPT_RTOL_F32,
             "update": TPT_BAND_F32, "h": TPT_BAND_F32}
    gaps = first["gaps"]
    print(f"    float32: masks {first['masks']} equal to one process's and "
          f"to 15a's flat plane's; losses {first['losses']}; gaps to one "
          "process " + ", ".join(f"{k} {gaps[k]:.3g} (band {bands[k]:.3g})"
                                 for k in bands))
    outside = {k: gaps[k] for k in bands if gaps[k] > bands[k]}
    if outside:
        raise RuntimeError(f"15c: outside the bands: {outside}")


def main() -> None:
    t_start = time.perf_counter()
    print("[1] card")
    card = phase_card()
    rates = card_rates(torch.cuda.get_device_name(0))
    print(f"    rates for bounds: H100 SXM data sheet, "
          f"{rates[0] / 1e12:.2f} TB/s, {rates[1] / 1e12:.0f} TFLOP/s fp32, "
          f"{BF16_TC_FLOPS / 1e12:.0f} TFLOP/s bf16 tensor cores, "
          f"{SFU_RATE / 1e12:.3f} T exp/s")
    print("[2] build")
    t0 = time.perf_counter()
    sources = ("cada_update", "ssm_scan", "flash_attention")
    build.build_all(sources)
    for name in sources:
        build.load(name)
    print(f"    built and loaded {', '.join(f'{n}.cu' for n in sources)} "
          f"(one nvcc each, in parallel) in {time.perf_counter() - t0:.1f} s")
    params, batches, held_out = setup_main()
    layout = flat.layout_of(params)
    print(f"[3] kernels vs plain (n_flat = {layout.n_flat}; the serving "
          "path's scan and attention)")
    main_shape = phase_kernels(rates, layout)
    main_shape.update(phase_lm_kernels(rates))
    print("[4] main path")
    launches, skipping_c = phase_main(card, params, batches, held_out)
    profile_rounds("cada2", params, batches)
    profile_rounds("laq", params, batches)
    profile_rounds("topk", params, batches)
    print("[5] plain lockstep")
    phase_lockstep("cada2", 1.0, params, batches)
    phase_lockstep("laq", skipping_c["laq"], params, batches)
    phase_lockstep("topk", skipping_c["topk"], params, batches)
    print("[6] serving path")
    launches.update(phase_serve(card))
    print("[7] training path")
    train_launches, train_sizes = phase_train(card, rates)
    for name, v in train_launches.items():
        launches[name] += v
    for name, entry in train_sizes.items():
        main_shape[name]["trainer_size"] = entry
    print("[8] the paper's problems, the delta rules, checkpoints")
    gc.collect()
    torch.cuda.empty_cache()
    t8 = time.perf_counter()
    paper_launches, eq3_trainer = phase_paper_all(card, rates)
    for name, v in paper_launches.items():
        launches[name] += v
    main_shape["eq3_row_mean"]["trainer_size"] = eq3_trainer
    print(f"    phase 8 took {time.perf_counter() - t8:.1f} s")
    print("[9] the cohort plane")
    gc.collect()
    torch.cuda.empty_cache()
    t9 = time.perf_counter()
    for name, v in phase_cohort(card, skipping_c).items():
        launches[name] += v
    print(f"    phase 9 took {time.perf_counter() - t9:.1f} s")
    print("[10] the sim runtime")
    gc.collect()
    torch.cuda.empty_cache()
    t10 = time.perf_counter()
    for name, v in phase_sim(card, params, batches, skipping_c).items():
        launches[name] += v
    print(f"    phase 10 took {time.perf_counter() - t10:.1f} s")
    print("[11] MoE, M-RoPE and embedding-input models")
    gc.collect()
    torch.cuda.empty_cache()
    t11 = time.perf_counter()
    moe_launches, qwen_flash = phase_moe(card, rates)
    for name, v in moe_launches.items():
        launches[name] += v
    main_shape["flash_attention"]["qwen2_vl_shape"] = qwen_flash
    print(f"    phase 11 took {time.perf_counter() - t11:.1f} s")
    print("[12] the scheduler, sliding-window decode, the pytree plane")
    gc.collect()
    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    slice_launches, window_flash = phase_slice11(card, rates, params,
                                                 batches, skipping_c)
    for name, v in slice_launches.items():
        launches[name] += v
    main_shape["flash_attention"]["window_8192_shape"] = window_flash
    print(f"    phase 12 took {time.perf_counter() - t12:.1f} s")
    print("[13] the mesh runtime")
    t13 = time.perf_counter()
    for name, v in phase_mesh(card).items():
        launches[name] += v
    print(f"    phase 13 took {time.perf_counter() - t13:.1f} s")
    print("[14] tensor-parallel serving")
    gc.collect()
    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    tp_launches, tp_kernels = phase_tp(card)
    for name, v in tp_launches.items():
        launches[name] += v
    for name, entry in tp_kernels.items():
        main_shape[name]["tp_rank_shape"] = entry
    print(f"    phase 14 took {time.perf_counter() - t14:.1f} s")
    print("[15] the mesh trainer: the model axis, parameter FSDP, the pytree "
          "plane")
    gc.collect()
    torch.cuda.empty_cache()
    t15 = time.perf_counter()
    for name, v in phase_tpt(card).items():
        launches[name] += v
    print(f"    phase 15 took {time.perf_counter() - t15:.1f} s")
    csrc = "src/repro_torch/kernels/csrc/"
    source = {"amsgrad": "cada_update.cu", "batched_diff_sq": "cada_update.cu",
              "batched_sq": "cada_update.cu", "diff_sq": "cada_update.cu",
              "eq3_row_mean": "cada_update.cu",
              "selective_scan": "ssm_scan.cu",
              "flash_attention": "flash_attention.cu"}
    replaces = {"amsgrad": "src/repro/kernels/cada_update.py:34",
                "batched_diff_sq": "src/repro/kernels/cada_update.py:106",
                "batched_sq": "src/repro/kernels/cada_update.py:144",
                "diff_sq": "src/repro/kernels/cada_update.py:174",
                "eq3_row_mean": "src/repro/kernels/ops.py:126",
                "selective_scan": "src/repro/kernels/ssm_scan.py:39",
                "flash_attention": "src/repro/kernels/flash_attention.py:33"}
    notes = {"eq3_row_mean": "a fori_loop in the JAX package, not Pallas: "
                             "its row order is the bit contract"}
    kernels = [{"name": name, "route": "cuda", "source": csrc + source[name],
                "replaces": replaces[name], "launches": launches[name],
                "library_ms": None, **main_shape[name],
                "library_note": LIBRARY_NOTE[name],
                **({"replaces_note": notes[name]} if name in notes else {})}
               for name in (*WRAPPERS, *LM_WRAPPERS)]
    print(f"    total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
