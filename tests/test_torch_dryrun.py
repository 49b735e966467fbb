"""The port's dry run (``repro_torch.launch.dryrun``) on the 16x16
production mesh, in one subprocess that imports no JAX: granite-moe-1b-
a400m ``decode_32k`` (the reference's own integration combo,
``tests/test_serving_sharding.py``), stablelm-1.6b ``train_4k`` and
zamba2-2.7b ``prefill_32k``. Each row is held against the reference's
tables and formulas, reckoned here without a compile:

  * the parameter bytes a rank: the reference's ``param_pspecs`` (its
    ``train_policy``'s FSDP choice in training, its
    ``_serving_param_pspecs`` in serving) applied to its
    ``abstract_params`` shapes, each leaf divided by the sizes of the axes
    its spec names;
  * the training state a rank: ``tools/mesh_state_bytes.py --policy``'s;
  * ``model_flops_per_rank``: the reference's 6·N_active·tokens (train)
    or 2·N_active·tokens (serving) over the chips.
"""
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.configs.base import SHAPES as JSHAPES
from repro.distributed import serving as JSV
from repro.distributed import sharding as JS
from repro.launch import policy as JP
from repro.models.config import active_param_count
from repro.models.model import abstract_params as j_abstract_params

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMBOS = (("granite-moe-1b-a400m", "decode_32k"),
          ("stablelm-1.6b", "train_4k"), ("zamba2-2.7b", "prefill_32k"))
MESH = {"data": 16, "model": 16}
SCRIPT = """
import json, sys
from repro_torch.launch import dryrun
rows = [dryrun.run_combo(a, s, verbose=False) for a, s in %r]
print(json.dumps({"rows": rows, "jax": "jax" in sys.modules,
                  "repro": any(m == "repro" or m.startswith("repro.")
                               for m in sys.modules)}))
"""


class _Stub:
    shape = MESH


@pytest.fixture(scope="module")
def rows():
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", SCRIPT % (COMBOS,)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert not got["jax"] and not got["repro"]
    return {(r["arch"], r["shape"]): r for r in got["rows"]}


def _ref_param_bytes(jcfg, specs) -> int:
    shapes = jax.tree.leaves(j_abstract_params(jcfg))
    specs = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    total = 0
    for x, spec in zip(shapes, specs):
        axes = [a for e in spec if e is not None
                for a in (e if isinstance(e, tuple) else (e,))]
        total += (math.prod(x.shape) * np.dtype(x.dtype).itemsize
                  // math.prod(MESH[a] for a in axes))
    return total


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_dry_run_rows_equal_the_reference_tables(rows, arch, shape):
    row = rows[arch, shape]
    jcfg = JC.get_config(arch)
    sh = JSHAPES[shape]
    if sh.kind == "train":
        hp = JP.train_policy(jcfg, _Stub())
        specs = JS.param_pspecs(jcfg, _Stub(), hp.fsdp, hp.fsdp_axes)
        tokens, mult = sh.batch * sh.seq, 6
    else:
        specs = JSV._serving_param_pspecs(jcfg, _Stub())
        tokens = sh.batch * (sh.seq if sh.kind == "prefill" else 1)
        mult = 2
    assert row["param_bytes_per_rank"] == _ref_param_bytes(jcfg, specs)
    want = mult * active_param_count(jcfg) * tokens / 256
    assert row["model_flops_per_rank"] == pytest.approx(want, rel=1e-12)
    assert row["flops_per_rank"] > 0 and row["chips"] == 256
    assert row["mesh"] == "16x16"
    for key in ("t_compute_s", "t_memory_s", "t_collective_s"):
        assert row[key] > 0, key
    assert row["dominant"] in ("compute", "memory", "collective")
    if sh.kind == "train":
        sys.path.insert(0, os.path.join(ROOT, "tools"))
        import mesh_state_bytes
        tool = mesh_state_bytes.main(["--arch", arch, "--mesh",
                                      "data=16,model=16", "--policy"])
        assert (row["param_bytes_per_rank"] + row["state_bytes_per_rank"]
                == tool["per_rank_bytes"])
    else:
        assert row["state_bytes_per_rank"] == 0
        assert row["cache_bytes_per_rank"] > 0
    if shape == "prefill_32k":
        # the scan's and flash's operations are counted by formula
        assert set(row["kernel_ops_per_rank"]) == {"selective_scan",
                                                   "flash_attention"}
