"""Lockstep comparisons of the pytree plane (``fused=False``): the port's
round result against the JAX package's (shared by
``test_torch_pytree_plane.py`` and ``test_torch_pytree_trainer.py``; their
docstrings state the contract). Dicts are packed in the port's flat layout
so the flat lockstep's wire check (``lockstep_wire.py``) applies."""
import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import flat as F
from repro_torch.utils.trees import tree_leaves
from lockstep_wire import wire_differences

MARGIN_BAND = 1e-3
MAX_WIRE_DIFF_SHARE = 1e-3
WORKER_EXTRAS = ("worker_delta", "residual", "momenta", "worker_params")
SHARED_EXTRAS = ("snapshot",)
INT_EXTRAS = ("period",)
LOCAL_KINDS = ("local_momentum", "fedadam")


def np32(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(
        x, np.float32)


def _tensors(tree):
    if torch.is_tensor(tree_leaves(tree)[0]):
        return tree
    return convert.params_from_numpy(tree, "cpu")


class Packer:
    """Dicts (numpy or tensors) packed in the port's layout: parameter-
    shaped ones to (n_flat,), (M,)-leading ones to (M, n_flat)."""

    def __init__(self, params):
        self.layout = F.layout_of(_tensors(params))

    def one(self, tree):
        return np32(self.layout.pack(_tensors(tree)))

    def rows(self, tree):
        return np32(self.layout.pack_worker(_tensors(tree)))


class Tally:
    def __init__(self):
        self.flips = self.uploads = self.skips = 0
        self.wire_diffs = self.entries = 0
        self.worst = (0.0, "")


def compare_round(k, rule, pk, j_prev_comm, j_comm, t_comm, jm, tm,
                  participation, tally, state_tol, server_pairs=()):
    """Holds one round's port result against the reference's. Returns
    False (and counts a flip) where the masks differ inside the margin
    band, else the (n_flat,) mask of the columns a wire difference
    touches. ``server_pairs`` are (name, reference, port) packed arrays of
    the server step's result (θ, the moments), compared outside those
    columns."""
    j_up, t_up = np.asarray(jm["upload_mask"]), tm["upload_mask"].numpy()
    tally.uploads += int(j_up.sum())
    tally.skips += int((~j_up & (True if participation is None
                                 else participation)).sum())
    if not np.array_equal(j_up, t_up):
        margin = np.abs(jm["lhs"] - jm["rhs"])
        flipped = j_up != t_up
        assert (margin[flipped] <= MARGIN_BAND * jm["rhs"]).all(), (
            f"round {k}: upload masks differ outside the margin band: "
            f"jax {j_up}, port {t_up}, lhs {jm['lhs']}, rhs {jm['rhs']}")
        tally.flips += 1
        return False

    assert t_comm.staleness.dtype == torch.int32
    assert np.array_equal(t_comm.staleness.numpy(), j_comm.staleness)
    for key in INT_EXTRAS:
        if key in j_comm.extras:
            assert t_comm.extras[key].dtype == torch.int32
            assert np.array_equal(t_comm.extras[key].numpy(),
                                  j_comm.extras[key]), key
    assert sorted(t_comm.extras) == sorted(j_comm.extras)
    assert int(tm["uploads"]) == int(jm["uploads"])
    assert int(tm["grad_evals"]) == int(jm["grad_evals"])
    np.testing.assert_allclose(float(tm["bytes_up"]), float(jm["bytes_up"]),
                               rtol=1e-6)
    jl, tl = np.asarray(jm["lhs"]), tm["lhs"].numpy()
    assert np.array_equal(np.isfinite(jl), np.isfinite(tl))
    assert np.array_equal(jl[~np.isfinite(jl)], tl[~np.isfinite(tl)])

    wg_prev = pk.rows(j_prev_comm.worker_grads)
    wg_ref = pk.rows(j_comm.worker_grads)
    flagged, _ = wire_differences(rule, pk.layout, state_tol, wg_prev,
                                  wg_ref, pk.rows(t_comm.worker_grads))
    cols = flagged.any(axis=0)
    wire_scale = float(np.abs(wg_ref - wg_prev).max())
    tally.wire_diffs += int(flagged.sum())
    tally.entries += int(j_up.sum()) * pk.layout.n

    pairs = [(n, a, b, "col") for n, a, b in server_pairs]
    pairs += [("nabla", pk.one(j_comm.nabla), pk.one(t_comm.nabla), "col"),
              ("worker_grads", wg_ref, pk.rows(t_comm.worker_grads),
               "entry"),
              ("rhs", jm["rhs"], tm["rhs"], None),
              ("lhs", jl[np.isfinite(jl)], tl[np.isfinite(tl)], None)]
    if "loss" in jm:
        pairs.append(("loss", jm["loss"], tm["loss"], None))
    for name, v in j_comm.extras.items():
        if name in WORKER_EXTRAS:
            pairs.append((name, pk.rows(v), pk.rows(t_comm.extras[name]),
                          "entry" if name != "worker_params" else None))
        elif name in SHARED_EXTRAS:
            pairs.append((name, pk.one(v), pk.one(t_comm.extras[name]),
                          None))
        else:
            assert name in INT_EXTRAS, name
    for name, a, b, where in pairs:
        a, b = np32(a), np32(b)
        assert a.shape == b.shape, name
        keep = (np.ones(a.shape, bool) if where is None else
                ~np.broadcast_to(cols, a.shape) if where == "col" else
                ~flagged)
        if not keep.any():
            continue
        scale = max(np.abs(a).max(),
                    wire_scale if name == "residual" else 0.0, 1e-30)
        np.testing.assert_allclose(b[keep], a[keep], rtol=0,
                                   atol=state_tol * scale,
                                   err_msg=f"{name} at round {k}")
        tally.worst = max(tally.worst,
                          (float(np.abs(b - a)[keep].max() / scale), name))
    return cols


def check_tally(kind, tally, label):
    print(f"\n{label}: largest gap {tally.worst[0]:.3g} of scale "
          f"({tally.worst[1]}), {tally.flips} in-band flip rounds, "
          f"{tally.uploads} uploads, {tally.wire_diffs} wire differences "
          f"in {tally.entries} uploaded entries")
    assert tally.flips <= 1
    assert tally.uploads > 0
    assert tally.wire_diffs <= MAX_WIRE_DIFF_SHARE * tally.entries
    if kind not in ("always", *LOCAL_KINDS):
        assert tally.skips > 0, "the gate never skipped: the test is vacuous"
