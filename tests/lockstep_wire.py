"""The wire differences a lockstep test allows between the port and the
JAX package (shared by ``test_torch_lockstep.py`` and
``test_torch_trainer_lockstep.py``; their docstrings state the contract).

Where the two sides' gradients differ by their rounding gap, a b-bit
quantizer can round an entry to the neighbouring level and a top-k
selection can keep a different entry at the k-th place of a segment.
:func:`wire_differences` finds such entries of the uploaded worker plane
and checks each: one quantization level at most, or a top-k support swap
at the k-th magnitude.
"""
import numpy as np

from repro_torch.core.quantize import topk_count


def wire_kind(rule):
    """(quantizer levels or 0, top-k fraction or None) of a rule's wire."""
    bits = rule.quantize_bits or (8 if rule.kind in ("cinn", "laq") else 0)
    levels = float(2 ** (bits - 1) - 1) if bits else 0.0
    frac = rule.topk_frac if rule.kind == "topk" else None
    return levels, frac


def wire_differences(rule, layout, state_tol, wg_prev, wg_ref, wg_port):
    """(M, n_flat) bool mask of the wire differences (see the module
    docstring), each checked; returns (mask, largest swap gap / scale).

    An entry is a candidate where it differs beyond state_tol, where it
    differs by more than half a quantization level (a flip below state_tol
    still moves the residual), or where one side sent it and the other
    did not (top-k)."""
    diff = np.abs(wg_port - wg_ref)
    tol = state_tol * max(np.abs(wg_ref).max(), 1e-30)
    levels, frac = wire_kind(rule)
    w_ref, w_port = wg_ref - wg_prev, wg_port - wg_prev
    level = np.zeros_like(w_ref)
    if levels:
        for o, s in zip(layout.offsets, layout.sizes):
            level[:, o:o + s] = np.abs(w_ref[:, o:o + s]).max(
                axis=1, keepdims=True) / levels
    flagged = diff > tol
    if levels:
        flagged |= diff > level / 2
    if frac is not None:
        flagged |= (w_ref == 0.0) != (w_port == 0.0)
    if not flagged.any():
        return flagged, 0.0
    assert levels or frac is not None, (
        f"{int(flagged.sum())} worker-plane entries beyond state_tol on a "
        "raw wire")
    worst_swap = 0.0
    for w, j in zip(*np.nonzero(flagged)):
        if levels and diff[w, j] <= level[w, j] * (1 + 1e-3) + tol:
            continue
        seg = np.searchsorted(np.asarray(layout.offsets), j, side="right") - 1
        o, s = layout.offsets[seg], layout.sizes[seg]
        row = np.abs(w_ref[w, o:o + s])
        scale = row.max()
        assert frac is not None, (
            f"worker {w} entry {j}: |Δ| {diff[w, j]:.3g} is more than one "
            f"level {level[w, j]:.3g}")
        kth = np.sort(row)[::-1][topk_count(s, frac) - 1]
        sent = (w_port[w, j] if w_ref[w, j] == 0.0 else w_ref[w, j])
        assert w_ref[w, j] == 0.0 or w_port[w, j] == 0.0, (
            f"worker {w} entry {j}: both sides sent it, {w_ref[w, j]:.6g} "
            f"vs {w_port[w, j]:.6g}")
        gap = abs(abs(sent) - kth)
        assert gap <= state_tol * scale + level[w, j] * (1 + 1e-3), (
            f"worker {w} entry {j}: a support swap {abs(sent):.6g} away "
            f"from the k-th magnitude {kth:.6g}")
        worst_swap = max(worst_swap, gap / scale)
    return flagged, worst_swap
