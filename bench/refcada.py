"""The plain reference of CADA's cada2 round and the AMSGrad server step
(the paper's Algorithm 1 with eq. (10)'s rule, eq. (3)'s aggregate and
eqs. (2a)–(2c)), on per-leaf float32 dicts, written from the paper and
independent of the program.

Step k, for each worker m on its own rows ξ_m of the step's batch:
  g_m = ∇ℓ(θ^k; ξ_m), s_m = ∇ℓ(θ^{k−τ_m}; ξ_m) (its last uploaded point)
  upload_m = ||g_m − s_m||² > (c / d_max) Σ_d ||θ^{k+1−d} − θ^{k−d}||²
             or τ_m ≥ D
  an uploading worker sends δ_m = g_m − ĝ_m and keeps ĝ_m = g_m;
  ∇ += Σ_m δ_m / M  (eq. 3)
  h = β1 h + (1 − β1) ∇;  v̂ = max(β2 v̂ + (1 − β2) ∇², v̂)
  θ^{k+1} = θ^k − lr h / √(ε + v̂), kept in each leaf's storage dtype
Every worker starts with τ_m = D, so the first step uploads all.

``grad_fn(theta, rows) -> (loss, {path: grad})`` is the reference model's
gradient (``bench/reference.py``).
"""
from __future__ import annotations

import torch


def _sq(tree: dict) -> torch.Tensor:
    return sum(torch.sum(v * v) for v in tree.values())


class Cada2Reference:
    def __init__(self, theta: dict, dtypes: dict, m: int, rule: dict,
                 opt: dict, grad_fn):
        self.theta = {p: t.float() for p, t in theta.items()}
        self.dtypes = dtypes
        self.m = m
        self.c, self.d_max, self.max_delay = (rule["c"], rule["d_max"],
                                              rule["max_delay"])
        self.lr, self.b1, self.b2, self.eps = (opt["lr"], opt["b1"],
                                               opt["b2"], opt["eps"])
        self.grad_fn = grad_fn
        zeros = lambda: {p: torch.zeros_like(t) for p, t in self.theta.items()}
        self.h, self.vhat, self.nabla = zeros(), zeros(), zeros()
        self.sent = [None] * m              # ĝ_m; None: zeros
        self.stale = [self.theta] * m       # θ^{k−τ_m}
        self.tau = [self.max_delay] * m
        self.diff_hist = [0.0] * self.d_max
        self.k = 0

    def step(self, rows: list) -> dict:
        """One round on the workers' ``rows``; returns the step's loss (the
        workers' mean), each worker's LHS and upload, and Σupd²."""
        rhs = self.c / self.d_max * sum(self.diff_hist)
        losses, lhs, upload = [], [], []
        inc = {p: torch.zeros_like(t) for p, t in self.theta.items()}
        for w in range(self.m):
            loss, g = self.grad_fn(self.theta, rows[w])
            if self.stale[w] is self.theta:
                dsq = 0.0
            else:
                _, s = self.grad_fn(self.stale[w], rows[w])
                dsq = float(_sq({p: g[p] - s[p] for p in g}))
                del s
            up = dsq > rhs or self.tau[w] >= self.max_delay
            if up:
                sent = self.sent[w] or {p: torch.zeros_like(t)
                                        for p, t in g.items()}
                for p in g:
                    delta = g[p] - sent[p]
                    inc[p] += delta
                    sent[p] = sent[p] + delta
                self.sent[w] = sent
            losses.append(float(loss))
            lhs.append(dsq)
            upload.append(up)
            del g
        for p in inc:
            self.nabla[p] = self.nabla[p] + inc[p] * (1.0 / self.m)
        for w in range(self.m):
            self.tau[w] = 1 if upload[w] else self.tau[w] + 1
            if upload[w]:
                self.stale[w] = self.theta
        upd_sq = 0.0
        theta = {}
        for p, t in self.theta.items():
            g = self.nabla[p]
            self.h[p] = self.b1 * self.h[p] + (1 - self.b1) * g
            self.vhat[p] = torch.maximum(
                self.b2 * self.vhat[p] + (1 - self.b2) * g * g, self.vhat[p])
            upd = -self.lr * self.h[p] / torch.sqrt(self.eps + self.vhat[p])
            upd_sq += float(torch.sum(upd * upd))
            theta[p] = (t + upd).to(self.dtypes[p]).float()
        self.theta = theta
        self.diff_hist[self.k % self.d_max] = upd_sq
        self.k += 1
        return {"loss": sum(losses) / self.m, "lhs": lhs, "upload": upload,
                "rhs": rhs, "dtheta_sq": upd_sq}
