"""Optimization problems for the exact-semantics simulator (counterpart of
``repro.core.problems``).

Both expose the flat-vector interface the simulator uses, on the torch
``device`` they are built for (the card unless the caller asks for the
CPU):
  * ``dim``                            — parameter dimension d
  * ``loss(x)`` / ``grad(x)``          — full objective and exact gradient,
    for one point (d,) or a batch of points (N, d)
  * ``presample_grads(gen, T, p)``     — all gradient randomness of a
    T-step, p-worker run, drawn from the ``torch.Generator`` ``gen`` (the
    engines seed it ``seed + 1`` on the problem's device)
  * ``batch_grads_at(views, draw)``    — stochastic gradients at a
    (..., p, d) stack of views given those steps' pre-drawn randomness
  * ``constants()``                    — ProblemConstants for the theorems
  * ``m2_estimate`` / ``sigma2``       — second-moment / variance bounds

The data (the quadratic's ``A`` and ``x*``, the classification set) are
built with numpy from ``default_rng(seed)``, bitwise the reference's.  The
gradient randomness cannot be: the reference draws it from ``jax.random``.
Every simulator entry point therefore takes ``draws=`` in place of
``presample_grads``, and the parity tests pass the reference's arrays.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import grad as func_grad
from torch.func import vmap

from repro_torch.core.theory import ProblemConstants


class Quadratic:
    """Strongly convex quadratic f(x) = 0.5 (x-x*)' A (x-x*), stochastic
    gradients = exact gradient + isotropic noise with E||xi||^2 = sigma^2."""

    def __init__(self, dim: int = 64, cond: float = 10.0, sigma: float = 1.0,
                 seed: int = 0, device="cuda"):
        rng = np.random.default_rng(seed)
        eigs = np.linspace(1.0, cond, dim)
        q, _ = np.linalg.qr(rng.normal(size=(dim, dim)))
        self.device = torch.device(device)
        self.A = torch.as_tensor(
            (q @ np.diag(eigs) @ q.T).astype(np.float32), device=self.device)
        self.x_star = torch.as_tensor(
            rng.normal(size=dim).astype(np.float32), device=self.device)
        self.dim = dim
        self.sigma = sigma
        self.L = float(eigs[-1])
        self.c = float(eigs[0])

    def loss(self, x):
        dlt = x - self.x_star
        return 0.5 * (dlt * (dlt @ self.A)).sum(-1)

    def grad(self, x):
        """A is symmetric, so the row-major product is the gradient."""
        return (x - self.x_star) @ self.A

    def presample_grads(self, gen: torch.Generator, T: int, p: int):
        """All gradient noise for a T-step, p-worker run in one draw."""
        noise = torch.randn((T, p, self.dim), generator=gen,
                            device=self.device)
        return noise * (self.sigma / math.sqrt(self.dim))

    def batch_grads_at(self, views, draw):
        """Gradients at a (..., p, d) view stack given the noise (..., p, d)."""
        return self.grad(views) + draw

    def sim_data(self) -> dict:
        """The problem as tensors, for the fused step."""
        return {"A": self.A, "x_star": self.x_star}

    @property
    def sigma2(self) -> float:
        return self.sigma ** 2

    def m2_estimate(self, radius2: float) -> float:
        """Second-moment bound over ||x - x*||^2 <= radius2 (restricted set
        X, as the paper requires for strongly convex objectives)."""
        return self.L ** 2 * radius2 + self.sigma2

    def constants(self, x0) -> ProblemConstants:
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=self.device)
        return ProblemConstants(
            L=self.L, sigma2=self.sigma2,
            f0_minus_fstar=float(self.loss(x0)),
            c=self.c, x0_dist2=float(((x0 - self.x_star) ** 2).sum()))


class MLPClassification:
    """Small two-layer MLP on a fixed synthetic classification set — the
    non-convex testbed. Stochastic gradients come from minibatch sampling;
    the draws are minibatch indices (T, p, batch)."""

    def __init__(self, n_samples: int = 512, in_dim: int = 16,
                 hidden: int = 32, n_classes: int = 4, batch: int = 16,
                 seed: int = 0, device="cuda"):
        rng = np.random.default_rng(seed)
        w_true = rng.normal(size=(in_dim, n_classes))
        xs = rng.normal(size=(n_samples, in_dim))
        logits = xs @ w_true + 0.5 * rng.normal(size=(n_samples, n_classes))
        ys = np.argmax(logits, axis=-1)
        self.device = torch.device(device)
        self.xs = torch.as_tensor(xs.astype(np.float32), device=self.device)
        self.ys = torch.as_tensor(ys.astype(np.int32), device=self.device)
        self.batch = batch
        self.in_dim, self.hidden, self.n_classes = in_dim, hidden, n_classes
        self.shapes = [(in_dim, hidden), (hidden,), (hidden, n_classes),
                       (n_classes,)]
        self.dim = sum(int(np.prod(s)) for s in self.shapes)

    def init(self, seed: int = 1):
        rng = np.random.default_rng(seed)
        parts = [rng.normal(size=s) / np.sqrt(max(s[0], 1))
                 for s in self.shapes]
        flat = np.concatenate([p.reshape(-1) for p in parts])
        return torch.as_tensor(flat.astype(np.float32), device=self.device)

    def _unflatten(self, x):
        out, o = [], 0
        for s in self.shapes:
            n = int(np.prod(s))
            out.append(x[..., o:o + n].reshape(*x.shape[:-1], *s))
            o += n
        return out

    def _loss_on(self, x, xs, ys):
        w1, b1, w2, b2 = self._unflatten(x)
        h = torch.tanh(xs @ w1 + b1)
        logp = torch.log_softmax(h @ w2 + b2, dim=-1)
        return -torch.gather(logp, 1, ys.long()[:, None]).mean()

    def _full(self, fn, x):
        one = lambda xx: fn(xx, self.xs, self.ys)
        return one(x) if x.ndim == 1 else vmap(one)(x)

    def loss(self, x):
        return self._full(self._loss_on, x)

    def grad(self, x):
        return self._full(func_grad(self._loss_on), x)

    def presample_grads(self, gen: torch.Generator, T: int, p: int):
        """All minibatch index draws for a T-step, p-worker run."""
        return torch.randint(0, self.xs.shape[0], (T, p, self.batch),
                             generator=gen, device=self.device)

    def batch_grads_at(self, views, draw):
        """Gradients at a (..., d) view stack given each view's minibatch
        indices (..., batch)."""
        flat_v = views.reshape(-1, self.dim)
        idx = draw.reshape(-1, self.batch).long()
        g = vmap(func_grad(self._loss_on))(flat_v, self.xs[idx],
                                           self.ys[idx])
        return g.reshape(views.shape)

    def estimate_noise(self, x, n: int = 64, seed: int = 7):
        """Empirical (sigma2, m2) at x, from n minibatches drawn with a
        generator seeded ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        idx = torch.randint(0, self.xs.shape[0], (n, self.batch),
                            generator=gen, device=self.device)
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        gs = self.batch_grads_at(x.expand(n, self.dim), idx)
        mean = gs.mean(0)
        sigma2 = float(((gs - mean) ** 2).sum(-1).mean())
        m2 = float((gs ** 2).sum(-1).mean())
        return sigma2, m2

    def constants(self, x0, L_estimate: float = 20.0) -> ProblemConstants:
        sigma2, _ = self.estimate_noise(x0)
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=self.device)
        return ProblemConstants(
            L=L_estimate, sigma2=sigma2,
            f0_minus_fstar=float(self.loss(x0)),  # f* >= 0 for CE loss
        )
