"""Adam as the JAX package builds it (counterpart of links_tpu/train/optim.py):
optax's chain of

    [global-norm clip] -> + weight_decay * param (coupled L2) -> scale_by_adam
    (b1 0.9, b2 0.999, eps 1e-8, bias correction by step count) -> * -lr

with lr = learning_rate * lr_gamma ** floor(step / steps_per_epoch), the
per-epoch staircase. With ``bf16_moments`` the moments are stored as bf16 at
rest: upcast to f32 entering the update, rounded to nearest-even bf16 leaving
it; the update math is f32 either way. ``torch.optim.Adam`` cannot keep its
moments that way, and its decay and bias correction are arranged
differently, so this is its own small optimizer over ``torch._foreach``
ops.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from links_tpu_torch.config import OptimConfig

B1, B2, EPS = 0.9, 0.999, 1e-8


class Adam:
    """Adam state (moments, step count) for a fixed list of parameters,
    updated in place by ``step``."""

    def __init__(self, params, cfg: OptimConfig, steps_per_epoch: int):
        self.params = list(params)
        self.cfg = cfg
        self.steps_per_epoch = max(steps_per_epoch, 1)
        dtype = torch.bfloat16 if cfg.bf16_moments else torch.float32
        self.mu = [torch.zeros_like(p, dtype=dtype) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=dtype) for p in self.params]
        self.count = 0  # updates applied

    def lr(self, count: int) -> float:
        """The staircase learning rate of update number ``count`` (from 0),
        in f32 as optax computes it."""
        p = np.float32(count // self.steps_per_epoch)
        return float(np.float32(self.cfg.learning_rate) * np.float32(self.cfg.lr_gamma) ** p)

    @torch.no_grad()
    def step(self, grads, norm: torch.Tensor | None = None) -> None:
        """Apply one update from ``grads`` (one per parameter, f32). The clip
        reads ``norm``, the global norm of the gradient that ``grads`` are a
        shard of (ZeRO, tensor parallelism: train/parallel.py), or by
        default their own."""
        cfg = self.cfg
        grads = list(grads)
        if cfg.clip_grad_norm:
            if norm is None:
                norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            if not float(norm) < cfg.clip_grad_norm:
                grads = torch._foreach_mul(torch._foreach_div(grads, norm), cfg.clip_grad_norm)
        if cfg.weight_decay:
            grads = torch._foreach_add(grads, self.params, alpha=cfg.weight_decay)
        mu = [m.float() for m in self.mu]
        nu = [v.float() for v in self.nu]
        # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - B1))
        torch._foreach_mul_(nu, B2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - B2))
        self.count += 1
        bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(self.count))
        # update = -lr * (mu / bc1) / (sqrt(nu / bc2) + eps)
        den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), EPS)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        torch._foreach_mul_(upd, -self.lr(self.count - 1))
        torch._foreach_add_(self.params, upd)
        dtype = self.mu[0].dtype
        self.mu = [m.to(dtype) for m in mu]
        self.nu = [v.to(dtype) for v in nu]

    def state_dict(self) -> dict:
        """The moments at their stored dtype, on the CPU, and the update count."""
        return {"mu": [m.detach().cpu() for m in self.mu],
                "nu": [v.detach().cpu() for v in self.nu], "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        """Restore what ``state_dict`` returned, onto the parameters' devices.
        Moments stored at another dtype than the configured one are cast to
        it, with a warning: that changes the optimizer's recipe mid-run."""
        moments = [*state["mu"], *state["nu"]]
        shapes = [p.shape for p in self.params] * 2
        if len(moments) != len(shapes) or any(m.shape != s for m, s in zip(moments, shapes)):
            raise ValueError("Adam state does not match the parameters: "
                             f"{len(state['mu'])} moments for {len(self.params)} parameters")
        dtype = torch.bfloat16 if self.cfg.bf16_moments else torch.float32
        drift = [m.dtype for m in moments if m.dtype != dtype]
        if drift:
            flag = "--no-bf16-opt-state" if dtype == torch.bfloat16 else "--bf16-opt-state"
            warnings.warn(f"resuming: {len(drift)} Adam moments change dtype across the resume "
                          f"boundary (checkpoint {drift[0]} -> configured {dtype}), which "
                          f"changes the optimizer's recipe mid-run; pass {flag} to resume "
                          f"with the checkpoint's own", stacklevel=2)
        self.mu = [m.to(device=p.device, dtype=dtype) for m, p in zip(state["mu"], self.params)]
        self.nu = [v.to(device=p.device, dtype=dtype) for v, p in zip(state["nu"], self.params)]
        self.count = int(state["count"])
