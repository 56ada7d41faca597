"""Lion and Prodigy as `torch.optim` optimizers.

The JAX package takes both from optax (``optax.lion``,
``optax.contrib.prodigy``; `training_utils/config.py` maps ``Lion8bit`` and
``Prodigy`` onto them). Neither is in `torch.optim`, and the port depends on
no optimizer package, so they are written here from optax 0.2.6 with its
defaults and its order of operations: the same updates step for step (in
float32 up to rounding; `tests/test_torch_training_harness.py` holds them
to optax).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterable

import torch

from refiners_tpu_torch.parallel.sharding import is_split, local, sum_over_shards


class Lion(torch.optim.Optimizer):
    """Lion (Chen et al., 2023), as ``optax.lion``:

        u = sign((1 - b1) g + b1 m);  m <- b2 m + (1 - b2) g;
        p <- p - lr (u + weight_decay p).

    The momentum takes each parameter's dtype.
    """

    def __init__(
        self,
        params: Iterable[Any],
        lr: float,
        betas: tuple[float, float] = (0.9, 0.99),
        weight_decay: float = 1e-3,
    ) -> None:
        super().__init__(params, {"lr": lr, "betas": tuple(betas), "weight_decay": weight_decay})

    @torch.no_grad()
    def step(self, closure: Callable[[], Any] | None = None) -> Any:
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(p)
                m, g = state["exp_avg"], p.grad
                update = torch.sign(g * (1 - b1) + m * b1)
                m.mul_(b2).add_(g, alpha=1 - b2)
                p.add_(update.add_(p, alpha=group["weight_decay"]), alpha=-group["lr"])
        return loss


class Prodigy(torch.optim.Optimizer):
    """Prodigy (Mishchenko and Defazio, 2023), as ``optax.contrib.prodigy``:
    AdamW on ``estim_lr``-scaled gradients, where ``estim_lr`` (the distance
    to the solution, from ``estim_lr0`` up) is re-estimated at every step
    from the gradients' correlation with the distance travelled from the
    first parameters.

    The estimate spans every parameter, as optax's spans the whole tree, so
    the optimizer takes one parameter group and keeps ``estim_lr``,
    ``numerator_weighted`` and ``count`` in it (`state_dict` saves them).
    The per-parameter state takes each parameter's dtype; the scalars are
    Python floats. Parameters without a gradient are left out. A parameter
    split over a mesh (a `DTensor`, tensor parallelism) adds the sums over
    all its shards to the estimate.
    """

    def __init__(
        self,
        params: Iterable[Any],
        lr: float = 1.0,
        betas: tuple[float, float] = (0.9, 0.999),
        beta3: float | None = None,
        eps: float = 1e-8,
        estim_lr0: float = 1e-6,
        estim_lr_coef: float = 1.0,
        weight_decay: float = 0.0,
        safeguard_warmup: bool = False,
    ) -> None:
        defaults = {
            "lr": lr, "betas": tuple(betas), "beta3": beta3, "eps": eps, "estim_lr0": estim_lr0,
            "estim_lr_coef": estim_lr_coef, "weight_decay": weight_decay, "safeguard_warmup": safeguard_warmup,
        }  # fmt: skip
        super().__init__(params, defaults)
        if len(self.param_groups) != 1:
            raise ValueError("Prodigy estimates one learning rate over all its parameters: give it one parameter group")
        self.param_groups[0].update(estim_lr=estim_lr0, numerator_weighted=0.0, count=0)

    @torch.no_grad()
    def step(self, closure: Callable[[], Any] | None = None) -> Any:
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        group = self.param_groups[0]
        b1, b2 = group["betas"]
        b3 = group["beta3"] if group["beta3"] is not None else math.sqrt(b2)
        estim_lr, estim_lr0 = group["estim_lr"], group["estim_lr0"]
        count = group["count"] + 1
        dlr = estim_lr * group["lr"] * math.sqrt(1 - b2**count) / (1 - b1**count)
        params = [p for p in group["params"] if p.grad is not None]
        numerator, denominator = [], []
        for p in params:
            state = self.state[p]
            if not state:
                for key in ("exp_avg", "exp_avg_sq", "grad_sum"):
                    state[key] = torch.zeros_like(p)
                state["params0"] = p.detach().clone()
            dg = p.grad * estim_lr
            numerator.append(torch.sum(local(p.grad).float() * (local(state["params0"]) - local(p)).float()))
            state["exp_avg"].mul_(b1).add_(dg, alpha=1 - b1)
            state["exp_avg_sq"].mul_(b2).addcmul_(dg, dg, value=1 - b2)
            weight = estim_lr if group["safeguard_warmup"] else dlr
            state["grad_sum"].mul_(b3).add_(dg, alpha=weight / estim_lr0)
            denominator.append(local(state["grad_sum"]).float().abs().sum())
        if not params:
            return loss
        if any(is_split(p) for p in params):
            sums = sum_over_shards(torch.stack([torch.stack(numerator), torch.stack(denominator)], dim=1), params)
            numerator, denominator = list(sums[:, 0]), list(sums[:, 1])
        # one transfer for the two sums (a device synchronization on the card)
        numerator_acum, denominator_sum = torch.stack([sum(numerator), sum(denominator)]).tolist()
        numerator_weighted = b3 * group["numerator_weighted"] + (estim_lr / estim_lr0) * dlr * numerator_acum
        estimate = group["estim_lr_coef"] * numerator_weighted / denominator_sum
        new_estim_lr = max(estim_lr, estimate)
        for p in params:
            state = self.state[p]
            denom = state["exp_avg_sq"].sqrt().add_(new_estim_lr * group["eps"])
            update = state["exp_avg"] / denom * dlr
            p.sub_(update.add_(p, alpha=group["weight_decay"] * dlr))
        group.update(estim_lr=new_estim_lr, numerator_weighted=numerator_weighted, count=count)
        return loss
