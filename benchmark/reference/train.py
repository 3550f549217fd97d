"""Plain reference of one training step of a speaker network.

The step of the nnet3 training (`train_cvector_with_am.sh`,
`run_xvector_new.sh`) as the port defines it: the task's logits (the
model kind's ``forward_train``, `benchmark/models/`), the per-example
mean cross entropy times the task's weight, its gradients (autograd on
the reference's own forward), then the optimizer chain, a frozen copy of
`sepi_tpu_torch/train/optim.py` (optax's order; `nnet3-train` flags):

1. Muon on every 2-D parameter (the output layers): Nesterov momentum
   with bias correction (beta = max(momentum, 0.9)), five Newton-Schulz
   steps (3.4445, -4.7750, 2.0315) on the momentum in (in, out)
   orientation normalised by its Frobenius norm + 1e-8, times
   sqrt(max(1, out / in)); Adam (0.9, 0.999, 1e-8, Nesterov) on the
   rest; times -lr, lr decaying exponentially from initial to final over
   the run's steps;
2. the update's global l2 norm capped at ``max_param_change``;
3. per-subtree learning-rate factors (``{"am": 0.1}``: parameters under
   ``am.``);
4. proportional shrink: u -= (1 - (1 - shrink lr)^exponent) p outside
   batch norms, exponent = min(1, shrink_iterations / steps).

The optimizer's arithmetic is float64 here; the forward and backward
products are in the precision asked (`precision.mm_grad`).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F


NS = (3.4445, -4.7750, 2.0315)


class Chain:
    """The optimizer of a run of ``total_steps`` steps."""

    def __init__(self, opt: Mapping, total_steps: int, lr_factors: Mapping[str, float]):
        self.opt = opt
        self.total = max(total_steps, 1)
        self.beta = max(opt["momentum"], 0.9)
        self.lr_factors = dict(lr_factors)
        self.exponent = min(1.0, opt["shrink_iterations"] / self.total) \
            if opt["proportional_shrink"] > 0 else 0.0

    def lr(self, count: int) -> float:
        o = self.opt
        frac = min(count / self.total, 1.0)
        return o["initial_lr"] * (o["final_lr"] / o["initial_lr"]) ** frac

    def factor(self, name: str) -> float:
        for prefix, f in self.lr_factors.items():
            if name == prefix or name.startswith(prefix + "."):
                return f
        return 1.0

    def update(self, grads: Dict[str, torch.Tensor], state: Dict, params: Mapping[str, torch.Tensor]):
        """The updates of one step (float64); advances ``state`` in place."""
        c = state["count"]
        lr = self.lr(c)
        b, b1, b2 = self.beta, 0.9, 0.999
        out = {}
        for n, g in grads.items():
            g = g.to(torch.float64)
            mu = state["mu"][n] = b * state["mu"][n] + (1 - b) * g if g.dim() == 2 else \
                b1 * state["mu"][n] + (1 - b1) * g
            if g.dim() == 2:
                mu_hat = b * mu / (1 - b ** (c + 2)) + (1 - b) * g / (1 - b ** (c + 1))
                k = mu_hat.t()  # (in, out)
                x = k.t() if k.shape[0] > k.shape[1] else k
                x = x / (torch.linalg.norm(x) + 1e-8)
                for _ in range(5):
                    a = x @ x.t()
                    x = NS[0] * x + (NS[1] * a + NS[2] * a @ a) @ x
                x = x.t() if k.shape[0] > k.shape[1] else x
                out[n] = (x * math.sqrt(max(1.0, k.shape[1] / k.shape[0]))).t() * (-lr)
            else:
                nu = state["nu"][n] = b2 * state["nu"][n] + (1 - b2) * g * g
                mu_hat = b1 * mu / (1 - b1 ** (c + 2)) + (1 - b1) * g / (1 - b1 ** (c + 1))
                out[n] = -lr * mu_hat / (torch.sqrt(nu / (1 - b2 ** (c + 1))) + 1e-8)
        norm = torch.sqrt(sum((u * u).sum() for u in out.values()))
        scale = min(1.0, float(self.opt["max_param_change"] / (norm + 1e-12)))
        shrink = 1.0 - (1.0 - self.opt["proportional_shrink"] * lr) ** self.exponent
        for n in out:
            out[n] = out[n] * scale * self.factor(n)
            if "batchnorm" not in n.split("."):
                out[n] = out[n] - shrink * params[n].to(torch.float64)
        state["count"] = c + 1
        return out


def step(params: Dict[str, torch.Tensor], state: Dict, chain: Chain, feats, labels,
         weight: float, task: str, cfg: Mapping, prec: str, forward) -> Dict[str, float]:
    """One CE step in place on float32 ``params``, the logits from
    ``forward(feats, params, cfg, task, prec)`` (the model kind's
    ``forward_train``); returns objf and the global gradient norm, and the
    gradients as the optimizer got them."""
    leaves = {n: p.detach().clone().requires_grad_(True) for n, p in params.items()}
    logits = forward(feats, leaves, cfg, task, prec).float()
    xent = -torch.gather(F.log_softmax(logits, -1), -1, labels[..., None].long())[..., 0]
    loss = weight * xent.mean()
    names = list(leaves)
    grads = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
    g = {n: torch.zeros_like(leaves[n]) if gr is None else gr.detach()
         for n, gr in zip(names, grads)}
    gnorm = float(torch.sqrt(sum((x.double() ** 2).sum() for x in g.values())))
    with torch.no_grad():
        upd = chain.update(g, state, params)
        for n in names:
            params[n] = (params[n].to(torch.float64) + upd[n]).to(torch.float32)
    return {"objf": float(-xent.detach().mean()), "grad_norm": gnorm, "grads": g}


def init_state(params: Mapping[str, torch.Tensor]) -> Dict:
    return {"count": 0, "mu": {n: torch.zeros_like(p, dtype=torch.float64) for n, p in params.items()},
            "nu": {n: torch.zeros_like(p, dtype=torch.float64) for n, p in params.items()}}


def leaf_gaps(prog: Mapping[str, torch.Tensor], ref: Mapping[str, torch.Tensor],
              names) -> Dict[str, float]:
    """Each leaf's |norm(prog) - norm(ref)|, over the larger of the leaf's
    reference norm and the median leaf's."""
    rn = {n: float(ref[n].double().norm()) for n in names}
    med = float(np.median(list(rn.values()))) if rn else 0.0
    return {n: abs(float(prog[n].double().norm()) - rn[n]) / max(rn[n], med, 1e-30)
            for n in names}
