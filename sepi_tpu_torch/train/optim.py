"""The optimizer chain of the nnet3-train update, over named tensors.

Port of `sepi_tpu/train/optim.py` (an optax chain there), step for step
in optax's order:

1. the preconditioner, with the learning rate applied inside it:
   - "muon" (default; `optax.contrib.muon` with beta = max(momentum,
     0.9)): parameters with two dimensions (in the x-vector only the
     output layer's weight) take Nesterov momentum with bias correction,
     then 5 Newton-Schulz steps (coefficients 3.4445, -4.7750, 2.0315)
     on the momentum normalised by its Frobenius norm + 1e-8, then the
     shape factor sqrt(max(1, out/in)); every other parameter takes
     Adam (b1 0.9, b2 0.999, eps 1e-8, Nesterov).  A torch `Linear`
     weight is (out, in); the iteration runs on it in Flax's (in, out)
     orientation, transposed as optax transposes it, so the shape factor
     and the rounding are the reference's;
   - "none": [L2 term,] momentum trace (g + momentum * trace), times -lr;
2. ``max_param_change``: the update scaled so its global l2 norm is at
   most that (eps 1e-12);
3. per-subtree learning-rate factors (Flax-style "/" prefixes);
4. proportional shrink: u -= (1 - (1 - shrink * lr)^exponent) * p, for
   every parameter outside a batchnorm.

Every count starts at 0 at the first update.  Scalars derived from the
step count (`StepScalars`: the learning rate, the shrink factor, the bias
corrections) are computed on the host in float32 as the reference does,
so a step never waits for the device.  A captured step (`train.graphs`)
cannot take host floats that change each step: it reads the same float32
numbers from a device row that the host fills before each replay
(`OptimizerChain.scalar_rows`), and every op that takes one rounds as it
does with the host float.  Only the module's parameters take part: the
batchnorm's fixed zero offset is a buffer.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import OptimizerConfig

NS_COEFFS = (3.4445, -4.7750, 2.0315)
NS_STEPS = 5
ADAM_B1, ADAM_B2, EPS = 0.9, 0.999, 1e-8


def lr_schedule(cfg: OptimizerConfig, total_steps: int,
                num_jobs_multiplier: float = 1.0) -> Callable[[int], float]:
    """Exponential decay initial -> final over total_steps
    (common.py:644-657), in float32 like the reference's schedule."""
    total = np.float32(max(total_steps, 1))
    ratio = np.float32(cfg.final_lr / cfg.initial_lr)

    def schedule(step: int) -> float:
        frac = np.minimum(np.float32(step) / total, np.float32(1.0))
        lr = np.float32(cfg.initial_lr) * ratio ** frac
        return float(np.float32(lr * np.float32(num_jobs_multiplier)))

    return schedule


def dropout_schedule(spec: str) -> Callable[[float], float]:
    """Parse nnet3 dropout schedules like '0,0@0.20,0.1@0.50,0' into
    rate(train_fraction), piecewise linear through the knots (first at
    fraction 0, last at 1).  A parser only: no v1-v5 graph has dropout."""
    parts = spec.split(",")
    knots = []
    for i, p in enumerate(parts):
        if "@" in p:
            v, f = p.split("@")
            knots.append((float(f), float(v)))
        else:
            knots.append((0.0 if i == 0 else 1.0, float(p)))
    knots.sort(key=lambda t: t[0])

    def rate(frac: float) -> float:
        if frac <= knots[0][0]:
            return knots[0][1]
        for (f0, v0), (f1, v1) in zip(knots, knots[1:]):
            if frac <= f1:
                w = 0.0 if f1 == f0 else (frac - f0) / (f1 - f0)
                return v0 + w * (v1 - v0)
        return knots[-1][1]

    return rate


def flax_path(name: str) -> str:
    """The reference's parameter path of a torch parameter name:
    ``segment.output.weight`` -> ``segment/output/kernel``,
    ``frames.tdnn1.batchnorm.weight`` -> ``frames/tdnn1/batchnorm/scale``."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "scale" if len(parts) > 1 and parts[-2] == "batchnorm" else "kernel"
    return "/".join(parts)


def subtree_lr_factors(names: Sequence[str], factors: Mapping[str, float]) -> Dict[str, float]:
    """Per-parameter multipliers from Flax-style prefixes ({"am": 0.2},
    {"segment/tdnn6": 0.5}): the first prefix equal to the parameter's
    path or to one of its "/" ancestors wins; others get 1."""
    out = {}
    for n in names:
        joined = flax_path(n)
        out[n] = next((f for prefix, f in factors.items()
                       if joined == prefix or joined.startswith(prefix + "/")), 1.0)
    return out


def check_shrink_guard(cfg: OptimizerConfig, lr: float) -> None:
    """train_cvector_dnn.py:292-296: refuse unstable shrinkage."""
    factor = 1.0 - cfg.proportional_shrink * lr
    if factor <= cfg.shrink_guard:
        raise ValueError(
            f"shrink factor {factor:.3f} <= guard {cfg.shrink_guard}: "
            "proportional-shrink too large for this learning rate"
        )


def _bias_correction(decay: float, count: int) -> float:
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def _shrink_factor(shrink: float, lr: float, exponent: float) -> float:
    """1 - (1 - shrink*lr)^exponent in float32."""
    return float(np.float32(1.0) - (np.float32(1.0) - np.float32(shrink) * np.float32(lr))
                 ** np.float32(exponent))


def _reciprocal(x: float) -> float:
    return float(np.float32(1.0) / np.float32(x))


Scalar = Union[float, torch.Tensor]


class StepScalars(NamedTuple):
    """The per-step scalars of one update at count ``c``: host floats
    (eager) or 0-dim float32 views of a device row (a captured step).
    ``bc_*`` are bias corrections 1 - decay^n (beta = max(momentum, 0.9)
    for Muon, Adam's b1 and b2) at n = c + 1 (``_c1``) and c + 2
    (``_c2``); ``inv_*`` their float32 reciprocals."""

    lr: Scalar
    shrink: Scalar
    bc_beta_c1: Scalar
    bc_beta_c2: Scalar
    bc_b1_c1: Scalar
    bc_b1_c2: Scalar
    bc_b2_c1: Scalar
    inv_beta_c1: Scalar
    inv_beta_c2: Scalar
    inv_b1_c1: Scalar
    inv_b1_c2: Scalar
    inv_b2_c1: Scalar


def _div(t: torch.Tensor, d: Scalar, inv: Scalar) -> torch.Tensor:
    """``t / d`` rounded as torch rounds ``t / float``: on a CUDA tensor
    that op multiplies by the host scalar's float32 reciprocal, so a device
    ``d`` takes its reciprocal ``inv`` there; elsewhere it divides
    (`tools/graph_ops_probe.py`)."""
    if isinstance(d, torch.Tensor) and t.is_cuda:
        return t * inv
    return t / d


def _foreach_div(ts, d: Scalar, inv: Scalar):
    """`torch._foreach_div(ts, d)` rounded as with a host float ``d``: on
    CUDA that op, too, multiplies by the float32 reciprocal."""
    if isinstance(d, torch.Tensor) and ts[0].is_cuda:
        return torch._foreach_mul(ts, inv)
    return torch._foreach_div(ts, d)


def newton_schulz(x: torch.Tensor, steps: int = NS_STEPS, eps: float = EPS) -> torch.Tensor:
    """optax's `orthogonalize_via_newton_schulz` on a matrix in Flax's
    (in, out) orientation: transposed when rows > cols, normalised by its
    Frobenius norm, then X <- c0 X + (c1 A + (c2 A) A) X with A = X X^T."""
    transposed = x.shape[0] > x.shape[1]
    if transposed:
        x = x.T
    x = x / (torch.linalg.norm(x) + eps)
    c0, c1, c2 = NS_COEFFS
    for _ in range(steps):
        a = x @ x.T
        b = c1 * a + (c2 * a) @ a
        x = c0 * x + b @ x
    return x.T if transposed else x


def global_norm(tensors) -> torch.Tensor:
    """l2 norm over all tensors, as a device scalar: one concatenation and
    a sum of squares.  (On the CPU, torch's float32 `vector_norm` and
    `_foreach_norm` drift by ~1e-4 over the x-vector's 7M parameters;
    `sum` does not.)"""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    return torch.sqrt(torch.sum(flat * flat))


def clip_update_norm(updates: Dict[str, torch.Tensor], max_change: float) -> None:
    """Kaldi --max-param-change: cap the global l2 of the (post-LR)
    update, in place: u *= min(1, max_change / (norm + 1e-12))."""
    norm = global_norm(updates.values())
    torch._foreach_mul_(list(updates.values()), torch.clamp(max_change / (norm + 1e-12), max=1.0))


def proportional_shrink(updates: Dict[str, torch.Tensor], params: Mapping[str, torch.Tensor],
                        shrink: float, lr: float, exponent: float,
                        factor: Optional[Scalar] = None) -> None:
    """u -= (1 - (1 - shrink*lr)^exponent) * p for every parameter outside
    a batchnorm (in place): the reference's once-per-iteration shrink
    spread over steps.  ``factor``, when given, is that coefficient
    (`StepScalars.shrink`, a device scalar in a captured step)."""
    if factor is None:
        factor = _shrink_factor(shrink, lr, exponent)
    names = [n for n in updates if "batchnorm" not in n.split(".")]
    torch._foreach_sub_([updates[n] for n in names],
                        torch._foreach_mul([params[n] for n in names], factor))


class OptimizerChain:
    """`build_optimizer`'s chain.  ``init(params)`` makes the state (a dict
    of tensors and a step count); ``update(grads, state, params)`` returns
    the updates of one step and advances the state in place;
    `apply_updates` adds them to the parameters."""

    def __init__(self, cfg: OptimizerConfig, total_steps: int,
                 num_jobs_multiplier: float = 1.0,
                 lr_factors: Optional[Dict[str, float]] = None):
        if cfg.preconditioner == "muon" and cfg.l2_regularize > 0:
            raise ValueError(
                "l2_regularize is only implemented for the momentum-SGD chain "
                "(preconditioner='none'); with muon use proportional_shrink"
            )
        if cfg.preconditioner not in ("muon", "none", ""):
            raise ValueError(f"unknown preconditioner {cfg.preconditioner!r}")
        self.cfg = cfg
        self.muon = cfg.preconditioner == "muon"
        self.beta = max(cfg.momentum, 0.9)
        self.schedule = lr_schedule(cfg, total_steps, num_jobs_multiplier)
        self.lr_factors = dict(lr_factors or {})
        self.exponent = 0.0
        if cfg.proportional_shrink > 0:
            check_shrink_guard(cfg, cfg.initial_lr * num_jobs_multiplier)
            self.exponent = min(1.0, cfg.shrink_iterations / max(total_steps, 1))

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        zeros = {n: torch.zeros_like(p) for n, p in params.items()}
        if not self.muon:
            return {"count": 0, "trace": zeros}
        nu = {n: torch.zeros_like(p) for n, p in params.items() if p.ndim != 2}
        return {"count": 0, "mu": zeros, "nu": nu}

    def scalars(self, count: int) -> StepScalars:
        """The host's float32 scalars of the update at ``count``."""
        lr = self.schedule(count)
        shrink = (_shrink_factor(self.cfg.proportional_shrink, lr, self.exponent)
                  if self.cfg.proportional_shrink > 0 else 0.0)
        c1, b = count + 1, self.beta
        bc = (_bias_correction(b, c1), _bias_correction(b, c1 + 1),
              _bias_correction(ADAM_B1, c1), _bias_correction(ADAM_B1, c1 + 1),
              _bias_correction(ADAM_B2, c1))
        return StepScalars(lr, shrink, *bc, *(_reciprocal(x) for x in bc))

    def scalar_rows(self, count: int, k: int = 1) -> np.ndarray:
        """(k, len(StepScalars)) float32: the scalars of counts count ..
        count + k - 1, the rows a captured step reads."""
        return np.asarray([self.scalars(count + i) for i in range(k)], np.float32)

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: dict,
               params: Mapping[str, torch.Tensor],
               scalars: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """``scalars``: a device row of `scalar_rows` for this count, read
        in place of the host's floats (a captured step); None computes them."""
        count = state["count"]
        s = self.scalars(count) if scalars is None else StepScalars(*scalars.unbind(0))
        if self.muon:
            updates = self._muon_adam(grads, state, s)
        else:
            names = list(grads)
            g = [grads[n] for n in names]
            if self.cfg.l2_regularize > 0:
                g = torch._foreach_add(g, torch._foreach_mul([params[n] for n in names],
                                                             self.cfg.l2_regularize))
            trace = [state["trace"][n] for n in names]
            torch._foreach_mul_(trace, self.cfg.momentum)
            torch._foreach_add_(trace, g)  # g + momentum * trace
            updates = dict(zip(names, torch._foreach_mul(trace, -s.lr)))
        clip_update_norm(updates, self.cfg.max_param_change)
        if self.lr_factors:
            for n, f in subtree_lr_factors(list(updates), self.lr_factors).items():
                if f != 1.0:
                    updates[n].mul_(f)
        if self.cfg.proportional_shrink > 0:
            proportional_shrink(updates, params, self.cfg.proportional_shrink, s.lr,
                                self.exponent, factor=s.shrink)
        state["count"] = count + 1
        return updates

    def _muon_adam(self, grads, state, s: StepScalars):
        updates = {}
        for n, g in grads.items():
            if g.ndim == 2:
                b, mu = self.beta, state["mu"][n]
                mu.copy_((1 - b) * g + b * mu)
                mu_hat = (b * _div(mu, s.bc_beta_c2, s.inv_beta_c2)
                          + (1 - b) * _div(g, s.bc_beta_c1, s.inv_beta_c1))
                # torch Linear weight (out, in) -> Flax kernel (in, out)
                k = mu_hat.T
                factor = float(np.sqrt(np.float32(max(1.0, k.shape[1] / k.shape[0]))))
                updates[n] = (newton_schulz(k) * factor).T * (-s.lr)
        # Adam on the rest, as one multi-tensor op per line
        names = [n for n, g in grads.items() if g.ndim != 2]
        g = [grads[n] for n in names]
        mu = [state["mu"][n] for n in names]
        nu = [state["nu"][n] for n in names]
        torch._foreach_mul_(mu, ADAM_B1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - ADAM_B1))  # (1-b1) g + b1 mu
        torch._foreach_mul_(nu, ADAM_B2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - ADAM_B2))
        mu_hat = torch._foreach_mul(_foreach_div(mu, s.bc_b1_c2, s.inv_b1_c2), ADAM_B1)
        torch._foreach_add_(mu_hat, torch._foreach_mul(
            _foreach_div(g, s.bc_b1_c1, s.inv_b1_c1), 1 - ADAM_B1))
        den = torch._foreach_sqrt(_foreach_div(nu, s.bc_b2_c1, s.inv_b2_c1))
        torch._foreach_add_(den, EPS)
        step = torch._foreach_div(mu_hat, den)
        torch._foreach_mul_(step, -s.lr)
        updates.update(zip(names, step))
        return {n: updates[n] for n in grads}


def apply_updates(params: Mapping[str, torch.Tensor], updates: Mapping[str, torch.Tensor]) -> None:
    with torch.no_grad():
        torch._foreach_add_([params[n] for n in updates], list(updates.values()))


def build_optimizer(cfg: OptimizerConfig, total_steps: int, num_jobs_multiplier: float = 1.0,
                    lr_factors: Optional[Dict[str, float]] = None
                    ) -> Tuple[OptimizerChain, Callable[[int], float]]:
    """The full chain; returns (chain, lr_schedule_fn) like the reference."""
    chain = OptimizerChain(cfg, total_steps, num_jobs_multiplier, lr_factors)
    return chain, chain.schedule
