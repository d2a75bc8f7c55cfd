"""µP-AdamW optimizer and LR schedule.

Port of `omnibiote_tpu/training/optim.py`, whose optax chain is
  clip-by-global-norm (norm kept for logging) -> Adam moments ->
  + wd·wd_mult·p -> ·(-lr(t)·lr_mult)
with the reference's semantics (train_encoder.py:193-201,316-318):
  * base LR = lr·sqrt(global_batch_size)/32;
  * µP: matrix-like parameters get LR/width_mult and, with mup's default
    decoupled_wd=False, weight decay·width_mult (`mup.py`);
  * LinearLR 1.0 -> 0.0 over total_iters, continued from the true step
    count on resume;
  * Adam moments in fp32, or stored in bf16 (`moment_dtype`) with all the
    arithmetic in fp32 (the JAX package's `scale_by_adam_mixed`).

The update runs in place on the fp32 master parameters with foreach ops
(one kernel per op for all tensors at once). Step counters are host ints,
so an update never waits for the device; the global grad norm stays a
device tensor.

Sharded (parallel/sharding.py): the tensors are this rank's shards, the
µP multipliers are read from their global names, and the clip's global norm
sums the shards' squares over every rank (the default group), each
replicated tensor counted on one rank only (`norm_weights`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import OmniBioTAConfig, TrainConfig, torch_dtype
from ..mup import lr_mult_tree, wd_mult_tree


def scaled_lr(train_cfg: TrainConfig) -> float:
    """lr·sqrt(batch)/32 (train_encoder.py:195; default batch 1024 -> x1)."""
    return train_cfg.lr * (train_cfg.batch_size ** 0.5) / 32.0


def linear_decay(base_lr: float, total_iters: int) -> Callable[[int], float]:
    """torch LinearLR(start_factor=1.0, end_factor=0.0, total_iters), in
    fp32 as the JAX schedule computes it."""
    def sched(count: int) -> float:
        frac = np.float32(min(count, total_iters)) / np.float32(max(total_iters, 1))
        return float(np.float32(base_lr) * (np.float32(1.0) - frac))
    return sched


@dataclasses.dataclass
class OptState:
    """The optax chain's state: the clip's pre-clip global norm (device
    tensor), Adam's step count and moments ({name: tensor}, in
    moment_dtype, the parameters' layout), and the schedule's count."""
    grad_norm: torch.Tensor
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    sched_count: int


class MupAdamW:
    """clip(grad_clip) -> Adam -> µP weight decay -> µP LR, over a fixed
    list of named parameters."""

    def __init__(self, names: List[str], model_cfg: OmniBioTAConfig,
                 train_cfg: TrainConfig, total_iters: int,
                 norm_weights: Optional[List[float]] = None):
        tc = train_cfg
        self.norm_weights = norm_weights
        self.names = list(names)
        self.b1, self.b2, self.eps = tc.beta1, tc.beta2, tc.epsilon
        self.weight_decay, self.grad_clip = tc.weight_decay, tc.grad_clip
        self.moment_dtype = torch_dtype(tc.moment_dtype)
        self.schedule = linear_decay(scaled_lr(tc), total_iters)
        lr_m = lr_mult_tree(self.names, model_cfg, force_lr=tc.force_lr)
        wd_m = wd_mult_tree(self.names, model_cfg, force_lr=tc.force_lr,
                            decoupled=tc.mup_decoupled_wd)
        self.lr_mults = [lr_m[n] for n in self.names]
        self.wd_mults = [wd_m[n] for n in self.names]

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        zeros = lambda: {n: torch.zeros_like(params[n], dtype=self.moment_dtype)
                         for n in self.names}
        dev = params[self.names[0]].device
        return OptState(torch.zeros((), dtype=torch.float32, device=dev), 0,
                        zeros(), zeros(), 0)

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: OptState,
               params: Dict[str, torch.Tensor]) -> None:
        """One step: updates `params` (fp32 masters) and `state` in place."""
        p = [params[n] for n in self.names]
        g = [grads[n] for n in self.names]

        # clip by the global norm (per-tensor square sums in fp32 whatever
        # the grad dtype); a clipped grad keeps its dtype, as in JAX
        g32 = [x.float() for x in g]
        norms = torch.stack(torch._foreach_norm(g32))
        if self.norm_weights is None:
            gnorm = torch.linalg.vector_norm(norms)
        else:
            # this rank's share, squared, summed over the ranks (at one rank
            # sqrt(x·x) == x in IEEE arithmetic: the unsharded norm's bits)
            w = torch.tensor(self.norm_weights, device=norms.device)
            share = torch.linalg.vector_norm(norms * w)
            sq = share * share
            dist.all_reduce(sq)
            gnorm = torch.sqrt(sq)
        clip = self.grad_clip / torch.clamp_min(gnorm, self.grad_clip)
        g32 = torch._foreach_mul(g32, clip)
        if any(x.dtype != torch.float32 for x in g):
            g32 = [y.to(x.dtype).float() for x, y in zip(g, g32)]

        # Adam moments and update quotient, fp32 arithmetic
        count = state.count + 1
        b1, b2 = self.b1, self.b2
        c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
        mu = [state.mu[n] for n in self.names]
        nu = [state.nu[n] for n in self.names]
        if self.moment_dtype == torch.float32:
            m32, n32 = mu, nu           # updated in place
        else:
            m32, n32 = [x.float() for x in mu], [x.float() for x in nu]
        torch._foreach_mul_(m32, b1)
        torch._foreach_add_(m32, g32, alpha=1.0 - b1)
        torch._foreach_mul_(n32, b2)
        torch._foreach_addcmul_(n32, g32, g32, value=1.0 - b2)
        den = torch._foreach_div(n32, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(m32, c1)
        torch._foreach_div_(u, den)
        if self.moment_dtype != torch.float32:
            for dst, src in zip(mu, m32):
                dst.copy_(src)
            for dst, src in zip(nu, n32):
                dst.copy_(src)

        # + wd·wd_mult·p, then ·(-lr(t)·lr_mult), then onto the masters
        torch._foreach_add_(u, torch._foreach_mul(
            p, [self.weight_decay * m for m in self.wd_mults]))
        lr = self.schedule(state.sched_count)
        torch._foreach_mul_(u, [float(np.float32(-lr) * np.float32(m))
                                for m in self.lr_mults])
        torch._foreach_add_(p, u)

        state.grad_norm = gnorm
        state.count = count
        state.sched_count += 1


def make_optimizer(names: List[str], model_cfg: OmniBioTAConfig,
                   train_cfg: TrainConfig, total_iters: int,
                   norm_weights: Optional[List[float]] = None) -> MupAdamW:
    """MupAdamW; norm_weights: a sharded trainer's (parallel/sharding.py)."""
    return MupAdamW(names, model_cfg, train_cfg, total_iters, norm_weights)


def current_lr(opt_state: OptState, train_cfg: TrainConfig,
               total_iters: int) -> float:
    """LR at the current step (for logging, cf. train_encoder.py:326-332)."""
    return linear_decay(scaled_lr(train_cfg), total_iters)(opt_state.sched_count)
