"""Asynchronous RL trainer (GLM-5 §4.1.1).

Port of ``repro.async_rl.trainer``.  Consumes trajectory groups from the
buffer, computes the Direct Double-sided-IS loss (Eq. 3–5) on padded token
batches, applies Muon/AdamW updates, and pushes weights to the rollout
engines every ``push_every`` gradient steps — RESETTING THE OPTIMIZER
after each push, as the paper does ("the weight update considers a
different optimization problem due to the changing rollout policy").

The forward is the model's full-vocabulary ``logits`` (K9 in every dense
layer; its backward is plain), as the reference's, not K10's chunked loss:
the IS loss needs each generated token's logprob.  The model's parameters
are trained in place; autograd is on for the step whatever the calling
thread's grad mode (the front-ends' serve threads run without it).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.async_rl.rollout import RolloutEngine
from repro_torch.async_rl.tito import Trajectory
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.models.losses import token_logprobs
from repro_torch.optim import muon
from repro_torch.rl.async_is import async_is_loss
from repro_torch.rl.grpo import group_advantages


def pack_groups(groups: List[List[Trajectory]], pad_to: int,
                prompt_pad: int) -> Dict[str, np.ndarray]:
    """Flatten groups to fixed-size arrays for the loss."""
    trajs = [t for g in groups for t in g]
    B = len(trajs)
    tokens = np.zeros((B, prompt_pad + pad_to), np.int32)
    lp_roll = np.zeros((B, pad_to), np.float32)
    mask = np.zeros((B, pad_to), np.float32)
    rewards = np.zeros((len(groups), len(groups[0])), np.float32)
    for i, t in enumerate(trajs):
        p = t.prompt[-prompt_pad:]
        tokens[i, prompt_pad - len(p):prompt_pad] = p
        n = min(len(t.tokens), pad_to)
        tokens[i, prompt_pad:prompt_pad + n] = t.tokens[:n]
        lp_roll[i, :n] = t.logprobs[:n]
        mask[i, :n] = 1.0
        if t.loss_mask is not None:
            mask[i, :n] *= t.loss_mask[:n]
    for gi, g in enumerate(groups):
        for si, t in enumerate(g):
            rewards[gi, si] = t.reward
    return {"tokens": tokens, "lp_rollout": lp_roll, "mask": mask,
            "rewards": rewards, "prompt_pad": prompt_pad}


class AsyncTrainer:
    def __init__(self, cfg: ModelConfig, params: torch.nn.Module, specs, *,
                 engines: List[RolloutEngine], lr: float = 1e-3,
                 push_every: int = 4, eps_low: float = 0.2,
                 eps_high: float = 0.2, muon_split: bool = True,
                 device=None):
        """``params`` is the model (trained in place) on ``device`` (the
        GPU unless ``device="cpu"`` is asked for); ``specs`` its
        parameters' logical axes (``get_model(cfg).param_axes(params)``,
        the reference's Builder specs)."""
        self.device = resolve_device(device)
        first = next(params.parameters())
        if first.device.type != self.device.type:
            raise ValueError(f"params live on {first.device}, the trainer "
                             f"runs on {self.device}")
        self.cfg = cfg
        self.model = get_model(cfg)
        self.params = params
        self.specs = specs
        self.engines = engines
        self.lr = lr
        self.push_every = push_every
        self.version = 0
        params.requires_grad_(True)
        self._named = dict(params.named_parameters())
        self.opt_state = muon.init(self._named, specs)
        self.muon_split = muon_split
        self.eps = (eps_low, eps_high)
        self.history: List[dict] = []

    def _step(self, tokens: torch.Tensor, lp_rollout: torch.Tensor,
              mask: torch.Tensor, adv: torch.Tensor, prompt_pad: int
              ) -> dict:
        named = self._named
        with torch.enable_grad():
            logits = self.model.logits(self.params, tokens)
            # logprob of generated token t is read at position t-1
            gen = tokens[:, prompt_pad:]
            lp_all = token_logprobs(logits[:, prompt_pad - 1:-1], gen)
            st = async_is_loss(lp_all, lp_rollout, adv, mask,
                               eps_low=self.eps[0], eps_high=self.eps[1])
            st.loss.backward()
        # a parameter the loss never reads (an MTP head) has no gradient;
        # JAX gives it zeros
        grads, gnorm = muon.global_norm_clip(
            {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in named.items()}, 1.0)
        self.opt_state = muon.update(named, grads, self.specs,
                                     self.opt_state, lr=self.lr,
                                     cfg=self.cfg, split=self.muon_split)
        for p in named.values():
            p.grad = None
        return {"loss": st.loss.detach(), "kept": st.kept_frac,
                "ratio": st.mean_ratio, "grad_norm": gnorm}

    def train_on(self, groups: List[List[Trajectory]], *,
                 pad_to: int = 16, prompt_pad: int = 16) -> dict:
        batch = pack_groups(groups, pad_to, prompt_pad)
        dev = next(iter(self._named.values())).device
        adv = group_advantages(
            torch.from_numpy(batch["rewards"]).to(dev)).reshape(-1)
        metrics = self._step(
            torch.from_numpy(batch["tokens"]).to(dev),
            torch.from_numpy(batch["lp_rollout"]).to(dev),
            torch.from_numpy(batch["mask"]).to(dev), adv, prompt_pad)
        self.version += 1
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["version"] = self.version
        metrics["mean_reward"] = float(batch["rewards"].mean())
        self.history.append(metrics)
        if self.version % self.push_every == 0:
            for e in self.engines:
                e.push_weights(self.params, self.version)
            # paper: reset optimizer after each inference-engine weight push
            self.opt_state = muon.init(self._named, self.specs)
        return metrics
