"""End-to-end training driver (port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \
      --steps 6 --device cpu

Builds the model from the arch config (full or smoke-reduced), a synthetic
Markov LM corpus, the Muon(+Split) optimizer and the train step, with
periodic async checkpointing and one JSON line of metrics every
``--log-every`` steps (the reference's keys: loss, ce, aux, grad_norm,
step, lr, tok_per_s).  It runs on the GPU unless ``--device cpu`` is
given.  ``train(cfg, tc)`` is the loop itself, for callers with their own
``ModelConfig`` (a depth-cut one, say); ``main`` parses the reference's
flags into it.  The reference's default arch, ``glm-5``, trains with its
MTP head (0.3 × the MTP losses in the loss, logged as ``mtp``);
``--arch falcon-mamba-7b`` trains the Mamba-1 LM and ``--arch zamba2-2.7b``
the hybrid (Mamba-2 layers and one shared attention block, DSA on that
block unless ``--dense-attn``); the model comes from the registry by the
config's family.  ``--arch`` takes every id and alias of the registry.
Like the reference's trainer CLI, it builds no frontend embeddings:
``phi-3-vision-4.2b`` (family ``vlm``) trains on text alone, and
``whisper-base`` (family ``audio``), whose loss needs the encoder's frame
embeddings, stops with an error that says so (callers with frames call
the train step of ``launch.steps`` with ``frontend_embeds`` in the
batch).  As the reference's, it builds the host mesh (one rank: a process
group of one rank is started for it and ended after the loop, unless the
caller has one) and gives it to the train step.  The reference also
places the parameters by the sharding rules (``tree_shardings``); one
rank holds each parameter whole under them, so here they stay plain
tensors (see ``launch.steps``).
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import List, Optional

import torch

from repro_torch.checkpoint import io as ckpt
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.pipeline import Pipeline, lm_generator
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import get_model
from repro_torch.optim import muon, schedule


def n_params(model: torch.nn.Module) -> int:
    """Parameter count (the reference's ``utils.tree_size`` of the params)."""
    return sum(p.numel() for p in model.parameters())


def train(cfg: ModelConfig, tc: TrainConfig, *, device=None,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          log_every: int = 10, freeze: Optional[str] = None,
          model: Optional[torch.nn.Module] = None) -> List[dict]:
    """Train ``cfg`` for ``tc.total_steps`` steps; returns the logged
    metric dicts (one every ``log_every`` steps and the last).  ``freeze``
    is ``launch.steps.make_train_step``'s (``"all_but_indexer"``: the DSA
    indexer's warm-up, the base frozen); ``model`` trains that model (on
    ``device``) in place of one initialised from ``tc.seed``."""
    if cfg.family == "audio":
        raise ValueError(
            f"{cfg.name} (family 'audio') trains on frame embeddings "
            f"(B, {cfg.encoder_seq_len}, {cfg.d_model}) as "
            f"batch['frontend_embeds'], which this trainer's token corpus "
            f"does not make; build the batch and call "
            f"launch.steps.make_train_step")
    dev = resolve_device(device)
    M = get_model(cfg)
    if model is None:
        model = M.init(cfg,
                       torch.Generator(device=dev).manual_seed(tc.seed),
                       device=dev)
    print(f"arch={cfg.name} params={n_params(model) / 1e6:.1f}M "
          f"family={cfg.family}", flush=True)
    with host_mesh(dev) as mesh:
        return _loop(cfg, tc, model, mesh, dev, ckpt_dir, ckpt_every,
                     log_every, freeze)


def _loop(cfg, tc, model, mesh, dev, ckpt_dir, ckpt_every,
          log_every, freeze) -> List[dict]:
    axes = get_model(cfg).param_axes(model)
    step_fn = make_train_step(model, mesh=mesh, train_cfg=tc,
                              lr=tc.learning_rate, freeze=freeze)
    opt_state = muon.init(dict(model.named_parameters()), axes)
    pipe = Pipeline(lm_generator(cfg.vocab_size, tc.seq_len, tc.batch_size,
                                 seed=tc.seed, steps=tc.total_steps),
                    device=dev)
    peak = tc.learning_rate
    hist, writers = [], []
    t0 = time.time()
    for i, batch in enumerate(pipe):
        lr = schedule.warmup_cosine(i, peak=peak, floor=peak * 0.1,
                                    warmup=tc.warmup_steps,
                                    total=tc.total_steps)
        opt_state, metrics = step_fn(opt_state, batch, lr=lr)
        if i % log_every == 0 or i == tc.total_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m.update(step=i, lr=float(lr),
                     tok_per_s=tc.batch_size * tc.seq_len * (i + 1)
                     / (time.time() - t0))
            hist.append(m)
            print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                              for k, v in m.items()}), flush=True)
        if ckpt_dir and (i + 1) % ckpt_every == 0:
            writers.append(ckpt.save_async(
                Path(ckpt_dir) / f"step_{i + 1}",
                {"params": model.state_dict()}, step=i + 1))
    pipe.close()
    for w in writers:
        w.join()
    if ckpt_dir:
        ckpt.save(Path(ckpt_dir) / f"step_{tc.total_steps}",
                  {"params": model.state_dict()}, step=tc.total_steps)
    print(f"final loss {hist[-1]['loss']:.4f} "
          f"(started {hist[0]['loss']:.4f})", flush=True)
    return hist


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm-5")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-muon-split", action="store_true")
    ap.add_argument("--dense-attn", action="store_true",
                    help="disable DSA sparsity (dense baseline)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run without a GPU (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.dense_attn:
        cfg = cfg.replace(dsa=None)
    tc = TrainConfig(batch_size=args.batch, seq_len=args.seq,
                     learning_rate=args.lr, warmup_steps=args.warmup,
                     total_steps=args.steps,
                     muon_split=not args.no_muon_split, seed=args.seed)
    return train(cfg, tc, device=args.device, ckpt_dir=args.ckpt_dir,
                 ckpt_every=args.ckpt_every, log_every=args.log_every)


if __name__ == "__main__":
    main()
