#!/usr/bin/env python3
"""How the trainer's first steps move the loss at full width, on one GPU.

    python3 lr_study.py

``chip_smoke.py``'s 5-step trainer runs hold that the loss falls.  This
script shows what sets whether it does: for zamba2-2.7b at full width
(depth 54 -> 12, as ``chip_smoke.py`` trains it; dense attention, batch
2 x 2048) at learning rates 1e-3, 2e-3 and 4e-3, and for Yi-6B (depth 32
-> 8, batch 2 x 2048) at 2e-3, each step's loss, the spread of the logits
over the vocabulary (their standard deviation, averaged over the first
256 positions of the step's first row, before the step) and the gradient
norm, in fp32 with TF32 off, ``TrainConfig`` defaults otherwise, warm-up
0 and the cosine schedule over 5 steps (``launch.train.train``'s).  One
``[lr]`` line a run.  Without a GPU it exits non-zero.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def run(cfg, batch, seq, lr, steps=5):
    """(loss, logit spread, grad norm) a step of ``steps`` trainer steps."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import Pipeline, lm_generator
    from repro_torch.launch.steps import make_train_step
    from repro_torch.layers.common import logits_from_hidden
    from repro_torch.models import get_model
    from repro_torch.optim import muon, schedule
    M = get_model(cfg)
    model = M.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                   device="cuda")
    tc = TrainConfig(batch_size=batch, seq_len=seq, learning_rate=lr,
                     warmup_steps=0, total_steps=steps, seed=0)
    step = make_train_step(model, train_cfg=tc, lr=lr)
    opt = muon.init(dict(model.named_parameters()), M.param_axes(model))
    pipe = Pipeline(lm_generator(cfg.vocab_size, seq, batch, seed=0,
                                 steps=steps), device="cuda")
    out = []
    for i, data in enumerate(pipe):
        with torch.no_grad():
            h, _, _ = M.hidden(model, data["tokens"][:1, :256])
            spread = logits_from_hidden(model.embed, h, cfg).std(-1).mean()
        opt, m = step(opt, data, lr=schedule.warmup_cosine(
            i, peak=lr, floor=lr * 0.1, warmup=0, total=steps))
        out.append((round(float(m["loss"]), 5), round(float(spread), 4),
                    round(float(m["grad_norm"]), 4)))
    pipe.close()
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("lr_study: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("lr_study: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    build.build_all(build.LIBRARIES)
    zamba2 = get_config("zamba2_2p7b").replace(num_layers=12, dsa=None)
    yi = get_config("yi_6b").replace(num_layers=8, dsa=None)
    for cfg, lr in ((zamba2, 1e-3), (zamba2, 2e-3), (zamba2, 4e-3),
                    (yi, 2e-3)):
        steps = run(cfg, 2, 2048, lr)
        print(f"[lr] model={cfg.name} layers={cfg.num_layers} lr={lr} "
              f"losses={[s[0] for s in steps]} "
              f"logit_spread={[s[1] for s in steps]} "
              f"grad_norm={[s[2] for s in steps]}", flush=True)
        chip_smoke._free()
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
