"""PyTorch port: every architecture of the registry, the port's mirror of
``tests/test_models.py``'s per-arch tests over all eleven ``ARCH_IDS``.

* the registry: ``ARCH_IDS`` and every alias equal to the reference's, and
  ``get_model`` serving families dense, moe, vlm, audio, ssm and hybrid;
* each smoke config equal to the reference's on every field the port
  keeps (the port's ``ModelConfig`` is the reference's less the mesh and
  implementation switches), and so each full config;
* the smoke train step (the port's ``make_train_step``: loss, gradients,
  clipping, one Muon step) on seeded weights, with the frontend embeddings
  of ``test_models._batch`` (0.01 · N(0, 1); vlm: (B, F, D) patches before
  the text, audio: (B, encoder_seq_len, D) frames): loss finite and > 0,
  every gradient and updated weight finite;
* prefill + 2 decode steps over a contiguous cache: the shapes of
  ``test_smoke_decode`` (vlm text-only, audio with its frames), finite;
* each FULL config built on the ``meta`` device: the parameter count
  equal to the reference's abstract init (kimi-k2's 1 T included).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.models import get_model as jax_get_model
from repro_torch import configs as tconfigs
from repro_torch.bridge import _MODEL
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig as PortConfig
from repro_torch.launch.steps import make_train_step
from repro_torch.models import encdec, get_model, transformer
from repro_torch.models.transformer import Transformer
from repro_torch.optim import muon
from _torch_threads import one_torch_thread  # noqa: F401

B, S = 2, 64


def test_registry_matches_reference():
    assert ARCH_IDS == JAX_ARCH_IDS
    assert tconfigs._ALIASES == jconfigs._ALIASES
    for alias, arch in jconfigs._ALIASES.items():
        assert tconfigs.canonical(alias) == arch
    families = {get_smoke_config(a).family: get_model(get_smoke_config(a))
                for a in ARCH_IDS}
    assert set(families) == {"dense", "moe", "vlm", "audio", "ssm",
                             "hybrid"}
    assert families["vlm"] is transformer and families["audio"] is encdec
    with pytest.raises(KeyError):
        tconfigs.canonical("gdn-1b")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_reference(arch):
    for port, ref in ((get_smoke_config(arch), jconfigs.get_smoke_config(arch)),
                      (get_config(arch), jconfigs.get_config(arch))):
        for f in dataclasses.fields(PortConfig):
            want = getattr(ref, f.name)
            got = getattr(port, f.name)
            if dataclasses.is_dataclass(want):
                assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                    f.name
            else:
                assert got == want, f.name


def _batch(cfg, seed=1):
    """``test_models._batch`` in torch, from numpy seeds."""
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                           .astype(np.int32))
    batch = {"tokens": tok, "targets": torch.roll(tok, -1, dims=1)}
    if cfg.frontend != "none":
        F = cfg.encoder_seq_len if cfg.family == "audio" \
            else cfg.frontend_tokens
        batch["frontend_embeds"] = torch.from_numpy(
            (0.01 * rng.standard_normal((B, F, cfg.d_model)))
            .astype(np.float32))
    return batch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_step(arch):
    cfg = get_smoke_config(arch)
    assert cfg.num_layers <= 4 and cfg.d_model <= 512
    assert cfg.num_experts <= 4
    M = get_model(cfg)
    model = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = make_train_step(model, lr=1e-3)
    state = muon.init(dict(model.named_parameters()), M.param_axes(model))
    state, metrics = step(state, _batch(cfg))
    assert torch.isfinite(metrics["loss"]) and metrics["loss"] > 0, arch
    assert torch.isfinite(metrics["grad_norm"]), arch
    for name, p in model.named_parameters():
        assert torch.isfinite(p).all(), (arch, name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_decode(arch):
    cfg = get_smoke_config(arch)
    M = get_model(cfg)
    model = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(cfg)
    cache = M.init_cache(cfg, B, S + 8, device="cpu")
    kw = {}
    if cfg.family == "audio":
        kw["frontend_embeds"] = batch["frontend_embeds"]
    logits, cache = M.prefill(model, batch["tokens"], cache, **kw)
    assert logits.shape == (B, 1, cfg.vocab_size)
    tok = logits.argmax(-1)
    for step in range(2):
        logits, cache = M.decode_step(model, tok, cache, S + step)
        assert logits.shape == (B, 1, cfg.vocab_size)
        assert torch.isfinite(logits).all(), arch
        tok = logits.argmax(-1)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_param_count(arch):
    cfg = get_config(arch)
    model = _MODEL.get(cfg.family, Transformer)(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    jcfg = jconfigs.get_config(arch)
    params, _ = jax_get_model(jcfg).init(jax.random.key(0), jcfg,
                                         abstract=True)
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    assert n == n_ref, arch
    floor = 5e7 if arch == "whisper_base" else 1e9
    assert n > floor, arch
