"""PyTorch port: the GDN / SimpleGDN ablation layer (``layers.gdn``)
against the reference's ``repro.layers.gdn``.

Both forms, fp32, the reference's ``build_gdn`` weights carried over by
``bridge.gdn_from_jax_params``: ``apply_gdn`` within rtol 1e-5 of the
reference's (S 1, 7 and 40, so the conv's window and the recurrence run
past their first steps), ``_delta_scan`` alone likewise, and the layer's
leaves, shapes, logical axes and init scales as ``build_gdn`` declares
them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxConfig
from repro.layers import gdn as jgdn
from repro.sharding.rules import Builder
from repro_torch.bridge import gdn_from_jax_params
from repro_torch.layers import gdn as tgdn
from repro_torch.models.transformer import param_axes
from test_torch_train import port_cfg
from _torch_threads import one_torch_thread  # noqa: F401

JCFG = JaxConfig(name="gdn-smoke", num_layers=1, d_model=64, num_heads=4,
                 num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=64,
                 ssm_conv=4)
FORMS = {"gdn": False, "simple": True}
RTOL, ATOL = 1e-5, 1e-6


def _reference(simple, seed=0):
    b = Builder(jax.random.key(seed), jnp.float32)
    jgdn.build_gdn(b, JCFG, simple=simple)
    return b


@pytest.mark.parametrize("S", [1, 7, 40])
@pytest.mark.parametrize("form", list(FORMS))
def test_apply_gdn_matches_reference(form, S):
    simple = FORMS[form]
    b = _reference(simple)
    params_np = jax.tree.map(np.asarray, b.params)
    if simple:                  # a decay away from its zero init
        params_np["decay"] = np.linspace(-1.0, 2.0, JCFG.num_heads,
                                         dtype=np.float32)
    layer = gdn_from_jax_params(params_np, port_cfg(JCFG), simple,
                                device="cpu")
    x = np.random.default_rng(S).standard_normal(
        (2, S, JCFG.d_model)).astype(np.float32)
    want = jgdn.apply_gdn(jax.tree.map(jnp.asarray, params_np),
                          jnp.asarray(x), JCFG, simple=simple)
    got = tgdn.apply_gdn(layer, torch.from_numpy(x), layer.cfg,
                         simple=simple)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_delta_scan_matches_reference():
    rng = np.random.default_rng(3)
    B, S, H, dh = 2, 33, 3, 8
    q, k, v = (rng.standard_normal((B, S, H, dh)).astype(np.float32)
               for _ in range(3))
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    beta, g = (rng.random((B, S, H)).astype(np.float32) for _ in range(2))
    want = jgdn._delta_scan(*(jnp.asarray(a) for a in (q, k, v, beta, g)))
    got = tgdn._delta_scan(*(torch.from_numpy(a) for a in (q, k, v, beta,
                                                              g)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("form", list(FORMS))
def test_leaves_axes_and_inits_match_reference(form):
    simple = FORMS[form]
    b = _reference(simple)
    layer = tgdn.build_gdn(port_cfg(JCFG), simple, device="cpu")
    shapes = {k: tuple(p.shape) for k, p in layer.named_parameters()}
    assert shapes == {k: tuple(v.shape) for k, v in b.params.items()}
    assert param_axes(layer) == {k: tuple(v) for k, v in b.specs.items()}
    for k, p in layer.named_parameters():
        ref = np.asarray(b.params[k])
        if not ref.any():
            assert not p.any(), k              # zeros where zeros
        else:                                  # the same scale
            np.testing.assert_allclose(float(p.std()), float(ref.std()),
                                       rtol=0.25)
