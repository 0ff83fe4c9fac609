"""The PyTorch port's layers against `repro.models` on the same numpy
inputs (fp32): RMSNorm's f32 statistics, interleaved-pair RoPE (full
and chatglm's half-width), the GQA projections and head repetition,
SwiGLU, the embedding and the vocab projection."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import repro.configs as jconfigs
from repro.models import attention as jatt
from repro.models import layers as jlayers
from repro.models import transformer as jT
import repro_torch.configs as tconfigs
from repro_torch.models import attention as tatt
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as tT

ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=1e-5)


def test_configs_are_copies():
    for name in jconfigs.ARCHS:
        assert jconfigs.get(name).__dict__ == tconfigs.get(name).__dict__
        assert jconfigs.get_reduced(name).__dict__ == \
            tconfigs.get_reduced(name).__dict__


def test_rmsnorm():
    r = _rng(0)
    x = r.normal(size=(2, 5, 64)).astype(np.float32) * 3
    scale = r.normal(size=(64,)).astype(np.float32)
    got = tlayers.rmsnorm({"scale": torch.from_numpy(scale)},
                          torch.from_numpy(x), 1e-5)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                           1e-5)
    _close(got, want)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope_rotates_interleaved_pairs(fraction):
    r = _rng(1)
    x = r.normal(size=(2, 6, 4, 16)).astype(np.float32)
    pos = np.arange(6) + 37
    rot = max(int(16 * fraction), 2)
    tc, ts = tatt.rope_angles(torch.from_numpy(pos), rot, 1e4)
    jc, js = jatt.rope_angles(jnp.asarray(pos), rot, 1e4)
    _close(tc, jc)
    _close(ts, js)
    got = tatt.apply_rope(torch.from_numpy(x), tc, ts, fraction)
    want = jatt.apply_rope(jnp.asarray(x), jc, js, fraction)
    _close(got, want)
    # the interleaved convention: pair (0, 1) rotates together
    c, s = float(tc[0, 0]), float(ts[0, 0])
    x0, x1 = x[0, 0, 0, 0], x[0, 0, 0, 1]
    np.testing.assert_allclose(float(got[0, 0, 0, 0]), x0 * c - x1 * s,
                               atol=ATOL)


def test_qkv_repeat_kv_swiglu_embed_logits():
    cfg = jconfigs.get_reduced("yi-6b")
    r = _rng(2)
    d, h, kv, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    w = {k: r.normal(size=s).astype(np.float32) * 0.1 for k, s in
         {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd),
          "wi": (d, ff), "wg": (d, ff), "wdown": (ff, d)}.items()}
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    j = {k: jnp.asarray(v) for k, v in w.items()}
    x = r.normal(size=(2, 5, d)).astype(np.float32)
    for got, want in zip(tatt.qkv(t, torch.from_numpy(x), cfg),
                         jatt.qkv(j, jnp.asarray(x), cfg)):
        _close(got, want)
    k = r.normal(size=(2, 5, kv, hd)).astype(np.float32)
    _close(tatt.repeat_kv(torch.from_numpy(k), h // kv),
           jatt.repeat_kv(jnp.asarray(k), h // kv))
    _close(tlayers.swiglu(t, torch.from_numpy(x)),
           jlayers.swiglu(j, jnp.asarray(x)))
    emb = r.normal(size=(cfg.vocab_size, d)).astype(np.float32)
    ids = r.integers(0, cfg.vocab_size, size=(2, 7))
    _close(tlayers.embed_lookup({"embedding": torch.from_numpy(emb)},
                                torch.from_numpy(ids)),
           jlayers.embed_lookup({"embedding": jnp.asarray(emb)},
                                jnp.asarray(ids)))
    p_t = {"embed": {"embedding": torch.from_numpy(emb)}}
    p_j = {"embed": {"embedding": jnp.asarray(emb)}}
    _close(tT.logits_fn(p_t, torch.from_numpy(x)),
           jT.logits_fn(p_j, jnp.asarray(x)), atol=1e-4)


def test_init_params_layout_and_dtype():
    cfg = tconfigs.get_reduced("yi-6b")
    gen = torch.Generator().manual_seed(0)
    p = tT.init_params(gen, cfg)
    assert p["layers"]["attn"]["wq"].shape == (
        cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.head_dim)
    assert p["layers"]["mlp"]["wdown"].shape == (
        cfg.n_layers, cfg.d_ff, cfg.d_model)
    assert p["embed"]["embedding"].dtype == torch.float32
    # same seed, same weights
    q = tT.init_params(torch.Generator().manual_seed(0), cfg)
    assert torch.equal(p["layers"]["attn"]["wo"],
                       q["layers"]["attn"]["wo"])
    with pytest.raises(NotImplementedError, match="Queue A item 3"):
        tT.init_params(gen, tconfigs.get_reduced("mixtral-8x7b"))
