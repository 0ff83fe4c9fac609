"""The port's whole-prompt model functions against
`repro.models.transformer` on the reference's own weights (carried
across by `params_from_numpy`): `prefill` logits, hidden states and
decode caches (``full_kv`` on and off, ``last_index``,
``all_hidden``), then `init_cache` + three `decode_step`s continuing
the prompt on the shared clock, checked on logits, every cache slot
and the ``len``/``cursor``/``abs`` counters.  Reduced yi-6b and
reduced h2o-danube (32-key sliding window: the trimmed ring and its
wrap-around write), plus the audio family's ``frame_embeds``.
atol/rtol 1e-4: the matmuls sum in another order in XLA and in torch
over a few layers."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import repro.configs as jconfigs
from repro.models import transformer as jT
import repro_torch.configs as tconfigs
from repro_torch.models import transformer as tT
from repro_torch.models.convert import params_from_numpy

TOL = dict(atol=1e-4, rtol=1e-4)
B, S, CACHE = 2, 40, 64


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _load(name):
    jcfg = jconfigs.get_reduced(name)
    tcfg = tconfigs.get_reduced(name)
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, params_from_numpy(tree, tcfg, "cpu")


@pytest.fixture(scope="module", params=["yi-6b", "h2o-danube-3-4b"])
def model(request):
    return _load(request.param)


def _tokens(cfg, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _check_cache(tcache, jcache):
    for key in ("len", "cursor", "abs"):
        assert int(tcache[key]) == int(jcache[key]), key
    for key in ("k", "v"):
        assert tuple(tcache[key].shape) == jcache[key].shape, key
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), **TOL)


@pytest.mark.parametrize("full_kv", [False, True])
def test_prefill_matches_reference(model, full_kv):
    jcfg, tcfg, jparams, tparams = model
    toks = _tokens(jcfg)
    jh, jc = jT.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                        full_kv=full_kv)
    th, tc = tT.prefill(tparams, {"tokens": torch.from_numpy(toks)}, tcfg,
                        full_kv=full_kv)
    np.testing.assert_allclose(tT.logits_fn(tparams, th).numpy(),
                               np.asarray(jT.logits_fn(jparams, jh)), **TOL)
    _check_cache(tc, jc)
    if tcfg.sliding_window and not full_kv:
        assert tc["k"].shape[2] == tcfg.sliding_window < S
    # last_index and all_hidden read the same pass
    jh, _ = jT.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                       full_kv=full_kv, last_index=jnp.int32(17))
    th, _ = tT.prefill(tparams, {"tokens": torch.from_numpy(toks)}, tcfg,
                       full_kv=full_kv, last_index=17)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    jall, _ = jT.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                         full_kv=full_kv, all_hidden=True)
    tall, _ = tT.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                         tcfg, full_kv=full_kv, all_hidden=True)
    assert tuple(tall.shape) == (B, S, tcfg.d_model)
    np.testing.assert_allclose(tall.numpy(), np.asarray(jall), **TOL)


def _splice_ref(jcfg, jc):
    """The prefill cache at the head of an `init_cache` of CACHE slots."""
    cache = jT.init_cache(jcfg, B, CACHE)
    n = jc["k"].shape[2]
    cache = dict(cache, k=cache["k"].at[:, :, :n].set(jc["k"]),
                 v=cache["v"].at[:, :, :n].set(jc["v"]),
                 len=jc["len"], cursor=jc["cursor"], abs=jc["abs"])
    return cache


def _splice_port(tcfg, tc):
    cache = tT.init_cache(tcfg, B, CACHE, device="cpu")
    n = tc["k"].shape[2]
    cache["k"][:, :, :n] = tc["k"]
    cache["v"][:, :, :n] = tc["v"]
    return dict(cache, len=tc["len"], cursor=tc["cursor"], abs=tc["abs"])


def test_init_cache_and_decode_step_continue_the_prompt(model):
    jcfg, tcfg, jparams, tparams = model
    toks = _tokens(jcfg, seed=4)
    jh, jc = jT.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    th, tc = tT.prefill(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    jcache = _splice_ref(jcfg, jc)
    tcache = _splice_port(tcfg, tc)
    _check_cache(tcache, jcache)
    nxt = np.array(jnp.argmax(jT.logits_fn(jparams, jh), -1),
                   np.int32)[:, None]
    for _ in range(3):
        jl, jcache = jT.decode_step(jparams, jcache,
                                    {"tokens": jnp.asarray(nxt)}, jcfg)
        tl, tcache = tT.decode_step(tparams, tcache,
                                    {"tokens": torch.from_numpy(nxt)}, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _check_cache(tcache, jcache)
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    if tcfg.sliding_window:
        # the ring wrapped: the writes went to the oldest slots 0..2
        assert int(tcache["cursor"]) == 3 and int(tcache["abs"]) == S + 3


def test_decode_step_on_a_full_cache_matches_reference(model):
    """An 8-token prompt in an 8-slot cache: the next writes land on the
    last slot again (the reference's clamped `dynamic_update_slice`),
    and with danube's 32-key window the prompt is shorter than the
    window (cursor 0: the ring's first write takes slot 0)."""
    jcfg, tcfg, jparams, tparams = model
    toks = _tokens(jcfg, seed=8)[:1, :8]
    jh, jcache = jT.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    th, tcache = tT.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                            tcfg)
    _check_cache(tcache, jcache)
    nxt = np.array([[7]], np.int32)
    for _ in range(2):
        jl, jcache = jT.decode_step(jparams, jcache,
                                    {"tokens": jnp.asarray(nxt)}, jcfg)
        tl, tcache = tT.decode_step(tparams, tcache,
                                    {"tokens": torch.from_numpy(nxt)}, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _check_cache(tcache, jcache)


def test_init_cache_shapes_and_refusals():
    for name in ("yi-6b", "h2o-danube-3-4b"):
        jcfg, tcfg = jconfigs.get_reduced(name), tconfigs.get_reduced(name)
        jc = jT.init_cache(jcfg, 3, 80)
        tc = tT.init_cache(tcfg, 3, 80, device="cpu")
        assert set(tc) == set(jc)
        for key in jc:
            assert tuple(tc[key].shape) == jc[key].shape, (name, key)
            assert not tc[key].any()
    with pytest.raises(NotImplementedError, match="item 3"):
        tT.init_cache(tconfigs.get_reduced("mixtral-8x7b"), 1, 8,
                      device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        tT.init_cache(tconfigs.get_reduced("zamba2-7b"), 1, 8,
                      device="cpu")


def test_audio_prefill_adds_frame_embeds():
    jcfg, tcfg, jparams, tparams = _load("musicgen-large")
    assert tcfg.family == "audio"
    toks = _tokens(jcfg, seed=6)
    frames = np.random.default_rng(6).normal(
        size=(B, S, tcfg.d_model)).astype(np.float32)
    jh, jc = jT.prefill(jparams, {"tokens": jnp.asarray(toks),
                                  "frame_embeds": jnp.asarray(frames)},
                        jcfg)
    th, tc = tT.prefill(tparams, {"tokens": torch.from_numpy(toks),
                                  "frame_embeds": torch.from_numpy(frames)},
                        tcfg)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    _check_cache(tc, jc)
    plain, _ = tT.prefill(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert not torch.allclose(plain, th)


def test_use_kernel_true_on_cpu_raises(model):
    _, tcfg, _, tparams = model
    with pytest.raises(ValueError, match="CUDA"):
        tT.prefill(tparams, {"tokens": torch.zeros((1, 8), dtype=torch.long)},
                   tcfg, use_kernel=True)
