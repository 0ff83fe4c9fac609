"""The port's Mamba-1 slice against the reference on reduced
falcon-mamba (4 layers, d_model 64, d_inner 128, state 8, fp32), the
reference's own weights carried across by `params_from_numpy`:

* `models/ssm.py`: `causal_conv1d`, `mamba1_scan_ref`,
  `mamba1_chunked` (one chunk and several, with a carried state) and
  `ssm_block_apply`, on y, the ``ssm`` state and the ``conv`` state at
  1e-5;
* `models/transformer.py`: `prefill`, `init_cache` and `decode_step`
  on logits and the ``(ssm, conv)`` cache at 1e-4 (the matmuls sum in
  another order over four layers);
* the engine: `make_engine` sends the ssm family to the dense engine
  whatever ``engine`` names; its greedy streams are held against a
  greedy loop over the reference's jitted `prefill` (left-padded to the
  bucket, ``last_index`` = bucket - 1) and `decode_step`, one request
  at a time, with no reference engine: a slot's stream depends only on
  its own prompt, since the ssm branch of `decode_step` reads no shared
  clock.  A differing token counts only where the loop's top-2 logit
  margin is above 1e-3 (the near-tie rule of
  `test_torch_engine_whole.py`).
* f32 leaves stay f32 at a bf16 config; ``use_kernel=True`` on CPU
  tensors raises."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import repro.configs as jconfigs
from repro.models import ssm as jssm
from repro.models import transformer as jT
import repro_torch.configs as tconfigs
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tT
from repro_torch.models.convert import F32_LEAVES, params_from_numpy
from repro_torch.serving.engine import (DenseServingEngine, Request,
                                        make_engine)

BLOCK_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
MARGIN = 1e-3
NAME = "falcon-mamba-7b"


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get_reduced(NAME)
    tcfg = tconfigs.get_reduced(NAME)
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    return jcfg, tcfg, jparams, tparams


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **tol)


def _layer(model, i=1):
    jcfg, tcfg, jparams, tparams = model
    return (jax.tree.map(lambda a: a[i], jparams["layers"]["ssm"]),
            {k: v[i] for k, v in tparams["layers"]["ssm"].items()})


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_config_is_the_reduced_mamba1():
    tcfg = tconfigs.get_reduced(NAME)
    assert (tcfg.family, tcfg.mamba_version, tcfg.n_layers, tcfg.d_model,
            tcfg.d_inner, tcfg.ssm_state, tcfg.dtype) == \
        ("ssm", 1, 4, 64, 128, 8, "float32")


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d(with_state):
    x = _normal((2, 9, 16), 1)
    w = _normal((16, 4), 2)
    st = _normal((2, 3, 16), 3) if with_state else None
    jy, js = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                None if st is None else jnp.asarray(st))
    ty, ts = tssm.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                None if st is None else torch.from_numpy(st))
    _close(ty, jy, BLOCK_TOL)
    _close(ts, js, BLOCK_TOL)


def _states(tcfg, b, seed):
    h = _normal((b, tcfg.d_inner, tcfg.ssm_state), seed) * 0.5
    c = _normal((b, tcfg.ssm_conv - 1, tcfg.d_inner), seed + 1)
    return h, c


def _both(fn_j, fn_t, x, h, c, **kw):
    jo = fn_j(jnp.asarray(x), None if h is None else jnp.asarray(h),
              None if c is None else jnp.asarray(c), **kw)
    to = fn_t(torch.from_numpy(x), None if h is None else torch.from_numpy(h),
              None if c is None else torch.from_numpy(c), **kw)
    for got, want in zip(to, jo):      # (y, ssm state, conv state)
        _close(got, want, BLOCK_TOL)
    return to


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba1_scan_ref_and_chunked(model, with_state):
    jcfg, tcfg, _, _ = model
    jl, tl = _layer(model)
    x = _normal((2, 40, tcfg.d_model), 4)
    h, c = _states(tcfg, 2, 5) if with_state else (None, None)
    seq = _both(lambda *a: jssm.mamba1_scan_ref(jl, a[0], jcfg, *a[1:]),
                lambda *a: tssm.mamba1_scan_ref(tl, a[0], tcfg, *a[1:]),
                x, h, c)
    # one chunk (S 40 < 256) and four chunks of 10, the state carried
    for chunk in (256, 10):
        out = _both(
            lambda *a, chunk: jssm.mamba1_chunked(jl, a[0], jcfg, chunk,
                                                  *a[1:]),
            lambda *a, chunk: tssm.mamba1_chunked(tl, a[0], tcfg, chunk,
                                                  *a[1:]),
            x, h, c, chunk=chunk)
        for got, want in zip(out, seq):   # chunked == sequential
            torch.testing.assert_close(got, want, **BLOCK_TOL)


def test_mamba1_chunked_uneven_length_raises(model):
    """41 tokens in chunks of 16 give nch 2 of 20: the reshape fails in
    the reference and in the port's plain path alike."""
    jcfg, tcfg, _, _ = model
    jl, tl = _layer(model)
    x = _normal((1, 41, tcfg.d_model), 6)
    with pytest.raises(Exception):
        jssm.mamba1_chunked(jl, jnp.asarray(x), jcfg, 16)
    with pytest.raises(RuntimeError):
        tssm.mamba1_chunked(tl, torch.from_numpy(x), tcfg, 16)


@pytest.mark.parametrize("mode", ["chunked", "decode", "ref"])
def test_ssm_block_apply(model, mode):
    jcfg, tcfg, _, _ = model
    jl, tl = _layer(model, 2)
    s = 1 if mode == "decode" else 24
    x = _normal((3, s, tcfg.d_model), 7)
    h, c = _states(tcfg, 3, 8)
    jy, jst = jssm.ssm_block_apply(jl, jnp.asarray(x), jcfg, mode=mode,
                                   state={"ssm": jnp.asarray(h),
                                          "conv": jnp.asarray(c)})
    ty, tst = tssm.ssm_block_apply(tl, torch.from_numpy(x), tcfg,
                                   mode=mode,
                                   state={"ssm": torch.from_numpy(h),
                                          "conv": torch.from_numpy(c)})
    _close(ty, jy, BLOCK_TOL)
    for key in ("ssm", "conv"):
        _close(tst[key], jst[key], BLOCK_TOL)


def test_mamba2_raises_naming_its_item(model):
    _, tcfg, _, _ = model
    _, tl = _layer(model)
    cfg2 = dataclasses.replace(tcfg, mamba_version=2)
    with pytest.raises(NotImplementedError, match="Queue A item 10"):
        tssm.ssm_block_apply(tl, torch.zeros((1, 4, tcfg.d_model)), cfg2)


def _check_cache(tcache, jcache):
    assert set(tcache) == set(jcache) == {"len", "cursor", "abs", "ssm",
                                          "conv"}
    for key in ("len", "cursor", "abs"):
        assert int(tcache[key]) == int(jcache[key]), key
    for key in ("ssm", "conv"):
        assert tuple(tcache[key].shape) == jcache[key].shape, key
        _close(tcache[key], jcache[key], MODEL_TOL)


def test_prefill_init_cache_and_decode_step(model):
    jcfg, tcfg, jparams, tparams = model
    toks = np.random.default_rng(9).integers(
        0, tcfg.vocab_size, size=(2, 40)).astype(np.int32)
    jh, jc = jT.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    th, tc = tT.prefill(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    _close(tT.logits_fn(tparams, th), jT.logits_fn(jparams, jh), MODEL_TOL)
    _check_cache(tc, jc)
    jh, _ = jT.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                       last_index=jnp.int32(17))
    th, _ = tT.prefill(tparams, {"tokens": torch.from_numpy(toks)}, tcfg,
                       last_index=17)
    _close(th, jh, MODEL_TOL)
    # a zero cache of 3 slots, the prompt's state spliced into slot 1
    jcache = jT.init_cache(jcfg, 3, 64)
    tcache = tT.init_cache(tcfg, 3, 64, device="cpu")
    assert set(tcache) == set(jcache)
    for key in jcache:
        assert tuple(tcache[key].shape) == jcache[key].shape, key
        assert not tcache[key].any()
    assert tcache["ssm"].dtype == torch.float32
    jcache = dict(jcache, ssm=jcache["ssm"].at[:, 1].set(jc["ssm"][:, 0]),
                  conv=jcache["conv"].at[:, 1].set(jc["conv"][:, 0]),
                  len=jc["len"], cursor=jc["cursor"], abs=jc["abs"])
    tcache["ssm"][:, 1] = tc["ssm"][:, 0]
    tcache["conv"][:, 1] = tc["conv"][:, 0]
    tcache = dict(tcache, len=tc["len"], cursor=tc["cursor"], abs=tc["abs"])
    nxt = np.asarray([[3], [int(toks[0, -1])], [250]], np.int32)
    for _ in range(3):
        jl, jcache = jT.decode_step(jparams, jcache,
                                    {"tokens": jnp.asarray(nxt)}, jcfg)
        tl, tcache = tT.decode_step(tparams, tcache,
                                    {"tokens": torch.from_numpy(nxt)}, tcfg)
        _close(tl, jl, MODEL_TOL)
        _check_cache(tcache, jcache)
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]


def test_params_f32_leaves_stay_f32_at_bf16():
    jcfg = dataclasses.replace(jconfigs.get_reduced(NAME), dtype="bfloat16")
    tcfg = dataclasses.replace(tconfigs.get_reduced(NAME), dtype="bfloat16")
    tree = jax.tree.map(np.asarray,
                        jT.init_params(jax.random.PRNGKey(1), jcfg))
    converted = params_from_numpy(tree, tcfg, "cpu")
    drawn = tT.init_params(torch.Generator().manual_seed(1), tcfg)
    for p in (converted, drawn):
        ssm = p["layers"]["ssm"]
        for leaf in F32_LEAVES:
            assert ssm[leaf.split("/")[-1]].dtype == torch.float32, leaf
        for leaf in ("in_proj", "conv_w", "x_proj", "dt_proj", "out_proj"):
            assert ssm[leaf].dtype == torch.bfloat16, leaf
        assert p["embed"]["embedding"].dtype == torch.bfloat16
    # a_log carried exactly, not rounded through bf16
    np.testing.assert_array_equal(
        converted["layers"]["ssm"]["a_log"].numpy(),
        tree["layers"]["ssm"]["a_log"])
    torch.testing.assert_close(drawn["layers"]["ssm"]["a_log"],
                               converted["layers"]["ssm"]["a_log"])
    cache = tT.init_cache(tcfg, 2, 16, device="cpu")
    assert cache["ssm"].dtype == torch.float32
    assert cache["conv"].dtype == torch.bfloat16


def test_use_kernel_true_on_cpu_raises(model):
    _, tcfg, _, tparams = model
    toks = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="CUDA"):
        tT.prefill(tparams, {"tokens": toks}, tcfg, use_kernel=True)
    cache = tT.init_cache(tcfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tT.decode_step(tparams, cache, {"tokens": toks[:, :1]}, tcfg,
                       use_kernel=True)


# -- the engine ---------------------------------------------------------------

BUCKETS = (16, 32)
ENGINE_KW = dict(slots=2, max_len=64, prefill_buckets=BUCKETS)


def _requests(vocab):
    """Four prompts of 5-30 tokens over two buckets, 8 new tokens each;
    two slots, so later requests reuse a slot another one left."""
    rng = np.random.default_rng(11)
    return [(rid, rng.integers(0, vocab, size=n).astype(np.int32), 8)
            for rid, n in enumerate((12, 30, 5, 21))]


@pytest.fixture(scope="module")
def ref_loop(model):
    """The reference's greedy stream of each request alone: its jitted
    `prefill` on the prompt left-padded with 0 to its bucket, then
    `decode_step`s; each step's logits are kept for the near-tie rule."""
    jcfg, _, jparams, _ = model
    prefill = jax.jit(lambda p, t, i: jT.prefill(p, {"tokens": t}, jcfg,
                                                 last_index=i))
    decode = jax.jit(lambda p, c, t: jT.decode_step(p, c, {"tokens": t},
                                                    jcfg))
    out = {}
    for rid, prompt, n_new in _requests(jcfg.vocab_size):
        bucket = next(b for b in BUCKETS if len(prompt) <= b)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, bucket - len(prompt):] = prompt
        hidden, cache = prefill(jparams, jnp.asarray(toks),
                                jnp.int32(bucket - 1))
        logits = [np.asarray(jT.logits_fn(jparams, hidden))[0]]
        stream = [int(np.argmax(logits[-1]))]
        while len(stream) < n_new:
            lg, cache = decode(jparams, cache,
                               jnp.asarray([[stream[-1]]], jnp.int32))
            logits.append(np.asarray(lg)[0])
            stream.append(int(np.argmax(logits[-1])))
        out[rid] = (stream, logits)
    return out


def _serve(tparams, tcfg, **kw):
    eng = make_engine(tparams, tcfg, device="cpu", **ENGINE_KW, **kw)
    futs = [eng.submit(Request(rid, p, max_new_tokens=n))
            for rid, p, n in _requests(tcfg.vocab_size)]
    eng.run_to_completion()
    return eng, {f.get().rid: f.get().tokens for f in futs}


def test_engine_streams_match_reference_loop(model, ref_loop):
    _, tcfg, _, tparams = model
    eng, got = _serve(tparams, tcfg, engine="dense")
    assert isinstance(eng, DenseServingEngine)
    assert set(eng._prefills) == set(BUCKETS)
    assert set(got) == set(ref_loop)
    assert len(set(tuple(t) for t in got.values())) > 1
    for rid, (want, logits) in ref_loop.items():
        assert len(got[rid]) == len(want), rid
        diff = [i for i, (a, b) in enumerate(zip(got[rid], want)) if a != b]
        if diff:
            top = np.sort(logits[diff[0]])
            margin = float(top[-1] - top[-2])
            assert margin <= MARGIN, (
                f"request {rid} differs at token {diff[0]} where the "
                f"reference's top-2 margin is {margin:.2e}")


def test_every_engine_choice_serves_ssm_through_dense(model):
    """The reference's fallback: chunked, paged and dense all build the
    dense engine (page-pool options dropped) and give identical
    streams."""
    _, tcfg, _, tparams = model
    streams = {}
    for engine in ("chunked", "paged", "dense"):
        eng, streams[engine] = _serve(
            tparams, tcfg, engine=engine, page_size=8, n_pages=4,
            chunk_size=16, step_tokens=24, prefix_cache_compute=True,
            tiering=True, kv_shards=2)
        assert type(eng) is DenseServingEngine, engine
        assert set(eng.cache) == {"len", "cursor", "abs", "ssm", "conv"}
    assert streams["chunked"] == streams["paged"] == streams["dense"]


def test_make_engine_refuses_the_families_still_to_port(model):
    _, _, _, tparams = model
    for name, item in (("zamba2-7b", "Queue A item 10"),
                       ("llama-3.2-vision-90b", "Queue A item 10"),
                       ("mixtral-8x7b", "Queue A item 3")):
        with pytest.raises(NotImplementedError, match=item):
            make_engine(tparams, tconfigs.get_reduced(name), engine="dense",
                        device="cpu")
