"""The port's whole-prompt engines: `make_engine(engine="paged")`
(whole-prompt prefill over AGAS pages) and `engine="dense"` (the
static slot pool with one shared clock), on the reference's own
weights.

* Greedy parity with the reference's paged and dense engines on the
  trace of `test_serving_paged.test_paged_engine_token_parity_with_dense`
  (mixed lengths pre-padded to the one bucket 32, so the dense
  engine's left-pad is the literal prompt), under the same near-tie
  rule as `test_torch_engine.py`; inside the port chunked = paged =
  dense exactly.
* Preemption under page pressure, oversized-prompt rejection and
  truncation at max_len (`test_serving_paged.py`), a preempted request
  equal to its uncontended run, and prefix compute skip on/off token
  identity through `PagedKVCache.store_hidden_prefill`.

The reference engines hand host numpy views to jitted steps through
`jnp.asarray`, which may alias buffers the engine mutates; the
`ref_copies` fixture makes those conversions copy for the duration of a
test (see `test_torch_engine.py`)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import repro.configs as jconfigs
from repro.models import transformer as jT
from repro.serving.engine import Request as JRequest
from repro.serving.engine import make_engine as jmake_engine
import repro_torch.configs as tconfigs
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import (DenseServingEngine,
                                        PagedServingEngine, Request,
                                        make_engine)

MARGIN = 1e-3
PARITY_KW = dict(slots=4, max_len=96, prefill_buckets=(32,))


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


class _CopyingJnp:
    """`jax.numpy` whose `asarray` copies its (host) argument."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(x, *args, **kwargs):
        return jnp.array(np.array(x), *args, **kwargs)


@pytest.fixture
def ref_copies(monkeypatch):
    import repro.serving.engine as jengine
    import repro.serving.kvcache as jkvcache
    monkeypatch.setattr(jengine, "jnp", _CopyingJnp())
    monkeypatch.setattr(jkvcache, "jnp", _CopyingJnp())


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get_reduced("yi-6b")
    tcfg = tconfigs.get_reduced("yi-6b")
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    return jcfg, tcfg, jparams, tparams


def _parity_requests(vocab):
    """`test_serving_paged._mixed_requests(cfg, 4, seed=3)` pre-padded
    to 32 (`_prepad`): 8-30 real tokens, 8 new tokens each."""
    rng = np.random.default_rng(3)
    out = []
    for rid in range(4):
        n = int(rng.integers(8, 30))
        p = np.zeros(32, np.int32)
        p[32 - n:] = rng.integers(0, vocab, size=n)
        out.append((rid, p, 8))
    return out


def _serve(eng, request_cls, reqs):
    futs = [eng.submit(request_cls(rid, p, max_new_tokens=n))
            for rid, p, n in reqs]
    eng.run_to_completion()
    return eng, {f.get().rid: f.get().tokens for f in futs}


def _port(tparams, tcfg, reqs, **kw):
    return _serve(make_engine(tparams, tcfg, device="cpu", **kw), Request,
                  reqs)


def _assert_streams_match(model, reqs, port, ref):
    """Equal token streams, or a first difference where the
    reference's top-2 logit margin is a near tie (<= MARGIN)."""
    jcfg, _, jparams, _ = model
    prompts = {rid: p for rid, p, _ in reqs}
    assert set(port) == set(ref)
    for rid, want in ref.items():
        got = port[rid]
        assert len(got) == len(want), rid
        diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        if diff:
            i = diff[0]
            seq = np.concatenate([prompts[rid],
                                  np.asarray(want[:i], np.int32)])
            hidden, _ = jT.prefill(jparams,
                                   {"tokens": jnp.asarray(seq)[None]}, jcfg)
            top = np.sort(np.asarray(jT.logits_fn(jparams, hidden))[0])
            margin = float(top[-1] - top[-2])
            assert margin <= MARGIN, (
                f"request {rid} differs at token {i} where the "
                f"reference's top-2 margin is {margin:.2e}")


def test_paged_and_dense_match_reference_and_each_other(model, ref_copies):
    jcfg, tcfg, jparams, tparams = model
    reqs = _parity_requests(jcfg.vocab_size)
    peng, paged = _port(tparams, tcfg, reqs, engine="paged", page_size=16,
                        **PARITY_KW)
    deng, dense = _port(tparams, tcfg, reqs, engine="dense", **PARITY_KW)
    _, chunked = _port(tparams, tcfg, reqs, engine="chunked", page_size=16,
                       chunk_size=32, **PARITY_KW)
    assert isinstance(peng, PagedServingEngine)
    assert isinstance(deng, DenseServingEngine)
    assert set(peng._prefills) == set(deng._prefills) == {32}
    assert paged == dense == chunked          # inside the port: exact
    assert peng.kvc.pool.used_pages == 0
    assert len(set(tuple(t) for t in paged.values())) > 1
    for engine, port in (("paged", paged), ("dense", dense)):
        kw = dict(PARITY_KW, page_size=16) if engine == "paged" \
            else PARITY_KW
        _, ref = _serve(jmake_engine(jparams, jcfg, engine=engine, **kw),
                        JRequest, reqs)
        _assert_streams_match(model, reqs, port, ref)


PRESSURE_KW = dict(slots=5, max_len=80, prefill_buckets=(32,),
                   page_size=8)


def test_preemption_under_page_pressure_completes_all(model):
    _, tcfg, _, tparams = model
    rng = np.random.default_rng(2)
    reqs = [(rid, rng.integers(0, tcfg.vocab_size, size=24)
             .astype(np.int32), 20) for rid in range(5)]
    # 14 pages of 8 cannot hold 5 requests' worst case (6 pages each)
    eng = make_engine(tparams, tcfg, engine="paged", n_pages=14,
                      device="cpu", **PRESSURE_KW)
    attached = []
    orig_attach = eng.kvc.attach

    def logging_attach(slot, layout, k, v):
        attached.append(np.array(layout))
        return orig_attach(slot, layout, k, v)
    eng.kvc.attach = logging_attach
    eng, toks = _serve(eng, Request, reqs)
    assert len(eng.completions) == 5
    assert all(len(t) == 20 for t in toks.values())
    assert eng.preemptions > 0
    assert eng.kvc.pool.used_pages == 0
    # every re-admission re-prefilled [prompt | generated] verbatim
    resumed = [p for p in attached if len(p) > 24]
    assert len(resumed) == eng.preemptions
    prompts = {tuple(p.tolist()): rid for rid, p, _ in reqs}
    for layout in resumed:
        rid = prompts[tuple(layout[:24].tolist())]
        assert toks[rid][:len(layout) - 24] == list(layout[24:])
    s = eng.stats()
    assert s["steps"] == len(eng.counters) > 0
    assert 0.0 < s["peak_page_occupancy"] <= 1.0
    assert s["preemptions"] == eng.preemptions
    # a preempted stream equals its uncontended run
    _, roomy = _port(tparams, tcfg, reqs, engine="paged", **PRESSURE_KW)
    assert roomy == toks


def test_oversized_prompt_rejected_without_killing_engine(model):
    _, tcfg, _, tparams = model
    for engine, n_big in (("paged", 100), ("dense", 100)):
        eng = make_engine(tparams, tcfg, engine=engine, slots=2,
                          max_len=96, prefill_buckets=(64, 128),
                          page_size=16, device="cpu")
        f_big = eng.submit(Request(0, np.arange(n_big, dtype=np.int32)
                                   % 250, max_new_tokens=4))
        f_ok = eng.submit(Request(1, np.arange(10, dtype=np.int32),
                                  max_new_tokens=4))
        eng.run_to_completion()
        with pytest.raises(ValueError, match="exceeds max_len"):
            f_big.get()
        assert len(f_ok.get().tokens) == 4


def test_generation_truncates_at_max_len_instead_of_overflowing(model):
    _, tcfg, _, tparams = model
    eng = make_engine(tparams, tcfg, engine="paged", slots=2, max_len=64,
                      prefill_buckets=(32,), page_size=16, device="cpu")
    f1 = eng.submit(Request(0, np.arange(10, dtype=np.int32),
                            max_new_tokens=80))
    f2 = eng.submit(Request(1, np.arange(8, dtype=np.int32),
                            max_new_tokens=4))
    eng.run_to_completion()
    # 10 prompt tokens + 54 decode writes fill max_len 64; prefill's
    # first token needs no cache row, so 55 tokens come back
    assert len(f1.get().tokens) == 55
    assert len(f2.get().tokens) == 4
    assert eng.kvc.pool.used_pages == 0


def test_prefix_compute_skip_on_equals_off(model):
    """A warms the cache and stays resident; A again (full cover:
    admitted straight to decode off the checkpoint that
    `store_hidden_prefill` kept), B (shares A's 56-token head: the
    whole-prompt engine re-prefills it) and C (uncached) follow."""
    _, tcfg, _, tparams = model
    rng = np.random.default_rng(17)
    head = rng.integers(0, tcfg.vocab_size, size=56)
    a = np.concatenate([head, rng.integers(0, tcfg.vocab_size, size=24)])
    b = np.concatenate([head, rng.integers(0, tcfg.vocab_size, size=24)])
    c = rng.integers(0, tcfg.vocab_size, size=40)
    a, b, c = (x.astype(np.int32) for x in (a, b, c))
    kw = dict(engine="paged", slots=4, max_len=160, page_size=16,
              n_pages=48, prefill_buckets=(128,), device="cpu")
    out = {}
    for skip in (True, False):
        eng = make_engine(tparams, tcfg, prefix_cache_compute=skip, **kw)
        f0 = eng.submit(Request(0, a, max_new_tokens=12))
        eng.step()                         # A prefills and decodes
        futs = [f0] + [eng.submit(Request(rid, p, max_new_tokens=6))
                       for rid, p in ((1, a), (2, b), (3, c))]
        eng.run_to_completion()
        out[skip] = {f.get().rid: f.get().tokens for f in futs}
        if skip:
            assert eng.prefix_skips == 1
            assert eng.prefill_tokens_skipped == len(a)
        else:
            assert eng.prefix_skips == 0
    assert out[True] == out[False]
    assert out[True][1] == out[True][0][:6]   # same prompt, same stream
