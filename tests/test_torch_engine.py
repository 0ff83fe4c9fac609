"""Greedy token streams of the port's chunked engine against the
reference's, on the reference's own weights, over the traces of
`test_serving_chunked` (mixed lengths; mid-prefill preemption under a
small pool) and `test_prefix_compute_skip` (shared heads: full,
partial and uncached covers).

Across frameworks a differing token is a fault only where the
reference's top-2 logit margin at the first difference exceeds 1e-3
(a near tie can flip between separately compiled programs; DESIGN.md
§4a).  Inside the port the reference's invariants hold exactly:
compute skip on equals skip off, and a preempted request equals its
uncontended run.

The reference engines hand host numpy views (block tables, clocks) to
jitted steps through `jnp.asarray`, which on the CPU may alias the
host buffer that the engine then mutates in place; their greedy
streams then vary from run to run.  The `ref_copies` fixture makes
those conversions copy for the duration of a test, so the reference
side is deterministic; the reference package itself is untouched."""

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
from repro_torch.serving.engine import Request, make_engine

MARGIN = 1e-3

CHUNKED_KW = dict(slots=4, max_len=96, page_size=16, chunk_size=32)
PREEMPT_KW = dict(slots=2, max_len=64, page_size=8, chunk_size=16,
                  n_pages=8)
SKIP_KW = dict(slots=4, max_len=160, page_size=16, chunk_size=32,
               n_pages=48)


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


def _serve(eng, request_cls, waves):
    """Submit each wave once every request of the previous one is
    decoding (its pages stay resident, so a later wave can share
    them), then run to completion."""
    futs = []
    for i, wave in enumerate(waves):
        if i:
            while eng.queue or any(st["phase"] != "decode"
                                   for st in eng.active.values()):
                eng.step()
        futs += [eng.submit(request_cls(rid, p, max_new_tokens=n))
                 for rid, p, n in wave]
    eng.run_to_completion()
    return eng, {f.get().rid: f.get().tokens for f in futs}


def _serve_port(tparams, tcfg, waves, **kw):
    return _serve(make_engine(tparams, tcfg, device="cpu", **kw),
                  Request, waves)


def _serve_ref(jparams, jcfg, waves, **kw):
    return _serve(jmake_engine(jparams, jcfg, **kw), JRequest, waves)


def _ref_margin(jparams, jcfg, seq):
    """The reference's top-2 logit margin for the token after `seq`."""
    hidden, _ = jT.prefill(jparams, {"tokens": jnp.asarray(seq)[None]},
                           jcfg)
    logits = np.sort(np.asarray(jT.logits_fn(jparams, hidden))[0])
    return float(logits[-1] - logits[-2])


def _assert_streams_match(model, waves, port, ref):
    jcfg, _, jparams, _ = model
    prompts = {rid: p for wave in waves for rid, p, _ in wave}
    assert set(port) == set(ref)
    for rid, want in ref.items():
        got = port[rid]
        assert len(got) == len(want), rid
        diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        if diff:
            i = diff[0]
            seq = np.concatenate([prompts[rid],
                                  np.asarray(want[:i], np.int32)])
            margin = _ref_margin(jparams, jcfg, seq)
            assert margin <= MARGIN, (
                f"request {rid} differs at token {i} where the "
                f"reference's top-2 margin is {margin:.2e}")


def _parity_wave(vocab):
    """`test_serving_chunked._parity_requests`: mixed real lengths
    (below one page, above one chunk) pre-padded into one stream."""
    rng = np.random.default_rng(3)
    wave = []
    for rid, n in enumerate([5, 40, 20, 12]):
        p = np.zeros(64, np.int32)
        p[64 - n:] = rng.integers(0, vocab, size=n)
        wave.append((rid, p, 6))
    return [wave]


def _skip_waves(vocab):
    """`test_prefix_compute_skip._prompts`: A/B share a 56-token head,
    C shares nothing.  A warms the cache and stays resident while A
    (full cover), B (partial cover) and C (uncached) arrive."""
    rng = np.random.default_rng(17)
    head = rng.integers(0, vocab, size=56)
    a = np.concatenate([head, rng.integers(0, vocab, size=24)])
    b = np.concatenate([head, rng.integers(0, vocab, size=24)])
    c = rng.integers(0, vocab, size=40)
    a, b, c = (x.astype(np.int32) for x in (a, b, c))
    return [[(0, a, 12)], [(1, a, 6), (2, b, 6), (3, c, 6)]]


def test_chunked_trace_matches_reference(model, ref_copies):
    jcfg, tcfg, jparams, tparams = model
    waves = _parity_wave(jcfg.vocab_size)
    teng, port = _serve_port(tparams, tcfg, waves, **CHUNKED_KW)
    _, ref = _serve_ref(jparams, jcfg, waves, **CHUNKED_KW)
    _assert_streams_match(model, waves, port, ref)
    assert teng.kvc.pool.used_pages == 0


def test_prefix_skip_trace_matches_reference_and_skip_off(model, ref_copies):
    jcfg, tcfg, jparams, tparams = model
    waves = _skip_waves(jcfg.vocab_size)
    teng, port = _serve_port(tparams, tcfg, waves,
                             prefix_cache_compute=True, **SKIP_KW)
    _, ref = _serve_ref(jparams, jcfg, waves, prefix_cache_compute=True,
                        **SKIP_KW)
    _assert_streams_match(model, waves, port, ref)
    # the reference's compute-skip accounting, exactly
    assert teng.prefix_skips == 1
    assert teng.prefix_partial_hits == 1
    assert teng.prefill_tokens_skipped == 80 + 48
    _, off = _serve_port(tparams, tcfg, waves, **SKIP_KW)
    assert off == port                       # skip on == skip off


def test_mid_prefill_preemption_matches_reference_and_solo(model, ref_copies):
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(5)
    a = rng.integers(0, jcfg.vocab_size, size=20).astype(np.int32)
    b = rng.integers(0, jcfg.vocab_size, size=30).astype(np.int32)
    waves = [[(0, a, 24), (1, b, 6)]]
    teng, port = _serve_port(tparams, tcfg, waves, **PREEMPT_KW)
    assert teng.preemptions > 0
    comp = {c.rid: c for c in teng.completions}
    assert comp[1].preemptions > 0
    assert teng.kvc.pool.used_pages == 0
    _, ref = _serve_ref(jparams, jcfg, waves, **PREEMPT_KW)
    _assert_streams_match(model, waves, port, ref)
    solo_eng, solo = _serve_port(tparams, tcfg, [[(1, b, 6)]],
                                 **PREEMPT_KW)
    assert solo_eng.preemptions == 0
    assert solo[1] == port[1]                # preempted == unpreempted


def test_make_engine_raises_for_what_is_not_ported(model):
    _, tcfg, _, tparams = model
    kw = dict(slots=2, max_len=64, device="cpu")
    for engine in ("paged", "dense"):
        with pytest.raises(NotImplementedError, match="Queue A item 4"):
            make_engine(tparams, tcfg, engine=engine, tiering=True, **kw)
        with pytest.raises(NotImplementedError, match="Queue A item 5"):
            make_engine(tparams, tcfg, engine=engine, kv_shards=2, **kw)
        with pytest.raises(NotImplementedError, match="Queue A item 6"):
            make_engine(tparams, tcfg, engine=engine,
                        failure_plan=object(), **kw)
        with pytest.raises(ValueError, match="requires the chunked"):
            make_engine(tparams, tcfg, engine=engine, disagg=True, **kw)
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        make_engine(tparams, tcfg, disagg=True, **kw)
    with pytest.raises(NotImplementedError, match="Queue A item 4"):
        make_engine(tparams, tcfg, tiering=True, **kw)
    with pytest.raises(NotImplementedError, match="Queue A item 5"):
        make_engine(tparams, tcfg, kv_shards=2, **kw)
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        make_engine(tparams, tcfg, failure_plan=object(), **kw)
    with pytest.raises(ValueError, match="unknown engine"):
        make_engine(tparams, tcfg, engine="turbo", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_engine(tparams, tcfg, slots=2, max_len=64)


def test_tracing_flight_recorder_and_slo_verdicts(model):
    """The copied observability stack runs on the port's engine: spans
    and instants land in the tracer, lifecycle events in the flight
    recorder, and deadline-carrying requests get SLO verdicts."""
    from repro_torch.obs.trace import Tracer
    _, tcfg, _, tparams = model
    tracer = Tracer(capacity=1 << 12)
    eng = make_engine(tparams, tcfg, slots=2, max_len=64, page_size=8,
                      chunk_size=16, device="cpu", tracer=tracer,
                      flight_recorder=True)
    rng = np.random.default_rng(9)
    for rid in range(3):
        eng.submit(Request(rid, rng.integers(0, tcfg.vocab_size, size=20)
                           .astype(np.int32), max_new_tokens=3,
                           ttft_deadline_ms=1e6, itl_deadline_ms=1e6))
    eng.run_to_completion()
    names = {r.name for r in tracer.records()}
    assert {"step", "prefill_chunk", "decode_batch", "finish"} <= names
    events = [e for e in eng.recorder.timeline(0)]
    assert events and events[-1].name == "finish"
    s = eng.stats()
    assert s["slo"]["requests"] == 3 and s["slo"]["met"] == 3
