"""The port's paged KV cache against `repro.serving.kvcache`: the same
random sequence of attach / begin_chunk / covered-prefix attach /
prepare_decode / advance / release (preemption) on both, with prompts
sharing heads so prefix sharing, COW clones and page exhaustion all
occur.  Block tables, clocks, write rows, refcounts, counters and the
page contents (whole-prompt writes and COW clones) must come out
equal."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import repro.configs as jconfigs
from repro.serving import kvcache as jkv
import repro_torch.configs as tconfigs
from repro_torch.serving import kvcache as tkv

PS, CHUNK, SLOTS, MAX_LEN = 8, 16, 3, 64


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _prompts(rng, vocab):
    head = rng.integers(0, vocab, size=20)
    out = []
    for n in (20, 27, 36, 13, 44):
        tail = rng.integers(0, vocab, size=max(n - 20, 0))
        p = np.concatenate([head, tail])[:n] if n >= 20 else \
            rng.integers(0, vocab, size=n)
        out.append(p.astype(np.int32))
    return out


def _state(kvc):
    pool = kvc.pool
    return {
        "tables": kvc.tables.copy(), "lengths": kvc.lengths.copy(),
        "write_rows": kvc.write_rows.copy(),
        "write_offs": kvc.write_offs.copy(),
        "refs": dict(pool._refs), "free": pool.free_pages,
        "allocs": pool.allocs, "shares": pool.shares,
        "cow": pool.cow_copies, "hidden": sorted(pool._hidden),
    }


def _assert_same(j, t):
    sj, st = _state(j), _state(t)
    for k in sj:
        if isinstance(sj[k], np.ndarray):
            np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
        else:
            assert st[k] == sj[k], k
    null = t.pool.null_row
    for name in ("k", "v"):
        a = np.asarray(j.pool.pages[name]).copy()
        b = t.pool.pages[name].numpy().copy()
        if t.pool.sharded:
            a[:, :, null] = b[:, :, null] = 0
        else:
            a[:, null] = b[:, null] = 0
        np.testing.assert_array_equal(b, a, err_msg=name)


def _both(j, t, fn):
    """Run `fn` on both caches; both raise PageExhausted or neither."""
    outs = []
    for kvc, exc in ((j, jkv.PageExhausted), (t, tkv.PageExhausted)):
        try:
            outs.append(fn(kvc))
        except exc:
            outs.append("exhausted")
    assert outs[0] == outs[1]
    return outs[0]


@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_op_sequence_matches_reference(seed, n_shards):
    jcfg = jconfigs.get_reduced("yi-6b")
    tcfg = tconfigs.get_reduced("yi-6b")
    rng = np.random.default_rng(seed)
    j = jkv.PagedKVCache(jcfg, SLOTS, MAX_LEN, 10, PS, n_shards=n_shards)
    t = tkv.PagedKVCache(tcfg, SLOTS, MAX_LEN, 10, PS, n_shards=n_shards,
                         device="cpu")
    prompts = _prompts(rng, jcfg.vocab_size)
    shape = (jcfg.n_layers, MAX_LEN, jcfg.n_kv_heads, jcfg.head_dim)
    phase = [None] * SLOTS          # None | ("prefill", p, pos) | "decode"
    for _ in range(80):
        s = int(rng.integers(SLOTS))
        op = rng.random()
        if phase[s] is None:
            p = prompts[int(rng.integers(len(prompts)))]
            if op < 0.25:           # whole-prompt attach with its KV
                k = rng.normal(size=shape)[:, :len(p)].astype(np.float32)
                v = rng.normal(size=shape)[:, :len(p)].astype(np.float32)
                r = _both(j, t, lambda c: c.attach(
                    s, p, jnp.asarray(k) if c is j else torch.from_numpy(k),
                    jnp.asarray(v) if c is j else torch.from_numpy(v)))
                phase[s] = None if r == "exhausted" else "decode"
            else:                   # chunked, resuming at the cover
                cov = [c.covered_prefix(p) for c in (j, t)]
                assert (cov[0].covered, cov[0].full, cov[0].keys) == \
                    (cov[1].covered, cov[1].full, cov[1].keys)
                start = 0
                if cov[0].covered and not cov[0].full:
                    r = _both(j, t, lambda c: c.attach_covered(
                        s, p, cov[0].keys))
                    if r != "exhausted":
                        start = cov[0].covered
                phase[s] = ("prefill", p, start)
        elif phase[s] == "decode":
            if op < 0.15:
                _both(j, t, lambda c: c.release(s))   # finish / preempt
                phase[s] = None
            else:
                assert j.needs_alloc(s) == t.needs_alloc(s)
                r = _both(j, t, lambda c: c.prepare_decode(s))
                if r == "exhausted":
                    _both(j, t, lambda c: c.release(s))
                    phase[s] = None
                else:
                    _both(j, t, lambda c: c.advance(s))
                    if j.lengths[s] >= MAX_LEN:
                        _both(j, t, lambda c: c.release(s))
                        phase[s] = None
        else:
            _, p, pos = phase[s]
            end = min(pos + CHUNK, len(p))
            assert j.pages_needed_chunk(p, pos, end) == \
                t.pages_needed_chunk(p, pos, end)
            r = _both(j, t, lambda c: c.begin_chunk(s, p, pos, end))
            if r == "exhausted":    # preempted mid-prefill
                _both(j, t, lambda c: c.release(s))
                phase[s] = None
            else:
                n = -(-(end - pos) // PS)
                bh = rng.normal(size=(n, jcfg.d_model)).astype(np.float32)
                last = rng.normal(size=(jcfg.d_model,)).astype(np.float32)
                j.store_hidden_chunk(s, pos, end, bh, last)
                t.store_hidden_chunk(s, pos, end, torch.from_numpy(bh),
                                     torch.from_numpy(last))
                phase[s] = "decode" if end == len(p) else \
                    ("prefill", p, end)
        _assert_same(j, t)
    for s in range(SLOTS):
        _both(j, t, lambda c: c.release(s))
    _assert_same(j, t)
    assert t.pool.used_pages == 0


def test_batch_inputs_are_int32_tensors_on_the_pool_device():
    cfg = tconfigs.get_reduced("yi-6b")
    t = tkv.PagedKVCache(cfg, 2, 32, 8, PS, device="cpu")
    t.begin_chunk(0, np.arange(12, dtype=np.int32), 0, 12)
    t.prepare_decode(0)
    b = t.batch_inputs()
    for k, v in b.items():
        assert v.dtype == torch.int32 and v.device.type == "cpu", k
    np.testing.assert_array_equal(b["block_tables"].numpy(), t.tables)
    assert int(b["write_offs"][0]) == 12 % PS
