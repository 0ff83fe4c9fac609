"""A sliding-window config through the port's paged engines: reduced
h2o-danube (32-key window) with prompts longer than the window, served
by `make_engine(engine="chunked")` (16-token chunks, so later chunks
attend across the window's edge in the chunked-prefill path) and
`engine="paged"` (whole-prompt prefill), gives identical greedy
streams: the reference's own exact invariant between its engines.
Port only, on the port's random weights; no JAX."""

import numpy as np
import pytest
import torch

import repro_torch.configs as tconfigs
from repro_torch.device import make_generator
from repro_torch.models import transformer as tT
from repro_torch.serving.engine import Request, make_engine

KW = dict(slots=3, max_len=128, page_size=8, prefill_buckets=(64, 96))


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_windowed_config_chunked_equals_paged():
    cfg = tconfigs.get_reduced("h2o-danube-3-4b")
    assert cfg.sliding_window == 32
    params = tT.init_params(make_generator(0, "cpu"), cfg)
    rng = np.random.default_rng(5)
    reqs = [(rid, rng.integers(0, cfg.vocab_size, size=n).astype(np.int32))
            for rid, n in enumerate((40, 77, 33, 58))]
    assert all(len(p) > cfg.sliding_window for _, p in reqs)
    streams = {}
    for engine, extra in (("chunked", dict(chunk_size=16)), ("paged", {})):
        eng = make_engine(params, cfg, engine=engine, device="cpu", **KW,
                          **extra)
        futs = [eng.submit(Request(rid, p, max_new_tokens=12))
                for rid, p in reqs]
        eng.run_to_completion()
        streams[engine] = {f.get().rid: f.get().tokens for f in futs}
        assert eng.kvc.pool.used_pages == 0
    assert streams["chunked"] == streams["paged"]
    assert all(len(t) == 12 for t in streams["paged"].values())
    assert len(set(tuple(t) for t in streams["paged"].values())) > 1
