"""The port's paged model functions against `repro.models.transformer`
on the reference's own weights (carried across by
`params_from_numpy`): three prefill chunks (one with a prefix-shared
page routed to the null row), two decode steps and the compute-skip
resume, checked on logits and on every written page.  Reduced yi-6b
and reduced h2o-danube (32-token sliding window), flat and sharded
pools.  atol/rtol 1e-4: the matmuls sum in another order in XLA and
in torch over a few layers."""

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
PS, C, B = 8, 16, 2
PAGES_PER_SLOT = 7                 # 3 chunks of 2 pages + 1 decode page


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module", params=["yi-6b", "h2o-danube-3-4b"])
def model(request):
    jcfg = jconfigs.get_reduced(request.param)
    tcfg = tconfigs.get_reduced(request.param)
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, params_from_numpy(tree, tcfg, "cpu")


def test_params_from_numpy_keeps_the_stacked_layout(model):
    jcfg, tcfg, jparams, tparams = model
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == (11 if tcfg.tie_embeddings else 12)
    for path, leaf in flat_j:
        node = tparams
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    bad = jax.tree.map(np.asarray, jparams)
    bad["layers"]["attn"]["wq"] = bad["layers"]["attn"]["wq"][:1]
    with pytest.raises(ValueError, match="wq"):
        params_from_numpy(bad, tcfg, "cpu")


def _layout(sharded):
    """Block tables, per-chunk write rows and the null rows.  Slot 0's
    pages on locality 0, slot 1's on locality 1 when sharded."""
    if sharded:
        rps = PAGES_PER_SLOT + 1
        tables = np.stack([np.arange(PAGES_PER_SLOT),
                           rps + np.arange(PAGES_PER_SLOT)])
        null_rows = [(0, rps - 1), (1, rps - 1)]
        null = rps - 1
    else:
        tables = np.stack([np.arange(PAGES_PER_SLOT),
                           PAGES_PER_SLOT + np.arange(PAGES_PER_SLOT)])
        null = 2 * PAGES_PER_SLOT
        null_rows = [null]
    return tables.astype(np.int32), null, null_rows


def _pools(cfg, sharded):
    shape_rows = PAGES_PER_SLOT + 1 if sharded else 2 * PAGES_PER_SLOT + 1
    n_shards = 2 if sharded else 1
    jp = jT.init_paged_cache(cfg, shape_rows, PS, n_shards=n_shards)
    tp = tT.init_paged_cache(cfg, shape_rows, PS, n_shards=n_shards,
                             device="cpu")
    return jp, tp


def _check_pages(jpages, tpages, null_rows, sharded):
    for name in ("k", "v"):
        j = np.asarray(jpages[name]).copy()
        t = tpages[name].numpy().copy()
        for r in null_rows:      # write sinks: never read, order-free
            if sharded:
                j[:, r[0], r[1]] = t[:, r[0], r[1]] = 0
            else:
                j[:, r] = t[:, r] = 0
        np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("sharded", [False, True])
def test_chunks_decode_and_resume_match_reference(model, sharded):
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(5)
    tables, null, null_rows = _layout(sharded)
    jpages, tpages = _pools(jcfg, sharded)
    toks = rng.integers(0, jcfg.vocab_size, size=(B, 3 * C))
    hidden = None
    for i in range(3):
        start = np.full(B, i * C, np.int32)
        rows = tables[:, 2 * i:2 * i + 2].copy()
        if i == 1:
            rows[1, 0] = null    # a prefix-shared page: never rewritten
        batch = {"tokens": toks[:, i * C:(i + 1) * C].astype(np.int32),
                 "block_tables": tables, "start": start,
                 "chunk_rows": rows.astype(np.int32),
                 "last_index": np.int32(C - 3)}
        all_hidden = i == 0
        jout, jpages = jT.prefill_chunk(
            jparams, jpages, {k: jnp.asarray(v) for k, v in batch.items()},
            jcfg, all_hidden=all_hidden)
        tout, tpages = tT.prefill_chunk(
            tparams, tpages,
            {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
            tcfg, all_hidden=all_hidden)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
        if all_hidden:
            hidden = (np.asarray(jout[:, -1]), tout[:, -1])
        _check_pages(jpages, tpages, null_rows, sharded)
    for step in range(2):
        pos = np.full(B, 3 * C + step, np.int32)
        batch = {"tokens": rng.integers(0, jcfg.vocab_size, size=(B, 1))
                 .astype(np.int32),
                 "block_tables": tables, "positions": pos,
                 "write_rows": tables[:, -1].copy(),
                 "write_offs": np.full(B, step, np.int32)}
        jl, jpages = jT.decode_step_paged(
            jparams, jpages, {k: jnp.asarray(v) for k, v in batch.items()},
            jcfg)
        tl, tpages = tT.decode_step_paged(
            tparams, tpages,
            {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
            tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _check_pages(jpages, tpages, null_rows, sharded)
    np.testing.assert_allclose(
        tT.resume_prefill(tparams, hidden[1]).numpy(),
        np.asarray(jT.resume_prefill(jparams, jnp.asarray(hidden[0]))),
        **TOL)


def test_use_kernel_true_on_cpu_raises(model):
    _, tcfg, _, tparams = model
    tables, null, _ = _layout(False)
    _, tpages = _pools(tcfg, False)
    batch = {"tokens": torch.zeros((B, C), dtype=torch.int64),
             "block_tables": torch.from_numpy(tables),
             "start": torch.zeros(B, dtype=torch.int32),
             "chunk_rows": torch.from_numpy(tables[:, :2].copy()),
             "last_index": C - 1}
    with pytest.raises(ValueError, match="CUDA"):
        tT.prefill_chunk(tparams, tpages, batch, tcfg, use_kernel=True)
