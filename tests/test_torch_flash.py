"""The port's flash attention on the CPU against the reference's: the
torch `flash_jnp`, `ref.flash_attention_ref`, `ops.flash_attention`
and the kernel wrapper `flash.flash_attention_bshd` (both take the
plain path on a CPU tensor), held against the JAX
`flash_attention_ref` and the JAX `ops.flash_attention` (the Pallas
kernel in interpret mode, as `tests/test_kernels.py` runs it) on the
same numpy inputs.

The cases are those of `test_kernels.py` (GQA shapes, window 16/64,
non-causal, bf16, `q_offset` continuation) with its tolerances (fp32
atol 2e-5, bf16 atol 3e-2), plus rows that see no key at all (they
return 0), and a length that is not a multiple of the tile, where only
the plain versions are compared (the Pallas wrapper drops such a
tail).  The CUDA kernel itself is held against the plain version on
the card (`test_torch_cuda.py`, `chip_smoke.py`)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import repro.configs as jconfigs
from repro.kernels.attention.flash import flash_attention_bhsd as j_bhsd
from repro.kernels.attention.ops import flash_attention as j_flash
from repro.kernels.attention.ref import flash_attention_ref as j_ref
from repro.models import attention as jatt
import repro_torch.configs as tconfigs
from repro_torch.kernels.attention import flash, ops, ref
from repro_torch.models import attention as tatt

F32 = 2e-5
BF16 = 3e-2


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _qkv(seed, b, sq, sk, h, kv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, d)).astype(np.float32),
            rng.normal(size=(b, sk, kv, d)).astype(np.float32),
            rng.normal(size=(b, sk, kv, d)).astype(np.float32))


def _port(fn, arrs, dtype=torch.float32, **kw):
    out = fn(*(torch.from_numpy(a).to(dtype) for a in arrs), **kw)
    return out.float().numpy()


def _jax(fn, arrs, dtype=jnp.float32, **kw):
    out = fn(*(jnp.asarray(a).astype(dtype) for a in arrs), **kw)
    return np.asarray(out, np.float32)


CASES = [
    # (name, b, sq, sk, h, kv, d, kw, pallas tiles)
    ("gqa-128-32-2-4", 2, 128, 128, 4, 2, 32, {}, 64),
    ("gqa-256-64-1-2", 2, 256, 256, 2, 1, 64, {}, 64),
    ("gqa-128-16-4-4", 2, 128, 128, 4, 4, 16, {}, 64),
    ("window-16", 1, 128, 128, 2, 2, 32, {"window": 16}, 32),
    ("window-64", 1, 128, 128, 2, 2, 32, {"window": 64}, 32),
    ("noncausal", 1, 64, 64, 2, 2, 32, {"causal": False}, 32),
    ("q-offset", 1, 32, 64, 2, 2, 16, {"q_offset": 32}, 32),
    # queries 64..95 against 64 keys with a 16-key window: rows from
    # position 79 on see no key and return 0
    ("masked-rows", 1, 32, 64, 4, 2, 16, {"q_offset": 64, "window": 16},
     32),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_fp32_matches_reference_and_pallas(case):
    _, b, sq, sk, h, kv, d, kw, tile = case
    arrs = _qkv(sum(map(ord, case[0])), b, sq, sk, h, kv, d)
    want_ref = _jax(j_ref, arrs, **kw)
    want_pallas = _jax(j_flash, arrs, bq=tile, bk=tile, **kw)
    for got in (_port(ref.flash_attention_ref, arrs, **kw),
                _port(ops.flash_attention, arrs, **kw),
                _port(flash.flash_attention_bshd, arrs, **kw)):
        np.testing.assert_allclose(got, want_ref, atol=F32, rtol=0)
        np.testing.assert_allclose(got, want_pallas, atol=F32, rtol=0)
    if case[0] == "masked-rows":
        q_pos = 64 + np.arange(sq)
        dead = q_pos - (sk - 1) >= 16
        assert dead.any() and not dead.all()
        got = _port(ops.flash_attention, arrs, **kw)
        assert np.all(got[:, dead] == 0.0)


def test_flash_bf16_matches_reference_and_pallas():
    arrs = _qkv(5, 1, 128, 128, 4, 2, 32)
    want_ref = _jax(j_ref, arrs, jnp.bfloat16)
    want_pallas = _jax(j_flash, arrs, jnp.bfloat16, bq=64, bk=64)
    got = _port(ops.flash_attention, arrs, torch.bfloat16)
    np.testing.assert_allclose(got, want_ref, atol=BF16, rtol=0)
    np.testing.assert_allclose(got, want_pallas, atol=BF16, rtol=0)


def test_flash_matches_pallas_entry_in_its_own_layout():
    """The Pallas entry `flash_attention_bhsd` called directly on its
    (BH, S, D) layout, head bh reading KV row bh // n_rep, against the
    port's wrapper on the same numbers in the (B, S, H, D) layout."""
    b, s, h, kv, d = 2, 64, 4, 2, 16
    q, k, v = _qkv(9, b, s, s, h, kv, d)
    qf = q.transpose(0, 2, 1, 3).reshape(b * h, s, d)
    kf = k.transpose(0, 2, 1, 3).reshape(b * kv, s, d)
    vf = v.transpose(0, 2, 1, 3).reshape(b * kv, s, d)
    want = _jax(j_bhsd, (qf, kf, vf), n_rep=h // kv, bq=32, bk=32,
                window=24, interpret=True)
    got = _port(flash.flash_attention_bshd, (q, k, v), window=24)
    np.testing.assert_allclose(
        got.transpose(0, 2, 1, 3).reshape(b * h, s, d), want,
        atol=F32, rtol=0)


def test_flash_tail_not_a_tile_multiple():
    """200 queries and keys: the plain versions agree (the CUDA kernel
    masks its tails and is held to the plain version on the card)."""
    arrs = _qkv(11, 1, 200, 200, 4, 2, 16)
    for kw in ({}, {"window": 48}):
        np.testing.assert_allclose(_port(ops.flash_attention, arrs, **kw),
                                   _jax(j_ref, arrs, **kw),
                                   atol=F32, rtol=0)


def test_attention_and_decode_attention_match_reference():
    """`attention()` (GQA repeat + `flash_jnp`, 512-wide chunks) and the
    dense-cache `decode_attention`, on danube's reduced config (32-key
    window)."""
    jcfg = jconfigs.get_reduced("h2o-danube-3-4b")
    tcfg = tconfigs.get_reduced("h2o-danube-3-4b")
    q, k, v = _qkv(13, 2, 96, 96, tcfg.n_heads, tcfg.n_kv_heads,
                   tcfg.head_dim)
    got = _port(lambda *t: tatt.attention(*t, tcfg), (q, k, v))
    want = _jax(lambda *t: jatt.attention(*t, jcfg), (q, k, v))
    np.testing.assert_allclose(got, want, atol=F32, rtol=0)
    q1 = q[:, :1]
    for n in (1, 40, 96):
        got = _port(lambda *t: tatt.decode_attention(
            *t, torch.tensor(n, dtype=torch.int32), tcfg), (q1, k, v))
        want = _jax(lambda *t: jatt.decode_attention(
            *t, jnp.int32(n), jcfg), (q1, k, v))
        np.testing.assert_allclose(got, want, atol=F32, rtol=0)


def test_use_kernel_true_on_cpu_raises():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 8, 8, 2, 1, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, use_kernel=True)
    cfg = tconfigs.get_reduced("yi-6b")
    q, k, v = (torch.from_numpy(a) for a in _qkv(
        1, 1, 8, 8, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim))
    with pytest.raises(ValueError, match="CUDA"):
        tatt.attention(q, k, v, cfg, use_kernel=True)
    assert flash.LAUNCHES["flash_attention_bhsd"] == 0
