"""The PyTorch port's paged attention against the JAX reference.

The plain PyTorch versions (`repro_torch.kernels.attention.ref`) are
held against the reference's jnp oracles and its Pallas kernels (run
in interpret mode on the CPU, as the reference's own tests run them)
on the same numpy inputs: flat and sharded pools, window 0/6, one or
two KV heads, fp32, atol 1e-5 (the reference's paged-attention
tolerance).  The CUDA kernels are held against the plain versions in
`tests/test_torch_cuda.py`, which needs a card and skips without one;
`chip_smoke.py` runs the same comparison at full width.  The decode
kernel's split plan, which the wrapper computes on the host, is checked
here: its bounds, and that the splits cover each live key once.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels.attention import ops as jops
from repro.kernels.attention import ref as jref
from repro_torch.kernels.attention import ops as tops
from repro_torch.kernels.attention import paged as tpaged
from repro_torch.kernels.attention import ref as tref

ATOL = 1e-5
B, T, H, D, PS, PTAB = 3, 8, 4, 16, 8, 5


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _inputs(seed, kvh, sharded):
    """Pool of 2 x 6 rows (sharded) or 12 rows (flat), tables drawn over
    all rows, decode clocks and page-aligned chunk starts."""
    rng = np.random.default_rng(seed)
    n = 12
    kp = rng.normal(size=(n, PS, kvh, D)).astype(np.float32)
    vp = rng.normal(size=(n, PS, kvh, D)).astype(np.float32)
    if sharded:
        kp = kp.reshape(2, n // 2, PS, kvh, D)
        vp = vp.reshape(2, n // 2, PS, kvh, D)
    tables = rng.integers(0, n, size=(B, PTAB)).astype(np.int32)
    qd = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    qp = rng.normal(size=(B, T, H, D)).astype(np.float32)
    positions = np.asarray([0, 17, PTAB * PS - 1], np.int32)
    start = np.asarray([0, 8, 24], np.int32)
    return dict(kp=kp, vp=vp, tables=tables, qd=qd, qp=qp,
                positions=positions, start=start)


def _t(x):
    return torch.from_numpy(x)


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("kvh", [1, 2])
@pytest.mark.parametrize("window", [0, 6])
def test_plain_decode_matches_reference(window, kvh, sharded):
    a = _inputs(1 + kvh, kvh, sharded)
    got = tref.paged_attention_ref(
        _t(a["qd"]), _t(a["kp"]), _t(a["vp"]), _t(a["tables"]),
        _t(a["positions"]), window=window).numpy()
    args = [jnp.asarray(a[k]) for k in
            ("qd", "kp", "vp", "tables", "positions")]
    oracle = np.asarray(jref.paged_attention_ref(*args, window=window))
    pallas = np.asarray(jops.paged_attention(*args, window=window))
    np.testing.assert_allclose(got, oracle, atol=ATOL)
    np.testing.assert_allclose(got, pallas, atol=ATOL)


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("kvh", [1, 2])
@pytest.mark.parametrize("window", [0, 6])
def test_plain_prefill_matches_reference(window, kvh, sharded):
    a = _inputs(7 + kvh, kvh, sharded)
    got = tref.paged_prefill_attention_ref(
        _t(a["qp"]), _t(a["kp"]), _t(a["vp"]), _t(a["tables"]),
        _t(a["start"]), window=window).numpy()
    args = [jnp.asarray(a[k]) for k in
            ("qp", "kp", "vp", "tables", "start")]
    oracle = np.asarray(jref.paged_prefill_attention_ref(
        *args, window=window))
    pallas = np.asarray(jops.paged_prefill_attention(*args,
                                                     window=window))
    np.testing.assert_allclose(got, oracle, atol=ATOL)
    np.testing.assert_allclose(got, pallas, atol=ATOL)


def test_cpu_dispatch_uses_plain_version_and_counts_nothing():
    """On CPU tensors the wrappers compute the plain version and never
    count a launch; ``use_kernel=True`` on a CPU tensor raises."""
    a = _inputs(3, 2, False)
    tpaged.reset_launches()
    q = _t(a["qd"])
    pages = (_t(a["kp"]), _t(a["vp"]), _t(a["tables"]))
    out = tops.paged_attention(q, *pages, _t(a["positions"]))
    plain = tref.paged_attention_ref(q, *pages, _t(a["positions"]))
    assert torch.equal(out, plain)
    out = tpaged.paged_attention_bhd(q[:, 0], *pages, _t(a["positions"]))
    assert torch.equal(out, plain[:, 0])
    out = tpaged.paged_prefill_attention_btd(_t(a["qp"]), *pages,
                                             _t(a["start"]))
    assert torch.equal(out, tref.paged_prefill_attention_ref(
        _t(a["qp"]), *pages, _t(a["start"])))
    assert tpaged.LAUNCHES == {"paged_attention_bhd": 0,
                               "paged_prefill_attention_btd": 0}
    with pytest.raises(ValueError, match="CUDA"):
        tops.paged_attention(q, *pages, _t(a["positions"]),
                             use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        tops.paged_prefill_attention(_t(a["qp"]), *pages, _t(a["start"]),
                                     use_kernel=True)


def test_decode_split_plan_fills_the_card_within_bounds():
    """The decode split comes from the shapes and the SM count: the
    serve path's B 8 x (8, 128) tables of 16-token pages with 32/4 heads
    on 132 SMs take 16 splits of 8 pages (512 blocks); a lone slot takes
    splits of MIN_SPLIT_KEYS, a crowded grid splits of MAX_SPLIT_KEYS,
    and n_rep 32 two row groups of blocks."""
    plan = tpaged.decode_split_plan
    assert plan(8, 32, 4, 128, 16, 132) == (8, 16)
    assert plan(1, 32, 4, 128, 16, 132) == (2, 64)
    assert plan(64, 32, 4, 128, 16, 132) == (32, 4)
    assert plan(8, 96, 8, 128, 16, 132) == (16, 8)
    assert plan(4, 64, 2, 128, 16, 132) == (4, 32)
    assert plan(8, 32, 4, 128, 16, 16) == (32, 4)
    assert plan(2, 4, 2, 5, 8, 132) == (4, 2)
    assert plan(1, 8, 8, 3, 64, 132) == (1, 3)   # a page of 64 keys
    for args in ((8, 32, 4, 128, 16, 132), (3, 24, 2, 7, 8, 4),
                 (1, 4, 4, 1, 16, 132)):
        pps, splits = plan(*args)
        assert (splits - 1) * pps < args[3] <= splits * pps


@pytest.mark.parametrize("window", [0, 512])
def test_decode_splits_cover_live_keys_once(window):
    """Over the serve path's plan, the splits' key ranges partition the
    keys a slot sees (at or before its clock, inside the window) for
    clocks on and beside page and split edges; a split wholly past the
    clock or behind the window is empty."""
    ps, n_pages = 16, 128
    pps, splits = tpaged.decode_split_plan(8, 32, 4, n_pages, ps, 132)
    for pos in (0, 15, 16, 127, 128, 129, 1000, 2047, 3000):
        seen = []
        for s in range(splits):
            first, last = tpaged.split_key_range(s, pps, ps, n_pages, pos,
                                                 window)
            seen.extend(range(first, last + 1))
            if s * pps * ps > pos or \
                    (window and (s + 1) * pps * ps <= pos - window + 1):
                assert first > last, (pos, s)
        last_key = min(pos, n_pages * ps - 1)
        lo = max(0, pos - window + 1) if window else 0
        assert seen == list(range(lo, last_key + 1)), pos


def _c_signature(src: str, name: str) -> str:
    """The declaration of C entry point `name` in `src`, whitespace
    collapsed."""
    start = src.index(f"int {name}(")
    return " ".join(src[start:src.index(")", start) + 1].split())


def test_kernel_source_has_its_c_interface():
    """The CUDA sources ship with the package and export the C entry
    points the ctypes wrappers bind, with the signatures they bind."""
    from repro_torch.kernels.attention import flash as tflash
    src = tpaged.SOURCE.read_text()
    assert _c_signature(src, "paged_attention_decode") == (
        "int paged_attention_decode(const void* q, const void* k, "
        "const void* v, const void* tables, const void* positions, "
        "void* out, void* workspace, int B, int H, int KV, int D, int ps, "
        "int P, int window, float scale, int pages_per_split, int dtype, "
        "void* stream)")
    assert _c_signature(src, "paged_prefill_attention") == (
        "int paged_prefill_attention(const void* q, const void* k, "
        "const void* v, const void* tables, const void* start, "
        "void* out, int B, int T, int H, int KV, int D, int ps, int P, "
        "int window, float scale, int dtype, void* stream)")
    assert "cudaGetLastError" in src
    src = tflash.SOURCE.read_text()
    assert _c_signature(src, "flash_attention") == (
        "int flash_attention(const void* q, const void* k, "
        "const void* v, void* out, int B, int Sq, int Sk, int H, "
        "int KV, int D, long long q_sb, long long q_ss, long long q_sh, "
        "long long k_sb, long long k_ss, long long k_sh, int causal, "
        "int window, int q_offset, float scale, int dtype, "
        "void* stream)")
    assert "cudaGetLastError" in src


def test_build_hash_covers_included_headers(tmp_path):
    """The library path of a source changes when a header it includes
    by a quoted #include changes, and the two attention sources both
    pull in the shared tensor-core core (on copies, not the repo's
    files)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.attention import flash as tflash
    for source in (tpaged.SOURCE, tflash.SOURCE):
        names = [f.name for f in build.included_files(source)]
        assert names == [source.name, "attention_core.cuh"]
    src_dir = tpaged.SOURCE.parent
    for f in ("paged_attention.cu", "attention_core.cuh"):
        (tmp_path / f).write_bytes((src_dir / f).read_bytes())
    copy = tmp_path / "paged_attention.cu"
    before = build.library_path(copy)
    assert build.library_path(copy) == before
    header = tmp_path / "attention_core.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = build.library_path(copy)
    assert after != before
    assert after.name.startswith("libpaged_attention-")


def test_build_hash_follows_nested_quoted_includes(tmp_path):
    """A header included by an included header is hashed too, each path
    taken relative to the file that names it; angle-bracket includes
    (the toolkit's own headers) are not followed."""
    from repro_torch.kernels import build
    (tmp_path / "inc").mkdir()
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "inc/a.cuh"\n')
    (tmp_path / "inc" / "a.cuh").write_text('#include "b.cuh"\n')
    inner = tmp_path / "inc" / "b.cuh"
    inner.write_text("// b\n")
    assert [f.name for f in build.included_files(src)] == [
        "k.cu", "a.cuh", "b.cuh"]
    before = build.library_path(src)
    inner.write_text("// b, edited\n")
    assert build.library_path(src) != before

