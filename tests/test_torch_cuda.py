"""The CUDA kernels (attention, selective scan, RK3 stencil) against
their plain PyTorch versions, on the card only (marker ``cuda``).  This file
imports no JAX, so it runs on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Small shapes from a numpy seed.  Paged kernels: flat and sharded
pools, window 0 and 6, one or two KV heads; fp32 atol 1e-5, bf16 atol
2e-2 (the summation orders differ).  Flash kernel: causal and not,
window 0 and 24, a `q_offset` continuation and lengths that are not a
multiple of its 64-key tile, 2 or 4 query heads per KV head; fp32 atol
2e-5 (the reference's flash tolerance), bf16 atol 3e-2.  Both at the
served head dims (D 64, 120, 128 at n_rep 1, 4, 8 and 12), with query
counts that are not a multiple of 16 and key ranges that start
mid-tile: fp32 at the same atols, bf16 per element at 2^-7 * (sum_j
p_j |v_j| + |o|), the bound `chip_smoke.py` holds them to.  The split
decode kernel besides at those head dims, at clocks on and beside page
and split edges (0, 15, 16, 127, 128, 2047, one slot alone and eight
together) with window 0 and 512, flat and sharded pools, and captured
in a CUDA graph that is replayed with new clocks.  Selective
scan, both kernels (the chunked one for prompts, the sequential one for
decode steps and rows it cannot copy 16 bytes at a time): S on and
beside the chunked kernel's 128-step tile (1, 2, 127, 128, 129, 1000)
with channels that do not fill the last 32-channel block, B 1 and 8,
state sizes 4, 8 and 16, a zero and a given initial state, the final
state written in place over the initial one, a prompt whose x is not
16-byte aligned, and a prefill and a decode step captured in one CUDA
graph and replayed on new inputs; y and the final state at fp32
atol/rtol 1e-5 (the reference's scan tolerance).  RK3 stencil: grains
inside one 1024-column tile and across tiles, 1 and 4 blocks, every
pattern of physical sides, p 1, 3 and 7, at the reference test's dr
and at the compiled engine's production dr, input scales 0.01 and
0.1; and the compiled AMR step
through the kernel against its plain path and the global oracle; fp32
atol 1e-6 (the reference's stencil tolerance).  Each launch
adds exactly one to its wrapper's count.  `chip_smoke.py` makes the
same comparisons at the served models' full width and the AMR
production cell.  Without a card those cases
skip; the check that the kernel path refuses a CPU tensor runs
anywhere.
"""

import numpy as np
import pytest
import torch

B, T, H, D, PS, PTAB, N = 3, 8, 4, 16, 8, 5, 12


def _inputs(seed, kvh, sharded, dtype):
    rng = np.random.default_rng(seed)
    kp = rng.normal(size=(N, PS, kvh, D)).astype(np.float32)
    vp = rng.normal(size=(N, PS, kvh, D)).astype(np.float32)
    if sharded:
        kp = kp.reshape(2, N // 2, PS, kvh, D)
        vp = vp.reshape(2, N // 2, PS, kvh, D)
    a = dict(kp=kp, vp=vp,
             tables=rng.integers(0, N, size=(B, PTAB)).astype(np.int32),
             qd=rng.normal(size=(B, H, D)).astype(np.float32),
             qp=rng.normal(size=(B, T, H, D)).astype(np.float32),
             positions=np.asarray([0, 17, PTAB * PS - 1], np.int32),
             start=np.asarray([0, 8, 24], np.int32))
    out = {k: torch.from_numpy(v).cuda() for k, v in a.items()}
    for k in ("kp", "vp", "qd", "qp"):
        out[k] = out[k].to(dtype)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("kvh", [1, 2])
def test_cuda_kernels_match_plain(dtype, tol, kvh):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ and "
                    "have no CPU mode")
    from repro_torch.kernels.attention import paged, ref
    dtype = getattr(torch, dtype)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for sharded in (False, True):
            for window in (0, 6):
                c = _inputs(11 + kvh, kvh, sharded, dtype)
                pages = (c["kp"], c["vp"], c["tables"])
                paged.reset_launches()
                got = paged.paged_attention_bhd(
                    c["qd"], *pages, c["positions"], window=window)
                want = ref.paged_attention_ref(
                    c["qd"][:, None], *pages, c["positions"],
                    window=window)[:, 0]
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=tol, rtol=0)
                got = paged.paged_prefill_attention_btd(
                    c["qp"], *pages, c["start"], window=window)
                want = ref.paged_prefill_attention_ref(
                    c["qp"], *pages, c["start"], window=window)
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=tol, rtol=0)
                assert paged.LAUNCHES == {"paged_attention_bhd": 1,
                                          "paged_prefill_attention_btd": 1}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


FLASH_SHAPES = [  # (B, Sq, Sk, H, KV, D, q_offset)
    (2, 128, 128, 4, 2, 16, 0),
    (1, 100, 100, 8, 2, 32, 0),
    (1, 40, 90, 4, 1, 64, 50),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 3e-2)])
@pytest.mark.parametrize("shape", FLASH_SHAPES,
                         ids=["gqa2", "tail", "offset"])
def test_cuda_flash_kernel_matches_plain(dtype, tol, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA C++ and "
                    "has no CPU mode")
    from repro_torch.kernels.attention import flash, ops, ref
    b, sq, sk, h, kvh, d, off = shape
    rng = np.random.default_rng(sq + sk)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .cuda().to(getattr(torch, dtype))
               for s in ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d)))
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for causal in (True, False):
            for window in (0, 24):
                kw = dict(causal=causal, window=window, q_offset=off)
                flash.reset_launches()
                got = ops.flash_attention(q, k, v, **kw)
                want = ref.flash_attention_ref(q, k, v, **kw)
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=tol, rtol=0)
                assert flash.LAUNCHES == {"flash_attention_bhsd": 1}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


# the tensor-core instantiations (bf16) and the CUDA-core ones (fp32)
# at the served head dims: musicgen's D 64 at n_rep 1, h2o-danube's
# D 120 at n_rep 4 with a window, yi-6b's D 128 at n_rep 8 and
# command-r's n_rep 12 (60-row blocks); and D 20, not a multiple of 8,
# which the tensor-core kernels load element by element; query counts
# that are not a multiple of 16, and key ranges that start mid-tile
# (q_offset, start not on a page)
HEAD_CASES = [  # (H, KV, D, window)
    (4, 4, 64, 0),
    (8, 2, 120, 24),
    (16, 2, 128, 0),
    (24, 2, 128, 0),
    (4, 2, 20, 0),
]
HEAD_IDS = ["d64-rep1", "d120-rep4-window", "d128-rep8", "d128-rep12",
            "d20-element-loads"]


def _bf16_bound(plain_abs, want):
    """A bf16 ulp of each softmax weight times its value plus one of the
    output: 2^-7 * (sum_j p_j |v_j| + |o|), per element."""
    return 2.0 ** -7 * (plain_abs.float() + want.float().abs())


def _hold(got, want, plain_abs, fp32_atol):
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all())
    if plain_abs is None:
        torch.testing.assert_close(got, want, atol=fp32_atol, rtol=0)
    else:
        bound = _bf16_bound(plain_abs, want)
        assert bool(((got - want).abs() <= bound).all()), \
            float(((got - want).abs() / bound).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", HEAD_CASES, ids=HEAD_IDS)
def test_cuda_flash_kernel_served_head_dims(dtype, heads):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA C++ and "
                    "has no CPU mode")
    from repro_torch.kernels.attention import flash, ref
    h, kvh, d, window = heads
    rng = np.random.default_rng(h + d)
    dt = getattr(torch, dtype)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        # (Sq, Sk, q_offset): a whole prompt of 77 queries, and 45
        # queries continuing at 33 (keys start mid-tile)
        for sq, sk, off in ((77, 77, 0), (45, 78, 33)):
            q, k, v = (torch.from_numpy(rng.normal(size=s).astype(
                np.float32)).cuda().to(dt)
                for s in ((1, sq, h, d), (1, sk, kvh, d), (1, sk, kvh, d)))
            for causal in (True, False):
                kw = dict(causal=causal, window=window, q_offset=off)
                flash.reset_launches()
                got = flash.flash_attention_bshd(q, k, v, **kw)
                assert flash.LAUNCHES == {"flash_attention_bhsd": 1}
                want = ref.flash_attention_ref(q, k, v, **kw)
                plain_abs = None if dt == torch.float32 else \
                    ref.flash_attention_ref(q, k, v.abs(), **kw)
                _hold(got, want, plain_abs, 2e-5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", HEAD_CASES, ids=HEAD_IDS)
def test_cuda_prefill_kernel_served_head_dims(dtype, heads):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ and "
                    "have no CPU mode")
    from repro_torch.kernels.attention import paged, ref
    h, kvh, d, window = heads
    rng = np.random.default_rng(7 * h + d)
    dt = getattr(torch, dtype)
    ps, ptab, n, t = 16, 8, 20, 37
    # two slots: one from 0, one continuing at 23 (not on a page)
    start = torch.tensor([0, 23], dtype=torch.int32).cuda()
    kp, vp = (torch.from_numpy(rng.normal(size=(n, ps, kvh, d)).astype(
        np.float32)).cuda().to(dt) for _ in range(2))
    tables = torch.from_numpy(rng.integers(0, n, size=(2, ptab)).astype(
        np.int32)).cuda()
    q = torch.from_numpy(rng.normal(size=(2, t, h, d)).astype(
        np.float32)).cuda().to(dt)
    for sharded in (False, True):
        pools = (kp, vp) if not sharded else \
            (kp.reshape(2, n // 2, ps, kvh, d),
             vp.reshape(2, n // 2, ps, kvh, d))
        paged.reset_launches()
        got = paged.paged_prefill_attention_btd(q, *pools, tables, start,
                                                window=window)
        assert paged.LAUNCHES == {"paged_attention_bhd": 0,
                                  "paged_prefill_attention_btd": 1}
        want = ref.paged_prefill_attention_ref(q, *pools, tables, start,
                                               window=window)
        plain_abs = None if dt == torch.float32 else \
            ref.paged_prefill_attention_ref(q, pools[0], pools[1].abs(),
                                            tables, start, window=window)
        _hold(got, want, plain_abs, 1e-5)


def _decode_case(rng, dt, positions, heads, ps, ptab, sharded):
    """Decode inputs on the card: a pool of distinct rows per slot (an
    even count, so it also reshapes to two shards), tables over them,
    the given clocks."""
    h, kvh, d = heads
    b = len(positions)
    n = b * ptab + (b * ptab) % 2

    def cuda(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).cuda().to(dt)

    kp, vp = cuda(n, ps, kvh, d), cuda(n, ps, kvh, d)
    if sharded:
        kp = kp.reshape(2, n // 2, ps, kvh, d)
        vp = vp.reshape(2, n // 2, ps, kvh, d)
    tables = torch.from_numpy(rng.permutation(n)[:b * ptab].reshape(
        b, ptab).astype(np.int32)).cuda()
    pos = torch.tensor(positions, dtype=torch.int32).cuda()
    return cuda(b, h, d), kp, vp, tables, pos


def _hold_decode(q, kp, vp, tables, pos, window):
    """One decode launch against the plain version: fp32 at 1e-5, bf16
    per element at the bf16 bound."""
    from repro_torch.kernels.attention import paged, ref
    paged.reset_launches()
    got = paged.paged_attention_bhd(q, kp, vp, tables, pos, window=window)
    assert paged.LAUNCHES == {"paged_attention_bhd": 1,
                              "paged_prefill_attention_btd": 0}
    want = ref.paged_attention_ref(q[:, None], kp, vp, tables, pos,
                                   window=window)[:, 0]
    plain_abs = None if q.dtype == torch.float32 else \
        ref.paged_attention_ref(q[:, None], kp, vp.abs(), tables, pos,
                                window=window)[:, 0]
    _hold(got, want, plain_abs, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", HEAD_CASES, ids=HEAD_IDS)
def test_cuda_decode_kernel_served_head_dims(dtype, heads):
    """The split decode kernel at the served head dims (lane groups of
    8, 16 and 4 lanes; one and two row groups; element loads at D 20
    in bf16), three slots at clocks 0, mid-page and the table's last
    key, over several splits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ and "
                    "have no CPU mode")
    from repro_torch.kernels.attention import paged
    h, kvh, d, window = heads
    rng = np.random.default_rng(11 * h + d)
    ps, ptab = 16, 8
    assert paged.decode_split_plan(3, h, kvh, ptab, ps, 132)[1] > 1
    for sharded in (False, True):
        c = _decode_case(rng, getattr(torch, dtype), [0, 37, ps * ptab - 1],
                         (h, kvh, d), ps, ptab, sharded)
        _hold_decode(*c, window)


EDGE_CLOCKS = (0, 15, 16, 127, 128, 2047)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 8])
def test_cuda_decode_split_edges(dtype, batch):
    """Clocks on and beside page and split edges (pages of 16, splits of
    4-32 pages over a (B, 128) table), a slot at 0 beside one at 2047,
    a 512-key window whose leading splits lie wholly behind it, flat
    and sharded pools; yi-6b's 8 query heads per KV head at D 128."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ and "
                    "have no CPU mode")
    from repro_torch.kernels.attention import paged
    rng = np.random.default_rng(batch)
    heads, ps, ptab = (16, 2, 128), 16, 128
    cases = [[c] for c in EDGE_CLOCKS] if batch == 1 else \
        [list(EDGE_CLOCKS) + [0, 2047]]
    for positions in cases:
        pps, splits = paged.decode_split_plan(len(positions), heads[0],
                                              heads[1], ptab, ps, 132)
        assert splits > 1
        for window in (0, 512):
            for sharded in (False, True):
                c = _decode_case(rng, getattr(torch, dtype), positions,
                                 heads, ps, ptab, sharded)
                _hold_decode(*c, window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_decode_graph_replay(dtype):
    """One decode call captured in a CUDA graph and replayed twice with
    new clocks written into its positions tensor: each replay agrees
    with the plain version at its clocks (the workspace and the combine
    carry nothing from one call to the next)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ and "
                    "have no CPU mode")
    from repro_torch.kernels.attention import paged, ref
    rng = np.random.default_rng(3)
    q, kp, vp, tables, pos = _decode_case(
        rng, getattr(torch, dtype), [2047, 0, 500, 1000], (16, 2, 128),
        16, 128, False)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        paged.paged_attention_bhd(q, kp, vp, tables, pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged.paged_attention_bhd(q, kp, vp, tables, pos)
    for clocks in ([5, 2047, 16, 127], [1500, 300, 0, 2047]):
        pos.copy_(torch.tensor(clocks, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        want = ref.paged_attention_ref(q[:, None], kp, vp, tables,
                                       pos)[:, 0]
        plain_abs = None if q.dtype == torch.float32 else \
            ref.paged_attention_ref(q[:, None], kp, vp.abs(), tables,
                                    pos)[:, 0]
        _hold(out, want, plain_abs, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash", "prefill"])
def test_cuda_tensor_core_block_shapes(kernel):
    """Grids large enough for the 128-row blocks (two warp groups on
    different rows) beside the small ones above (two warp groups
    splitting the keys of 64 rows): yi-6b's 32/4 heads of 128, bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ and "
                    "have no CPU mode")
    from repro_torch.kernels.attention import flash, paged, ref
    rng = np.random.default_rng(5)
    h, kvh, d = 32, 4, 128

    def cuda(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).cuda().to(torch.bfloat16)

    if kernel == "flash":
        q, k, v = cuda(1, 1000, h, d), cuda(1, 1000, kvh, d), \
            cuda(1, 1000, kvh, d)
        flash.reset_launches()
        got = flash.flash_attention_bshd(q, k, v)
        assert flash.LAUNCHES == {"flash_attention_bhsd": 1}
        want = ref.flash_attention_ref(q, k, v)
        plain_abs = ref.flash_attention_ref(q, k, v.abs())
    else:
        ps, ptab, n = 16, 40, 330
        kp, vp = cuda(n, ps, kvh, d), cuda(n, ps, kvh, d)
        tables = torch.from_numpy(rng.permutation(n)[:8 * ptab].reshape(
            8, ptab).astype(np.int32)).cuda()
        start = torch.tensor([0, 5, 64, 100, 128, 200, 300, 383],
                             dtype=torch.int32).cuda()
        q = cuda(8, 256, h, d)
        paged.reset_launches()
        got = paged.paged_prefill_attention_btd(q, kp, vp, tables, start)
        assert paged.LAUNCHES["paged_prefill_attention_btd"] == 1
        want = ref.paged_prefill_attention_ref(q, kp, vp, tables, start)
        plain_abs = ref.paged_prefill_attention_ref(q, kp, vp.abs(),
                                                    tables, start)
    _hold(got, want, plain_abs, None)


def test_flash_kernel_path_refuses_cpu_tensors():
    from repro_torch.kernels.attention import flash, ops
    q = torch.zeros(1, 8, 2, 16)
    k = torch.zeros(1, 8, 1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, k, use_kernel=True)
    assert flash.LAUNCHES["flash_attention_bhsd"] == 0


SCAN_SHAPES = [  # (B, S, D, N)
    (1, 200, 96, 16),
    (3, 1, 64, 8),
    (2, 70, 40, 4),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SCAN_SHAPES,
                         ids=["prefill", "decode", "state4"])
def test_cuda_scan_kernel_matches_plain(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA C++ and "
                    "has no CPU mode")
    from repro_torch.kernels.scan import ops, ref, scan
    b, s, d, n = shape
    rng = np.random.default_rng(s + d + n)

    def cuda(x):
        return torch.from_numpy(np.asarray(x, np.float32)).cuda()

    dt = cuda(rng.uniform(0.01, 1.0, size=(b, s, d)))
    x = cuda(rng.normal(size=(b, s, d)))
    bm = cuda(rng.normal(size=(b, s, n)) * 0.3)
    cm = cuda(rng.normal(size=(b, s, n)))
    a = cuda(-rng.uniform(0.5, 2.0, size=(d, n)))
    h0 = cuda(rng.normal(size=(b, d, n)))
    for state in (None, h0):
        want_y, want_h = ref.selective_scan_fused_ref(dt, x, bm, cm, a,
                                                      state)
        scan.reset_launches()
        y, h_t = scan.selective_scan_fused(dt, x, bm, cm, a, state)
        torch.cuda.synchronize()
        torch.testing.assert_close(y, want_y, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(h_t, want_h, atol=1e-5, rtol=1e-5)
        assert scan.LAUNCHES == {"selective_scan": 1}
        # the final state written in place over the initial one
        out = torch.zeros_like(h0) if state is None else state.clone()
        y, h_t = scan.selective_scan_fused(
            dt, x, bm, cm, a, None if state is None else out,
            out_state=out)
        assert h_t is out
        torch.testing.assert_close(y, want_y, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(out, want_h, atol=1e-5, rtol=1e-5)
        y, h_t = ops.selective_scan(dt, x, bm, cm, a, state)
        torch.testing.assert_close(y, want_y, atol=1e-5, rtol=1e-5)
        assert scan.LAUNCHES == {"selective_scan": 3}


def _scan_inputs(rng, b, s, d, n):
    """dt, x, B, C, a and a state, on the card, drawn as in
    `test_cuda_scan_kernel_matches_plain`."""
    def cuda(x):
        return torch.from_numpy(np.asarray(x, np.float32)).cuda()
    return (cuda(rng.uniform(0.01, 1.0, size=(b, s, d))),
            cuda(rng.normal(size=(b, s, d))),
            cuda(rng.normal(size=(b, s, n)) * 0.3),
            cuda(rng.normal(size=(b, s, n))),
            cuda(-rng.uniform(0.5, 2.0, size=(d, n))),
            cuda(rng.normal(size=(b, d, n))))


def _scan_close(got, want):
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


# on and beside the chunked kernel's 128-step tile; 1 is a decode step
SCAN_EDGE_STEPS = [1, 2, 127, 128, 129, 1000]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 8, 16])
@pytest.mark.parametrize("s", SCAN_EDGE_STEPS)
def test_cuda_scan_tile_edges(s, n):
    """B 1 and 8, from a zero state into a new one and from a given
    state written over in place; d_inner 72 leaves the last 32-channel
    block of the chunked kernel part-empty."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA C++ and "
                    "has no CPU mode")
    from repro_torch.kernels.scan import ref, scan
    rng = np.random.default_rng(1000 * s + n)
    d = 72
    for b in (1, 8):
        dt, x, bm, cm, a, h0 = _scan_inputs(rng, b, s, d, n)
        assert scan.use_chunked(s, d, n, dt.data_ptr(), x.data_ptr()) == \
            (s > 1)
        for state in (None, h0):
            want_y, want_h = ref.selective_scan_fused_ref(dt, x, bm, cm, a,
                                                          state)
            out = None if state is None else state.clone()
            scan.reset_launches()
            y, h_t = scan.selective_scan_fused(dt, x, bm, cm, a, out,
                                               out_state=out)
            torch.cuda.synchronize()
            assert scan.LAUNCHES == {"selective_scan": 1}
            assert out is None or h_t is out
            _scan_close(y, want_y)
            _scan_close(h_t, want_h)


@pytest.mark.cuda
def test_cuda_scan_unaligned_prompt():
    """A prompt whose x starts 4 bytes past a 16-byte boundary runs the
    sequential kernel, and agrees."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA C++ and "
                    "has no CPU mode")
    from repro_torch.kernels.scan import ref, scan
    rng = np.random.default_rng(5)
    b, s, d, n = 2, 300, 64, 16
    dt, x, bm, cm, a, h0 = _scan_inputs(rng, b, s, d, n)
    shifted = torch.empty(x.numel() + 1, device="cuda")[1:].view(b, s, d)
    shifted.copy_(x)
    assert not scan.use_chunked(s, d, n, dt.data_ptr(), shifted.data_ptr())
    y, h_t = scan.selective_scan_fused(dt, shifted, bm, cm, a, h0)
    want_y, want_h = ref.selective_scan_fused_ref(dt, x, bm, cm, a, h0)
    _scan_close(y, want_y)
    _scan_close(h_t, want_h)


@pytest.mark.cuda
def test_cuda_scan_graph_replay():
    """A prefill (chunked kernel, zero state) and a decode step
    (sequential kernel, state written in place) captured in one CUDA
    graph, replayed twice on new inputs copied into the captured
    tensors: a call plans from shapes alone, so a graph holds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA C++ and "
                    "has no CPU mode")
    from repro_torch.kernels.scan import ref, scan
    rng = np.random.default_rng(6)
    d, n = 72, 16
    pre = _scan_inputs(rng, 1, 300, d, n)[:5]
    dec = _scan_inputs(rng, 8, 1, d, n)
    state = dec[5]

    def run():
        y_p, h_p = scan.selective_scan_fused(*pre)
        y_d, _ = scan.selective_scan_fused(*dec[:5], state,
                                           out_state=state)
        return y_p, h_p, y_d

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_p, h_p, y_d = run()
    for _ in range(2):
        new_pre = _scan_inputs(rng, 1, 300, d, n)[:5]
        new_dec = _scan_inputs(rng, 8, 1, d, n)
        for dst, src in zip(pre + dec, new_pre + new_dec):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        want_p = ref.selective_scan_fused_ref(*new_pre)
        want_d = ref.selective_scan_fused_ref(*new_dec)
        _scan_close(y_p, want_p[0])
        _scan_close(h_p, want_p[1])
        _scan_close(y_d, want_d[0])
        _scan_close(state, want_d[1])


STENCIL_GRAINS = [8, 1000, 2100]   # inside one 1024-column tile and across


@pytest.mark.cuda
@pytest.mark.parametrize("grain", STENCIL_GRAINS)
@pytest.mark.parametrize("nb", [1, 4])
def test_cuda_stencil_kernel_matches_plain(grain, nb):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA C++ and "
                    "has no CPU mode")
    from repro_torch.kernels.stencil import ops, ref, stencil
    rng = np.random.default_rng(grain + nb)
    patterns = [[0, 0], [1, 0], [0, 1], [1, 1]]
    # a batch of 4 takes every pattern at once, a batch of 1 each in turn
    flag_sets = [patterns] if nb == 4 else [[f] for f in patterns]
    # the reference test's dr/dt, and a fine grid's (the compiled
    # engine's production cell: 8,388,608 points over r in [0, 100])
    for dr in (0.05, 100.0 / (8388608 - 1)):
        for scale in (0.01, 0.1):
            u = torch.from_numpy((rng.normal(size=(nb, 3, grain + 6)) *
                                  scale).astype(np.float32)).cuda()
            r = torch.from_numpy(np.stack(
                [(np.arange(-3, grain + 3) + b * grain) * dr
                 for b in range(nb)]).astype(np.float32)).cuda()
            for flags in flag_sets:
                f = torch.tensor(flags, dtype=torch.int32).cuda()
                for p in (1, 3, 7):
                    kw = dict(dr=dr, dt=0.25 * dr, p=p)
                    want = ref.stencil_rk3_ref(u, r, f, **kw)
                    stencil.reset_launches()
                    got = stencil.stencil_rk3(u, r, f, **kw)
                    torch.cuda.synchronize()
                    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
                    assert stencil.LAUNCHES == {"stencil_rk3": 1}
                    left = f[:, 0].bool()[:, None, None]
                    right = f[:, 1].bool()[:, None, None]
                    got = ops.stencil_rk3_step(u, r, left, right, **kw)
                    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
                    assert stencil.LAUNCHES == {"stencil_rk3": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2])
def test_cuda_compiled_amr_step_matches_plain(k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA C++ and "
                    "has no CPU mode")
    from repro_torch.amr import compiled, wave
    from repro_torch.kernels.stencil import stencil
    prob = wave.WaveProblem(rmax=20.0, amplitude=0.005)
    out = {}
    for use_kernel in (True, False):
        cfg = compiled.CompiledAMRConfig(grain=1100, slots=4, n_steps=6,
                                         steps_per_exchange=k,
                                         use_kernel=use_kernel)
        step, _, init, to_g, _, info = compiled.make_uniform_step(
            prob, cfg, 3, device="cuda")
        pool = init()
        stencil.reset_launches()
        out[use_kernel] = to_g(step(pool))
        torch.cuda.synchronize()
        assert stencil.LAUNCHES["stencil_rk3"] == (6 if use_kernel else 0)
    torch.testing.assert_close(out[True], out[False], atol=1e-6, rtol=0)
    want = compiled.reference_uniform(prob, info["n_points"], 6, info["dr"],
                                      info["dt"], device="cuda")
    torch.testing.assert_close(out[True], want, atol=1e-6, rtol=0)


def test_stencil_kernel_path_refuses_cpu_tensors():
    from repro_torch.kernels.stencil import ops, stencil
    u = torch.zeros(1, 3, 14)
    r = torch.zeros(1, 14)
    mask = torch.ones((1, 1, 1), dtype=torch.bool)
    stencil.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        ops.stencil_rk3_step(u, r, mask, mask, dr=0.05, dt=0.01, p=7,
                             use_kernel=True)
    assert stencil.LAUNCHES["stencil_rk3"] == 0
