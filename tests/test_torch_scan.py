"""The port's selective-scan plain versions (`repro_torch.kernels.scan`)
against the reference's: `selective_scan_ref` and the Pallas
`selective_scan` run in interpret mode, at `test_kernels.py`'s three
shapes and its long-memory case; the fused form (`da`/`dbx` formed per
step from dt, x, B and a) with a zero state against the Pallas kernel
fed the reference's own `_mamba1_inputs`, and with a state against the
final state of the reference's `mamba1_scan_ref`.  atol/rtol 1e-5, the
reference's scan tolerance (`test_kernels.py:129-152`).  The CUDA
kernel itself runs only on the card (`test_torch_cuda.py`,
`chip_smoke.py`); here its wrapper's CPU path, its refusal of CPU
tensors and its choice between the chunked and the sequential kernel
are checked."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import repro.configs as jconfigs
from repro.kernels.scan.ref import selective_scan_ref as jscan_ref
from repro.kernels.scan.selective_scan import selective_scan as jpallas
from repro.models import ssm as jssm
from repro.models import transformer as jT
import repro_torch.configs as tconfigs
from repro_torch.kernels.scan import ops, ref, scan
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_numpy

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("s,d,n,chunk,dblk",
                         [(64, 32, 8, 16, 16), (128, 64, 16, 32, 32),
                          (32, 16, 4, 32, 16)])
def test_scan_ref_matches_reference_and_pallas(s, d, n, chunk, dblk):
    rng = np.random.default_rng(s + d + n)
    da = np.exp(-np.abs(rng.normal(size=(2, s, d, n)))).astype(np.float32)
    dbx = (rng.normal(size=(2, s, d, n)) * 0.1).astype(np.float32)
    c = rng.normal(size=(2, s, n)).astype(np.float32)
    got = ref.selective_scan_ref(_t(da), _t(dbx), _t(c)).numpy()
    want = np.asarray(jscan_ref(jnp.asarray(da), jnp.asarray(dbx),
                                jnp.asarray(c)))
    np.testing.assert_allclose(got, want, **TOL)
    pallas = np.asarray(jpallas(jnp.asarray(da), jnp.asarray(dbx),
                                jnp.asarray(c), chunk=chunk, d_block=dblk,
                                interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)


def test_scan_ref_long_memory():
    """Decay ~1 carries the state across many chunks exactly; the fused
    form with dt*a = log(0.999) gives the same."""
    s, d, n = 128, 8, 4
    da = np.full((1, s, d, n), 0.999, np.float32)
    dbx = np.zeros((1, s, d, n), np.float32)
    dbx[:, 0] = 1.0
    c = np.ones((1, s, n), np.float32)
    got = ref.selective_scan_ref(_t(da), _t(dbx), _t(c)).numpy()
    want = np.asarray(jscan_ref(jnp.asarray(da), jnp.asarray(dbx),
                                jnp.asarray(c)))
    pallas = np.asarray(jpallas(jnp.asarray(da), jnp.asarray(dbx),
                                jnp.asarray(c), chunk=16, d_block=8,
                                interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=1e-5)
    dt = torch.ones((1, s, d))
    x = torch.zeros((1, s, d))
    x[:, 0] = 1.0
    b = torch.ones((1, s, n))
    a = torch.full((d, n), float(np.log(np.float32(0.999))))
    # step 0 from h0 = 0: h = 0.999 * 0 + 1, as dbx[:, 0] = 1 above
    y, _ = ref.selective_scan_fused_ref(dt, x, b, _t(c), a)
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5)


@pytest.fixture(scope="module")
def layer():
    """Reduced falcon-mamba's first Mamba-1 block, the reference's
    weights on both sides, and an input of 2 x 32 tokens."""
    jcfg = jconfigs.get_reduced("falcon-mamba-7b")
    tcfg = tconfigs.get_reduced("falcon-mamba-7b")
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    jl = jax.tree.map(lambda a: a[0], jparams["layers"]["ssm"])
    tl = {k: v[0] for k, v in tparams["layers"]["ssm"].items()}
    x = np.random.default_rng(7).normal(
        size=(2, 32, tcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jl, tl, x


def test_fused_zero_state_matches_pallas_on_mamba1_inputs(layer):
    jcfg, tcfg, jl, tl, x = layer
    _, _, da, dbx, c_in, _ = jssm._mamba1_inputs(jl, jnp.asarray(x), jcfg,
                                                 None)
    want = np.asarray(jpallas(da, dbx, c_in, chunk=16, d_block=32,
                              interpret=True))
    xc, _, dt, b_in, c, a, _ = tssm._mamba1_pre(tl, _t(x), tcfg, None)
    y, h_t = ref.selective_scan_fused_ref(dt, xc.float(), b_in, c, a)
    np.testing.assert_allclose(y.numpy(), want, **TOL)
    assert tuple(h_t.shape) == (2, tcfg.d_inner, tcfg.ssm_state)
    # the dispatch and the wrapper take the plain version on the CPU
    y2, h2 = ops.selective_scan(dt, xc.float(), b_in, c, a)
    y3, h3 = scan.selective_scan_fused(dt, xc.float(), b_in, c, a)
    assert torch.equal(y2, y) and torch.equal(h2, h_t)
    assert torch.equal(y3, y) and torch.equal(h3, h_t)
    out = torch.empty_like(h_t)
    y4, h4 = scan.selective_scan_fused(dt, xc.float(), b_in, c, a,
                                       out_state=out)
    assert h4 is out and torch.equal(y4, y) and torch.equal(out, h_t)


def test_fused_with_state_matches_mamba1_scan_ref_state(layer):
    jcfg, tcfg, jl, tl, x = layer
    h0 = np.random.default_rng(8).normal(
        size=(2, tcfg.d_inner, tcfg.ssm_state)).astype(np.float32)
    _, want_h, _ = jssm.mamba1_scan_ref(jl, jnp.asarray(x), jcfg,
                                        ssm_state=jnp.asarray(h0))
    xc, _, dt, b_in, c, a, _ = tssm._mamba1_pre(tl, _t(x), tcfg, None)
    _, h_t = ops.selective_scan(dt, xc.float(), b_in, c, a, _t(h0))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(want_h), **TOL)
    # splitting the sequence and carrying the state changes nothing
    y1, h1 = ref.selective_scan_fused_ref(dt[:, :13], xc[:, :13].float(),
                                          b_in[:, :13], c[:, :13], a,
                                          _t(h0))
    y2, h2 = ref.selective_scan_fused_ref(dt[:, 13:], xc[:, 13:].float(),
                                          b_in[:, 13:], c[:, 13:], a, h1)
    y, _ = ref.selective_scan_fused_ref(dt, xc.float(), b_in, c, a, _t(h0))
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, **TOL)
    torch.testing.assert_close(h2, h_t, **TOL)


def test_use_kernel_true_on_cpu_raises(layer):
    _, tcfg, _, tl, x = layer
    scan.reset_launches()
    z = torch.zeros((1, 4, 8))
    bc = torch.zeros((1, 4, 2))
    with pytest.raises(ValueError, match="CUDA"):
        ops.selective_scan(z, z, bc, bc, torch.zeros((8, 2)),
                           use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        tssm.mamba1_chunked(tl, _t(x), tcfg, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        tssm.mamba1_scan_ref(tl, _t(x), tcfg, use_kernel=True)
    assert scan.LAUNCHES == {"selective_scan": 0}


def test_scan_kernel_choice():
    """`scan.use_chunked`: a prompt runs the chunked kernel; a decode
    step, and rows it cannot copy 16 bytes at a time or a state too
    large for its shared memory, the sequential one."""
    assert scan.use_chunked(256, 8192, 16, 0, 1 << 20, 2 << 20)
    assert scan.use_chunked(2, 4, scan.CHUNKED_MAX_STATE, 16, 32)
    assert not scan.use_chunked(1, 8192, 16, 0, 1 << 20)
    assert not scan.use_chunked(256, 8190, 16, 0, 1 << 20)
    assert not scan.use_chunked(256, 8192, 64, 0, 1 << 20)
    assert not scan.use_chunked(256, 8192, 16, 0, (1 << 20) + 4)
