"""The port's RK3 stencil plain version (`repro_torch.kernels.stencil`)
against the reference's: its `stencil_rk3_ref` and the Pallas
`stencil_rk3` run in interpret mode, at `test_kernels.py`'s grains
(8, 32, 128), batches (1, 4) and powers (1, 3, 7), with the first
block's left side and the last block's right side physical; the
wrapper's CPU path and `ops.stencil_rk3_step`'s mask packing; atol
1e-6, the reference's stencil tolerance (`test_kernels.py:33`).  The
CUDA kernel itself runs only on the card (`test_torch_cuda.py`,
`chip_smoke.py`); here its refusal of CPU tensors is checked."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.kernels.stencil.ref import stencil_rk3_ref as jref
from repro.kernels.stencil.stencil import H as JH
from repro.kernels.stencil.stencil import stencil_rk3 as jpallas
from repro_torch.amr.wave import H
from repro_torch.kernels.stencil import ops, ref, stencil

TOL = dict(atol=1e-6, rtol=0)
# one XLA program per shape and power instead of one per operation
jref_jit = jax.jit(jref, static_argnames=("dr", "dt", "p"))


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _inputs(grain, nb, seed, scale=0.01, dr=0.05):
    rng = np.random.default_rng(seed)
    u = (rng.normal(size=(nb, 3, grain + 2 * H)) * scale).astype(np.float32)
    r = np.stack([(np.arange(-H, grain + H) + b * grain) * dr
                  for b in range(nb)]).astype(np.float32)
    flags = np.zeros((nb, 2), np.int32)
    flags[0, 0] = 1
    flags[-1, 1] = 1
    return u, r, flags


def test_halo_width_matches_reference():
    assert H == JH == 3


@pytest.mark.parametrize("grain", [8, 32, 128])
@pytest.mark.parametrize("nb", [1, 4])
@pytest.mark.parametrize("p", [1, 3, 7])
def test_stencil_ref_matches_reference_and_pallas(grain, nb, p):
    u, r, flags = _inputs(grain, nb, seed=grain + nb + p)
    kw = dict(dr=0.05, dt=0.01, p=p)
    got = ref.stencil_rk3_ref(torch.from_numpy(u), torch.from_numpy(r),
                              torch.from_numpy(flags), **kw).numpy()
    want = np.asarray(jref_jit(jnp.asarray(u), jnp.asarray(r),
                               jnp.asarray(flags), **kw))
    np.testing.assert_allclose(got, want, **TOL)
    pallas = np.asarray(jpallas(jnp.asarray(u), jnp.asarray(r),
                                jnp.asarray(flags), interpret=True, **kw))
    np.testing.assert_allclose(got, pallas, **TOL)


def test_every_flag_pattern_and_scale_matches_reference():
    """Blocks with no, left, right and both physical sides in one batch,
    at input scales 0.01 and 0.1 (test_kernels.py's two scales)."""
    for scale in (0.01, 0.1):
        u, r, _ = _inputs(32, 4, seed=7, scale=scale, dr=0.1)
        flags = np.asarray([[0, 0], [1, 0], [0, 1], [1, 1]], np.int32)
        kw = dict(dr=0.1, dt=0.02, p=7)
        got = ref.stencil_rk3_ref(torch.from_numpy(u), torch.from_numpy(r),
                                  torch.from_numpy(flags), **kw).numpy()
        want = np.asarray(jref_jit(jnp.asarray(u), jnp.asarray(r),
                                   jnp.asarray(flags), **kw))
        np.testing.assert_allclose(got, want, **TOL)


def test_wrapper_cpu_path_and_ops_packing():
    u, r, flags = _inputs(32, 4, seed=3)
    kw = dict(dr=0.05, dt=0.01, p=7)
    tu, tr, tf = (torch.from_numpy(a) for a in (u, r, flags))
    want = ref.stencil_rk3_ref(tu, tr, tf, **kw)
    stencil.reset_launches()
    got = stencil.stencil_rk3(tu, tr, tf, **kw)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert stencil.LAUNCHES["stencil_rk3"] == 0     # no kernel ran
    left = tf[:, 0].bool()[:, None, None]
    right = tf[:, 1].bool()[:, None, None]
    got = ops.stencil_rk3_step(tu, tr, left, right, **kw)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    # a strided r_ext slice, as the K > 1 steps of the compiled engine see
    wide = torch.cat([tr[:, :1] - 0.05, tr, tr[:, -1:] + 0.05], dim=1)
    got = ops.stencil_rk3_step(tu, wide[:, 1:-1], left, right, **kw)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_use_kernel_true_refuses_cpu_tensors():
    u, r, flags = _inputs(8, 1, seed=1)
    tu, tr = torch.from_numpy(u), torch.from_numpy(r)
    mask = torch.ones((1, 1, 1), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        ops.stencil_rk3_step(tu, tr, mask, mask, dr=0.05, dt=0.01, p=7,
                             use_kernel=True)
