"""The port's AMR physics and compiled uniform engine (`repro_torch.amr`)
against the reference's (`repro.amr`), on the same numpy inputs:
`initial_data`, `grid`, `rhs`, `fused_rk3_block` (no, left, right and
both physical sides), its numpy twin, `global_step`, `energy`, `linf`,
and `make_uniform_step` at 1 and 4 localities, 4 slots of grain 32, 6
steps, 1 and 2 steps per exchange, against the reference's
`reference_uniform` and, at one locality, the reference's own
`make_uniform_step` on a (1, 1) mesh with the jnp and the Pallas
(interpret mode) stencil.  atol 1e-6, the reference's stencil and
compiled-engine tolerance (`test_kernels.py:33`,
`test_distributed.py:42`)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.amr import compiled as jc
from repro.amr import wave as jw
from repro.distributed.compat import make_mesh
from repro_torch.amr import compiled as tc
from repro_torch.amr import wave as tw

TOL = dict(atol=1e-6, rtol=0)
PROB = dict(rmax=20.0, amplitude=0.005)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _block(seed, g=32, scale=0.1, dr=0.05):
    rng = np.random.default_rng(seed)
    u = (rng.normal(size=(3, g + 2 * tw.H)) * scale).astype(np.float32)
    r = (np.arange(-tw.H, g + tw.H) * dr).astype(np.float32)
    return u, r


def test_constants_and_problem_match_reference():
    assert (tw.H, tw.NFIELDS) == (jw.H, jw.NFIELDS)
    np.testing.assert_array_equal(tw.SIGNS, jw.SIGNS)
    a, b = tw.WaveProblem(**PROB), jw.WaveProblem(**PROB)
    assert (a.dr, a.dt, a.p) == (b.dr, b.dt, b.p)
    assert a.torch_dtype() == torch.float32


@pytest.mark.parametrize("offset", [0, 100])
def test_initial_data_and_grid_match_reference(offset):
    tp, jp = tw.WaveProblem(**PROB), jw.WaveProblem(**PROB)
    got = tw.initial_data(tp, n=200, offset=offset, device="cpu").numpy()
    want = np.asarray(jw.initial_data(jp, n=200, offset=offset))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(
        tw.grid(tp, n=200, offset=offset, device="cpu").numpy(),
        np.asarray(jw.grid(jp, n=200, offset=offset)))


@pytest.mark.parametrize("p", [1, 3, 7])
def test_rhs_matches_reference(p):
    u, r = _block(p)
    got = tw.rhs(torch.from_numpy(u), torch.from_numpy(r), 0.05, p).numpy()
    want = np.asarray(jw.rhs(jnp.asarray(u), jnp.asarray(r), 0.05, p))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("left,right", [(False, False), (True, False),
                                        (False, True), (True, True)])
def test_fused_rk3_block_matches_reference(left, right):
    u, r = _block(11)
    got = tw.fused_rk3_block(torch.from_numpy(u), torch.from_numpy(r),
                             0.05, 0.01, 7, left, right).numpy()
    want = np.asarray(jw.fused_rk3_block(jnp.asarray(u), jnp.asarray(r),
                                         0.05, 0.01, 7, left, right))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        tw.fused_rk3_block_np(u, r, 0.05, 0.01, 7, left, right), want, **TOL)
    # the masked (tensor) form of the flags, as a batch of blocks takes them
    got = tw.fused_rk3_block(torch.from_numpy(u), torch.from_numpy(r),
                             0.05, 0.01, 7, torch.tensor(left),
                             torch.tensor(right)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_global_step_energy_linf_match_reference():
    jp = jw.WaveProblem(**PROB, n_points=256)
    n = 256
    dr, dt = jp.dr, jp.dt
    u0 = np.array(jw.initial_data(jp))
    r = (np.arange(n) * dr).astype(np.float32)
    tu, ju = torch.from_numpy(u0), jnp.asarray(u0)
    for _ in range(3):
        tu = tw.global_step(tu, torch.from_numpy(r), dr, dt, jp.p)
        ju = jw.global_step(ju, jnp.asarray(r), dr, dt, jp.p)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL)
    np.testing.assert_allclose(
        tw.energy(tu, torch.from_numpy(r), dr).item(),
        float(jw.energy(ju, jnp.asarray(r), dr)), rtol=1e-5)
    np.testing.assert_allclose(tw.linf(tu).item(), float(jw.linf(ju)),
                               rtol=1e-6)


def _port_uniform(n_loc, k, **kw):
    cfg = tc.CompiledAMRConfig(grain=32, slots=4, n_steps=6,
                               steps_per_exchange=k, **kw)
    step, mk, init, to_g, dev, info = tc.make_uniform_step(
        tw.WaveProblem(**PROB), cfg, n_loc, device="cpu")
    pool = init()
    assert mk() == (tuple(pool.shape), pool.dtype) == \
        ((n_loc, 4, 3, 32), torch.float32)
    assert dev == torch.device("cpu")
    return to_g(step(pool)).numpy(), info


@pytest.mark.parametrize("n_loc", [1, 4])
@pytest.mark.parametrize("k", [1, 2])
def test_make_uniform_step_matches_reference_uniform(n_loc, k):
    got, info = _port_uniform(n_loc, k)
    assert info["n_points"] == n_loc * 4 * 32
    want = jc.reference_uniform(jw.WaveProblem(**PROB), info["n_points"], 6,
                                info["dr"], info["dt"])
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    port_ref = tc.reference_uniform(tw.WaveProblem(**PROB), info["n_points"],
                                    6, info["dr"], info["dt"], device="cpu")
    np.testing.assert_allclose(port_ref.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("k", [1, 2])
def test_make_uniform_step_matches_reference_engine(use_pallas, k):
    """At one locality the reference's engine runs on a (1, 1) mesh of
    the one CPU device; with `use_pallas` its stencil is the Pallas
    kernel in interpret mode."""
    mesh = make_mesh((1, 1), ("data", "model"))
    cfg = jc.CompiledAMRConfig(grain=32, slots=4, n_steps=6,
                               steps_per_exchange=k, use_pallas=use_pallas)
    step, _, init, to_g, _, info = jc.make_uniform_step(
        jw.WaveProblem(**PROB), cfg, mesh, ("data", "model"))
    want = np.asarray(to_g(jax.jit(step)(init())))
    got, tinfo = _port_uniform(1, k)
    assert (tinfo["dr"], tinfo["dt"]) == (info["dr"], info["dt"])
    np.testing.assert_allclose(got, want, **TOL)


def test_assemble_halos_is_the_ring_of_blocks():
    """The two parcel legs and the pool-neighbour halos put, around each
    block, the cells of the previous and next block of the flattened
    ring."""
    pool = torch.arange(2 * 3 * 3 * 8, dtype=torch.float32).reshape(
        2, 3, 3, 8)
    flat = pool.reshape(6, 3, 8)
    got = tc.assemble_halos(pool, 2)
    want = torch.cat([torch.roll(flat, 1, 0)[..., -2:], flat,
                      torch.roll(flat, -1, 0)[..., :2]], dim=-1)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_config_errors_match_reference():
    prob = tw.WaveProblem(**PROB)
    with pytest.raises(ValueError, match="multiple of steps_per_exchange"):
        tc.make_uniform_step(prob, tc.CompiledAMRConfig(
            grain=32, slots=4, n_steps=5, steps_per_exchange=2), 1,
            device="cpu")
    with pytest.raises(ValueError, match="halo exceeds grain"):
        tc.make_uniform_step(prob, tc.CompiledAMRConfig(
            grain=8, slots=4, n_steps=6, steps_per_exchange=3), 1,
            device="cpu")


def test_use_kernel_true_refuses_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        _port_uniform(1, 1, use_kernel=True)
