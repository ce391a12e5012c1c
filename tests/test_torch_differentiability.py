"""Port vs JAX: reverse-mode gradients through the port's compute paths
(tests/test_differentiability.py for JAX), and the CUDA wrappers' grad
guard.

``torch.autograd.grad`` through the port's ``sw_simulate`` (plain
Richtmyer) and ``lw_flux_plain`` on the CPU in f64 equals ``jax.grad`` of
the same functions on the same inputs within 1e-10 relative (of the
gradient's largest entry), and passes the JAX test's own central-difference
check (2e-4 and 1e-5 relative).  The CUDA kernels have no backward, so
their wrappers refuse an input that requires grad while grad mode is on
(checked here on CPU tensors: the guard comes before the device check; on
the card by ``chip_smoke.py``'s ``grad`` phase).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climatemodel_tpu.constants import p_surface_earth
from climatemodel_tpu.models.grey import GreyGas as JGreyGas
from climatemodel_tpu.models.shallow_water import ShallowWater as JSW
from climatemodel_tpu.models.shallow_water import sw_simulate as jsw_simulate
from climatemodel_tpu.ops.two_stream import lw_flux_plain as jlw_flux_plain
from climatemodel_tpu_torch.models.grey import GreyGas as PGreyGas
from climatemodel_tpu_torch.models.shallow_water import ShallowWater as PSW
from climatemodel_tpu_torch.models.shallow_water import sw_simulate
from climatemodel_tpu_torch.ops import cuda_convection, cuda_stencils
from climatemodel_tpu_torch.ops import cuda_two_stream
from climatemodel_tpu_torch.ops.two_stream import lw_flux_plain

F64 = torch.float64

# the world of tests/test_differentiability.py:35-40
SW_ARGS = dict(nx=18, ny=12, dx=100e3, dy=100e3, dt=60.0, f_0=1e-4,
               beta=1.6e-11,
               initial_info={'type': 'height_gaussian',
                             'min_h_surface': 9750.0,
                             'max_h_surface': 10750.0, 'x0': 0.0, 'y0': 0.0,
                             'x_std': 400e3, 'y_std': 400e3,
                             'add_noise': False})
SW_IDXS = [5 * 12 + 6, 9 * 12 + 6, 0]


def _fd_check(f, grad, x0, idxs, rtol, eps_scale=1e-4):
    """Central finite differences of the port's ``f`` against its gradient
    at selected flat indices (the JAX test's ``_fd_check``)."""
    g = grad.detach().numpy().ravel()
    x_flat = x0.detach().numpy().ravel()
    for i in idxs:
        eps = eps_scale * max(1.0, abs(x_flat[i]))
        xp = x_flat.copy()
        xp[i] += eps
        xm = x_flat.copy()
        xm[i] -= eps
        with torch.no_grad():
            fp = float(f(torch.from_numpy(xp.reshape(x0.shape))))
            fm = float(f(torch.from_numpy(xm.reshape(x0.shape))))
        fd = (fp - fm) / (2 * eps)
        assert abs(g[i] - fd) <= rtol * max(abs(fd), 1e-8), (i, g[i], fd)


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), \
        np.abs(got - want).max() / np.abs(want).max()


def _sw_worlds():
    jw = JSW(**SW_ARGS)
    pw = PSW(**SW_ARGS, dtype=F64, device='cpu')
    return jw, pw


def test_grad_through_shallow_water_steps_equals_jax():
    """d(height variance after 5 plain Richtmyer steps)/d(initial height):
    the port's adjoint equals JAX's within 1e-10 relative and passes the
    JAX test's finite-difference check (2e-4)."""
    jw, pw = _sw_worlds()
    kw = jw._step_kwargs()
    assert kw['solver'] == 'richtmyer'
    h0_np = np.asarray(jw.state.h, np.float64)
    np.testing.assert_array_equal(pw.state.h.numpy(), h0_np)
    h_mean_j = jnp.mean(jw.state.h)

    def jloss(h0):
        out = jsw_simulate(jw.state.replace(h=h0), jw.params, 5, **kw)
        return jnp.sum((out.h[1:-1, 1:-1] - h_mean_j) ** 2) / h0.size

    g_jax = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(h0_np)))

    pkw = pw._step_kwargs()
    h_mean_p = pw.state.h.mean()

    def ploss(h0):
        out = sw_simulate(pw.state.replace(h=h0), pw.params, 5, **pkw)
        return ((out.h[1:-1, 1:-1] - h_mean_p) ** 2).sum() / h0.numel()

    h0 = torch.from_numpy(h0_np.copy()).requires_grad_()
    (g_port,) = torch.autograd.grad(ploss(h0), h0)
    assert g_port.dtype == F64
    _close(g_port.numpy(), g_jax, 1e-10)
    _fd_check(ploss, g_port, h0, SW_IDXS, rtol=2e-4)


def test_grad_through_grey_radiation_equals_jax():
    """d(OLR)/dT through ``lw_flux_plain`` (the differentiable route; the
    kernel dispatcher ``lw_flux`` has none, as in JAX): equal to JAX's
    within 1e-10 relative, and the finite-difference check of
    tests/test_differentiability.py:71 (1e-5, eps 1e-3)."""
    args = dict(nz=40, ny=1, tau_lw_func='scale_height',
                tau_lw_func_args=[0.22 * p_surface_earth, 4.0])
    jw = JGreyGas(**args, dtype=jnp.float64)
    dtau = np.asarray(jw.forcing.dtau, np.float64)[:, 0]
    T0 = np.asarray(jw.T[:, 0], np.float64) + np.asarray(
        jnp.linspace(30.0, -30.0, jw.nz - 1))
    pw = PGreyGas(**args, dtype=F64, device='cpu')
    np.testing.assert_array_equal(pw.forcing.dtau[0, :, 0].numpy(), dtau)

    def jolr(T):
        up, _down = jlw_flux_plain(T, jnp.asarray(dtau),
                                   jnp.asarray(240.0, jnp.float64))
        return up[-1]

    g_jax = np.asarray(jax.jit(jax.grad(jolr))(jnp.asarray(T0)))

    dtau_t = torch.from_numpy(dtau)
    toa = torch.tensor(240.0, dtype=F64)

    def polr(T):
        up, _down = lw_flux_plain(T, dtau_t, toa)
        return up[-1]

    T = torch.from_numpy(T0.copy()).requires_grad_()
    (g_port,) = torch.autograd.grad(polr(T), T)
    _close(g_port.numpy(), g_jax, 1e-10)
    _fd_check(polr, g_port, T, [0, 10, 38], rtol=1e-5, eps_scale=1e-3)


def _kernel_calls():
    """Each CUDA wrapper with small CPU inputs, and the plain route its
    refusal names."""
    z = lambda *s: torch.zeros(s, dtype=torch.float32)  # noqa: E731
    one = torch.ones((), dtype=torch.float32)
    return [
        ('lw_walk', 'lw_flux_plain', cuda_two_stream.lw_walk,
         (z(4, 2), z(4, 2), z(2))),
        ('net_stats_walk', 'lw_flux_plain', cuda_two_stream.net_stats_walk,
         (z(2, 4), z(2, 4), z(2, 5), z(2, 5), z(2), z(2, 5), 2)),
        ('iso_fit', 'iso_rows_plain', cuda_convection.iso_fit,
         (z(2, 4), torch.ones(4))),
        ('div_probe', 'div_probe_plain', cuda_convection.div_probe,
         (z(4), torch.ones(4))),
        ('richtmyer_step', "solver='richtmyer'", cuda_stencils.richtmyer_step,
         (z(5, 5), z(5, 5), z(5, 5), z(3, 3), z(3, 3), None, None, one,
          torch.ones((), dtype=torch.bool), one, one, one)),
    ]


@pytest.mark.parametrize('case', range(5))
def test_cuda_wrappers_refuse_inputs_that_require_grad(case):
    """Under grad mode an input that requires grad raises RuntimeError
    naming the differentiable plain route, before anything else is checked;
    detached (or under no_grad) the same call goes on to the device check,
    which refuses a CPU tensor with ValueError."""
    name, plain, fn, args = _kernel_calls()[case]
    for k in range(len(args)):
        if not isinstance(args[k], torch.Tensor) or \
                not args[k].is_floating_point():
            continue
        graded = list(args)
        graded[k] = args[k].clone().requires_grad_()
        with pytest.raises(RuntimeError, match=f'{name}.*no backward.*'
                           + plain.replace('(', r'\(')):
            fn(*graded)
        with torch.no_grad(), pytest.raises(ValueError, match='CUDA'):
            fn(*graded)
    with pytest.raises(ValueError, match='CUDA'):
        fn(*args)
