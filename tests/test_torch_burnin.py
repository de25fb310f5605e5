"""The port's burn-in forward pass against the reference's on the same
JAX-initialised parameters and numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_operator.ops.burnin import BurninConfig as JaxConfig
from tpu_operator.ops.burnin import burnin_forward, init_burnin as jax_init
from tpu_operator_torch.entry import entry
from tpu_operator_torch.ops.burnin import (BurninConfig, BurninModel,
                                           init_burnin, params_from_jax)
from tpu_operator_torch.parallel.numerics import (residual_limit,
                                                  residual_tolerance)

SMALL = dict(d_model=64, d_hidden=128, n_layers=2, batch=8)
X = np.random.default_rng(3).standard_normal(
    (SMALL["batch"], SMALL["d_model"]), dtype=np.float32)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _jax_params(jdt):
    params = jax_init(JaxConfig(**SMALL, dtype=jdt))
    return {name: np.asarray(a) for name, a in params.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    jdt, tdt = DTYPES[dtype]
    params = _jax_params(jdt)
    want = np.asarray(burnin_forward(params, jnp.asarray(X, jdt)),
                      np.float32)
    model = params_from_jax(params, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(X).to(tdt))
    assert got.dtype == tdt and got.shape == X.shape
    # f32 is tight (gelu's tanh approximation matters at this precision);
    # bf16 allows a few unit roundoffs of 2^-8 per layer
    tol = residual_tolerance(tdt, SMALL["n_layers"], SMALL["d_hidden"])
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * scale)


def test_params_from_jax_is_lossless():
    params = _jax_params(jnp.bfloat16)
    model = params_from_jax(params, device="cpu")
    for name in ("w_in", "w_out"):
        tensor = getattr(model, name)
        assert tensor.dtype == torch.bfloat16
        np.testing.assert_array_equal(tensor.detach().float().numpy(),
                                      np.asarray(params[name], np.float32))
    assert model.w_in.shape == (2, 64, 128) and model.w_out.shape == \
        (2, 128, 64)


def test_init_is_seeded_and_shaped():
    cfg = BurninConfig(**SMALL)
    a, b = (init_burnin(cfg, seed=5, device="cpu") for _ in range(2))
    torch.testing.assert_close(a.w_in, b.w_in)
    assert not torch.equal(a.w_in,
                           init_burnin(cfg, seed=6, device="cpu").w_in)
    assert a.w_in.shape == (2, 64, 128) and a.w_in.dtype == torch.bfloat16
    # scaled by 1/sqrt(fan-in), as in the reference
    assert abs(a.w_in.float().std().item() - 64 ** -0.5) < 0.02


def test_model_rejects_mismatched_weights():
    with pytest.raises(ValueError, match="w_in"):
        BurninModel(torch.zeros(2, 64, 128), torch.zeros(2, 64, 128))


def test_entry_runs_at_full_width_on_an_explicit_cpu():
    fn, (x,) = entry(device="cpu")
    cfg = BurninConfig()
    assert (cfg.d_model, cfg.d_hidden, cfg.n_layers, cfg.batch) == \
        (512, 2048, 4, 32)
    assert x.shape == (cfg.batch, cfg.d_model) and x.dtype == torch.bfloat16
    with torch.no_grad():
        y = fn(x)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())


def test_bf16_forward_within_the_per_element_limit_of_f32():
    """At full width, the bf16 forward lies within ``residual_limit`` of
    the same weights in f32, and a forward without its last layer does
    not."""
    cfg = BurninConfig()
    model, (x,) = entry(device="cpu")
    with torch.no_grad():
        got = model(x).float()
        w_in, w_out = model.w_in.float(), model.w_out.float()
        want = BurninModel(w_in, w_out)(x.float())
        short = BurninModel(w_in[:-1], w_out[:-1])(x.float())
    limit = residual_limit(want, cfg.dtype, cfg.n_layers)
    assert bool(((got - want).abs() <= limit).all())
    assert not bool(((short - want).abs() <= limit).all())


def test_flops_per_step_matches_reference():
    assert BurninConfig(**SMALL).flops_per_step() == \
        JaxConfig(**SMALL).flops_per_step()
