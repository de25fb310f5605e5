"""The port's train steps against the reference's ``make_train_step`` and
``make_sharded_train_step``, on the same JAX-initialised parameters and
numpy inputs.

Tolerances, derived rather than picked:

- forward and loss: each side's bf16 output lies within
  ``residual_limit`` of the same model in f32, so each loss lies within
  2·rms(pred − y)·rms(limit) + rms(limit)² of the f32 loss;
- gradients: each weight gradient gathers the roundings of the forward and
  of the backward through the layers, about 16 independent roundings per
  layer (forward: two matmul outputs, the activation, the residual sum;
  backward: the two activation-gradient products, the activation's
  derivative, the weight product; each counted on the way in and out), so
  ``residual_limit`` with 16·L layers, plus f32 accumulation noise over the
  widest reduction as ``residual_tolerance`` counts it;
- parameters after one AdamW step: the first step is lr·g/(|g| + eps), close
  to lr·sign(g). Each side's gradient lies within its limit ℓ of the f32
  one, g. Where |g| > 2ℓ both sides agree on the sign and differ by their
  own rounding of the parameter, the step's relative rounding times lr,
  and the step's sensitivity to the gradient, at most lr·eps·2ℓ/(|g| − ℓ)².
  The relative rounding: the moments stored in the parameters' dtype
  (u for the first, u/2 for the root of the second), the bias corrections
  1 − β^t cast to that dtype by optax (u and u/2 again), and those
  corrections computed in f32, where β itself is rounded: u₃₂·β/(1 − β)
  for the first, half of it for the second. Elsewhere the two sides may
  step in opposite directions: 2·lr plus the rounding.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_operator.ops import burnin as jax_burnin
from tpu_operator.parallel.mesh import MeshPlan as JaxPlan
from tpu_operator.parallel.mesh import make_mesh as jax_make_mesh
from tpu_operator_torch.ops import burnin
from tpu_operator_torch.parallel import collectives
from tpu_operator_torch.parallel.mesh import MeshPlan, make_mesh
from tpu_operator_torch.parallel.numerics import (effective_matmul_eps,
                                                  residual_limit)

SMALL = dict(d_model=64, d_hidden=128, n_layers=2, batch=8)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CPU = torch.device("cpu")
F32_EPS = float(torch.finfo(torch.float32).eps)


def _case(dtype, seed=0):
    """The reference's parameters and a numpy batch, both packages'
    configs."""
    jdt, tdt = DTYPES[dtype]
    jcfg = jax_burnin.BurninConfig(**SMALL, dtype=jdt)
    tcfg = burnin.BurninConfig(**SMALL, dtype=tdt)
    params = {k: np.asarray(v) for k, v in
              jax_burnin.init_burnin(jcfg, jax.random.PRNGKey(seed)).items()}
    rng = np.random.default_rng(seed)
    x = np.asarray(jnp.asarray(
        rng.standard_normal((SMALL["batch"], SMALL["d_model"]),
                            dtype=np.float32), jdt))
    y = rng.standard_normal((SMALL["batch"], SMALL["d_model"]),
                            dtype=np.float32)
    return jcfg, tcfg, params, x, y


def _torch(params, x, y):
    t = {k: burnin._tensor_from_numpy(v, CPU) for k, v in params.items()}
    return t, burnin._tensor_from_numpy(x, CPU), torch.from_numpy(y)


def _f32(params, x, y):
    """The port's loss, gradients and prediction in f32 on the same
    values: the yardstick both sides are held to."""
    t, tx, ty = _torch(params, x, y)
    leaves = burnin._leaves({k: v.float() for k, v in t.items()})
    pred = burnin.burnin_forward(leaves, tx.float())
    loss = (pred - ty).square().mean()
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    return loss.item(), grads, pred.detach()


def _loss_tol(pred32, y, dtype):
    limit = residual_limit(pred32, dtype, SMALL["n_layers"])
    rms_limit = limit.square().mean().sqrt().item()
    rms_err = (pred32 - torch.from_numpy(y)).square().mean().sqrt().item()
    return 2 * rms_err * rms_limit + rms_limit ** 2


def _grad_limit(g32, dtype):
    rms = g32.square().mean().sqrt()
    return (residual_limit(g32, dtype, 16 * SMALL["n_layers"])
            + 32 * F32_EPS * math.sqrt(SMALL["d_hidden"]) * rms)


def _assert_adam_rule(got, want, g32, dtype, lr, tx=burnin.AdamW(1e-3)):
    """``got`` and ``want`` are the parameters after one step."""
    u = effective_matmul_eps(dtype)
    got, want = got.float(), want.float()
    rounding = u * (got.abs() + want.abs())
    limit = _grad_limit(g32, dtype)
    sure = g32.abs() > 2 * limit
    step_rel = 3 * u + F32_EPS * (tx.b1 / (1 - tx.b1)
                                  + tx.b2 / (1 - tx.b2) / 2)
    sensitivity = lr * tx.eps * 2 * limit / (g32.abs() - limit).square()
    err = (got - want).abs()
    assert bool((err[sure] <= (rounding + lr * step_rel
                               + sensitivity)[sure]).all())
    assert bool((err <= rounding + 2 * lr).all())
    assert sure.float().mean().item() > 0.5   # the rule is not vacuous


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_single_device_step_matches_the_reference(dtype):
    jcfg, tcfg, params, x, y = _case(dtype)
    jdt, tdt = DTYPES[dtype]
    jstep, jtx = jax_burnin.make_train_step(jcfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    j_loss, j_grads = jax.value_and_grad(jax_burnin._loss)(
        jp, jnp.asarray(x), jnp.asarray(y))
    j_params, _, _ = jstep(jp, jtx.init(jp), jnp.asarray(x), jnp.asarray(y))

    step, tx = burnin.make_train_step(tcfg)
    t_params, t_x, t_y = _torch(params, x, y)
    leaves = burnin._leaves(t_params)
    t_loss = burnin._loss(leaves, t_x, t_y)
    t_grads = dict(zip(leaves, torch.autograd.grad(
        t_loss, list(leaves.values()))))
    new, state, loss = step(t_params, tx.init(t_params), t_x, t_y)
    assert state["count"] == 1 and loss.item() == t_loss.item()

    loss32, g32, pred32 = _f32(params, x, y)
    tol = _loss_tol(pred32, y, tdt)
    assert abs(float(j_loss) - loss32) <= tol
    assert abs(t_loss.item() - loss32) <= tol
    for k in ("w_in", "w_out"):
        limit = _grad_limit(g32[k], tdt)
        for g in (torch.from_numpy(np.asarray(j_grads[k], np.float32)),
                  t_grads[k].float()):
            assert bool(((g - g32[k]).abs() <= limit).all()), k
        assert new[k].dtype == tdt
        _assert_adam_rule(new[k], torch.from_numpy(
            np.asarray(j_params[k], np.float32)), g32[k], tdt,
            tcfg.learning_rate)


def test_adam_rule_rejects_a_step_in_the_wrong_direction():
    _, tcfg, params, x, y = _case("bfloat16")
    step, tx = burnin.make_train_step(tcfg)
    t_params, t_x, t_y = _torch(params, x, y)
    new, _, _ = step(t_params, tx.init(t_params), t_x, t_y)
    _, g32, _ = _f32(params, x, y)
    lr = tcfg.learning_rate
    wrong = t_params["w_in"].float() + lr * torch.sign(g32["w_in"])
    with pytest.raises(AssertionError):
        _assert_adam_rule(new["w_in"], wrong, g32["w_in"], torch.bfloat16,
                          lr)


def test_adamw_uses_optax_defaults():
    tx = burnin.AdamW(1e-3)
    assert (tx.b1, tx.b2, tx.eps, tx.weight_decay) == (0.9, 0.999, 1e-8,
                                                       1e-4)


def _jax_sharded(plan, dtype="bfloat16"):
    """The reference's sharded step on its (data, model) mesh: its own
    parameters and batch as numpy, and the parameters (numpy, f32) and loss
    after one step."""
    jcfg, tcfg, _, _, _ = _case(dtype)
    mesh = jax_make_mesh(plan[0] * plan[1], JaxPlan(*plan))
    step, params, opt_state, x, y = jax_burnin.make_sharded_train_step(
        jcfg, mesh)
    arrays = ({k: np.asarray(v) for k, v in params.items()},
              np.asarray(x), np.asarray(y))
    new, _, loss = step(params, opt_state, x, y)
    return (tcfg, arrays, {k: np.asarray(v, np.float32)
                           for k, v in new.items()}, float(loss))


def _gathered(new, group):
    """The whole parameters held by one model group after a sharded step."""
    return {"w_in": torch.cat([new[r]["w_in"] for r in group], dim=2),
            "w_out": torch.cat([new[r]["w_out"] for r in group], dim=1)}


def test_sharded_loss_matches_single_device_and_reference():
    """On (2, 2): the port's sharded loss, its single-device loss and the
    reference's sharded loss all lie within the bf16 limit of the f32
    loss (the port's analogue of ``test_ops.py:60``), and the port's
    sharded parameters after the step are held to the reference's sharded
    step's under the Adam rule."""
    tcfg, (params, x, y), jax_new, jax_loss = _jax_sharded((2, 2))
    mesh = make_mesh(4, MeshPlan(2, 2), device="cpu")
    state = burnin.sharded_state_from_jax(params, x, y, mesh, tcfg)
    step = burnin.make_sharded_step(mesh, burnin.AdamW(tcfg.learning_rate))
    new, _, sharded_loss = step(*state)
    single, tx = burnin.make_train_step(tcfg)
    t_params, t_x, t_y = _torch(params, x, y)
    _, _, single_loss = single(t_params, tx.init(t_params), t_x, t_y)
    loss32, g32, pred32 = _f32(params, x, y)
    tol = _loss_tol(pred32, y, torch.bfloat16)
    for loss in (sharded_loss.item(), single_loss.item(), jax_loss):
        assert abs(loss - loss32) <= tol, (loss, loss32, tol)
    for group in mesh.groups("model"):
        got = _gathered(new, group)
        for k in ("w_in", "w_out"):
            assert got[k].dtype == torch.bfloat16
            _assert_adam_rule(got[k], torch.from_numpy(jax_new[k]), g32[k],
                              torch.bfloat16, tcfg.learning_rate)


@pytest.mark.parametrize("plan", [(2, 2), (1, 4), (4, 1), (2, 4)])
def test_sharded_step_matches_single_device_step(plan):
    """In f32 the sharded step computes the single-device step: the loss
    to f32 rounding, the parameters under the Adam rule, and every data
    replica of a shard holds the same parameters."""
    _, tcfg, params, x, y = _case("float32")
    mesh = make_mesh(plan[0] * plan[1], MeshPlan(*plan), device="cpu")
    tx = burnin.AdamW(tcfg.learning_rate)
    state = burnin.sharded_state_from_jax(params, x, y, mesh, tcfg)
    new, opt, loss = burnin.make_sharded_step(mesh, tx)(*state)
    single, _ = burnin.make_train_step(tcfg)
    t_params, t_x, t_y = _torch(params, x, y)
    want, _, want_loss = single(t_params, tx.init(t_params), t_x, t_y)
    loss32, g32, pred32 = _f32(params, x, y)
    assert abs(loss.item() - want_loss.item()) <= \
        2 * _loss_tol(pred32, y, torch.float32)
    model_groups = mesh.groups("model")
    for group in model_groups:
        got = _gathered(new, group)
        assert torch.equal(got["w_in"],
                           _gathered(new, model_groups[0])["w_in"])
        for k in ("w_in", "w_out"):
            _assert_adam_rule(got[k], want[k], g32[k], torch.float32,
                              tcfg.learning_rate)
    assert all(s["count"] == 1 for s in opt)


@pytest.mark.parametrize("plan", [(2, 2), (2, 4), (4, 2), (1, 4), (4, 1),
                                  (1, 1)])
def test_collective_log_holds_the_exact_groupings(plan):
    data, model = plan
    n = data * model
    _, tcfg, params, x, y = _case("bfloat16")
    mesh = make_mesh(n, MeshPlan(data, model), device="cpu")
    state = burnin.sharded_state_from_jax(params, x, y, mesh, tcfg)
    step = burnin.make_sharded_step(mesh, burnin.AdamW(tcfg.learning_rate))
    with collectives.recording() as log:
        step(*state)
    model_grouping = frozenset(frozenset(range(i * model, (i + 1) * model))
                               for i in range(data))
    data_grouping = frozenset(frozenset(range(j, n, model))
                              for j in range(model))
    by_axis = {(c.axis, c.grouping) for c in log if c.op == "psum"}
    assert by_axis == {("model", model_grouping), ("data", data_grouping)}
    # one output sum per layer, the loss's and one per parameter
    assert [c.axis for c in log].count("model") == SMALL["n_layers"]
    assert [c.axis for c in log].count("data") == 3


def test_collectives_record_only_inside_a_recording():
    mesh = make_mesh(2, MeshPlan(1, 2), device="cpu")
    xs = [torch.ones(2), torch.ones(2)]
    collectives.psum(xs, mesh, "model")
    with collectives.recording() as log:
        got = collectives.psum(xs, mesh, "model")
    assert len(log) == 1 and torch.equal(got[1], torch.full((2,), 2.0))


def test_sharded_training_reduces_the_loss():
    cfg = burnin.BurninConfig(d_model=32, d_hidden=64, n_layers=2, batch=8,
                              learning_rate=1e-2)
    mesh = make_mesh(4, MeshPlan(2, 2), device="cpu")
    step, params, opt_state, x, y = burnin.make_sharded_train_step(cfg, mesh)
    losses = []
    for _ in range(5):
        params, opt_state, loss = step(params, opt_state, x, y)
        losses.append(loss.item())
    assert all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]


def test_sharding_rejects_an_uneven_split():
    mesh = make_mesh(3, MeshPlan(1, 3), device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        burnin.make_sharded_train_step(burnin.BurninConfig(**SMALL), mesh)
