"""The burn-in model: a residual MLP, the flagship device workload.

The port of ``tpu_operator/ops/burnin.py``: the forward pass, the
single-device train step and the train step sharded over a (data, model)
mesh of ranks. Parameters stay
stacked by layer (``w_in`` [L, d, h], ``w_out`` [L, h, d]), in bf16 by
default, and each layer computes ``h + gelu(h @ w_in) @ w_out`` in the
activations' dtype. ``jax.nn.gelu`` defaults to the tanh approximation, so
the port uses ``F.gelu(approximate="tanh")``.

Weights come from a seeded ``torch.Generator``; they do not reproduce JAX's
draws, and nothing relies on them doing so. :func:`params_from_jax` moves
JAX-initialised parameters across through numpy, which is how the parity
tests compare the two packages.

The optimizer is :class:`AdamW` with ``optax.adamw``'s defaults (weight decay
1e-4, not torch's 0.01), its moments kept in the parameters' dtype as optax
keeps them.

The sharded step (Megatron-style, as the reference's ``param_specs``) holds
on rank (d, m) batch block d, ``w_in[:, :, m-block]`` (column-parallel),
``w_out[:, m-block, :]`` (row-parallel) and the AdamW state of those shards.
Each layer's partial output is summed over the model group and the gradients
over the data group, both through ``parallel/collectives.psum``, whose log
records them. All ranks live in one process, so one autograd pass covers
them: a psum's gradient is a psum over the same group.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_operator_torch.parallel.collectives import psum
from tpu_operator_torch.parallel.mesh import Mesh
from tpu_operator_torch.utils.device import resolve_device


@dataclass(frozen=True)
class BurninConfig:
    d_model: int = 512
    d_hidden: int = 2048
    n_layers: int = 4
    batch: int = 32
    dtype: torch.dtype = torch.bfloat16
    learning_rate: float = 1e-3

    def flops_per_step(self) -> int:
        # fwd + bwd ~= 3x fwd matmul FLOPs
        fwd = 2 * self.batch * (self.d_model * self.d_hidden * 2) * self.n_layers
        return 3 * fwd


class BurninModel(nn.Module):
    """Residual MLP over layer-stacked weights."""

    def __init__(self, w_in: torch.Tensor, w_out: torch.Tensor):
        super().__init__()
        if w_in.dim() != 3 or w_out.shape != (w_in.shape[0], w_in.shape[2],
                                              w_in.shape[1]):
            raise ValueError(f"need w_in [L,d,h] and w_out [L,h,d], got "
                             f"{tuple(w_in.shape)} and {tuple(w_out.shape)}")
        self.w_in = nn.Parameter(w_in)
        self.w_out = nn.Parameter(w_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return burnin_forward({"w_in": self.w_in, "w_out": self.w_out}, x)


def _layer(h, w_in, w_out):
    return F.gelu(h @ w_in, approximate="tanh") @ w_out


def burnin_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The residual MLP over layer-stacked ``params``: for each layer
    ``h + gelu(h @ w_in) @ w_out`` in the activations' dtype."""
    h = x
    for w_in, w_out in zip(params["w_in"], params["w_out"]):
        h = (h + _layer(h, w_in, w_out)).to(h.dtype)
    return h


def init_burnin(cfg: BurninConfig = BurninConfig(), seed: int = 42,
                device="cuda") -> BurninModel:
    """Random weights scaled by 1/√fan-in, drawn from a seeded generator."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape_in = (cfg.n_layers, cfg.d_model, cfg.d_hidden)
    shape_out = (cfg.n_layers, cfg.d_hidden, cfg.d_model)
    w_in = torch.randn(shape_in, generator=gen, device=dev) \
        / math.sqrt(cfg.d_model)
    w_out = torch.randn(shape_out, generator=gen, device=dev) \
        / math.sqrt(cfg.d_hidden)
    return BurninModel(w_in.to(cfg.dtype), w_out.to(cfg.dtype))


def _tensor_from_numpy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    # JAX's bf16 arrays reach numpy as ml_dtypes.bfloat16, which
    # torch.from_numpy refuses: widen to f32 (lossless) and narrow back
    if a.dtype.name == "bfloat16":
        wide = torch.tensor(np.asarray(a, np.float32))
        return wide.to(device=device, dtype=torch.bfloat16)
    return torch.tensor(a, device=device)


def params_from_jax(params: dict, device="cuda") -> BurninModel:
    """A :class:`BurninModel` holding the reference's parameters
    (``{"w_in", "w_out"}`` as numpy arrays), in their dtype."""
    dev = resolve_device(device)
    return BurninModel(_tensor_from_numpy(np.asarray(params["w_in"]), dev),
                       _tensor_from_numpy(np.asarray(params["w_out"]), dev))


def _loss(params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean squared error in f32."""
    return (burnin_forward(params, x).float() - y).square().mean()


@dataclass(frozen=True)
class AdamW:
    """``optax.adamw`` with its defaults: Adam's moments with bias
    correction, then decoupled weight decay, scaled by the learning rate.
    Each update is computed in f32; the moments and the parameters are
    stored in the parameters' dtype."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def init(self, params: dict) -> dict:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(self, grads: dict, state: dict,
               params: dict) -> tuple[dict, dict]:
        count = state["count"] + 1
        new, mu, nu = {}, {}, {}
        for k, p in params.items():
            g = grads[k].float()
            m = (1 - self.b1) * g + self.b1 * state["mu"][k].float()
            v = (1 - self.b2) * g.square() + self.b2 * state["nu"][k].float()
            u = (m / (1 - self.b1 ** count)) \
                / ((v / (1 - self.b2 ** count)).sqrt() + self.eps)
            u = u + self.weight_decay * p.float()
            new[k] = (p.float() - self.learning_rate * u).to(p.dtype)
            mu[k], nu[k] = m.to(p.dtype), v.to(p.dtype)
        return new, {"count": count, "mu": mu, "nu": nu}


def _leaves(params: dict) -> dict:
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


def make_train_step(cfg: BurninConfig):
    """Single-device train step: ``step(params, opt_state, x, y)`` →
    ``(params, opt_state, loss)``, with ``params`` a dict of tensors."""
    tx = AdamW(cfg.learning_rate)

    def step(params, opt_state, x, y):
        leaves = _leaves(params)
        loss = _loss(leaves, x, y)
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        params, opt_state = tx.update(grads, opt_state, params)
        return params, opt_state, loss.detach()

    return step, tx


def param_specs() -> dict:
    """The mesh axis each parameter dimension is split over (None:
    replicated), as the reference's ``PartitionSpec``s."""
    return {"w_in": (None, None, "model"), "w_out": (None, "model", None)}


BATCH_SPEC = ("data", None)


def _block(t: torch.Tensor, spec: tuple, mesh: Mesh,
           rank: int) -> torch.Tensor:
    """Rank ``rank``'s block of ``t`` under ``spec``, on its device."""
    coords = mesh.coords(rank)
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = mesh.shape[axis]
            if t.shape[dim] % n:
                raise ValueError(f"dimension {dim} of {tuple(t.shape)} is not "
                                 f"divisible by the {axis} axis ({n})")
            size = t.shape[dim] // n
            t = t.narrow(dim, coords[axis] * size, size)
    return t.to(mesh.device(rank), copy=True).contiguous()


def shard_state(params: dict, x: torch.Tensor, y: torch.Tensor, mesh: Mesh,
                tx: AdamW):
    """Whole parameters and batch → per-rank ``(params, opt_state, x, y)``
    lists, indexed by rank."""
    specs = param_specs()
    ranks = range(mesh.size)
    shards = [{k: _block(v, specs[k], mesh, r) for k, v in params.items()}
              for r in ranks]
    return (shards, [tx.init(p) for p in shards],
            [_block(x, BATCH_SPEC, mesh, r) for r in ranks],
            [_block(y, BATCH_SPEC, mesh, r) for r in ranks])


def sharded_state_from_jax(params: dict, x, y, mesh: Mesh,
                           cfg: BurninConfig = BurninConfig()):
    """The reference's ``(params, x, y)``, as numpy arrays, as the
    per-rank state of :func:`make_sharded_train_step`'s step."""
    cpu = torch.device("cpu")
    whole = {k: _tensor_from_numpy(np.asarray(v), cpu)
             for k, v in params.items()}
    return shard_state(whole, _tensor_from_numpy(np.asarray(x), cpu),
                       _tensor_from_numpy(np.asarray(y), cpu), mesh,
                       AdamW(cfg.learning_rate))


def make_sharded_step(mesh: Mesh, tx: AdamW):
    """The train step over per-rank state: ``step(params, opt_state, x,
    y)`` → ``(params, opt_state, loss)``, the loss the global mean."""
    ranks = range(mesh.size)

    def step(params, opt_state, x, y):
        leaves = [_leaves(p) for p in params]
        h = list(x)
        for layer in range(leaves[0]["w_in"].shape[0]):
            partial = [_layer(h[r], leaves[r]["w_in"][layer],
                              leaves[r]["w_out"][layer]) for r in ranks]
            summed = psum(partial, mesh, "model")   # row-parallel output
            h = [(h[r] + summed[r]).to(h[r].dtype) for r in ranks]
        # the model ranks of a data shard hold the same output: the global
        # mean sums the shards' means over the data axis, counted once per
        # data shard by reading it on rank 0
        local = [(h[r].float() - y[r]).square().mean() / mesh.shape["data"]
                 for r in ranks]
        loss = psum(local, mesh, "data")[0]
        flat = [leaf for p in leaves for leaf in p.values()]
        # a leaf the loss does not reach has a zero gradient
        grads = iter(torch.autograd.grad(loss, flat, materialize_grads=True))
        grads = [{k: next(grads) for k in p} for p in leaves]
        for k in grads[0]:
            summed = psum([g[k] for g in grads], mesh, "data")
            for r in ranks:
                grads[r][k] = summed[r]
        new = [tx.update(grads[r], opt_state[r], params[r]) for r in ranks]
        return ([p for p, _ in new], [s for _, s in new], loss.detach())

    return step


def make_sharded_train_step(cfg: BurninConfig, mesh: Mesh, seed: int = 42):
    """The multi-rank train step the dry run drives: returns ``(step,
    params, opt_state, x, y)`` with everything already placed per rank.
    Weights from :func:`init_burnin` (``seed``), the batch from seed 7."""
    tx = AdamW(cfg.learning_rate)
    dev = mesh.device(0)
    model = init_burnin(cfg, seed=seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((cfg.batch, cfg.d_model), generator=gen,
                    device=dev).to(cfg.dtype)
    y = torch.randn((cfg.batch, cfg.d_model), generator=gen, device=dev)
    params = {"w_in": model.w_in.detach(), "w_out": model.w_out.detach()}
    return (make_sharded_step(mesh, tx), *shard_state(params, x, y, mesh, tx))
