"""Entry points: the burn-in forward pass and the multi-device dry run.

The port's counterparts of ``__graft_entry__.entry()`` and
``dryrun_multichip()``, at the model's full width (``BurninConfig()``
defaults) rather than the reference's small compile-check size.

The dry run's ranks are virtual ranks (``parallel/mesh.py``): on the card
every rank lies on ``cuda:0``, with its own tensors, and each ring kernel is
one launch that holds all of them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpu_operator_torch.ops.burnin import (BurninConfig, init_burnin,
                                           make_sharded_train_step)
from tpu_operator_torch.parallel import collectives
from tpu_operator_torch.parallel.mesh import Mesh, MeshPlan, make_mesh
from tpu_operator_torch.parallel.numerics import (attention_tolerance,
                                                  reduction_tolerance)
from tpu_operator_torch.parallel.ring import (ring_all_gather_sharded,
                                              ring_all_reduce_bidir_sharded,
                                              ring_all_reduce_sharded,
                                              ring_reduce_scatter_sharded)
from tpu_operator_torch.parallel.ring_attention import (reference_attention,
                                                        ring_attention)
from tpu_operator_torch.utils.device import resolve_device


def entry(device="cuda"):
    """Return ``(fn, args)``: the burn-in model and its input, on
    ``device``. ``fn(*args)`` runs the forward pass."""
    dev = resolve_device(device)
    cfg = BurninConfig()
    model = init_burnin(cfg, device=dev)
    x = torch.ones((cfg.batch, cfg.d_model), dtype=cfg.dtype, device=dev)
    return model, (x,)


def _require(cond: bool, msg: str) -> None:
    """A dry-run check: raises AssertionError, and stays under ``-O``."""
    if not cond:
        raise AssertionError(msg)


def _assert_collectives(log, plan: MeshPlan) -> None:
    """The step's sums ran over exactly the groups the shardings imply: a
    gradient sum over "data" (groups strided by ``plan.model``) and a
    row-parallel output sum over "model" (contiguous groups), matched
    against the collectives' log, as the reference matches its HLO's
    replica_groups (group sizes alone could alias when data == model)."""
    n = plan.data * plan.model
    if n == 1:
        return
    observed = {c.grouping for c in log if c.op == "psum"}
    _require(bool(observed), "no psum in the step")
    model_grouping = frozenset(
        frozenset(range(i * plan.model, (i + 1) * plan.model))
        for i in range(plan.data))
    data_grouping = frozenset(
        frozenset(range(j, n, plan.model)) for j in range(plan.model))
    for grouping, axis, size in ((data_grouping, "data", plan.data),
                                 (model_grouping, "model", plan.model)):
        if size > 1:
            _require(grouping in observed, (
                f"no collective over the {axis} axis grouping "
                f"{sorted(map(sorted, grouping))}; observed: "
                f"{[sorted(map(sorted, g)) for g in observed]}"))


def _allclose(got, want, tol: float, what: str) -> None:
    err = (got - want).abs()
    _require(bool((err <= tol + tol * want.abs()).all()),
             f"{what}: max abs err {err.max().item():.3e} > tolerance "
             f"{tol:.3e}")


def _check_ring_kernels(mesh: Mesh) -> None:
    """Hold the ring kernels (K3–K6) against the library collectives on the
    same ranks, and ring attention against the oracle, at the reference's
    inputs: rows, cols = 2n², 128 from ``np.random.default_rng(0)``."""
    devices = list(mesh.devices.flat)
    n = len(devices)
    ring_mesh = Mesh(np.array(devices, dtype=object), ("ring",))
    # two association orders of the same n-deep f32 reduction
    red_tol = reduction_tolerance(torch.float32, n)
    rows, cols = 2 * n * n, 128
    a = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (rows, cols), dtype=np.float32)).to(devices[0])
    shards = list(a.chunk(n))
    lib_sum = collectives.psum(shards, ring_mesh, "ring")[0]

    _allclose(ring_all_reduce_sharded(a, ring_mesh, "ring"), lib_sum,
              red_tol, "ring all-reduce")
    if (rows // n) % (2 * n) == 0:
        _allclose(ring_all_reduce_bidir_sharded(a, ring_mesh, "ring"),
                  lib_sum, red_tol, "bidirectional ring all-reduce")

    t, d = 4 * n, 16
    q, k, v = (torch.from_numpy(x).to(devices[0]) for x in
               np.random.default_rng(3).standard_normal((3, t, d),
                                                        dtype=np.float32))
    got = ring_attention(q, k, v, ring_mesh, "ring")
    ref = reference_attention(q, k, v)
    _allclose(got, ref, attention_tolerance(torch.float32, d,
                                            devices[0].type),
              "ring attention")

    gathered = collectives.all_gather(shards, ring_mesh, "ring")[0]
    _require(torch.equal(ring_all_gather_sharded(a, ring_mesh, "ring"),
                         gathered), "ring all-gather differs from all_gather")

    scattered = torch.cat(collectives.psum_scatter(shards, ring_mesh, "ring"))
    _allclose(ring_reduce_scatter_sharded(a, ring_mesh, "ring"), scattered,
              red_tol, "ring reduce-scatter")


def dryrun_multigpu(n_devices: int, device="cuda") -> float:
    """One full-width sharded train step over ``n_devices`` virtual ranks
    on ``device``: the loss must be finite and the step's sums must run
    over the data and model groups; then the ring kernels are held against
    the library collectives. Prints ``DRYRUN OK`` and returns the loss.

    Mesh axes ("data", "model"): the plan prefers both axes > 1, so the run
    exercises data- and tensor-parallel sums."""
    dev = resolve_device(device)
    plan = MeshPlan.auto(n_devices, max_model=max(1, n_devices // 2))
    mesh = make_mesh(n_devices, plan, device=dev)
    cfg = BurninConfig()
    with collectives.recording() as log:
        step, params, opt_state, x, y = make_sharded_train_step(cfg, mesh)
        params, opt_state, loss = step(params, opt_state, x, y)
    loss = float(loss)
    _require(math.isfinite(loss), f"burn-in loss not finite: {loss}")
    _assert_collectives(log, plan)
    _check_ring_kernels(mesh)
    devices = sorted({str(d) for d in mesh.devices.flat})
    print(f"DRYRUN OK: n={n_devices} plan=(data={plan.data},"
          f"model={plan.model}) loss={loss:.4f} devices={devices}")
    return loss
