"""The import guard: no JAX and no JAX package in a benchmark process.

The program under test is ``tpu_operator_torch``; the JAX package
``tpu_operator`` beside it is its reference in the CPU tests and is never
run here. Names are compared by their whole top-level part (the text before
the first dot), so ``tpu_operator_torch`` is not ``tpu_operator``.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_operator")


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: the
    modules this process has loaded), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names}
                  & set(FORBIDDEN))


class ForbiddenImport(RuntimeError):
    """A forbidden module is loaded in the benchmark's process."""


def check(stage: str, modules=None) -> None:
    """Raise :class:`ForbiddenImport` naming what was found at ``stage``."""
    found = forbidden_loaded(modules)
    if found:
        raise ForbiddenImport(f"{stage}: forbidden modules loaded: "
                              f"{', '.join(found)}")
