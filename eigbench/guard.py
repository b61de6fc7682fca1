"""The check that a run loaded neither JAX nor the JAX package.

Modules are compared by their top-level name, the part before the first
dot, taken whole: ``jax.numpy`` is JAX's, ``jaxtyping`` is not, and the
port (``pcsc_eigenvalue_solver_project_tpu_torch``) is not the JAX package
(``pcsc_eigenvalue_solver_project_tpu``) though its name begins with it."""

from __future__ import annotations

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "pcsc_eigenvalue_solver_project_tpu"})


def forbidden(module_names) -> list:
    """The forbidden top-level names among ``module_names``, sorted."""
    return sorted({name.split(".", 1)[0] for name in module_names} & FORBIDDEN)
