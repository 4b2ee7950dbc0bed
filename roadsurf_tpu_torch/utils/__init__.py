from .weights import from_jax_params, load_params

__all__ = ["from_jax_params", "load_params"]
