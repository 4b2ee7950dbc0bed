from .weights import from_jax_params, from_jax_quant, load_params

__all__ = ["from_jax_params", "from_jax_quant", "load_params"]
