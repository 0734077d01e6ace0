"""Model family of the port: the flagship decoder-only transformer
(models/transformer.py) and the serving engine over it
(models/inference.py)."""

from ray_tpu_torch.models.transformer import (Transformer,  # noqa: F401
                                              TransformerConfig, init_params,
                                              params_from_jax)

__all__ = ["Transformer", "TransformerConfig", "init_params",
           "params_from_jax"]
