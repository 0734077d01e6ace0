"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

The port grows slice by slice beside the JAX package (``ray_tpu``), which
stays the reference it is tested against. Module names follow
``ray_tpu``'s so each counterpart is easy to find. The port imports
``torch`` and never ``jax``, ``flax`` or anything under ``ray_tpu``.

This slice is the LLM serving engine:

    from ray_tpu_torch.models.inference import InferenceConfig, InferenceEngine
    from ray_tpu_torch.models.transformer import TransformerConfig, init_params

    cfg = TransformerConfig(...)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    engine = InferenceEngine(params, cfg, InferenceConfig(...))  # on "cuda"
    tokens = engine.generate([1, 2, 3], max_new_tokens=16)

Entry points run on the card unless the caller passes ``device="cpu"``.
On the card, every kernel runs as the hand-written CUDA kernel in
``ops/csrc``; there is no fallback to a plain PyTorch path.
"""

__version__ = "0.1.0"
