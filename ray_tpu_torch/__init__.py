"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

The port grows slice by slice beside the JAX package (``ray_tpu``), which
stays the reference it is tested against. Module names follow
``ray_tpu``'s so each counterpart is easy to find. The port imports
``torch`` and never ``jax``, ``flax`` or anything under ``ray_tpu``.

Ported so far: the LLM serving engine, the training step, and ring
attention (sequence parallelism over a mesh's ``seq`` axis) with every
TPU kernel of the JAX package as a hand-written CUDA kernel.

    from ray_tpu_torch.models.inference import InferenceConfig, InferenceEngine
    from ray_tpu_torch.models.train_step import make_optimizer, make_train_step
    from ray_tpu_torch.models.transformer import (Transformer,
                                                  TransformerConfig,
                                                  init_params)

    cfg = TransformerConfig(...)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0))
    engine = InferenceEngine(params, cfg, InferenceConfig(...))  # on "cuda"
    tokens = engine.generate([1, 2, 3], max_new_tokens=16)

    model = Transformer(cfg).load_params(params)                 # on "cuda"
    step = make_train_step(model, make_optimizer(model.parameters()))
    metrics = step({"tokens": batch})      # {"loss", "grad_norm"}; in place

    from ray_tpu_torch.models.train_step import make_forward
    from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh, use_mesh

    ring = Transformer(dataclasses.replace(cfg, ring_attention=True))
    ring.load_params(params)
    mesh = make_mesh(MeshConfig(seq=4), ["cuda:0"] * 4)  # one card, 4 shards
    with use_mesh(mesh):
        logits = make_forward(ring)(long_tokens)   # forward only on the card

On the CPU the ring runs over ``make_mesh(MeshConfig(seq=n), ["cpu"] * n)``
and is differentiable there; on the card its block kernel has no
backward, and a call that autograd would differentiate raises.

Entry points run on the card unless the caller passes ``device="cpu"``.
On the card, every kernel runs as the hand-written CUDA kernel in
``ops/csrc``; there is no fallback to a plain PyTorch path.
"""

__version__ = "0.1.0"
