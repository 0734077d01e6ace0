"""ray_tpu_torch.ops — hand-written Hopper kernels (sources in csrc/,
built by _build.py at first use) and their plain PyTorch versions:

  - ``paged_attention``: decode attention over a paged KV cache (serving);
  - ``flash``: fused causal attention, forward and backward (training);
  - ``ring_attention``: one ring step's block attention (kernel 2, forward
    only on the card) and the ring over a mesh's ``seq`` axis, in one
    process (``ring_attention_sharded``; ``devices=["cpu"] * n`` on the
    CPU) or across ranks (``ring_attention``, the per-rank body);
  - ``moe``: the Switch MoE layer, on one device or expert-parallel;
  - ``pipeline``: GPipe microbatching over a mesh's ``pipe`` axis.

Import the modules themselves (``ray_tpu_torch.ops.flash``); this package
re-exports nothing, so a module name never shadows a function of the same
name."""
