"""ray_tpu_torch.ops — hand-written Hopper kernels (sources in csrc/,
built by _build.py at first use) and their plain PyTorch versions:

  - ``paged_attention``: decode attention over a paged KV cache (serving);
  - ``flash``: fused causal attention, forward and backward (training);
  - ``ring_attention``: one ring step's block attention (kernel 2, forward
    only on the card) and the in-process ring over a mesh's ``seq`` axis
    (``ring_attention_sharded``; ``devices=["cpu"] * n`` on the CPU).

Import the modules themselves (``ray_tpu_torch.ops.flash``); this package
re-exports nothing, so a module name never shadows a function of the same
name."""
