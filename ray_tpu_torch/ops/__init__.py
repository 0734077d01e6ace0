"""ray_tpu_torch.ops — hand-written Hopper kernels (sources in csrc/,
built by _build.py at first use) and their plain PyTorch versions.

Import the modules themselves (``ray_tpu_torch.ops.paged_attention``);
this package re-exports nothing, so a module name never shadows a
function of the same name."""
