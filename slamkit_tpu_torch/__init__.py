"""slamkit_tpu_torch — the PyTorch / CUDA port of slamkit_tpu for NVIDIA Hopper.

The JAX package (`slamkit_tpu`) stays the reference; this package re-implements
its unit-LM serving path (scoring with `UnitLM.log_likelihood` and sampling
with `UnitLM.generate`) in PyTorch, with the Pallas flash-attention forward
rewritten as a hand-written CUDA kernel for sm_90a
(`slamkit_tpu_torch/ops/csrc/flash_fwd.cu`).

Nothing is imported eagerly: `import slamkit_tpu_torch.models` pulls in the
decoder and UnitLM, `slamkit_tpu_torch.ops` the attention ops. The package
never imports jax.
"""

__version__ = "0.1.0"
