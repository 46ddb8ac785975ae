"""PyTorch + CUDA port of agenda_tpu for NVIDIA Hopper (H100, sm_90a).

The package mirrors ``agenda_tpu``'s module names so each module's JAX
counterpart is easy to find. It imports torch and never jax, flax or
anything under ``agenda_tpu``: the parity tests are the only code that
imports both packages.

Entry points run on CUDA unless the caller passes ``device="cpu"``. On the
card the models compute in bf16 (f32 softmax, f32 GroupNorm statistics, f32
UNet output and sampler state); on the CPU they compute in f32.

The two hand-written kernels of the generation path live in ``csrc/``
(flash-attention forward and GroupNorm(+SiLU)); ``kernels/_build.py``
compiles them with ``nvcc`` at first use.
"""

__version__ = "0.1.0"
