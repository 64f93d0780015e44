"""PyTorch + CUDA port of ``imagined_speech_translation_tpu`` for NVIDIA Hopper.

The JAX package is the reference; this package imports ``torch`` and never
``jax``, and nothing of the JAX package: it keeps its own copies of the
jax-free modules it needs (``config``, ``runtime.batcher``, ``data``).
Slices ported so far, with the TPU kernels on them rewritten in CUDA C++
(``csrc/``):

* serving -- IIR frontend, region encoder, cross-region fusion, BART
  decoder, greedy/beam search and ``cli.serve.build_decode_fn``;
* the default training step -- train-mode model (dropout, BatchNorm batch
  statistics), flash attention with in-kernel dropout and its fused
  backward, composite loss, three-group fused AdamW and gradient
  accumulation (``training``).
"""

__version__ = "0.1.0"
