"""PyTorch + CUDA port of ``imagined_speech_translation_tpu`` for NVIDIA Hopper.

The JAX package is the reference; this package imports ``torch`` and never
``jax``.  It reuses only the JAX package's jax-free modules (``config`` and
``runtime``).  Slice ported so far: the serving path -- IIR frontend, region
encoder, cross-region fusion, BART decoder, greedy/beam search and
``cli.serve.build_decode_fn`` -- with the two TPU kernels on that path
rewritten in CUDA C++ (``csrc/``).
"""

__version__ = "0.1.0"
