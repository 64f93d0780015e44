"""PyTorch + CUDA port of ``imagined_speech_translation_tpu`` for NVIDIA Hopper.

The JAX package is the reference; this package imports ``torch`` and never
``jax``, and nothing of the JAX package: it keeps its own copies of the
jax-free modules it needs (``config``, ``runtime``, ``data`` with
``data.fetch``, ``evaluation``, ``utils.metrics``, ``wake.dataset`` and
``wake.native``).
Slices ported so far, with the TPU kernels on them rewritten in CUDA C++
(``csrc/``):

* serving -- IIR frontend, region encoder, cross-region fusion, BART
  decoder, greedy/beam search and ``cli.serve.build_decode_fn``, behind
  ``cli.serve`` -> ``runtime.server.WssService``: websocket sessions (the
  reference's text and binary framings, auth gate, command table), a ring
  buffer, windower and wake gate per session, windows pooled across
  sessions by ``runtime.BatchScheduler``, the float16 wire, a trainer
  checkpoint or a model ``state_dict`` as the weights, and the decode
  function optionally in a recycled child process
  (``runtime.worker.DecodeWorker``);
* the default training step -- train-mode model (dropout, BatchNorm batch
  statistics), flash attention with in-kernel dropout and its fused
  backward, composite loss, three-group fused AdamW and gradient
  accumulation (``training``);
* the eval-mode gradient -- ``cli.profile --what train``: the gradient of
  ``models.bart.cross_entropy_loss`` through the eval-mode model, whose
  attention backward at dropout rate 0 runs the split dQ and dK/dV
  kernels, traced with ``utils.profiling``;
* the trainer -- ``cli.train`` -> ``training.EEGTrainer`` (the dataset's
  windows, train steps, beam-search evaluation with BLEU/ROUGE and
  diversity, model selection, adaptive loss weights), checkpoints
  (``training.CheckpointManager``) with ``--resume``, and ``cli.evaluate``;
* the rest of the JAX package's entry points -- the pretrained decoder
  (``cli.convert_hf``, ``cli.train --bart-params``), data, tensor and
  sequence parallelism (``parallel``), the wake twin (``wake``,
  ``cli.wake_train``) and the reproduction chain (``cli.reproduce``).
"""

__version__ = "0.1.0"
