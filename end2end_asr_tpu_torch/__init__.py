"""PyTorch + CUDA port of end2end_asr_tpu for NVIDIA Hopper (H100).

The JAX package ``end2end_asr_tpu`` stays the reference; this package
imports nothing of it and nothing of JAX. Its TPU kernels become
hand-written CUDA kernels under ``csrc/`` (ops/stft.py,
ops/vgg_fused.py); the rest is plain PyTorch. Entry points:
``python -m end2end_asr_tpu_torch.test`` and
``python -m end2end_asr_tpu_torch.transcribe`` (``--device cuda`` by
default).
"""
