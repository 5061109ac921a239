"""Parallelism of the port: data parallelism over ``torch.distributed``
(`mesh`, one process a rank under ``torchrun``) and ZeRO-1 / FSDP on the
trainer's flat parameter buffer (`zero`), tensor and sequence
parallelism (`tp`) and pipeline parallelism (`pp`), on the data x pipe x
model grid of `mesh`. The module names are the JAX package's
(``end2end_asr_tpu/parallel/``)."""
