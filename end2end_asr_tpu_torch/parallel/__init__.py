"""Parallelism of the port: data parallelism over ``torch.distributed``
(`mesh`, one process a rank under ``torchrun``) and ZeRO-1 / FSDP on the
trainer's flat parameter buffer (`zero`). The module names are the JAX
package's (``end2end_asr_tpu/parallel/``); tensor, sequence and pipeline
parallelism are not ported yet."""
